"""Config system: reference-compatible JSON settings with group indirection.

The reference configures everything from one JSON file whose groups are
referenced by name from other groups (e.g. ``/Frontend/LocalSlam/
ScanMatcherConfigGroup = "ScanMatcherRealTimeCorrelative"``), letting
module types be swapped without code changes
(``launcher_settings_default.json``, loaded at ``slam_launcher.cpp:
109-154``; dispatch in ``slam_module_factory.cpp`` and the per-module
factories).  This module loads that exact file format and builds the
SLAM system from it; defaults mirror the reference's defaults.
"""
from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Dict, Optional


def _get(settings: Dict, path: str, default=None):
    """Path lookup with both '.' (boost ptree, used by the reference's
    config-group indirection strings like
    ``"PoseGraphOptimizerLM.LossHuber"``) and '/' separators."""
    node: Any = settings
    for part in re.split(r"[/.]", path.strip("/")):
        if not isinstance(node, dict) or part not in node:
            return default
        node = node[part]
    return node


def _bool(v, default=False):
    if v is None:
        return default
    if isinstance(v, bool):
        return v
    return str(v).lower() == "true"


def load_settings(path: str) -> Dict:
    return json.loads(Path(path).read_text())


def create_cost_config(settings: Dict, cost_type: str, config_group: str):
    """``CreateCostFunction`` (cost_function_factory.cpp:51-66): CostType
    in {"SquareError", "GreedyEndpoint"}, parameters from the named
    CostConfigGroup."""
    from ..matching.cost import CostConfig

    g = _get(settings, config_group, {}) or {}
    if cost_type == "SquareError":
        return CostConfig(
            cost_type="SquareError",
            covariance_scale=float(g.get("CovarianceScale", 1e4)),
        )
    if cost_type == "GreedyEndpoint":
        return CostConfig(
            cost_type="GreedyEndpoint",
            hit_and_missed_dist=float(g.get("HitAndMissedDist", 0.075)),
            occupancy_threshold=float(g.get("OccupancyThreshold", 0.1)),
            kernel_size=int(g.get("KernelSize", 1)),
            standard_deviation=float(g.get("StandardDeviation", 0.05)),
            scaling_factor=float(g.get("ScalingFactor", 1.0)),
        )
    raise ValueError(f"unknown cost type: {cost_type}")


def create_score_config(settings: Dict, score_type: str, config_group: str):
    """``CreateScoreFunction`` (score_function_factory.cpp): the reference
    implements exactly one score function (PixelAccurate, parameterless) —
    anything else is a configuration error."""
    if score_type != "PixelAccurate":
        raise ValueError(f"unknown score type: {score_type}")
    return score_type


def _matcher_cost(settings: Dict, g: Dict, default_type: str = "SquareError"):
    """Per-matcher CostType/CostConfigGroup dispatch
    (scan_matcher_factory.cpp:30-100)."""
    cost_type = g.get("CostType", default_type)
    group = g.get(
        "CostConfigGroup",
        "CostSquareError" if cost_type == "SquareError" else "CostGreedyEndpoint",
    )
    return create_cost_config(settings, cost_type, group)


def create_scan_matcher_from_group(
    settings: Dict, type_name: str, group_name: str, *,
    resolution: float, n_theta_max: int, crop: int, name: str = None,
):
    """Per-type scan matcher creation (``scan_matcher_factory.cpp``).
    ``name`` scopes the matcher's metric series like the reference
    (e.g. ``LocalSlam.ScanMatcherCorrelative``)."""
    from ..matching.correlative import CorrelativeConfig, ScanMatcherCorrelative
    from ..matching.linear_solver import LinearSolverConfig, ScanMatcherLinearSolver

    g = _get(settings, group_name, {}) or {}
    if "ScoreType" in g:
        create_score_config(
            settings, g["ScoreType"], g.get("ScoreConfigGroup", "")
        )
    if type_name == "RealTimeCorrelative":
        return ScanMatcherCorrelative(
            CorrelativeConfig(
                low_resolution=int(g.get("LowResolutionMapWinSize", 5)),
                range_x=float(g.get("SearchRangeX", 0.25)),
                range_y=float(g.get("SearchRangeY", 0.25)),
                range_theta=float(g.get("SearchRangeTheta", 0.5)),
                resolution=resolution,
                n_theta_max=n_theta_max,
                crop_rows=crop,
                crop_cols=crop,
                cost=_matcher_cost(settings, g),
            ),
            **(dict(name=name) if name else {}),
        )
    if type_name == "LinearSolver":
        # The reference asserts SquareError here
        # (scan_matcher_factory.cpp:152-156).
        if g.get("CostType", "SquareError") != "SquareError":
            raise ValueError(
                "LinearSolver requires CostType SquareError"
            )
        cost = _matcher_cost(settings, g)
        return ScanMatcherLinearSolver(
            LinearSolverConfig(
                num_iterations_max=int(g.get("NumOfIterationsMax", 10)),
                convergence_threshold=float(g.get("ConvergenceThreshold", 1e-4)),
                initial_lambda=float(g.get("InitialLambda", 1e-4)),
                covariance_scale=cost.covariance_scale,
                resolution=resolution,
            ),
            **(dict(name=name) if name else {}),
        )
    if type_name == "HillClimbing":
        from ..matching.hill_climbing import (
            HillClimbingConfig,
            ScanMatcherHillClimbing,
        )

        return ScanMatcherHillClimbing(
            HillClimbingConfig(
                linear_step=float(g.get("LinearStep", 0.1)),
                angular_step=float(g.get("AngularStep", 0.1)),
                max_iterations=int(g.get("MaxIterations", 100)),
                max_num_of_refinements=int(g.get("MaxNumOfRefinements", 5)),
                resolution=resolution,
                cost=_matcher_cost(settings, g, default_type="GreedyEndpoint"),
            )
        )
    if type_name == "GridSearch":
        from ..matching.grid_search import GridSearchConfig, ScanMatcherGridSearch

        return ScanMatcherGridSearch(
            GridSearchConfig(
                range_x=float(g.get("SearchRangeX", 2.5)),
                range_y=float(g.get("SearchRangeY", 2.5)),
                range_theta=float(g.get("SearchRangeTheta", 0.5)),
                step_x=float(g.get("SearchStepX", 0.05)),
                step_y=float(g.get("SearchStepY", 0.05)),
                step_theta=float(g.get("SearchStepTheta", 0.005)),
                resolution=resolution,
                crop_rows=crop,
                crop_cols=crop,
                cost=_matcher_cost(settings, g),
            )
        )
    if type_name == "BranchBound":
        from ..matching.branch_bound import (
            BranchBoundConfig,
            ScanMatcherBranchBound,
        )

        return ScanMatcherBranchBound(
            BranchBoundConfig(
                node_height_max=int(g.get("NodeHeightMax", 6)),
                range_x=float(g.get("SearchRangeX", 2.5)),
                range_y=float(g.get("SearchRangeY", 2.5)),
                range_theta=float(g.get("SearchRangeTheta", 0.5)),
                resolution=resolution,
                n_theta_max=n_theta_max,
                crop_rows=crop,
                crop_cols=crop,
                cost=_matcher_cost(settings, g),
            )
        )
    raise ValueError(f"unknown scan matcher type: {type_name}")


def create_slam_from_settings(
    settings: Dict,
    *,
    map_rows: int = 1024,
    map_cols: int = 1024,
    n_theta_max: int = 208,
    crop: int = 320,  # reference FPGA map-window contract
    loop_crop: int = 448,
    inline_backend: bool = False,
    fuse_matchers: bool = True,
):
    """``CreateLidarGraphSlam`` (slam_module_factory.cpp:214-244).

    ``inline_backend`` defaults to False: like the reference, the backend
    (loop detection + optimization) runs pipelined on a worker thread
    (``lidar_graph_slam.cpp:771-860``) so the frontend does not stall for
    the whole detect+optimize pass at every trigger; the frontend blocks
    only while node poses are being rewritten (wait_for_optimization).
    Pass True for single-threaded deterministic runs (tests)."""
    import numpy as np

    from ..graph.loss import LossFunction
    from ..graph.optimizer import OptimizerConfig, PoseGraphOptimizer
    from ..grid.builder import GridMapBuilder, GridMapBuilderConfig
    from ..loop.detector import (
        LoopDetectorConfig,
        LoopDetectorCorrelative,
        LoopDetectorEmpty,
    )
    from ..loop.searcher import LoopSearcherConfig, LoopSearcherNearest
    from ..metrics.registry import MetricManager
    from ..pipeline.backend import LidarGraphSlamBackend
    from ..pipeline.frontend import FrontendConfig, LidarGraphSlamFrontend
    from ..pipeline.slam import LidarGraphSlam
    from ..sensor.filters import (
        ScanAccumulator,
        ScanInterpolator,
        ScanOutlierFilter,
    )

    res = float(_get(settings, "GridMapBuilder/Map/Resolution", 0.05))

    builder_cfg = GridMapBuilderConfig(
        resolution=res,
        local_map_rows=map_rows,
        local_map_cols=map_cols,
        latest_map_rows=map_rows,
        latest_map_cols=map_cols,
        num_scans_for_latest_map=int(
            _get(settings, "GridMapBuilder/Map/NumOfScansForLatestMap", 10)
        ),
        travel_dist_threshold=float(
            _get(settings, "GridMapBuilder/Map/TravelDistThresholdForLocalMap", 2.5)
        ),
        num_overlapped_scans=int(
            _get(settings, "GridMapBuilder/Map/NumOfOverlappedScans", 10)
        ),
        usable_range_min=float(_get(settings, "GridMapBuilder/UsableRangeMin", 0.01)),
        usable_range_max=float(_get(settings, "GridMapBuilder/UsableRangeMax", 20.0)),
        probability_hit=float(_get(settings, "GridMapBuilder/ProbabilityHit", 0.62)),
        probability_miss=float(_get(settings, "GridMapBuilder/ProbabilityMiss", 0.46)),
    )
    builder = GridMapBuilder(builder_cfg)

    # --- frontend ------------------------------------------------------
    fe = _get(settings, "Frontend", {}) or {}
    sm_type = _get(settings, "Frontend/LocalSlam/ScanMatcherType", "RealTimeCorrelative")
    sm_group = _get(
        settings, "Frontend/LocalSlam/ScanMatcherConfigGroup",
        "ScanMatcherRealTimeCorrelative",
    )
    fsm_type = _get(settings, "Frontend/LocalSlam/FinalScanMatcherType", "LinearSolver")
    fsm_group = _get(
        settings, "Frontend/LocalSlam/FinalScanMatcherConfigGroup",
        "Frontend/LocalSlam/FinalScanMatcherLinearSolver",
    )
    final_matcher = create_scan_matcher_from_group(
        settings, fsm_type, fsm_group,
        resolution=res, n_theta_max=n_theta_max, crop=crop,
        name="LocalSlam.FinalScanMatcherLinearSolver",
    )
    if fuse_matchers and sm_type == "RealTimeCorrelative" \
            and fsm_type == "LinearSolver":
        # The reference's default two-stage frontend match (correlative
        # search + linear-solver refinement, lidar_graph_slam_frontend.cpp:
        # 210-237) compiles into ONE device dispatch — same ops, same
        # results, one host round trip instead of two (the device analog of
        # the FPGA matcher's single-offload contract,
        # scan_matcher_correlative_fpga.cpp:272-364).  Both configs come
        # from the same settings parser as the unfused matchers, so the
        # two paths cannot drift.
        from ..models.fused_matcher import FusedCorrelativeGNMatcher

        base = create_scan_matcher_from_group(
            settings, sm_type, sm_group,
            resolution=res, n_theta_max=n_theta_max, crop=crop,
            name="LocalSlam.ScanMatcherCorrelative",
        )
        scan_matcher = FusedCorrelativeGNMatcher(
            base.cfg, final_matcher.cfg,
            name="LocalSlam.ScanMatcherCorrelative",
            final_name="LocalSlam.FinalScanMatcherLinearSolver",
        )
    else:
        scan_matcher = create_scan_matcher_from_group(
            settings, sm_type, sm_group,
            resolution=res, n_theta_max=n_theta_max, crop=crop,
            name="LocalSlam.ScanMatcherCorrelative"
            if sm_type == "RealTimeCorrelative" else None,
        )
    init = _get(settings, "Frontend/InitialPose", {}) or {}
    fe_cfg = FrontendConfig(
        initial_pose=(
            float(init.get("X", 0.0)),
            float(init.get("Y", 0.0)),
            float(init.get("Theta", 0.0)),
        ),
        update_threshold_travel_dist=float(fe.get("UpdateThresholdTravelDist", 0.5)),
        update_threshold_angle=float(fe.get("UpdateThresholdAngle", 0.5)),
        update_threshold_time=float(fe.get("UpdateThresholdTime", 5.0)),
        loop_detection_threshold=float(fe.get("LoopDetectionThreshold", 2.5)),
        degeneration_threshold=float(fe.get("DegenerationThreshold", 10.0)),
        odometry_covariance_scale=float(fe.get("OdometryCovarianceScale", 1e2)),
        fuse_odometry_covariance=_bool(fe.get("FuseOdometryCovariance"), False),
        use_scan_outlier_filter=_bool(fe.get("UseScanOutlierFilter"), True),
        use_scan_accumulator=_bool(fe.get("UseScanAccumulator"), False),
        use_scan_interpolator=_bool(fe.get("UseScanInterpolator"), True),
        usable_range_max=builder_cfg.usable_range_max,
    )
    sof = _get(settings, fe.get("ScanOutlierFilterConfigGroup", "ScanOutlierFilter"), {}) or {}
    sif = _get(settings, fe.get("ScanInterpolatorConfigGroup", "ScanInterpolator"), {}) or {}
    sacc = _get(settings, fe.get("ScanAccumulatorConfigGroup", "ScanAccumulator"), {}) or {}
    frontend = LidarGraphSlamFrontend(
        fe_cfg,
        scan_matcher,
        final_matcher,
        outlier_filter=ScanOutlierFilter(
            valid_range_min=float(sof.get("ValidRangeMin", 0.01)),
            valid_range_max=float(sof.get("ValidRangeMax", 20.0)),
        ),
        interpolator=ScanInterpolator(
            dist_scans=float(sif.get("DistScans", 0.05)),
            dist_threshold_empty=float(sif.get("DistThresholdEmpty", 0.25)),
        ),
        accumulator=ScanAccumulator(int(sacc.get("NumOfAccumulatedScans", 3)))
        if fe_cfg.use_scan_accumulator
        else None,
        metrics=MetricManager.instance(),
    )

    # --- backend -------------------------------------------------------
    be = _get(settings, "Backend", {}) or {}
    ls_group = _get(settings, be.get("LoopSearcherConfigGroup", "LoopSearcherNearest"), {}) or {}
    searcher = LoopSearcherNearest(
        LoopSearcherConfig(
            travel_dist_threshold=float(ls_group.get("TravelDistThreshold", 10.0)),
            node_dist_threshold=float(ls_group.get("PoseGraphNodeDistMax", 5.0)),
            num_candidate_nodes=int(ls_group.get("NumOfCandidateNodes", 2)),
        )
    )
    ld_type = be.get("LoopDetectorType", "RealTimeCorrelative")
    ld_group_name = be.get(
        "LoopDetectorConfigGroup", "LoopDetectorRealTimeCorrelative"
    )
    ld = _get(settings, ld_group_name, {}) or {}
    if ld_type == "Empty":
        detector = LoopDetectorEmpty()
    else:
        loop_sm_type = ld.get("ScanMatcherType", "RealTimeCorrelative")
        loop_sm = create_scan_matcher_from_group(
            settings, loop_sm_type, f"{ld_group_name}/ScanMatcher",
            resolution=res, n_theta_max=n_theta_max, crop=loop_crop,
            name="LoopDetector.ScanMatcherCorrelative"
            if loop_sm_type == "RealTimeCorrelative" else None,
        )
        loop_final = create_scan_matcher_from_group(
            settings,
            ld.get("FinalScanMatcherType", "LinearSolver"),
            f"{ld_group_name}/FinalScanMatcherLinearSolver",
            resolution=res, n_theta_max=n_theta_max, crop=loop_crop,
            name="LoopDetector.FinalScanMatcherLinearSolver",
        )
        detector = LoopDetectorCorrelative(
            LoopDetectorConfig(
                score_threshold=float(ld.get("ScoreThreshold", 0.55)),
                known_rate_threshold=float(ld.get("KnownRateThreshold", 0.6)),
                usable_range_max=builder_cfg.usable_range_max,
            ),
            loop_sm,
            loop_final,
            resolution=res,
        )

    opt_type = be.get("PoseGraphOptimizerType", "G2O")
    og = _get(settings, be.get("PoseGraphOptimizerConfigGroup", "PoseGraphOptimizerLM"), {}) or {}
    loss_group = _get(
        settings,
        og.get("LossFunctionConfigGroup", "PoseGraphOptimizerLM/LossHuber"),
        {},
    ) or {}
    # G2O (Gauss-Newton + Cholmod) and LM both map onto the batched LM with
    # the Schur solver; G2O's configuration has no robust loss.
    loss = (
        LossFunction("Squared", 1.0)
        if opt_type == "G2O"
        else LossFunction(og.get("LossFunctionType", "Huber"), float(loss_group.get("Scale", 0.01)))
    )
    optimizer = PoseGraphOptimizer(
        OptimizerConfig(
            solver="schur",
            num_iterations_max=int(
                og.get("NumOfIterationsMax", og.get("MaxNumOfIterations", 10))
            ),
            error_tolerance=float(
                og.get("ErrorTolerance", og.get("ConvergenceThreshold", 1e-4))
            ),
            initial_lambda=float(og.get("InitialLambda", 1e-4)),
            loss=loss,
        )
    )
    backend = LidarGraphSlamBackend(
        searcher, detector, optimizer, inline=inline_backend
    )
    return LidarGraphSlam(frontend, backend, builder)
