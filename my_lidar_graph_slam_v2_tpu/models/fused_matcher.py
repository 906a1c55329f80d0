"""Fused frontend matcher: CSM window search + GN refinement in one jit.

The reference frontend runs two matchers back to back
(``lidar_graph_slam_frontend.cpp:210-237``): the correlative searcher and
the linear-solver (GN) refiner.  Device-side both are cheap; what is not
cheap is synchronizing with the host between them (one device round trip
per stage).  This module compiles the whole
two-stage match — coarse map precompute, coarse+fine sweeps, gating,
argmax, iterative GN refinement, covariance — into ONE jitted function
with a single result fetch, and exposes it with the standard matcher API.

Results are identical to running ScanMatcherCorrelative followed by
ScanMatcherLinearSolver (same underlying ops), minus host latency.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..core import pose as P
from ..matching.correlative import CorrelativeConfig, _correlative_core
from ..matching.linear_solver import LinearSolverConfig
from ..matching.types import ScanMatchingQuery, ScanMatchingSummary
from ..ops import gauss_newton, pool


def _fused_body(
    ccfg: CorrelativeConfig,
    lcfg: LinearSolverConfig,
    prob,
    observed,
    coarse_p,
    coarse_o,
    ranges,
    angles,
    mask,
    sensor_pose,
    offset_xy,
    score_threshold,
    known_rate_threshold,
    *,
    dense: bool = False,
):
    (csm_pose, score, known, found, csm_ncost, _, n_proc, n_total, exact) = (
        _correlative_core(
            ccfg, prob, observed, coarse_p, coarse_o,
            ranges, angles, mask, sensor_pose, offset_xy,
            score_threshold, known_rate_threshold, dense=dense,
        )
    )
    n = jnp.maximum(jnp.sum(mask).astype(jnp.float32), 1.0)
    refined, cost, iters = gauss_newton.gn_refine(
        prob, observed, ranges, angles, mask, csm_pose,
        ccfg.resolution, offset_xy,
        max_iterations=lcfg.num_iterations_max,
        convergence_threshold=lcfg.convergence_threshold,
        initial_lambda=lcfg.initial_lambda,
    )
    cov = gauss_newton.covariance(
        prob, observed, ranges, angles, mask, refined,
        ccfg.resolution, offset_xy, lcfg.covariance_scale,
    )
    return (refined, cov, score, known, found, cost / n, iters, n_proc,
            n_total, csm_pose, csm_ncost, exact)


_fused_core = functools.partial(
    jax.jit, static_argnames=("ccfg", "lcfg", "dense")
)(_fused_body)


@functools.partial(
    jax.jit, static_argnames=("ccfg", "lcfg", "max_shift", "dense")
)
def _fused_core_deltas(
    ccfg: CorrelativeConfig,
    lcfg: LinearSolverConfig,
    deltas,  # tuple of S [H, W] f32 per-scan log-odds delta images
    shifts,  # [S, 2] i32
    valid,  # [S] bool
    ranges,
    angles,
    mask,
    sensor_pose,
    offset_xy,
    score_threshold,
    known_rate_threshold,
    *,
    max_shift: int,
    dense: bool = False,
):
    """The WHOLE frontend keyframe match as one launch: latest-map fold
    (from per-scan cached deltas, grid/builder.py incremental mode) ->
    u8 quantize -> coarse sliding-window-max pool -> coarse+fine CSM
    sweeps -> GN refinement -> covariance.

    One device launch + one small result fetch per keyframe is the whole
    host<->device protocol — the device analogue of the reference FPGA
    driver's one-DMA-in/one-DMA-out per match
    (``scan_matcher_correlative_fpga.cpp:277-320``), and the right shape
    for remote-attached accelerators where every round trip costs a full
    network RTT.  Results are bit-identical to the staged path (same ops,
    same order)."""
    from ..ops import rasterize

    lo, obs = rasterize.fold_shifted_deltas_impl(
        jnp.stack(deltas), shifts, valid, max_shift=max_shift
    )
    # u8 quantize inline (ops/quant.py contract; that entry point is
    # jitted for host callers, a nested jit here would block fusion)
    prob = jnp.round(
        jnp.where(obs, jax.nn.sigmoid(lo), 0.0) * 255.0
    ).astype(jnp.uint8)
    # coarse maps None -> the core pools only the crop window it sweeps
    # (pool-on-crop, matching/correlative.py), ~6x less pooled area than
    # the full raster per keyframe.
    return _fused_body(
        ccfg, lcfg, prob, obs, None, None,
        ranges, angles, mask, sensor_pose, offset_xy,
        score_threshold, known_rate_threshold, dense=dense,
    )


class FusedCorrelativeGNMatcher:
    """Drop-in two-stage matcher; ``fused = True`` tells the frontend to
    skip its separate final-matcher call."""

    fused = True

    def __init__(
        self,
        ccfg: CorrelativeConfig,
        lcfg: LinearSolverConfig,
        name: str = "ScanMatcherCorrelativeFused",
        final_name: str = None,
        final_time_fraction: float = 0.5,
    ):
        from ..matching.correlative import ScanMatcherCorrelative
        from ..matching.linear_solver import LinearSolverMetrics

        self.ccfg = ccfg
        self.lcfg = lcfg
        self.name = name
        # Host-side proxy reused for the shared window/step/diff series
        # bookkeeping (matching/correlative.py:_observe_metrics); the
        # registry is idempotent, so the series are shared by name.
        self._series = ScanMatcherCorrelative(ccfg, name)
        self.metrics = self._series.metrics
        # GN-refinement series under the final matcher's name.  The fused
        # dispatch performs both stages in ONE launch, so exact per-stage
        # wall attribution is impossible; the measured wall is split
        # between the two OptimizationTime series by
        # ``final_time_fraction`` (approximate per-series, but the SUM of
        # the two series equals the true wall — no stage is reported as
        # a fictitious 0).
        self.final_time_fraction = final_time_fraction
        self.final_metrics = (
            LinearSolverMetrics(final_name) if final_name else None
        )

    # The frontend may hand this matcher the latest map as raw fold
    # inputs (per-scan delta images + shifts) instead of a materialized
    # raster, collapsing the keyframe's whole device pipeline into one
    # launch (see optimize_pose_deltas).
    supports_deltas = True

    def coarse_of(self, grid_map):
        return self._series.coarse_of(grid_map)

    def optimize_pose_deltas(
        self,
        fold,  # dict from GridMapBuilder.latest_fold_inputs
        scan,  # ScanArrays
        initial_pose,  # (3,) map-local robot pose
        score_threshold: float = 0.0,
        known_rate_threshold: float = 0.0,
    ) -> ScanMatchingSummary:
        import time as _time

        t1 = _time.perf_counter()
        sensor_pose = P.compound(initial_pose, scan.rel_sensor_pose)
        args = (
            self.ccfg, self.lcfg,
            fold["deltas"], fold["shifts"], fold["valid"],
            scan.ranges, scan.angles, scan.mask,
            jnp.asarray(sensor_pose, jnp.float32),
            jnp.asarray(fold["offset_xy"], jnp.float32),
            jnp.float32(score_threshold),
            jnp.float32(known_rate_threshold),
        )
        kw = dict(max_shift=fold["max_shift"])
        out = jax.device_get(_fused_core_deltas(*args, **kw))
        if not bool(out[-1]):
            from ..metrics.registry import MetricManager

            MetricManager.instance().counter(
                f"{self.name}.DenseFallbacks"
            ).increment()
            out = jax.device_get(_fused_core_deltas(*args, dense=True, **kw))
        self.metrics.InputSetupTime.observe(0)
        return self._finish(out, initial_pose, scan, t1)

    def optimize_pose(
        self,
        query: ScanMatchingQuery,
        score_threshold: float = 0.0,
        known_rate_threshold: float = 0.0,
    ) -> ScanMatchingSummary:
        import time as _time

        t0 = _time.perf_counter()
        gm, scan = query.grid_map, query.scan
        sensor_pose = P.compound(query.initial_pose, scan.rel_sensor_pose)
        coarse_p, coarse_o = self.coarse_of(gm)
        self.metrics.InputSetupTime.observe(
            int((_time.perf_counter() - t0) * 1e6)
        )
        t1 = _time.perf_counter()
        args = (
            self.ccfg, self.lcfg,
            gm.prob, gm.observed, coarse_p, coarse_o,
            scan.ranges, scan.angles, scan.mask,
            jnp.asarray(sensor_pose, jnp.float32),
            jnp.asarray(gm.offset_xy, jnp.float32),
            jnp.float32(score_threshold),
            jnp.float32(known_rate_threshold),
        )
        # ONE device->host fetch per keyframe: the whole result tuple comes
        # back in a single transfer (separate bool()/float() reads would
        # each pay a full round trip to a remote-attached device).
        out = jax.device_get(_fused_core(*args))
        if not bool(out[-1]):
            # A prune could not certify the CSM argmax — rare; redo with
            # the dense fine sweep (see matching/correlative.py).
            from ..metrics.registry import MetricManager

            MetricManager.instance().counter(
                f"{self.name}.DenseFallbacks"
            ).increment()
            out = jax.device_get(_fused_core(*args, dense=True))
        return self._finish(out, query.initial_pose, scan, t1)

    def _finish(self, out, initial_pose, scan, t1) -> ScanMatchingSummary:
        import time as _time

        (refined, cov, score, known, found, ncost, iters, n_proc, n_total,
         csm_pose, csm_ncost, _) = out
        est = P.move_backward(np.asarray(refined, np.float64), scan.rel_sensor_pose)
        wall_us = int((_time.perf_counter() - t1) * 1e6)
        frac = self.final_time_fraction if self.final_metrics else 0.0
        self.metrics.OptimizationTime.observe(int(wall_us * (1.0 - frac)))
        csm_est = P.move_backward(
            np.asarray(csm_pose, np.float64), scan.rel_sensor_pose
        )

        class _Q:  # _observe_metrics reads only .initial_pose
            pass

        q = _Q()
        q.initial_pose = np.asarray(initial_pose)
        self._series._observe_metrics(
            q, scan, csm_est, score, csm_ncost, int(n_proc), int(n_total)
        )
        if self.final_metrics is not None:
            fm = self.final_metrics
            # Approximate split of the single fused dispatch's wall (see
            # __init__); the two OptimizationTime series sum to the true
            # wall instead of reporting the final stage as 0.
            fm.OptimizationTime.observe(int(wall_us * frac))
            diff = P.inverse_compound(csm_est, est)
            fm.DiffTranslation.observe(float(P.distance(diff)))
            fm.DiffRotation.observe(abs(float(diff[2])))
            fm.NumOfIterations.observe(int(iters))
            fm.InitialCost.observe(float(csm_ncost))
            fm.FinalCost.observe(float(ncost))
            fm.NumOfScans.observe(int(scan.num_valid))
        return ScanMatchingSummary(
            pose_found=bool(found),
            normalized_cost=float(ncost),
            initial_pose=np.asarray(initial_pose),
            estimated_pose=est,
            covariance=np.asarray(cov, np.float64),
            normalized_score=float(score),
            known_rate=float(known),
        )
