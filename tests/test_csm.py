import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from my_lidar_graph_slam_v2_tpu.grid.geometry import GridGeometry
from my_lidar_graph_slam_v2_tpu.ops import csm, pool
from my_lidar_graph_slam_v2_tpu.utils import oracle


def random_map(rng, rows=160, cols=160, frac=0.2):
    prob = np.zeros((rows, cols), np.float64)
    n = int(rows * cols * frac)
    rr = rng.integers(0, rows, n)
    cc = rng.integers(0, cols, n)
    prob[rr, cc] = rng.uniform(0.001, 0.999, n)
    observed = prob != 0.0
    return prob, observed


def setup_case(rng, n_beams=48):
    geom = GridGeometry(resolution=0.05, rows=160, cols=160, offset_x=-4.0, offset_y=-4.0)
    prob, observed = random_map(rng)
    ranges = rng.uniform(0.5, 3.0, n_beams)
    angles = np.linspace(-np.pi * 0.75, np.pi * 0.75, n_beams) + rng.normal(0, 0.002, n_beams)
    sensor_pose = np.array([0.1, -0.05, 0.3])
    return geom, prob, observed, ranges, angles, sensor_pose


def run_sweep(geom, prob, observed, ranges, angles, sensor_pose,
              n_theta=31, nx=9, ny=9, stride=1, x0=-4, y0=-4,
              step_theta=0.01, theta0=-15):
    scores, known = csm.csm_sweep(
        jnp.asarray(prob, jnp.float32),
        jnp.asarray(observed),
        jnp.asarray(ranges, jnp.float32),
        jnp.asarray(angles, jnp.float32),
        jnp.ones(len(ranges), bool),
        jnp.asarray(sensor_pose, jnp.float32),
        jnp.int32(theta0),
        jnp.float32(step_theta),
        jnp.ones(n_theta, bool),
        jnp.int32(x0),
        jnp.int32(y0),
        geom.resolution,
        jnp.array([geom.offset_x, geom.offset_y], jnp.float32),
        n_theta=n_theta,
        nx=nx,
        ny=ny,
        stride=stride,
        crop_rows=192,
        crop_cols=192,
    )
    return np.asarray(scores), np.asarray(known)


def oracle_scores(geom, prob, ranges, angles, sensor_pose,
                  n_theta, nx, ny, stride, x0, y0, step_theta, theta0):
    n = len(ranges)
    S = np.zeros((n_theta, ny, nx))
    K = np.zeros((n_theta, ny, nx))
    for t in range(n_theta):
        th = sensor_pose[2] + (theta0 + t) * step_theta
        hx = sensor_pose[0] + ranges * np.cos(th + angles)
        hy = sensor_pose[1] + ranges * np.sin(th + angles)
        rows, cols = geom.position_to_index(hx, hy)
        for j in range(ny):
            for i in range(nx):
                s, kr = oracle.score_pixel_accurate_oracle(
                    prob, rows + y0 + j * stride, cols + x0 + i * stride, n
                )
                S[t, j, i] = s * n
                K[t, j, i] = kr * n
    return S, K


def test_sweep_matches_oracle_stride1():
    rng = np.random.default_rng(7)
    geom, prob, observed, ranges, angles, pose = setup_case(rng)
    scores, known = run_sweep(geom, prob, observed, ranges, angles, pose)
    S, K = oracle_scores(geom, prob, ranges, angles, pose,
                         31, 9, 9, 1, -4, -4, 0.01, -15)
    # f32 hit-point rounding can flip a cell on exact boundaries; allow a
    # tiny fraction of mismatched candidates
    close = np.isclose(scores, S, atol=2e-2)
    assert close.mean() > 0.97, close.mean()
    kclose = np.isclose(known, K, atol=1.01)
    assert kclose.mean() > 0.97


def test_sweep_strided_matches_oracle():
    rng = np.random.default_rng(8)
    geom, prob, observed, ranges, angles, pose = setup_case(rng)
    coarse = np.asarray(
        pool.sliding_window_max2d(jnp.asarray(prob, jnp.float32), 5)
    )
    coarse_obs = coarse > 0
    scores, known = run_sweep(
        geom, coarse, coarse_obs, ranges, angles, pose,
        n_theta=11, nx=4, ny=4, stride=5, x0=-8, y0=-8, theta0=-5,
    )
    S, K = oracle_scores(geom, coarse, ranges, angles, pose,
                         11, 4, 4, 5, -8, -8, 0.01, -5)
    close = np.isclose(scores, S, atol=2e-2)
    assert close.mean() > 0.97, close.mean()


def test_pool_matches_oracle():
    rng = np.random.default_rng(9)
    vals = rng.integers(0, 65536, size=(37, 53)).astype(np.uint16)
    got = np.asarray(pool.sliding_window_max2d(jnp.asarray(vals.astype(np.int32)), 8))
    want = oracle.precompute_map_oracle(vals, 8).astype(np.int32)
    np.testing.assert_array_equal(got, want)


def test_theta_params():
    ranges = jnp.full(10, 20.0)
    mask = jnp.ones(10, bool)
    step, t0, tmask = csm.theta_search_params(ranges, mask, 0.05, 0.5, 256)
    step = float(step)
    assert step == pytest.approx(
        np.arccos(1 - 0.5 * (0.05 / 20.0) ** 2), rel=1e-4
    )
    win = int(np.ceil(0.25 / step))
    assert int(t0) == -min(win, 128)
    assert int(tmask.sum()) == min(2 * win + 1, 256 - (128 - win) if win < 128 else 256)


def run_sweep_gather(geom, prob, observed, ranges, angles, sensor_pose,
                     n_theta=31, nx=9, ny=9, stride=1, x0=-4, y0=-4,
                     step_theta=0.01, theta0=-15, dtype=jnp.float32):
    if dtype == jnp.uint8:
        prob_a = jnp.asarray(np.round(prob * 255.0), jnp.uint8)
    else:
        prob_a = jnp.asarray(prob, dtype)
    row, col, ok = csm.beam_cells_abs(
        jnp.asarray(ranges, jnp.float32),
        jnp.asarray(angles, jnp.float32),
        jnp.ones(len(ranges), bool),
        jnp.asarray(sensor_pose, jnp.float32),
        jnp.int32(theta0),
        jnp.float32(step_theta),
        jnp.ones(n_theta, bool),
        geom.resolution,
        jnp.array([geom.offset_x, geom.offset_y], jnp.float32),
        n_theta=n_theta,
    )
    scores, known = csm.sweep_windows(
        prob_a, jnp.asarray(observed), row, col, ok,
        jnp.int32(y0), jnp.int32(x0), ny=ny, nx=nx, stride=stride,
    )
    return np.asarray(scores), np.asarray(known)


def test_sweep_windows_gather_matches_oracle():
    """The per-beam window-gather sweep (ops/csm.sweep_windows, the
    fast path) reproduces the reference scoring semantics
    (score_function_pixel_accurate.cpp:16-58): per-beam map lookups with
    out-of-map reading unknown — including beams whose windows hang off
    the map edge (no crop clipping at all)."""
    rng = np.random.default_rng(7)
    geom, prob, observed, ranges, angles, pose = setup_case(rng)
    scores, known = run_sweep_gather(
        geom, prob, observed, ranges, angles, pose
    )
    S, K = oracle_scores(geom, prob, ranges, angles, pose,
                         31, 9, 9, 1, -4, -4, 0.01, -15)
    close = np.isclose(scores, S, atol=2e-2)
    assert close.mean() > 0.97, close.mean()
    kclose = np.isclose(known, K, atol=1.01)
    assert kclose.mean() > 0.97

    # strided (coarse-style) windows
    scores_s, _ = run_sweep_gather(
        geom, prob, observed, ranges, angles, pose,
        n_theta=11, nx=4, ny=4, stride=5, x0=-8, y0=-8, theta0=-5,
    )
    S_s, _ = oracle_scores(geom, prob, ranges, angles, pose,
                           11, 4, 4, 5, -8, -8, 0.01, -5)
    close = np.isclose(scores_s, S_s, atol=2e-2)
    assert close.mean() > 0.97, close.mean()


def test_sweep_windows_gather_u8_exact_vs_f32():
    """u8 maps take the exact integer bf16 contraction: scores equal the
    f32 evaluation of the same quantized map to f32 roundoff."""
    rng = np.random.default_rng(13)
    geom, prob, observed, ranges, angles, pose = setup_case(rng)
    prob_q = np.round(prob * 255.0) / 255.0
    s_u8, k_u8 = run_sweep_gather(
        geom, prob_q, observed, ranges, angles, pose, dtype=jnp.uint8
    )
    s_f32, k_f32 = run_sweep_gather(
        geom, prob_q, observed, ranges, angles, pose, dtype=jnp.float32
    )
    np.testing.assert_allclose(s_u8, s_f32, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(k_u8, k_f32, rtol=1e-6, atol=1e-5)


def test_sweep_windows_edge_beams_read_unknown():
    """Beams pointing far outside the raster contribute exactly zero to
    score AND known count (reference: out-of-map lookups are unknown)."""
    geom = GridGeometry(resolution=0.05, rows=64, cols=64,
                        offset_x=-1.6, offset_y=-1.6)
    prob = np.full((64, 64), 0.9)
    observed = np.ones((64, 64), bool)
    # One beam lands mid-map, one lands 10 m off the east edge
    ranges = np.array([0.5, 10.0])
    angles = np.array([0.0, 0.0])
    pose = np.zeros(3)
    scores, known = run_sweep_gather(
        geom, prob, observed, ranges, angles, pose,
        n_theta=3, nx=3, ny=3, stride=1, x0=-1, y0=-1,
        step_theta=0.01, theta0=-1,
    )
    # Only the in-map beam scores: 0.9 per candidate, known 1
    np.testing.assert_allclose(scores, 0.9, atol=1e-5)
    np.testing.assert_allclose(known, 1.0, atol=1e-5)
