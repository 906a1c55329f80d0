import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from my_lidar_graph_slam_v2_tpu.grid import values as gv
from my_lidar_graph_slam_v2_tpu.grid.geometry import GridGeometry
from my_lidar_graph_slam_v2_tpu.ops import rasterize
from my_lidar_graph_slam_v2_tpu.utils import oracle

P_HIT, P_MISS = 0.62, 0.46
ODDS_HIT = gv.prob_to_odds(P_HIT)
ODDS_MISS = gv.prob_to_odds(P_MISS)
LO_HIT = float(np.log(ODDS_HIT))
LO_MISS = float(np.log(ODDS_MISS))


def make_scan(rng, n_beams=64, max_range=4.0):
    angles = np.linspace(-np.pi / 2, np.pi / 2, n_beams)
    ranges = rng.uniform(0.5, max_range, size=n_beams)
    return ranges, angles


def test_integrate_matches_oracle():
    rng = np.random.default_rng(42)
    geom = GridGeometry(resolution=0.05, rows=256, cols=256, offset_x=-6.4, offset_y=-6.4)
    ranges, angles = make_scan(rng)
    sensor = np.array([0.3, -0.2])
    hx = sensor[0] + ranges * np.cos(angles)
    hy = sensor[1] + ranges * np.sin(angles)
    hits = np.stack([hx, hy], axis=-1)

    # Oracle: sequential u16 updates with subpixel Bresenham
    vals = np.zeros((256, 256), dtype=np.uint16)
    oracle.integrate_scan_oracle(vals, geom, sensor, hits, ODDS_HIT, ODDS_MISS)
    prob_ref = gv.value_to_prob(vals)

    # Device: sampled-ray scatter version
    lo = jnp.zeros((256, 256), jnp.float32)
    obs = jnp.zeros((256, 256), bool)
    lo, obs = rasterize.integrate_scans(
        lo,
        obs,
        jnp.asarray(sensor, jnp.float32)[None],
        jnp.asarray(hits, jnp.float32)[None],
        jnp.ones((1, len(ranges)), bool),
        0.05,
        jnp.array([geom.offset_x, geom.offset_y], jnp.float32),
        LO_HIT,
        LO_MISS,
        num_samples=1024,
    )
    prob_dev = np.where(np.asarray(obs), 1 / (1 + np.exp(-np.asarray(lo))), 0.0)

    ref_known = prob_ref != 0.0
    dev_known = prob_dev != 0.0
    # Known-cell sets should agree on nearly all cells (corner grazes only)
    mismatch = np.mean(ref_known != dev_known)
    assert mismatch < 0.01, f"known-mask mismatch rate {mismatch}"

    both = ref_known & dev_known
    err = np.abs(prob_ref[both] - prob_dev[both])
    # Values agree tightly where the traversal agrees (small quantization +
    # occasional double/missing miss updates at cell corners)
    assert np.quantile(err, 0.99) < 0.05, np.quantile(err, [0.5, 0.9, 0.99])
    assert err.mean() < 0.005


def test_hit_cells_probability():
    # Coordinates chosen off cell boundaries: device indices are computed in
    # f32 and a position exactly on a boundary may floor to the neighbor.
    geom = GridGeometry(resolution=0.05, rows=128, cols=128, offset_x=-3.2, offset_y=-3.2)
    sensor = np.array([0.012, 0.017])
    hits = np.array([[1.013, 1.021]])
    lo = jnp.zeros((128, 128), jnp.float32)
    obs = jnp.zeros((128, 128), bool)
    lo, obs = rasterize.integrate_scans(
        lo, obs,
        jnp.asarray(sensor, jnp.float32)[None],
        jnp.asarray(hits, jnp.float32)[None, :, :],
        jnp.ones((1, 1), bool),
        0.05,
        jnp.array([geom.offset_x, geom.offset_y], jnp.float32),
        LO_HIT, LO_MISS,
    )
    r, c = geom.position_to_index(1.013, 1.021)
    lo_np = np.asarray(lo)
    assert np.asarray(obs)[r, c]
    assert lo_np[r, c] == pytest.approx(LO_HIT, abs=1e-5)
    # sensor cell should be free
    r0, c0 = geom.position_to_index(0.012, 0.017)
    assert lo_np[r0, c0] == pytest.approx(LO_MISS, abs=1e-5)


def test_sequential_scans_accumulate():
    geom = GridGeometry(resolution=0.05, rows=64, cols=64, offset_x=-1.6, offset_y=-1.6)
    sensor = np.array([0.012, 0.008])
    hits = np.array([[1.013, 0.008]])
    lo = jnp.zeros((64, 64), jnp.float32)
    obs = jnp.zeros((64, 64), bool)
    lo, obs = rasterize.integrate_scans(
        lo, obs,
        jnp.tile(jnp.asarray(sensor, jnp.float32), (3, 1)),
        jnp.tile(jnp.asarray(hits, jnp.float32)[None], (3, 1, 1)),
        jnp.ones((3, 1), bool),
        0.05,
        jnp.array([geom.offset_x, geom.offset_y], jnp.float32),
        LO_HIT, LO_MISS,
    )
    r, c = geom.position_to_index(1.013, 0.008)
    assert np.asarray(lo)[r, c] == pytest.approx(3 * LO_HIT, abs=1e-4)


def test_incremental_latest_map_parity():
    """fold_shifted_deltas over cached per-scan deltas must reproduce
    integrate_scans up to floor-boundary cell jitter (anchors differ by
    exact cell multiples; float rounding may flip isolated boundary
    cells)."""
    import jax.numpy as jnp

    from my_lidar_graph_slam_v2_tpu.grid import values as gv
    from my_lidar_graph_slam_v2_tpu.ops import rasterize

    rng = np.random.default_rng(7)
    H = W = 256
    res = 0.05
    off = jnp.asarray(np.float32([-res * (W // 2), -res * (H // 2)]))
    lh = float(np.log(gv.prob_to_odds(0.62)))
    lm = float(np.log(gv.prob_to_odds(0.46)))

    S, B = 5, 128
    sensors = np.cumsum(rng.normal(0.15, 0.05, (S, 2)), 0).astype(np.float32)
    angles = np.tile(np.linspace(-np.pi, np.pi, B), (S, 1))
    ranges = rng.uniform(0.5, 4.0, (S, B))
    hx = sensors[:, :1] + ranges * np.cos(angles)
    hy = sensors[:, 1:] + ranges * np.sin(angles)
    hits = np.stack([hx, hy], -1).astype(np.float32)
    msk = np.ones((S, B), bool)

    # Reference: direct sequential integration at the shared anchor
    lo0 = jnp.zeros((H, W), jnp.float32)
    obs0 = jnp.zeros((H, W), bool)
    ref_lo, ref_obs = rasterize.integrate_scans(
        lo0, obs0, jnp.asarray(sensors), jnp.asarray(hits), jnp.asarray(msk),
        res, off, lh, lm, num_samples=256,
    )

    # Incremental: per-scan deltas at each scan's own quantized anchor
    deltas, shifts = [], []
    for k in range(S):
        cell_k = np.floor(sensors[k] / res).astype(np.int64)
        anchor_k = cell_k * res
        deltas.append(rasterize.scan_delta(
            (H, W),
            jnp.asarray(sensors[k] - anchor_k),
            jnp.asarray(hits[k] - anchor_k[None, :]),
            jnp.asarray(msk[k]),
            res, off, lh, lm, num_samples=256,
        ))
        shifts.append((int(cell_k[1]), int(cell_k[0])))  # anchor cell (0,0)
    lo, obs = rasterize.fold_shifted_deltas(
        jnp.stack(deltas), jnp.asarray(np.array(shifts, np.int32)),
        jnp.ones(S, bool), max_shift=64,
    )

    ref_p = np.asarray(rasterize.prob_map(ref_lo, ref_obs))
    got_p = np.asarray(rasterize.prob_map(lo, obs))
    mismatch = np.mean(~np.isclose(ref_p, got_p, atol=1e-5))
    assert mismatch < 0.005, mismatch
    # observed masks nearly identical
    assert np.mean(np.asarray(ref_obs) != np.asarray(obs)) < 0.005


def test_out_of_extent_hits_counted():
    """Hits beyond the fixed raster extent are dropped by the kernel but
    must be counted (GridMapBuilder.OutOfExtentHits), not silent."""
    import numpy as np

    from my_lidar_graph_slam_v2_tpu.grid.builder import (
        GridMapBuilder,
        GridMapBuilderConfig,
    )
    from my_lidar_graph_slam_v2_tpu.graph.pose_graph import PoseGraph
    from my_lidar_graph_slam_v2_tpu.sensor.data import ScanData

    cfg = GridMapBuilderConfig(
        local_map_rows=128, local_map_cols=128, latest_map_rows=128,
        latest_map_cols=128, beam_capacity=64, samples_per_beam=32,
        usable_range_max=50.0,
    )
    builder = GridMapBuilder(cfg)
    before = builder._m_oob_hits.value
    n = 32
    # 40 m beams vs a 128-cell x 5 cm = 6.4 m raster: all hits land outside
    scan = ScanData(
        "lidar", 0.0, np.zeros(3), np.zeros(3), np.zeros(3),
        0.0, 50.0, -np.pi / 2, np.pi / 2,
        np.linspace(-np.pi / 2, np.pi / 2, n), np.full(n, 40.0),
    )
    builder.append_scan(PoseGraph(), np.zeros(3), np.eye(3) * 1e-6, scan)
    # Counted on device, fetched lazily (one transfer per run)
    builder.flush_oob()
    assert builder._m_oob_hits.value - before >= n
