"""Device-resident quantized map cache (grid/map_cache.py): the device
analogue of the reference FPGA's BRAM map cache keyed by LocalMapId
(``scan_matcher_correlative_fpga.cpp:254-270,589-646``)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from my_lidar_graph_slam_v2_tpu.grid.builder import LocalMap
from my_lidar_graph_slam_v2_tpu.grid.map_cache import DeviceMapCache
from my_lidar_graph_slam_v2_tpu.metrics.registry import MetricManager
from my_lidar_graph_slam_v2_tpu.ops import quant, rasterize

from tests.test_matchers import RES, build_map, synth_world_scan


def make_local_map(i=0, seed=3):
    rng = np.random.default_rng(seed)
    gm, _ = build_map([np.zeros(3)] * 4, rng=rng)
    # Rebuild the log-odds form (build_map returns the prob raster)
    lo = jnp.where(gm.observed, jnp.log(gm.prob / (1 - gm.prob)), 0.0)
    return LocalMap(
        local_map_id=i, logodds=lo, observed=gm.observed,
        offset_xy=gm.offset_xy, scan_node_id_min=0, scan_node_id_max=0,
        finished=True,
    ), gm


def test_hit_miss_and_version_invalidation():
    cache = DeviceMapCache(RES, metrics=MetricManager())
    lm, _ = make_local_map()
    r1 = cache.raster(lm)
    r2 = cache.raster(lm)
    assert r1.prob is r2.prob, "second lookup must be a cache hit"
    assert cache.stats["hits"] == 1 and cache.stats["misses"] == 1
    lm.version += 1  # builder bumps on every raster write
    r3 = cache.raster(lm)
    assert r3.prob is not r1.prob
    assert cache.stats["misses"] == 2


def test_quantization_accuracy_and_dtype():
    cache = DeviceMapCache(RES, metrics=MetricManager())
    lm, gm = make_local_map()
    r = cache.raster(lm)
    assert r.prob.dtype == jnp.uint8
    deq = np.asarray(quant.dequant_prob(r.prob))
    ref = np.asarray(rasterize.prob_map(lm.logodds, lm.observed))
    assert np.max(np.abs(deq - ref)) <= (0.5 / 255) + 1e-6
    # unknown cells stay exactly 0 (the ProbabilityOr convention)
    unknown = ~np.asarray(lm.observed)
    assert np.all(deq[unknown] == 0.0)


def test_lru_eviction_bounded():
    cache = DeviceMapCache(RES, max_entries=2, metrics=MetricManager())
    maps = [make_local_map(i)[0] for i in range(3)]
    for lm in maps:
        cache.raster(lm)
    assert cache.stats["entries"] == 2
    assert cache.stats["evictions"] == 1
    # map 0 was evicted -> re-materialized on next use
    cache.raster(maps[0])
    assert cache.stats["misses"] == 4
    # map 2 is still resident
    cache.raster(maps[2])
    assert cache.stats["hits"] == 1


def test_matcher_results_equal_on_quantized_map():
    """The correlative matcher must pick the same window winner on the u8
    raster as on the f32 raster (scores differ < quantization step)."""
    from my_lidar_graph_slam_v2_tpu.matching.correlative import (
        CorrelativeConfig, ScanMatcherCorrelative)
    from my_lidar_graph_slam_v2_tpu.matching.types import (
        MapRaster, ScanMatchingQuery)
    from tests.test_matchers import make_scan_arrays

    lm, gm = make_local_map()
    cache = DeviceMapCache(RES, metrics=MetricManager())
    rq = cache.raster(lm)

    true_pose = np.array([0.35, -0.2, 0.12])
    arrays = make_scan_arrays(true_pose, rng=np.random.default_rng(5))
    initial = true_pose + np.array([0.15, -0.1, 0.05])
    matcher = ScanMatcherCorrelative(CorrelativeConfig(
        range_x=0.6, range_y=0.6, range_theta=0.3,
        n_theta_max=32, crop_rows=256, crop_cols=256,
    ))
    s_f32 = matcher.optimize_pose(ScanMatchingQuery(gm, arrays, initial))
    s_u8 = matcher.optimize_pose(ScanMatchingQuery(rq, arrays, initial))
    assert s_u8.pose_found and s_f32.pose_found
    np.testing.assert_allclose(
        s_u8.estimated_pose, s_f32.estimated_pose, atol=1e-6,
        err_msg="quantization changed the argmax winner",
    )
    assert s_u8.normalized_score == pytest.approx(
        s_f32.normalized_score, abs=2e-3)


def test_serial_detector_uses_cache():
    """Repeated detect() against the same finished map: 1 miss, then hits;
    builder version bumps invalidate."""
    from my_lidar_graph_slam_v2_tpu.graph.pose_graph import (
        LocalMapNode, ScanNode)
    from my_lidar_graph_slam_v2_tpu.loop.detector import (
        LoopDetectorConfig, LoopDetectorCorrelative)
    from my_lidar_graph_slam_v2_tpu.matching.correlative import (
        CorrelativeConfig, ScanMatcherCorrelative)
    from my_lidar_graph_slam_v2_tpu.matching.linear_solver import (
        LinearSolverConfig, ScanMatcherLinearSolver)
    from my_lidar_graph_slam_v2_tpu.sensor.data import ScanData

    lm, gm = make_local_map()
    rng = np.random.default_rng(7)
    true_pose = np.array([0.3, -0.2, 0.15])
    ranges, angles = synth_world_scan(true_pose, rng=rng)
    scan = ScanData(
        "S", 0.0, true_pose, np.zeros(3), np.zeros(3),
        0.0, 12.0, float(angles[0]), float(angles[-1]), angles, ranges,
    )
    qnode = ScanNode(0, 0, np.zeros(3), true_pose + 0.05, scan)
    mnode = LocalMapNode(0, np.zeros(3), finished=True)
    queries = [dict(query_node=qnode, local_map=lm, local_map_node=mnode)]

    det = LoopDetectorCorrelative(
        LoopDetectorConfig(score_threshold=0.2, known_rate_threshold=0.1,
                           beam_capacity=192, usable_range_max=12.0),
        ScanMatcherCorrelative(CorrelativeConfig(
            range_x=1.0, range_y=1.0, range_theta=0.4,
            n_theta_max=32, crop_rows=256, crop_cols=256)),
        ScanMatcherLinearSolver(LinearSolverConfig()),
        map_cache=DeviceMapCache(RES, metrics=MetricManager()),
    )
    r1 = det.detect(queries)
    r2 = det.detect(queries)
    assert len(r1) == len(r2) == 1
    assert det.map_cache.stats == dict(
        entries=1, hits=1, misses=1, evictions=0)
