"""Reference-scale soak test (VERDICT r03 missing #2).

The reference's largest published run is Intel: 1,404 keyscans / 271,517
points over ~50 local maps with many loop closures
(``/root/reference/experiments_old.md:186-191``).  This soak drives the
FULL production pipeline on a synthetic multi-lap course sized to a
comparable structural scale — hundreds of keyframes, >64 local maps (so
the device map cache evicts), repeated loop closures, long-horizon
suffix propagation — and asserts the invariants that only show up at
scale:

* ATE stays bounded (and far below raw odometry drift);
* every hit lands inside the travel-bounded raster extent
  (``GridMapBuilder.OutOfExtentHits == 0``);
* the jit caches stay bounded (no per-keyframe recompiles);
* the map cache actually evicts (capacity pressure exercised) while
  loop detection keeps succeeding;
* host RSS growth over the run stays within budget.

Slow tier (``-m slow``): ~10 min on CPU.  The full 1,400-keyframe run
on the accelerator is ``scripts/bench_e2e.py``; this test is the
CI-checkable scaled invariant guard.
"""
import numpy as np
import pytest

from my_lidar_graph_slam_v2_tpu.datasets import synthetic
from my_lidar_graph_slam_v2_tpu.metrics.registry import MetricManager
from my_lidar_graph_slam_v2_tpu.pipeline.factory import (
    create_default_backend,
    create_default_slam,
)
from my_lidar_graph_slam_v2_tpu.utils.memory import physical_memory_usage


@pytest.mark.slow
def test_reference_scale_soak():
    mm = MetricManager.instance()
    mm.reset_all()

    # Scaled course: small rasters/windows keep CPU time ~10 min while the
    # STRUCTURAL scale (keyframes, local maps, loop closures) stays high.
    world = synthetic.World.office(seed=7, size=12.0)
    traj = synthetic.loop_trajectory(size=12.0, laps=8.0, step=0.3)
    seq = synthetic.generate(
        world, traj, n_beams=91, max_range=12.0, range_noise=0.01,
        odom_noise=(0.02, 0.008), seed=7,
    )

    backend = create_default_backend(
        n_theta_max=48, crop=256, beam_capacity=128, usable_range_max=12.0,
        inline=True, sharded=False,
    )
    # Small map-cache capacity so eviction under pressure is exercised
    backend.loop_detector.map_cache.max_entries = 16
    slam = create_default_slam(
        map_rows=512, map_cols=512, beam_capacity=128, samples_per_beam=256,
        usable_range_max=12.0, n_theta_max=48, crop=256, backend=backend,
        builder_overrides=dict(travel_dist_threshold=1.5),
    )
    slam.start_backend()

    rss0 = physical_memory_usage()
    gt = []
    for scan, g in zip(seq.scans, seq.ground_truth):
        if slam.process_scan(scan, scan.odom_pose):
            gt.append(g)
    slam.stop_backend()

    est = slam.get_trajectory()
    ate = synthetic.ate_rmse(est, np.asarray(gt))
    odom = np.stack([s.odom_pose for s in seq.scans])
    ate_odom = synthetic.ate_rmse(odom, seq.ground_truth[: len(odom)])

    n_maps = len(slam.builder.local_maps)
    n_loops = sum(1 for e in slam.pose_graph.edges if e.is_loop)
    assert slam.process_count >= 300, slam.process_count
    assert n_maps > 64, n_maps  # cache-eviction pressure reached
    assert n_loops >= 10, n_loops

    # Quality: bounded, and far below odometry drift
    assert ate < 0.30, (ate, ate_odom)
    assert ate < 0.5 * ate_odom, (ate, ate_odom)

    # Extent invariant: travel-bounded rasters caught every hit
    assert mm.counter("GridMapBuilder.OutOfExtentHits").value == 0

    # Map cache exercised beyond capacity -> evictions happened, yet
    # loop detection kept working
    cache = backend.loop_detector.map_cache
    stats = cache.stats()
    assert stats["evictions"] > 0, stats
    assert stats["hits"] > 0, stats
    assert len(cache._entries) <= 16

    # Bounded recompiles: jit caches must not scale with keyframes
    from my_lidar_graph_slam_v2_tpu.graph import optimizer as _opt
    from my_lidar_graph_slam_v2_tpu.models import fused_matcher as _fm

    assert _fm._fused_core_deltas._cache_size() <= 4
    assert _fm._fused_core._cache_size() <= 4
    assert _opt._optimize_core._cache_size() <= 24  # O(log E) buckets

    # Host memory: growth over the whole run bounded (catches per-frame
    # leaks of rasters/deltas/metric series blowups)
    rss_growth_mb = (physical_memory_usage() - rss0) / 2**20
    assert rss_growth_mb < 1500, rss_growth_mb
