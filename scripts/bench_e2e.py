#!/usr/bin/env python
"""End-to-end SLAM pipeline throughput on the target device.

The reference's whole evaluation story is per-run wall-clock with a
per-stage metric dump for every run (``slam_launcher.cpp:171-181``;
``experiments_old.md:199-225`` reports e.g. Intel = 1,404 keyscans with
per-stage ms tables).  This harness reproduces that methodology at the
same scale on synthetic input (the Radish logs don't ship with either
repo): a multi-lap office loop course sized to a target keyframe count,
the FULL production pipeline (keyframe gating, filter chain, incremental
latest-map rebuild, fused CSM+GN match, local/latest map integration,
loop search -> detect -> pose-graph LM -> write-back), one JSON artifact:

    keyframes/s, scans/s, ATE, per-stage mean/p90 ms, loop-closure
    counts, OutOfExtentHits, RSS, jit cache sizes.

Usage::

    python scripts/bench_e2e.py --keyframes 1400 --out results_e2e.json
    python scripts/bench_e2e.py --platform cpu --keyframes 120   # smoke
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def build_sequence(target_keyframes: int, seed: int = 0, step: float = 0.08,
                   size: float = 18.0, keyframe_travel: float = 0.5):
    """Synthetic sequence long enough to yield ~target_keyframes at the
    frontend's travel gate (laps around the office course, Intel-scale:
    the reference's Intel run is 1,404 keyscans, experiments_old.md:186)."""
    from my_lidar_graph_slam_v2_tpu.datasets import synthetic

    world = synthetic.World.office(seed=seed, size=size)
    one = synthetic.loop_trajectory(size=size, laps=1.0, step=step)
    per_lap = float(
        np.sum(np.hypot(np.diff(one[:, 0]), np.diff(one[:, 1])))
    )
    laps = target_keyframes * keyframe_travel * 1.06 / per_lap
    traj = synthetic.loop_trajectory(size=size, laps=laps, step=step)
    return synthetic.generate(
        world, traj, n_beams=181, max_range=30.0, range_noise=0.01,
        odom_noise=(0.01, 0.004), seed=seed,
    )


def _series_stats(values, scale=1e-3):
    """mean/p50/p90/max (ms if the series is in us) + sum (ms)."""
    v = np.asarray(values, np.float64)
    if v.size == 0:
        return None
    return dict(
        n=int(v.size),
        mean_ms=round(float(v.mean()) * scale, 3),
        p50_ms=round(float(np.percentile(v, 50)) * scale, 3),
        p90_ms=round(float(np.percentile(v, 90)) * scale, 3),
        max_ms=round(float(v.max()) * scale, 3),
        total_ms=round(float(v.sum()) * scale, 1),
    )


def run(target_keyframes: int = 1400, seed: int = 0, threaded: bool = True,
        max_scans: int | None = None, progress: bool = True,
        builder_overrides: dict | None = None) -> dict:
    import jax

    from my_lidar_graph_slam_v2_tpu.datasets.synthetic import ate_rmse
    from my_lidar_graph_slam_v2_tpu.graph.pose_graph import CONSTRAINT_LOOP
    from my_lidar_graph_slam_v2_tpu.metrics.registry import MetricManager
    from my_lidar_graph_slam_v2_tpu.pipeline.factory import (
        create_default_backend,
        create_default_slam,
    )
    from my_lidar_graph_slam_v2_tpu.utils.memory import (
        peak_memory_usage,
        physical_memory_usage,
    )

    mm = MetricManager.instance()
    mm.reset_all()

    t_gen = time.time()
    seq = build_sequence(target_keyframes, seed=seed)
    scans = seq.scans if max_scans is None else seq.scans[:max_scans]
    gen_s = time.time() - t_gen

    backend = create_default_backend(inline=not threaded)
    slam = create_default_slam(backend=backend,
                               builder_overrides=builder_overrides)
    slam.start_backend()

    # Warmup is NOT excluded: like the reference's wall-clock runs, jit
    # compile time is part of the first frames (one-off; reported so the
    # steady-state rate can be judged separately).
    t0 = time.time()
    first_kf_done = None
    for i, scan in enumerate(scans):
        if slam.process_scan(scan, scan.odom_pose):
            if first_kf_done is None and slam.process_count >= 3:
                first_kf_done = time.time() - t0  # compile warmup window
        if progress and (i + 1) % 1000 == 0:
            print(
                f"  scan {i+1}/{len(scans)}  keyframes={slam.process_count} "
                f"({(i+1)/(time.time()-t0):.1f} scans/s)",
                file=sys.stderr,
            )
    slam.stop_backend()
    wall = time.time() - t0

    # ---- results -------------------------------------------------------
    traj = slam.get_trajectory()
    # Scan nodes <-> ground truth alignment via the synthetic timestamps
    times, _ = slam.get_poses_with_times()
    dt = 0.1
    gt_idx = np.clip(np.round(times / dt).astype(int), 0,
                     len(seq.ground_truth) - 1)
    ate = ate_rmse(traj, seq.ground_truth[gt_idx])
    odom = np.stack([s.odom_pose for s in scans])
    ate_odom = ate_rmse(odom, seq.ground_truth[: len(scans)])

    n_loop_edges = sum(
        1 for e in slam.pose_graph.edges if e.constraint_type == CONSTRAINT_LOOP
    )

    stages = {}
    for name, metric in sorted(mm.metrics.items()):
        if name.endswith("Time") and hasattr(metric, "values"):
            st = _series_stats(metric.values)
            if st is not None:
                stages[name] = st

    oob = mm.counter("GridMapBuilder.OutOfExtentHits").value
    fallbacks = {
        name: int(c.value)
        for name, c in mm.metrics.items()
        if name.endswith("DenseFallbacks") and getattr(c, "value", 0)
    }
    keyframes = slam.process_count

    # jit cache sizes: recompile count proxy
    caches = {}
    from my_lidar_graph_slam_v2_tpu.graph import optimizer as _opt
    from my_lidar_graph_slam_v2_tpu.matching import correlative as _corr
    from my_lidar_graph_slam_v2_tpu.models import fused_matcher as _fm

    for nm, fn in (
        ("fused_core", _fm._fused_core),
        ("fused_core_deltas", _fm._fused_core_deltas),
        ("correlative_core", _corr.correlative_core_jit),
        ("optimize_core", getattr(_opt, "_optimize_core", None)),
    ):
        if fn is not None and hasattr(fn, "_cache_size"):
            caches[nm] = fn._cache_size()

    dev = jax.devices()[0]
    result = {
        "metric": "e2e_pipeline_keyframes_per_sec",
        "value": round(keyframes / wall, 2),
        "unit": "keyframes/s",
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "threaded_backend": threaded,
        "keyframes": keyframes,
        "scans": len(scans),
        "scans_per_sec": round(len(scans) / wall, 1),
        "wall_s": round(wall, 1),
        "warmup_first3_kf_s": round(first_kf_done or 0.0, 1),
        "gen_s": round(gen_s, 1),
        "ate_rmse_m": round(ate, 4),
        "ate_odometry_m": round(ate_odom, 4),
        "loop_edges": n_loop_edges,
        "local_maps": len(slam.builder.local_maps),
        "out_of_extent_hits": int(oob),
        "dense_fallbacks": fallbacks,
        "opt_wait_count": slam.opt_wait_count,
        "lag_wait_count": getattr(slam, "lag_wait_count", 0),
        "max_backend_lag": getattr(slam, "max_backend_lag", 0),
        "backend_thread_steps": slam.backend_thread_steps,
        "rss_mb": round(physical_memory_usage() / 2**20, 1),
        "peak_rss_mb": round(peak_memory_usage() / 2**20, 1),
        "jit_cache_sizes": caches,
        "stages": stages,
    }
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--keyframes", type=int, default=1400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-scans", type=int, default=None)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--inline", action="store_true",
                    help="inline (synchronous) backend instead of threaded")
    ap.add_argument("--no-compact", action="store_true",
                    help="disable finished-map compaction (A/B)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    from my_lidar_graph_slam_v2_tpu.utils import jaxcache

    jaxcache.enable()

    result = run(
        target_keyframes=args.keyframes,
        seed=args.seed,
        threaded=not args.inline,
        max_scans=args.max_scans,
        builder_overrides=(
            dict(compact_finished_maps=False) if args.no_compact else None
        ),
    )
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
