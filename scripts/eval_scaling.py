#!/usr/bin/env python
"""Multi-chip scaling harness (BASELINE: frames/s at 1 / 8 / 16 chips).

Measures the two scalable axes of the engine:

1. loop-candidate CSM fan-out: a fixed batch of candidates sharded over
   1..N devices (parallel/loop_sharded.py) — the generalization of the
   reference's 2-IP-core parallel loop detector;
2. distributed Schur-complement pose-graph LM (parallel/distributed.py).

On real multi-chip hardware this reports scans/s and scaling efficiency;
on a virtual CPU mesh (XLA_FLAGS=--xla_force_host_platform_device_count=N)
it validates the sharded paths and records the numbers for reference only
(virtual devices share host cores, so efficiency is not meaningful there).
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def bench_loop_fanout(n_devices, batch_per_device=2, iters=5, small=False):
    import jax
    import jax.numpy as jnp

    from my_lidar_graph_slam_v2_tpu.matching.correlative import CorrelativeConfig
    from my_lidar_graph_slam_v2_tpu.parallel.loop_sharded import (
        make_batched_loop_csm,
    )
    from my_lidar_graph_slam_v2_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(0)
    mesh = make_mesh(n_devices)
    if small:
        # Virtual-CPU-mesh tier: validates the sharded path + relative
        # scaling at a size the host can sweep in seconds
        cfg = CorrelativeConfig(
            range_x=1.0, range_y=1.0, range_theta=0.3,
            n_theta_max=32, crop_rows=256, crop_cols=256,
        )
        H = W = 512
        B = 256
    else:
        cfg = CorrelativeConfig(
            range_x=2.5, range_y=2.5, range_theta=0.5,
            n_theta_max=128, crop_rows=448, crop_cols=448,
        )
        H = W = 1024
        B = 512
    fn = make_batched_loop_csm(mesh, cfg)
    C = batch_per_device * n_devices
    prob = jnp.asarray(rng.uniform(0, 1, (C, H, W)).astype(np.float32))
    obs = prob > 0.5
    prob = jnp.where(obs, prob, 0.0)
    # production form: u8-quantized rasters (grid/map_cache.py)
    prob = jnp.round(prob * 255.0).astype(jnp.uint8)
    ranges = jnp.asarray(rng.uniform(0.5, 8.0, (C, B)).astype(np.float32))
    angles = jnp.asarray(
        np.tile(np.linspace(-np.pi, np.pi, B).astype(np.float32), (C, 1))
    )
    mask = jnp.ones((C, B), bool)
    poses = jnp.asarray(rng.normal(0, 0.1, (C, 3)).astype(np.float32))
    off_v = -H * 0.05 / 2.0
    offs = jnp.asarray(np.tile(np.float32([off_v, off_v]), (C, 1)))
    call = lambda: fn(prob, obs, ranges, angles, mask, poses, offs,
                      jnp.float32(0.0), jnp.float32(0.0))
    out = call()
    jax.device_get(np.asarray(jax.tree.leaves(out)[0]))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = call()
    jax.device_get(np.asarray(jax.tree.leaves(out)[0]))
    dt = time.perf_counter() - t0
    return C * iters / dt


def bench_schur_lm(n_devices, n_maps=64, n_scans=1024, iters=5, seed=0):
    """Distributed Schur-complement LM (parallel/distributed.py) on a
    synthetic chain-with-loops graph: wall time per optimize() call."""
    import jax

    from my_lidar_graph_slam_v2_tpu.graph.optimizer import OptimizerConfig
    from my_lidar_graph_slam_v2_tpu.parallel.distributed import (
        DistributedPoseGraphOptimizer,
    )
    from my_lidar_graph_slam_v2_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(seed)
    scans_per_map = n_scans // n_maps
    map_poses = np.cumsum(rng.normal(0, 0.5, (n_maps, 3)), 0)
    scan_poses = np.repeat(map_poses, scans_per_map, 0) + rng.normal(
        0, 0.05, (n_scans, 3))
    mi, si, il, rel, info = [], [], [], [], []
    for s in range(n_scans):
        m = s // scans_per_map
        mi.append(m); si.append(s); il.append(0)
        rel.append(scan_poses[s] - map_poses[m] + rng.normal(0, 0.01, 3))
        info.append(np.eye(3) * 100.0)
    # loop edges: every 8th scan also constrained to an earlier map
    for s in range(0, n_scans, 8):
        m = max(0, s // scans_per_map - 2)
        mi.append(m); si.append(s); il.append(1)
        rel.append(scan_poses[s] - map_poses[m] + rng.normal(0, 0.01, 3))
        info.append(np.eye(3) * 50.0)
    edges = (np.array(mi, np.int32), np.array(si, np.int32),
             np.array(il, np.int32), np.array(rel), np.stack(info))

    mesh = make_mesh(n_devices)
    opt = DistributedPoseGraphOptimizer(mesh)
    opt.optimize(map_poses, scan_poses, edges)  # compile
    t0 = time.perf_counter()
    for _ in range(iters):
        opt.optimize(map_poses, scan_poses, edges)
    return (time.perf_counter() - t0) / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None)
    ap.add_argument("--devices", type=int, nargs="+", default=None)
    args = ap.parse_args()
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    import jax

    n_avail = len(jax.devices())
    device_counts = args.devices or sorted(
        {d for d in (1, 2, 4, 8, 16) if d <= n_avail}
    )
    small = jax.devices()[0].platform == "cpu"
    results = []
    base = None
    for n in device_counts:
        rate = bench_loop_fanout(n, small=small)
        schur_s = bench_schur_lm(n)
        if base is None:
            base = rate
        eff = rate / (base * n)
        results.append(
            dict(devices=n, loop_candidates_per_s=round(rate, 2),
                 scaling_efficiency=round(eff, 3),
                 schur_lm_optimize_s=round(schur_s, 4),
                 workload="small" if small else "full")
        )
        print(results[-1], flush=True)
    out = dict(
        platform=jax.devices()[0].platform,
        device_kind=jax.devices()[0].device_kind,
        results=results,
        interpretation=(
            "loop_candidates_per_s: batch of loop-closure CSM queries "
            "(1024^2 map, 2.5 m window) sharded over the candidate axis; "
            "scaling_efficiency = rate / (rate_1dev * n). On the virtual "
            "CPU mesh the devices share host cores, so efficiency there "
            "validates the sharded code path, not hardware scaling; the "
            "per-GPU number is the meaningful absolute rate."
        ),
    )
    path = "results_scaling.json"
    if os.path.exists(path):
        with open(path) as f:
            prev = json.load(f)
        runs = prev.get("runs", [prev] if "results" in prev else [])
    else:
        runs = []
    runs = [r for r in runs if r.get("platform") != out["platform"]]
    runs.append(out)
    with open(path, "w") as f:
        json.dump(dict(runs=runs), f, indent=1)


if __name__ == "__main__":
    main()
