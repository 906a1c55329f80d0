#!/usr/bin/env python
"""Per-process entry for a multi-host SLAM run.

Each process runs the identical host-side pipeline (replicated state);
loop detection and the pose-graph Schur LM shard over the global device
mesh, with loop candidates routed to the process owning the reference
local map (my_lidar_graph_slam_v2_tpu/parallel/multihost.py).

Test/CI usage (spawned per process by tests/test_multihost.py):

    python scripts/multihost_worker.py --coordinator localhost:PORT \
        --num-processes 2 --process-id K --local-devices 2 --platform cpu

On GPU hosts, omit --platform/--local-devices and launch one process per
card, each with its own card: ``--local-device-ids K`` (otherwise every
process opens, and reserves memory on, every card of its host).  Prints
one JSON line with the run result.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=None)
    ap.add_argument("--local-device-ids", type=int, nargs="+", default=None,
                    help="accelerators this process owns (one per process "
                    "on a GPU host)")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--laps", type=float, default=1.25)
    ap.add_argument("--step", type=float, default=0.3)
    ap.add_argument(
        "--smoke", action="store_true",
        help="tiny shapes for the default-tier CI smoke (<30 s)")
    args = ap.parse_args()

    from my_lidar_graph_slam_v2_tpu.parallel import multihost

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    multihost.init_multihost(
        args.coordinator, args.num_processes, args.process_id,
        local_device_count=args.local_devices,
        local_device_ids=args.local_device_ids,
    )
    import jax
    import numpy as np

    from my_lidar_graph_slam_v2_tpu.datasets import synthetic
    from my_lidar_graph_slam_v2_tpu.pipeline.factory import create_default_slam

    mesh = multihost.global_mesh()
    if args.smoke:
        n_theta, crop, beams, rows, spb = 16, 128, 61, 256, 96
        builder_travel = 1.0
    else:
        n_theta, crop, beams, rows, spb = 48, 256, 121, 384, 192
        builder_travel = 1.5
    backend = multihost.create_multihost_backend(
        mesh,
        usable_range_max=10.0, n_theta_max=n_theta, crop=crop,
        beam_capacity=256,
        searcher_overrides=dict(
            travel_dist_threshold=10.0, node_dist_threshold=5.0
        ),
    )
    world = synthetic.World.office(seed=21, size=10.0)
    traj = synthetic.loop_trajectory(size=10.0, laps=args.laps, step=args.step)
    seq = synthetic.generate(
        world, traj, n_beams=beams, max_range=10.0,
        range_noise=0.01, odom_noise=(0.05, 0.02), seed=22,
    )
    slam = create_default_slam(
        map_rows=rows, map_cols=rows, beam_capacity=256,
        samples_per_beam=spb, usable_range_max=10.0,
        n_theta_max=n_theta, crop=crop, backend=backend,
        builder_overrides=dict(travel_dist_threshold=builder_travel),
    )
    import time as _time

    gt = []
    dropped_rasters = dropped_scans = 0
    t_run = _time.time()
    for scan, g in zip(seq.scans, seq.ground_truth):
        if slam.process_scan(scan, scan.odom_pose):
            gt.append(g)
        # Owner-sharded host state (Stage 5b): non-owned aged-out heavy
        # state is released as the run advances
        ret = multihost.apply_owner_retention(slam.pose_graph, slam.builder)
        dropped_rasters += ret["dropped_rasters"]
        dropped_scans += ret["dropped_scans"]
    slam.stop_backend()
    wall_s = _time.time() - t_run
    est = slam.get_trajectory()
    ate = synthetic.ate_rmse(est, np.asarray(gt))
    n_loops = sum(1 for e in slam.pose_graph.edges if e.is_loop)
    detector = backend.loop_detector

    # Sharded-exact global map: partial per-owner rasters summed across
    # processes (skipped in smoke mode to hold the <30 s budget)
    global_map_observed_cells = None
    if not args.smoke:
        _, gmap = multihost.construct_global_map_sharded(slam)
        global_map_observed_cells = int(np.asarray(gmap.observed).sum())

    print(json.dumps(dict(
        process_id=args.process_id,
        num_processes=jax.process_count(),
        global_devices=len(jax.devices()),
        wall_s=round(wall_s, 2),
        scans=len(seq.scans),
        scans_per_sec=round(len(seq.scans) / max(wall_s, 1e-9), 2),
        keyframes=len(est),
        loops=n_loops,
        ate=round(float(ate), 5),
        trajectory_sum=round(float(np.abs(est).sum()), 4),
        rasterized_map_ids=sorted(detector.rasterized_map_ids),
        all_map_ids=sorted(lm.local_map_id for lm in slam.builder.local_maps),
        rasters_held_ids=sorted(
            lm.local_map_id for lm in slam.builder.local_maps
            if lm.holds_raster
        ),
        scan_buffers_held=sum(
            1 for n in slam.pose_graph.scan_nodes if n.scan_data is not None
        ),
        total_scan_nodes=len(slam.pose_graph.scan_nodes),
        dropped_rasters=dropped_rasters,
        dropped_scans=dropped_scans,
        global_map_observed_cells=global_map_observed_cells,
    )), flush=True)


if __name__ == "__main__":
    main()
