#!/usr/bin/env python
"""ATE evaluation harness over the BASELINE.json configurations.

The Radish logs (Intel/ACES/MIT) do not ship with either repo, so each
configuration runs on a deterministic synthetic world of comparable
geometry (segment-world ray casting + drifting odometry;
datasets/synthetic.py) with ground truth attached:

  #1 odometry-only CSM (no loop closure)
  #2 CSM + correlative loop detection + online pose-graph updates
  #3 branch-and-bound loop detection + full pose-graph optimization
  #4 multi-candidate loop search + robust kernels (Huber / DCS)

Writes results to results_ate.json and prints a table. Run with
--platform cpu on a host without an accelerator.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def run_config(name, *, backend_kind, loss_kind=None, laps, odom_noise,
               searcher=None, seed=11):
    from my_lidar_graph_slam_v2_tpu.datasets import synthetic
    from my_lidar_graph_slam_v2_tpu.pipeline.factory import (
        create_default_backend,
        create_default_slam,
    )

    world = synthetic.World.office(seed=seed, size=12.0)
    traj = synthetic.loop_trajectory(size=12.0, laps=laps, step=0.08)
    seq = synthetic.generate(
        world, traj, n_beams=181, max_range=12.0,
        range_noise=0.01, odom_noise=odom_noise, seed=seed + 1,
    )
    backend = None
    if backend_kind is not None:
        opt = {}
        if loss_kind:
            from my_lidar_graph_slam_v2_tpu.graph.loss import LossFunction

            opt = dict(loss=LossFunction(loss_kind, 0.01))
        backend = create_default_backend(
            usable_range_max=12.0, n_theta_max=128, crop=448,
            searcher_overrides=searcher or dict(travel_dist_threshold=6.0),
            optimizer_overrides=opt,
        )
        if backend_kind == "branchbound":
            from my_lidar_graph_slam_v2_tpu.matching.branch_bound import (
                BranchBoundConfig,
                ScanMatcherBranchBound,
            )

            # B&B's reference role is wide-window relocalization: give it
            # its own (larger) search window and theta range, distinct
            # from config #2's correlative 2.5 m window
            backend.loop_detector.scan_matcher = ScanMatcherBranchBound(
                BranchBoundConfig(
                    node_height_max=5, range_x=3.5, range_y=3.5,
                    range_theta=0.75, n_theta_max=160,
                    crop_rows=448, crop_cols=448,
                )
            )
    slam = create_default_slam(
        map_rows=768, map_cols=768, beam_capacity=512,
        samples_per_beam=512, usable_range_max=12.0,
        n_theta_max=128, crop=384, backend=backend,
    )
    slam.start_backend()
    gts = []
    t0 = time.time()
    for scan, gt in zip(seq.scans, seq.ground_truth):
        if slam.process_scan(scan, scan.odom_pose):
            gts.append(gt)
    slam.stop_backend()
    wall = time.time() - t0
    est = slam.get_trajectory()
    gts = np.asarray(gts)
    odom = np.stack([s.odom_pose for s in seq.scans])
    n_loops = sum(1 for e in slam.pose_graph.edges if e.is_loop)
    return dict(
        config=name,
        keyframes=len(est),
        scans=len(seq.scans),
        wall_s=round(wall, 1),
        scans_per_s=round(len(seq.scans) / wall, 2),
        ate_m=round(synthetic.ate_rmse(est, gts), 4),
        ate_odometry_m=round(synthetic.ate_rmse(odom, seq.ground_truth), 4),
        loop_edges=n_loops,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    laps_short = 0.35 if args.quick else 0.5
    laps_loop = 1.15 if args.quick else 1.3
    results = [
        run_config("1-odometry-only-csm", backend_kind=None,
                   laps=laps_short, odom_noise=(0.03, 0.01)),
        run_config("2-csm-correlative-loop", backend_kind="correlative",
                   laps=laps_loop, odom_noise=(0.05, 0.02)),
        run_config("3-branch-bound-loop", backend_kind="branchbound",
                   laps=laps_loop, odom_noise=(0.05, 0.02)),
        run_config("4-multi-candidate-robust", backend_kind="correlative",
                   loss_kind="DCS", laps=laps_loop, odom_noise=(0.05, 0.02),
                   searcher=dict(travel_dist_threshold=6.0,
                                 num_candidate_nodes=6)),
    ]
    with open("results_ate.json", "w") as f:
        json.dump(results, f, indent=1)
    hdr = f"{'config':<28} {'kf':>4} {'ATE[m]':>8} {'odomATE':>8} {'loops':>5} {'scan/s':>7}"
    print(hdr)
    print("-" * len(hdr))
    for r in results:
        print(f"{r['config']:<28} {r['keyframes']:>4} {r['ate_m']:>8.4f} "
              f"{r['ate_odometry_m']:>8.4f} {r['loop_edges']:>5} {r['scans_per_s']:>7}")


if __name__ == "__main__":
    main()
