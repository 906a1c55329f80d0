"""CLI launcher: run SLAM on a Carmen log.

Equivalent of ``src/my_lidar_graph_slam/slam_launcher.cpp:205-360``::

    python -m my_lidar_graph_slam_v2_tpu.pipeline.launcher \
        <carmen log> <settings.json> [output-prefix]

Loads the log, builds the module graph from the (reference-compatible)
settings file, feeds scans through the pipeline, then saves the global
map PNG+metadata, the pose-graph JSON, the latest map, and the metrics
JSON — the same artifact set the reference emits.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("log", help="Carmen log file")
    ap.add_argument("settings", nargs="?", default=None,
                    help="settings JSON (reference format); defaults apply")
    ap.add_argument("output", nargs="?", default=None,
                    help="output prefix (default: log stem)")
    ap.add_argument("--map-size", type=int, default=1024)
    ap.add_argument("--crop", type=int, default=320)  # reference FPGA map-window contract
    ap.add_argument("--max-scans", type=int, default=None)
    ap.add_argument("--platform", default=None,
                    help="force jax platform (e.g. cpu); without it the run "
                    "needs an accelerator")
    ap.add_argument("--draw-every", type=int, default=0, metavar="N",
                    help="rewrite <output>.graph.svg every N keyframes "
                    "(live pose-graph view, like the reference's gnuplot "
                    "drawFrameInterval)")
    ap.add_argument("--client", default=None, metavar="SETTINGS",
                    help="TCP client settings JSON (reference "
                    "client-settings.json format: Enabled, Server.Address, "
                    "Server.Port); streams grid-map params once, then the "
                    "pose array + latest scan per keyframe "
                    "(slam_launcher.cpp:288-296)")
    args = ap.parse_args(argv)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if jax.default_backend() == "cpu" and "cpu" not in (
        jax.config.jax_platforms or ""
    ).split(","):
        # JAX found no accelerator and fell back to the host; a run that
        # was meant for the accelerator must not silently carry on there.
        print("no accelerator found (JAX fell back to the CPU); pass "
              "--platform cpu or set JAX_PLATFORMS=cpu to run on the host",
              file=sys.stderr)
        return 2

    # One-time-cost analog of the reference's bitstream load
    # (slam_launcher.cpp:83-107): compiled cores persist across runs.
    from ..utils import jaxcache

    jaxcache.enable()

    from ..config.settings import create_slam_from_settings, load_settings
    from ..io import map_saver
    from ..io.carmen import read_carmen_log
    from ..metrics.registry import MetricManager
    from ..sensor.data import ScanData

    out_prefix = args.output or Path(args.log).stem

    t0 = time.time()
    records = read_carmen_log(args.log)
    scans = [r for r in records if isinstance(r, ScanData)]
    if args.max_scans:
        scans = scans[: args.max_scans]
    print(f"loaded {len(scans)} scans in {time.time()-t0:.1f}s", file=sys.stderr)
    if not scans:
        print("no scan data in log", file=sys.stderr)
        return 1

    settings = load_settings(args.settings) if args.settings else {}
    slam = create_slam_from_settings(
        settings, map_rows=args.map_size, map_cols=args.map_size,
        crop=args.crop,
    )
    slam.start_backend()

    # TCP visualization client (reference: slam_launcher.cpp:253-296)
    client = None
    if args.client:
        import json as _json

        from ..config.settings import _get
        from ..network.slam_client import GridMapParams, SlamClient

        with open(args.client) as f:
            csettings = _json.load(f)
        if csettings.get("Enabled", False):
            client = SlamClient(
                _get(csettings, "Server/Address", "127.0.0.1"),
                int(_get(csettings, "Server/Port", 1901)),
            )
            if not client.connect():
                print("Failed to connect to a server", file=sys.stderr)
                return 1
            client.send_grid_map_params(GridMapParams(
                resolution=float(
                    _get(settings, "GridMapBuilder/Map/Resolution", 0.05)),
                min_range=float(
                    _get(settings, "GridMapBuilder/UsableRangeMin", 0.01)),
                max_range=float(
                    _get(settings, "GridMapBuilder/UsableRangeMax", 20.0)),
                probability_hit=float(
                    _get(settings, "GridMapBuilder/ProbabilityHit", 0.62)),
                probability_miss=float(
                    _get(settings, "GridMapBuilder/ProbabilityMiss", 0.46)),
            ))
    t0 = time.time()
    processed = 0
    for i, scan in enumerate(scans):
        if slam.process_scan(scan, scan.odom_pose):
            processed += 1
            if client is not None:
                times, poses = slam.get_poses_with_times()
                client.send_pose_array(times, poses)
                latest = slam.get_latest_scan()
                if latest is not None:
                    client.send_scan(latest)
            if args.draw_every and processed % args.draw_every == 0:
                from ..io import graph_plot

                graph_plot.draw_pose_graph(
                    slam.pose_graph, f"{out_prefix}.graph.svg"
                )
            if processed % 50 == 0:
                print(
                    f"frame {processed} ({i+1}/{len(scans)} scans, "
                    f"{time.time()-t0:.1f}s)",
                    file=sys.stderr,
                )
    if client is not None:
        client.disconnect()
    slam.stop_backend()
    wall = time.time() - t0
    print(
        f"processed {processed} keyframes / {len(scans)} scans in {wall:.1f}s "
        f"({len(scans)/max(wall,1e-9):.1f} scans/s)",
        file=sys.stderr,
    )

    traj = slam.get_trajectory()
    map_pose, global_map = slam.get_global_map()
    map_saver.save_map(global_map, out_prefix, map_pose, trajectory=traj)
    map_saver.save_pose_graph(slam.pose_graph, f"{out_prefix}.posegraph.json")
    latest_pose, latest_map = slam.get_latest_map()
    map_saver.save_map(latest_map, f"{out_prefix}.latest", latest_pose)
    slam.builder.flush_oob()  # include global-map construction in the count
    MetricManager.instance().save_json(f"{out_prefix}.metric.json")
    print(f"saved {out_prefix}.png / .posegraph.json / .metric.json",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
