import json
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from my_lidar_graph_slam_v2_tpu.io import carmen, map_saver
from my_lidar_graph_slam_v2_tpu.sensor.data import OdometryData, ScanData


def write_synthetic_carmen(path, n=5):
    """FLASER old-format lines + PARAM records."""
    rng = np.random.default_rng(0)
    lines = [
        "# synthetic test log",
        "PARAM Laser.MaxRange 20.0",
        "PARAM robot_frontlaser_offset 0.08",
    ]
    for i in range(n):
        nr = 181
        ranges = rng.uniform(0.5, 8.0, nr)
        x, y, th = 0.1 * i, 0.05 * i, 0.01 * i
        vals = " ".join(f"{r:.3f}" for r in ranges)
        lines.append(
            f"FLASER {nr} {vals} {x+0.08:.3f} {y:.3f} {th:.3f} "
            f"{x:.3f} {y:.3f} {th:.3f} {100.0+i:.2f} host {100.0+i:.2f}"
        )
        lines.append(
            f"ODOM {x:.3f} {y:.3f} {th:.3f} 0.1 0.0 0.0 {100.0+i:.2f} host {100.0+i:.2f}"
        )
    path.write_text("\n".join(lines))


def test_carmen_reader_native_parity(tmp_path):
    """The C++ parser (native/carmen_reader.cpp) must return the same
    record stream as the Python reference path, across all formats."""
    p = tmp_path / "t.log"
    write_synthetic_carmen(p, n=10)
    beams = " ".join("5.0" for _ in range(181))
    with p.open("a") as f:
        f.write(
            "\nROBOTLASER1 0 -1.5707963 3.1415927 0.0174533 30.0 0.01 0 "
            f"181 {beams} 0 1.0 2.0 0.1 0.9 1.9 0.1 0.5 0.1 0.3 0.2 0.1 "
            "200.5 host 200.5\n"
            "RAWLASER1 0 -1.5707963 3.1415927 0.0174533 30.0 0.01 0 "
            f"181 {beams} 0 201.5 host 201.5\n"
            "garbage line that should be skipped\n"
        )
    try:
        b = carmen.read_carmen_log(str(p), native=True)
    except Exception:
        pytest.skip("native toolchain unavailable")
    a = carmen.read_carmen_log(str(p), native=False)
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert type(ra) is type(rb)
        if isinstance(ra, ScanData):
            np.testing.assert_allclose(ra.ranges, rb.ranges)
            np.testing.assert_allclose(ra.angles, rb.angles)
            np.testing.assert_allclose(ra.odom_pose, rb.odom_pose)
            np.testing.assert_allclose(
                ra.relative_sensor_pose, rb.relative_sensor_pose, atol=1e-12
            )
            assert ra.time_stamp == rb.time_stamp
            assert ra.max_range == rb.max_range
        else:
            np.testing.assert_allclose(ra.pose, rb.pose)
            np.testing.assert_allclose(ra.velocity, rb.velocity)


def test_carmen_reader(tmp_path):
    p = tmp_path / "test.log"
    write_synthetic_carmen(p)
    records = carmen.read_carmen_log(str(p))
    scans = [r for r in records if isinstance(r, ScanData)]
    odoms = [r for r in records if isinstance(r, OdometryData)]
    assert len(scans) == 5 and len(odoms) == 5
    s = scans[0]
    assert s.num_scans == 181
    assert s.max_range == pytest.approx(20.0)
    # FLASER with 181 beams: angles spread over pi starting at -pi/2
    assert s.angles[0] == pytest.approx(-np.pi / 2)
    assert s.angles[-1] == pytest.approx(np.pi / 2, abs=1e-6)
    # sensor offset = laser pose relative to robot pose
    np.testing.assert_allclose(s.relative_sensor_pose, [0.08, 0, 0], atol=1e-9)
    assert s.time_stamp == pytest.approx(100.0)


def test_carmen_writer_rejects_heterogeneous_geometry(tmp_path):
    """write_carmen_log emits PARAM geometry once (from scans[0]); a
    sequence with differing beam counts/angles/ranges must be rejected
    instead of silently mis-written (io/carmen.py uniformity contract)."""
    import dataclasses

    p = tmp_path / "uniform.log"
    write_synthetic_carmen(p)
    scans = [r for r in carmen.read_carmen_log(str(p))
             if isinstance(r, ScanData)]
    out = tmp_path / "out.log"
    carmen.write_carmen_log(scans, str(out))  # uniform: fine
    assert out.exists()

    bad = list(scans)
    bad[2] = dataclasses.replace(
        bad[2], max_range=bad[2].max_range + 5.0)
    with pytest.raises(ValueError, match="uniform laser geometry"):
        carmen.write_carmen_log(bad, str(tmp_path / "bad.log"))

    bad2 = list(scans)
    bad2[1] = dataclasses.replace(
        bad2[1],
        angles=bad2[1].angles[:-2],
        ranges=bad2[1].ranges[:-2],
    )
    with pytest.raises(ValueError, match="uniform laser geometry"):
        carmen.write_carmen_log(bad2, str(tmp_path / "bad2.log"))


def test_map_saver_roundtrip(tmp_path):
    from my_lidar_graph_slam_v2_tpu.graph.pose_graph import (
        LocalMapNode,
        PoseGraph,
        PoseGraphEdge,
        ScanNode,
    )

    pg = PoseGraph()
    pg.local_map_nodes.append(LocalMapNode(0, np.array([1.0, 2.0, 0.3]), True))
    pg.scan_nodes.append(
        ScanNode(0, 0, np.zeros(3), np.array([1.1, 2.1, 0.31]), None)
    )
    pg.edges.append(
        PoseGraphEdge(0, 0, 0, 0, np.array([0.1, 0.1, 0.01]), np.eye(3) * 5)
    )
    path = tmp_path / "pg.json"
    map_saver.save_pose_graph(pg, str(path))
    pg2 = map_saver.load_pose_graph(str(path))
    assert len(pg2.scan_nodes) == 1 and len(pg2.edges) == 1
    np.testing.assert_allclose(
        pg2.scan_nodes[0].global_pose, pg.scan_nodes[0].global_pose
    )
    np.testing.assert_allclose(
        pg2.edges[0].information_mat, pg.edges[0].information_mat
    )


def test_png_writer(tmp_path):
    img = (np.arange(64 * 48) % 256).astype(np.uint8).reshape(48, 64)
    p = tmp_path / "t.png"
    map_saver.write_png_gray(str(p), img)
    data = p.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert b"IHDR" in data and b"IEND" in data


def test_settings_factory_default(tmp_path):
    """Building from the reference's default settings, as committed in
    ``h2h/settings_lm.json`` (its launcher_settings_default.json with the
    LM optimizer selected; the head-to-head runs use it)."""
    from pathlib import Path

    from my_lidar_graph_slam_v2_tpu.config.settings import (
        create_slam_from_settings,
        load_settings,
    )

    repo = Path(__file__).resolve().parent.parent
    settings = load_settings(str(repo / "h2h" / "settings_lm.json"))
    slam = create_slam_from_settings(
        settings, map_rows=256, map_cols=256, n_theta_max=64, crop=256
    )
    from my_lidar_graph_slam_v2_tpu.matching.linear_solver import (
        ScanMatcherLinearSolver,
    )
    from my_lidar_graph_slam_v2_tpu.models.fused_matcher import (
        FusedCorrelativeGNMatcher,
    )

    # The default correlative+linear-solver combo fuses into one dispatch
    assert isinstance(slam.frontend.scan_matcher, FusedCorrelativeGNMatcher)
    assert isinstance(slam.frontend.final_scan_matcher, ScanMatcherLinearSolver)
    assert slam.frontend.scan_matcher.lcfg.num_iterations_max == 10
    assert slam.frontend.scan_matcher.ccfg.range_x == pytest.approx(0.25)
    assert slam.builder.cfg.probability_hit == pytest.approx(0.62)
    # loop detector window from the default settings (2.5 m)
    assert slam.backend.loop_detector.scan_matcher.cfg.range_x == pytest.approx(2.5)
    assert slam.backend.loop_detector.cfg.score_threshold == pytest.approx(0.55)
    # PoseGraphOptimizerType=LM -> the Huber loss of PoseGraphOptimizerLM
    assert slam.backend.optimizer.cfg.loss.kind == "Huber"


def test_launcher_cli_on_synthetic_log(tmp_path):
    """End-to-end CLI drive: Carmen log in, maps + pose graph + metrics out."""
    from my_lidar_graph_slam_v2_tpu.datasets import synthetic
    from my_lidar_graph_slam_v2_tpu.pipeline import launcher

    world = synthetic.World.office(seed=2, size=10.0)
    traj = synthetic.loop_trajectory(size=10.0, laps=0.12, step=0.1)
    seq = synthetic.generate(world, traj, n_beams=181, max_range=10.0, seed=3)
    # Write as a Carmen FLASER log
    lines = ["PARAM Laser.MaxRange 10.0"]
    for s in seq.scans:
        vals = " ".join(f"{r:.3f}" for r in s.ranges)
        x, y, th = s.odom_pose
        lines.append(
            f"FLASER {s.num_scans} {vals} {x:.4f} {y:.4f} {th:.4f} "
            f"{x:.4f} {y:.4f} {th:.4f} {s.time_stamp:.2f} h {s.time_stamp:.2f}"
        )
    log = tmp_path / "synth.log"
    log.write_text("\n".join(lines))

    # Streaming server fixture: the launcher must drive the TCP client
    # exactly like the reference (slam_launcher.cpp:253-296)
    import socket
    import struct
    import threading

    received = bytearray()
    server = socket.socket()
    server.bind(("127.0.0.1", 0))
    server.listen(1)
    port = server.getsockname()[1]

    def serve():
        conn, _ = server.accept()
        while True:
            data = conn.recv(65536)
            if not data:
                break
            received.extend(data)
        conn.close()

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    client_settings = tmp_path / "client.json"
    client_settings.write_text(json.dumps(
        {"Enabled": True, "Server": {"Address": "127.0.0.1", "Port": port}}
    ))

    out = tmp_path / "out"
    rc = launcher.main([
        str(log), None, str(out), "--map-size", "512", "--crop", "320",
        "--client", str(client_settings),
    ])
    assert rc == 0

    th.join(timeout=10)
    server.close()
    buf = bytes(received)
    # first message: GridMapParams; then >=1 PoseArray + Scan per keyframe;
    # final u32 is the stop signal
    assert struct.unpack_from(">I", buf, 0)[0] == 3  # MSG_GRID_MAP_PARAMS
    msg_types = []
    off = 0
    while off + 4 <= len(buf):
        t = struct.unpack_from(">I", buf, off)[0]
        if t == 3:
            off += 4 + 7 * 8 + 2 * 4
        elif t == 1:
            n = struct.unpack_from(">I", buf, off + 4)[0]
            off += 8 + n * 4 * 8
        elif t == 2:
            n = struct.unpack_from(">I", buf, off + 4)[0]
            off += 8 + 8 * 8 + 2 * n * 8
        elif t == 0:
            off += 4
        else:
            raise AssertionError(f"unknown message type {t} at {off}")
        msg_types.append(t)
    assert off == len(buf), "stream must parse exactly"
    assert msg_types.count(1) >= 3 and msg_types.count(2) >= 3
    assert msg_types[-1] == 0  # stop signal on disconnect
    assert (tmp_path / "out.png").exists()
    assert (tmp_path / "out.posegraph.json").exists()
    assert (tmp_path / "out.metric.json").exists()
    pg = json.loads((tmp_path / "out.posegraph.json").read_text())
    assert len(pg["ScanNodes"]) >= 3
    metrics = json.loads((tmp_path / "out.metric.json").read_text())
    # Sectioned layout matching the reference (slam_launcher.cpp:171-181)
    assert "Frontend.ProcessTime" in metrics["ValueSequences"]
    assert "Frontend.ProcessCount" in metrics["Counters"]
    seq = metrics["ValueSequences"]["Frontend.ProcessTime"]
    assert int(seq["NumOfSamples"]) >= 3
    assert len(seq["Values"].split()) == int(seq["NumOfSamples"])

    # Observability parity gate: every series the reference binary emits
    # (committed h2h artifact) must be present in our export
    import subprocess
    import sys as _sys
    from pathlib import Path
    repo = Path(__file__).resolve().parent.parent
    ref_metric = repo / "h2h" / "ref_synth3.metric.json"
    if ref_metric.exists():
        r = subprocess.run(
            [_sys.executable, str(repo / "scripts" / "metric_diff.py"),
             str(ref_metric), str(tmp_path / "out.metric.json")],
            capture_output=True, text=True,
        )
        assert r.returncode == 0, r.stdout + r.stderr


def test_pose_graph_svg_live_view(tmp_path):
    """GnuplotHelper replacement (gnuplot_helper.cpp:22-77): SVG frame
    with odometry edges black, loop edges blue, atomically replaced."""
    import numpy as np

    from my_lidar_graph_slam_v2_tpu.graph.pose_graph import (
        CONSTRAINT_LOOP,
        CONSTRAINT_ODOMETRY,
        LocalMapNode,
        PoseGraph,
        PoseGraphEdge,
        ScanNode,
    )
    from my_lidar_graph_slam_v2_tpu.io import graph_plot

    pg = PoseGraph()
    pg.local_map_nodes.append(LocalMapNode(0, np.zeros(3)))
    for i in range(4):
        pg.scan_nodes.append(
            ScanNode(i, 0, np.zeros(3), np.array([i * 1.0, 0.1 * i, 0.0]))
        )
        pg.edges.append(
            PoseGraphEdge(0, i, 0, CONSTRAINT_ODOMETRY,
                          np.zeros(3), np.eye(3))
        )
    pg.edges.append(
        PoseGraphEdge(0, 3, 1, CONSTRAINT_LOOP, np.zeros(3), np.eye(3))
    )
    out = tmp_path / "live.svg"
    graph_plot.draw_pose_graph(pg, str(out))
    svg = out.read_text()
    assert svg.startswith("<svg")
    assert graph_plot.ODOMETRY_COLOR in svg
    assert graph_plot.LOOP_COLOR in svg
    assert "polyline" in svg
    # empty graph renders without error
    assert graph_plot.pose_graph_svg(PoseGraph()).startswith("<svg")


def test_map_saver_extended_outputs(tmp_path):
    """SaveLocalMaps / Save*MapAndScan / SavePrecomputedGridMaps parity
    (map_saver.hpp:181-214)."""
    import numpy as np

    from my_lidar_graph_slam_v2_tpu.datasets import synthetic
    from my_lidar_graph_slam_v2_tpu.io import map_saver
    from my_lidar_graph_slam_v2_tpu.pipeline.factory import create_default_slam

    world = synthetic.World.office(seed=5, size=8.0)
    traj = synthetic.loop_trajectory(size=8.0, laps=0.15, step=0.3)
    seq = synthetic.generate(world, traj, n_beams=91, max_range=8.0, seed=5)
    slam = create_default_slam(
        map_rows=512, map_cols=512, beam_capacity=128,
        samples_per_beam=160, usable_range_max=8.0,
        n_theta_max=32, crop=256,
    )
    last_scan = None
    for scan in seq.scans[:10]:
        if slam.process_scan(scan, scan.odom_pose):
            last_scan = scan
    pose, raster = slam.get_latest_map()
    trajectory = slam.get_trajectory()

    out = tmp_path / "m"
    map_saver.save_map_and_scan(
        raster, str(out), pose,
        scan_global_pose=trajectory[-1], scan=last_scan,
        trajectory=trajectory,
    )
    assert (tmp_path / "m.png").exists() and (tmp_path / "m.json").exists()

    map_saver.save_local_maps(slam.builder, slam.pose_graph, str(tmp_path / "lm"))
    assert (tmp_path / "lm.local-map-0.png").exists()

    map_saver.save_precomputed_maps(raster, str(tmp_path / "pc"), pose,
                                    heights=(1, 3))
    assert (tmp_path / "pc.precomp-2.png").exists()
    assert (tmp_path / "pc.precomp-8.png").exists()


REFERENCE_SETTINGS = "/root/reference/launcher_settings_default.json"


@pytest.mark.skipif(
    not __import__("os").path.exists(REFERENCE_SETTINGS),
    reason="reference settings file not present",
)
def test_reference_default_settings_verbatim():
    """Load the reference's actual ``launcher_settings_default.json``
    VERBATIM and assert the constructed module graph: module types, search
    windows, cost-function dispatch (CostType/CostConfigGroup), filter
    chain, loop searcher/detector, optimizer and grid-map builder
    parameters (slam_module_factory.cpp:214-244 + the per-module
    factories)."""
    from my_lidar_graph_slam_v2_tpu.config.settings import (
        create_slam_from_settings,
        load_settings,
    )
    from my_lidar_graph_slam_v2_tpu.loop.detector import LoopDetectorCorrelative
    from my_lidar_graph_slam_v2_tpu.loop.searcher import LoopSearcherNearest
    from my_lidar_graph_slam_v2_tpu.models.fused_matcher import (
        FusedCorrelativeGNMatcher,
    )

    settings = load_settings(REFERENCE_SETTINGS)
    slam = create_slam_from_settings(settings, map_rows=512, map_cols=512)

    # Frontend: RealTimeCorrelative + LinearSolver final -> fused matcher
    fe = slam.frontend
    assert isinstance(fe.scan_matcher, FusedCorrelativeGNMatcher)
    ccfg = fe.scan_matcher.ccfg
    assert (ccfg.range_x, ccfg.range_y, ccfg.range_theta) == (0.25, 0.25, 0.5)
    assert ccfg.low_resolution == 5
    # ScanMatcherRealTimeCorrelative/CostType = SquareError,
    # CostSquareError/CovarianceScale = 10000.0
    assert ccfg.cost.cost_type == "SquareError"
    assert ccfg.cost.covariance_scale == 10000.0
    lcfg = fe.scan_matcher.lcfg
    assert lcfg.num_iterations_max == 10
    assert lcfg.convergence_threshold == pytest.approx(1e-4)
    assert lcfg.initial_lambda == pytest.approx(1e-4)
    assert lcfg.covariance_scale == 10000.0
    # Frontend thresholds + filter chain
    assert fe.cfg.update_threshold_travel_dist == 0.5
    assert fe.cfg.update_threshold_angle == 0.5
    assert fe.cfg.update_threshold_time == 5.0
    assert fe.cfg.loop_detection_threshold == 2.5
    assert fe.cfg.degeneration_threshold == 10.0
    assert fe.cfg.odometry_covariance_scale == 100.0
    assert fe.outlier_filter is not None        # UseScanOutlierFilter=true
    assert fe.interpolator is not None          # UseScanInterpolator=true
    assert fe.accumulator is None               # UseScanAccumulator=false
    assert fe.outlier_filter.valid_range_max == 20.0
    assert fe.interpolator.dist_scans == 0.05

    # Backend: nearest searcher, correlative loop detector, G2O-group
    # optimizer (mapped onto the same-contract device LM solver)
    be = slam.backend
    assert isinstance(be.loop_searcher, LoopSearcherNearest)
    assert be.loop_searcher.cfg.travel_dist_threshold == 10.0
    assert be.loop_searcher.cfg.node_dist_threshold == 5.0
    assert be.loop_searcher.cfg.num_candidate_nodes == 2
    assert isinstance(be.loop_detector, LoopDetectorCorrelative)
    assert be.loop_detector.cfg.score_threshold == 0.55
    assert be.loop_detector.cfg.known_rate_threshold == 0.6
    lm_cfg = be.loop_detector.scan_matcher.cfg
    assert (lm_cfg.range_x, lm_cfg.range_y, lm_cfg.range_theta) == (
        2.5, 2.5, 0.5,
    )
    assert lm_cfg.cost.cost_type == "SquareError"
    # PoseGraphOptimizerType=G2O -> squared loss, its iteration caps
    assert be.optimizer.cfg.num_iterations_max == 10
    assert be.optimizer.cfg.loss.kind == "Squared"

    # GridMapBuilder group
    b = slam.builder.cfg
    assert b.resolution == 0.05
    assert b.num_scans_for_latest_map == 10
    assert b.travel_dist_threshold == 2.5
    assert b.num_overlapped_scans == 10
    assert b.usable_range_min == 0.01
    assert b.usable_range_max == 20.0
    assert b.probability_hit == 0.62
    assert b.probability_miss == 0.46


@pytest.mark.skipif(
    not __import__("os").path.exists(REFERENCE_SETTINGS),
    reason="reference settings file not present",
)
def test_reference_settings_cost_dispatch_all_matchers():
    """Every matcher group in the reference file resolves its
    CostType/CostConfigGroup through the factory: HillClimbing gets
    GreedyEndpoint (kernel params from CostGreedyEndpoint), the
    GridSearch loop detector's matcher gets GreedyEndpoint, BranchBound
    and Correlative get SquareError (scan_matcher_factory.cpp:30-189)."""
    from my_lidar_graph_slam_v2_tpu.config.settings import (
        create_scan_matcher_from_group,
        load_settings,
    )

    settings = load_settings(REFERENCE_SETTINGS)
    mk = lambda t, g: create_scan_matcher_from_group(
        settings, t, g, resolution=0.05, n_theta_max=64, crop=256,
    )

    hc = mk("HillClimbing", "ScanMatcherHillClimbing")
    assert hc.cfg.cost.cost_type == "GreedyEndpoint"
    assert hc.cfg.cost.kernel_size == 1
    assert hc.cfg.cost.standard_deviation == 0.05
    assert hc.cfg.cost.hit_and_missed_dist == 0.075
    assert hc.cfg.linear_step == 0.1
    assert hc.cfg.max_iterations == 100

    gs = mk("GridSearch", "LoopDetectorGridSearch/ScanMatcher")
    assert gs.cfg.cost.cost_type == "GreedyEndpoint"
    assert (gs.cfg.step_x, gs.cfg.step_theta) == (0.05, 0.005)

    bb = mk("BranchBound", "LoopDetectorBranchBound/ScanMatcher")
    assert bb.cfg.cost.cost_type == "SquareError"
    assert bb.cfg.node_height_max == 6

    co = mk(
        "RealTimeCorrelative",
        "LoopDetectorRealTimeCorrelative/ScanMatcher",
    )
    assert co.cfg.cost.cost_type == "SquareError"
    assert co.cfg.cost.covariance_scale == 10000.0

    # LinearSolver rejects a non-SquareError cost like the reference's
    # Assert (scan_matcher_factory.cpp:152-156)
    bad = {"G": {"CostType": "GreedyEndpoint"}}
    with pytest.raises(ValueError):
        create_scan_matcher_from_group(
            bad, "LinearSolver", "G",
            resolution=0.05, n_theta_max=64, crop=256,
        )
