import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp


def test_fused_matcher_matches_two_stage():
    from my_lidar_graph_slam_v2_tpu.matching.correlative import (
        CorrelativeConfig,
        ScanMatcherCorrelative,
    )
    from my_lidar_graph_slam_v2_tpu.matching.linear_solver import (
        LinearSolverConfig,
        ScanMatcherLinearSolver,
    )
    from my_lidar_graph_slam_v2_tpu.matching.types import ScanMatchingQuery
    from my_lidar_graph_slam_v2_tpu.models.fused_matcher import (
        FusedCorrelativeGNMatcher,
    )
    from tests.test_matchers import build_map, make_scan_arrays

    rng = np.random.default_rng(31)
    true_pose = np.array([0.3, -0.2, 0.1])
    gm, _ = build_map([np.zeros(3)] * 8 + [true_pose] * 8, rng=rng)
    scan = make_scan_arrays(true_pose)
    init = true_pose + np.array([0.05, -0.06, 0.08])

    ccfg = CorrelativeConfig(crop_rows=320, crop_cols=320, n_theta_max=96)
    lcfg = LinearSolverConfig()
    csm = ScanMatcherCorrelative(ccfg)
    gn = ScanMatcherLinearSolver(lcfg)
    s1 = csm.optimize_pose(ScanMatchingQuery(gm, scan, init))
    s1f = gn.optimize_pose(ScanMatchingQuery(gm, scan, s1.estimated_pose))

    fused = FusedCorrelativeGNMatcher(ccfg, lcfg)
    s2 = fused.optimize_pose(ScanMatchingQuery(gm, scan, init))
    assert s2.pose_found
    np.testing.assert_allclose(s2.estimated_pose, s1f.estimated_pose, atol=2e-3)
    np.testing.assert_allclose(s2.covariance, s1f.covariance, rtol=0.05, atol=1e-3)


def test_checkpoint_roundtrip(tmp_path):
    from my_lidar_graph_slam_v2_tpu.datasets import synthetic
    from my_lidar_graph_slam_v2_tpu.pipeline import checkpoint
    from my_lidar_graph_slam_v2_tpu.pipeline.factory import create_default_slam

    world = synthetic.World.office(seed=4, size=10.0)
    traj = synthetic.loop_trajectory(size=10.0, laps=0.2, step=0.1)
    seq = synthetic.generate(world, traj, n_beams=181, max_range=10.0, seed=5)

    def make():
        return create_default_slam(
            map_rows=512, map_cols=512, beam_capacity=512,
            samples_per_beam=256, usable_range_max=10.0,
            n_theta_max=64, crop=320,
        )

    # Run A: full run
    slam_a = make()
    half = len(seq.scans) // 2
    for s in seq.scans:
        slam_a.process_scan(s, s.odom_pose)
    est_full = slam_a.get_trajectory()

    # Run B: first half, checkpoint, restore into a fresh instance, resume
    slam_b = make()
    for s in seq.scans[:half]:
        slam_b.process_scan(s, s.odom_pose)
    checkpoint.save(slam_b, str(tmp_path / "ckpt"))

    slam_c = make()
    checkpoint.load(slam_c, str(tmp_path / "ckpt"))
    assert len(slam_c.pose_graph.scan_nodes) == len(slam_b.pose_graph.scan_nodes)
    for s in seq.scans[half:]:
        slam_c.process_scan(s, s.odom_pose)
    est_resumed = slam_c.get_trajectory()

    assert len(est_resumed) == len(est_full)
    # Resumed trajectory should closely track the uninterrupted run
    err = np.linalg.norm(est_resumed[:, :2] - est_full[:, :2], axis=1)
    assert err.max() < 0.15, err.max()


def test_checkpoint_owner_sharded_roundtrip(tmp_path):
    """Per-owner checkpoint (Stage 5b): after owner retention drops
    non-owned heavy state, save/load reproduces exactly that state —
    owned rasters restore bit-exact from .maps.npz, dropped maps come
    back pose-only, and the union of both ranks' checkpoints covers
    every map."""
    from my_lidar_graph_slam_v2_tpu.datasets import synthetic
    from my_lidar_graph_slam_v2_tpu.parallel.multihost import (
        apply_owner_retention,
    )
    from my_lidar_graph_slam_v2_tpu.pipeline import checkpoint
    from my_lidar_graph_slam_v2_tpu.pipeline.factory import create_default_slam

    world = synthetic.World.office(seed=4, size=10.0)
    traj = synthetic.loop_trajectory(size=10.0, laps=0.6, step=0.25)
    seq = synthetic.generate(world, traj, n_beams=121, max_range=10.0, seed=5)

    def make():
        return create_default_slam(
            map_rows=384, map_cols=384, beam_capacity=256,
            samples_per_beam=192, usable_range_max=10.0,
            n_theta_max=32, crop=256,
            builder_overrides=dict(
                travel_dist_threshold=1.0,
                num_scans_for_latest_map=4,
                num_overlapped_scans=4,
            ),
        )

    held_by_rank = {}
    for rank in (0, 1):
        slam = make()
        for s in seq.scans:
            slam.process_scan(s, s.odom_pose)
            apply_owner_retention(
                slam.pose_graph, slam.builder,
                num_processes=2, process_id=rank,
            )
        maps = slam.builder.local_maps
        # Finished owned maps may be COMPACTED (u8 + packed observed,
        # grid/builder LocalMap.compact) — they still hold their raster.
        held = [lm.local_map_id for lm in maps if lm.holds_raster]
        dropped = [lm.local_map_id for lm in maps if not lm.holds_raster]
        assert dropped, "run too short: retention never dropped a map"
        held_by_rank[rank] = set(held)
        n_scans_held = sum(
            1 for n in slam.pose_graph.scan_nodes if n.scan_data is not None
        )
        assert n_scans_held < len(slam.pose_graph.scan_nodes)

        prefix = str(tmp_path / f"ckpt_rank{rank}")
        checkpoint.save(slam, prefix)
        restored = make()
        checkpoint.load(restored, prefix)
        for lm_old, lm_new in zip(maps, restored.builder.local_maps):
            if not lm_old.holds_raster:
                assert not lm_new.holds_raster and lm_new.dropped
                assert lm_new.shape == lm_old.shape  # metadata retained
            elif lm_old.compacted:
                assert lm_new.compacted
                np.testing.assert_array_equal(
                    np.asarray(lm_new.prob_q), np.asarray(lm_old.prob_q)
                )
                np.testing.assert_array_equal(
                    np.asarray(lm_new.observed), np.asarray(lm_old.observed)
                )
            else:
                np.testing.assert_array_equal(
                    np.asarray(lm_new.logodds), np.asarray(lm_old.logodds)
                )
                np.testing.assert_array_equal(
                    np.asarray(lm_new.observed), np.asarray(lm_old.observed)
                )
        # Scan holdings restore to exactly the retained set
        for n_old, n_new in zip(
            slam.pose_graph.scan_nodes, restored.pose_graph.scan_nodes
        ):
            assert (n_old.scan_data is None) == (n_new.scan_data is None)

    # Old maps partition by owner; union covers everything
    all_ids = set(range(len(held_by_rank[0] | held_by_rank[1])))
    assert held_by_rank[0] | held_by_rank[1] >= all_ids
    recent = set(sorted(all_ids)[-2:])
    assert held_by_rank[0] & held_by_rank[1] <= recent
