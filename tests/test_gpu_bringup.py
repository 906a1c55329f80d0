"""The GPU bring-up's host-side pieces: compile-cache placement, the
benchmark's peak table, the smoke run's gates, the chunked sweep path
that only an accelerator takes by default, and the backend worker's
failure surfacing.  ``test_smoke_kernels_on_gpu`` runs on a card only."""
import threading
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

REPO = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------- compile cache --
@pytest.fixture
def restore_cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("from_env", [False, True])
def test_jaxcache_placement(tmp_path, monkeypatch, restore_cache_config,
                            from_env):
    from my_lidar_graph_slam_v2_tpu.utils import jaxcache

    if from_env:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
        want = str(tmp_path / "c")
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        # One fixed directory inside the checkout, never under $HOME
        want = str(REPO / ".jax_cache")
    assert jaxcache.enable() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert Path(want).is_dir()


# ------------------------------------------------------------ peak table --
def test_bench_peaks_reject_unknown_device():
    import bench

    h100 = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert h100["hbm_gbps"] == 3350.0 and h100["bf16_tflops"] == 989.0
    assert h100["int8_tops"] == 1979.0 and h100["tf32_tflops"] == 495.0
    for kind in ("cpu", "NVIDIA A100-SXM4-80GB", "Unknown accelerator"):
        with pytest.raises(ValueError, match="no published peaks"):
            bench.device_peaks(kind)


# ---------------------------------------------------------- smoke gates --
def test_smoke_pipeline_gates_on_synth11(tmp_path):
    """The launcher on the first 120 scans of synth11.clf, read back and
    judged by chip_smoke's gate function."""
    import chip_smoke
    from my_lidar_graph_slam_v2_tpu.pipeline import launcher

    out = tmp_path / "synth11"
    rc = launcher.main([
        str(REPO / "h2h" / "synth11.clf"),
        str(REPO / "h2h" / "settings_lm.json"), str(out),
        "--max-scans", "120", "--map-size", "512",
    ])
    assert rc == 0
    res = chip_smoke.evaluate_run(f"{out}.posegraph.json",
                                  REPO / "h2h" / "synth11_gt.npy")
    assert res["nodes"] > 10 and res["local_maps"] >= 1
    assert res["loop_edges"] == 0  # no revisit this early in the log
    ok = chip_smoke.pipeline_failures(
        res, keyframes=res["nodes"], loop_ref=0, loop_band=0, ate_max=0.05)
    assert ok == [], ok
    bad = chip_smoke.pipeline_failures(
        res, keyframes=res["nodes"] + 1, loop_ref=20, loop_band=5,
        ate_max=res["ate_m"] / 2)
    assert len(bad) == 3, bad


def test_smoke_mesh_pair_gates():
    import chip_smoke

    one = dict(nodes=997, loop_edges=370, ate_m=0.018)
    assert chip_smoke.mesh_pair_failures(one, dict(one, ate_m=0.02)) == []
    assert chip_smoke.mesh_pair_failures(one, dict(one, loop_edges=360)) == []
    bad = chip_smoke.mesh_pair_failures(
        one, dict(nodes=996, loop_edges=340, ate_m=0.06))
    assert len(bad) == 4, bad  # keyframes, loops, ATE bound, ATE gap


# ---------------------------------------------------- chunked sweep path --
@pytest.mark.parametrize("u8", [False, True])
def test_chunked_patch_sweep_matches_conv(u8):
    """Windows of more than 256 offsets run as a scan over offset chunks
    on an accelerator; on the CPU the convolution runs instead.  Forced
    here, the chunked path must reproduce the convolution."""
    from my_lidar_graph_slam_v2_tpu.ops import csm

    rng = np.random.default_rng(11)
    T, crop, H = 6, 48, 160
    hit = rng.integers(0, 3, (T, crop, crop)).astype(np.float32)
    prob = rng.uniform(0, 1, (H, H)).astype(np.float32)
    obs = rng.uniform(0, 1, (H, H)) > 0.3
    prob = np.where(obs, prob, 0.0)
    if u8:
        prob_a = jnp.asarray(np.round(prob * 255), jnp.uint8)
        hit_a, precision = jnp.asarray(hit, jnp.bfloat16), "split"
    else:
        prob_a = jnp.asarray(prob)
        hit_a, precision = jnp.asarray(hit), "highest"
    args = (hit_a, jnp.int32(40), jnp.int32(37), prob_a, jnp.asarray(obs),
            jnp.int32(-8), jnp.int32(-9))
    kw = dict(nx=17, ny=19, stride=1, precision=precision)  # 323 offsets
    s_conv, k_conv = csm.sweep_from_hits(*args, **kw)
    s_chunk, k_chunk = csm.sweep_from_hits(*args, force_chunked=True, **kw)
    assert s_chunk.shape == (T, 19, 17)
    np.testing.assert_allclose(np.asarray(s_chunk), np.asarray(s_conv),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(k_chunk), np.asarray(k_conv),
                               rtol=1e-5, atol=1e-4)


# ------------------------------------------------ backend worker failure --
class _FailingBackend:
    inline = False

    def run_step(self, parent):
        raise ValueError("device lost")


class _Builder:
    local_maps = []

    def flush_oob(self):
        pass


class _Frontend:
    """Appends a node per scan and notifies the backend, like the real
    frontend after a keyframe."""

    def process_scan(self, slam, scan, odom_pose):
        slam.pose_graph.scan_nodes.append(object())
        slam.notify_backend()
        return True


def _failing_slam(max_backend_lag=24):
    from my_lidar_graph_slam_v2_tpu.pipeline.slam import LidarGraphSlam

    return LidarGraphSlam(_Frontend(), _FailingBackend(), _Builder(),
                          max_backend_lag=max_backend_lag)


def test_backend_worker_error_reaches_process_scan_and_stop():
    slam = _failing_slam()
    slam.start_backend()
    slam.process_scan(None, None)
    slam._backend_thread.join(timeout=10)
    assert not slam._backend_thread.is_alive()
    with pytest.raises(RuntimeError, match="backend worker") as e:
        slam.process_scan(None, None)
    assert isinstance(e.value.__cause__, ValueError)
    with pytest.raises(RuntimeError, match="backend worker"):
        slam.stop_backend()


def test_backend_worker_error_wakes_lag_throttle():
    """A frontend blocked on the lag bound must not wait forever on a
    backend thread that died."""
    slam = _failing_slam(max_backend_lag=1)
    for _ in range(3):
        slam.pose_graph.scan_nodes.append(object())
    slam.start_backend()
    done = threading.Event()

    def frontend():
        slam.notify_backend()  # blocks in throttle_backend_lag
        done.set()

    t = threading.Thread(target=frontend, daemon=True)
    t.start()
    assert done.wait(timeout=10), "frontend still blocked"
    with pytest.raises(RuntimeError):
        slam.process_scan(None, None)


# ---------------------------------------------------------------- card --
@pytest.mark.gpu
def test_smoke_kernels_on_gpu(gpu):
    """chip_smoke's rasterizer, GN and optimizer comparisons on the card."""
    import chip_smoke

    with jax.default_device(gpu):
        chip_smoke.kernel_rasterizer()
        chip_smoke.kernel_gn(batch=2)
        chip_smoke.kernel_optimizer()
