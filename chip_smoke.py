#!/usr/bin/env python
"""GPU smoke run: the SLAM pipeline and its device ops on an NVIDIA card.

    python chip_smoke.py               # one GPU
    python chip_smoke.py --four-cards  # four GPUs: the multi-device backend

One process, phases in order, every number on its own line:

* device   -- JAX's devices, and the card's name and power limit from
  ``nvidia-smi``.  Anything but a GPU ends the run (exit 2): there is no
  CPU fallback.
* pipeline -- the CLI launcher (``pipeline/launcher.py``) on
  ``h2h/synth3.clf`` (6,350 scans) with ``h2h/settings_lm.json`` at its
  defaults (1024^2 maps, crop 320), checked against the reference
  binary's run on the same log: keyframes, loop edges, ATE.
* kernels  -- each device op of the main path against its plain
  reference at real widths: (a) the frontend correlative core,
  (b) the loop window, (c) the rasterizer, (d) GN refine and covariance
  against the same call on the host CPU, (e) the LM optimizer on the
  reference's final 997-node graph.

``--four-cards`` runs only the multi-device path: ``synth3.clf`` through
``create_default_slam`` with ``create_distributed_backend`` on a 4-device
mesh, compared with the same run on a 1-device mesh, then
``__graft_entry__.dryrun_multichip(4)``.

A phase that fails prints its traceback; the script then exits 1.  Only
when every phase passed is the last line of stdout the JSON object
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

OUT_DIR = REPO / "smoke_out"

# The reference binary on synth3.clf with settings_lm.json
# (h2h/ref_synth3.posegraph.json, h2h/ref_synth3.metric.json).
SYNTH3 = dict(
    log=REPO / "h2h" / "synth3.clf",
    gt=REPO / "h2h" / "synth3_gt.npy",
    settings=REPO / "h2h" / "settings_lm.json",
    ref_graph=REPO / "h2h" / "ref_synth3.posegraph.json",
    keyframes=997,
    loop_ref=366,
    loop_band=10,
    ate_max=0.05,
    ref_final_error=0.125673,
)


def log(msg: str = "") -> None:
    print(msg, flush=True)


def check(ok, what) -> None:
    """A gate that holds under ``python -O`` too (unlike ``assert``)."""
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------- gates --
def pipeline_failures(res: dict, *, keyframes: int, loop_ref: int,
                      loop_band: int, ate_max: float) -> list:
    """What a pipeline run's result (``evaluate_run``) fails of its
    gates: exact keyframe count, loop edges within ``loop_ref`` +-
    ``loop_band``, ATE at most ``ate_max`` metres."""
    out = []
    if res["nodes"] != keyframes:
        out.append(f"keyframes {res['nodes']} != {keyframes}")
    if abs(res["loop_edges"] - loop_ref) > loop_band:
        out.append(
            f"loop edges {res['loop_edges']} outside {loop_ref} +- {loop_band}"
        )
    if not res["ate_m"] <= ate_max:
        out.append(f"ATE {res['ate_m']:.4f} m > {ate_max} m")
    return out


def mesh_pair_failures(one: dict, four: dict, *, ate_max: float = 0.05,
                       loop_rel: float = 0.05, ate_diff: float = 0.01) -> list:
    """Gates of the 4-device run against the 1-device run: equal
    keyframes, loop edges within ``loop_rel`` of each other, each ATE at
    most ``ate_max`` and the two within ``ate_diff``."""
    out = []
    if one["nodes"] != four["nodes"]:
        out.append(f"keyframes {four['nodes']} (4 dev) != {one['nodes']} (1 dev)")
    hi = max(one["loop_edges"], four["loop_edges"], 1)
    if abs(one["loop_edges"] - four["loop_edges"]) > loop_rel * hi:
        out.append(
            f"loop edges {four['loop_edges']} (4 dev) vs "
            f"{one['loop_edges']} (1 dev) differ by more than {loop_rel:.0%}"
        )
    for name, r in (("1 dev", one), ("4 dev", four)):
        if not r["ate_m"] <= ate_max:
            out.append(f"ATE {r['ate_m']:.4f} m ({name}) > {ate_max} m")
    if abs(one["ate_m"] - four["ate_m"]) > ate_diff:
        out.append(f"ATEs differ by more than {ate_diff} m")
    return out


def evaluate_run(pg_path, gt_path) -> dict:
    """Keyframes, local maps, loop edges and ATE of a written pose graph,
    read as ``scripts/head_to_head.py`` reads it."""
    from head_to_head import evaluate

    return evaluate(Path(pg_path), np.load(gt_path))


# ------------------------------------------------------------ utilities --
class CompileClock:
    """Seconds and count of XLA backend compiles, from JAX's monitoring
    events (``/jax/core/compile/backend_compile_duration``)."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        import jax

        self.seconds = 0.0
        self.count = 0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event == self.EVENT:
            self.seconds += duration
            self.count += 1


def card_line() -> str:
    """``name, power.limit`` of every card, from a child that stays off
    JAX."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip()


def peak_bytes(dev) -> int:
    return int(dev.memory_stats()["peak_bytes_in_use"])


def _gib(n: int) -> str:
    return f"{n / 2**30:.3f} GiB"


# --------------------------------------------------------------- phases --
def device_phase(want: int) -> dict:
    import jax

    devs = jax.devices()
    log(f"jax {jax.__version__} devices: {devs}")
    d0 = devs[0]
    log(f"platform {d0.platform}, device_kind {d0.device_kind}, "
        f"count {len(devs)}")
    if d0.platform != "gpu":
        log(f"no GPU found: JAX's default platform is {d0.platform!r}")
        raise SystemExit(2)
    if len(devs) < want:
        log(f"need {want} GPUs, found {len(devs)}")
        raise SystemExit(2)
    log(f"card (name, power limit): {card_line()}")
    return dict(platform=d0.platform, kind=d0.device_kind, count=len(devs))


def pipeline_phase(clock: CompileClock) -> dict:
    """The CLI launcher on synth3.clf at its defaults."""
    import jax

    from my_lidar_graph_slam_v2_tpu.pipeline import launcher

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    prefix = OUT_DIR / "synth3"
    argv = [str(SYNTH3["log"]), str(SYNTH3["settings"]), str(prefix)]
    c0, n0 = clock.seconds, clock.count
    t0 = time.perf_counter()
    rc = launcher.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"launcher exited {rc}")
    res = evaluate_run(f"{prefix}.posegraph.json", SYNTH3["gt"])
    compile_s = clock.seconds - c0
    peak = peak_bytes(jax.devices()[0])
    log(f"pipeline synth3: keyframes {res['nodes']}, local maps "
        f"{res['local_maps']}, loop edges {res['loop_edges']} "
        f"(reference 366), ATE {res['ate_m']:.4f} m (reference 0.1116)")
    log(f"pipeline synth3: wall {wall:.1f} s, of which XLA compile "
        f"{compile_s:.1f} s in {clock.count - n0} compiles, "
        f"peak device memory {_gib(peak)}")
    bad = pipeline_failures(
        res, keyframes=SYNTH3["keyframes"], loop_ref=SYNTH3["loop_ref"],
        loop_band=SYNTH3["loop_band"], ate_max=SYNTH3["ate_max"],
    )
    check(not bad, "; ".join(bad))
    return dict(res, wall_s=wall, compile_s=compile_s, peak_bytes=peak)


def _bench_batch(batch=8):
    """The bench.py workload (1024^2 u8 latest maps, 512-beam scans),
    stacked into a batch."""
    import jax.numpy as jnp

    import bench

    cases = bench.build_workload()
    sel = [cases[i % len(cases)] for i in range(batch)]
    args = (
        jnp.stack([c[0].prob for c in sel]),
        jnp.stack([c[0].observed for c in sel]),
        jnp.stack([c[1].ranges for c in sel]),
        jnp.stack([c[1].angles for c in sel]),
        jnp.stack([c[1].mask for c in sel]),
        jnp.asarray(np.stack([c[2] for c in sel]).astype(np.float32)),
        jnp.asarray(np.stack([np.asarray(c[0].offset_xy)
                              for c in sel]).astype(np.float32)),
    )
    return cases, sel, args


def _sweeps_both_ways(cfg):
    """Per case: hit images and coarse/fine scores by the int8 path and by
    the exact bf16 path, on the same u8 map (production shapes)."""
    import jax
    import jax.numpy as jnp

    from my_lidar_graph_slam_v2_tpu.ops import csm, pool

    wx, wy = cfg.win_cells
    nbx, nby = cfg.blocks
    LR = cfg.low_resolution
    nxf, nyf = nbx * LR, nby * LR
    T = cfg.n_theta_max

    def one(p, o, r, a, m, sp, off):
        step_t, t0i, tmask = csm.theta_search_params(
            r, m, cfg.resolution, cfg.range_theta, T)
        hr, hc, valid, r0, c0 = csm.beam_cells(
            r, a, m, sp, t0i, step_t, tmask, cfg.resolution, off,
            n_theta=T, crop_rows=cfg.crop_rows, crop_cols=cfg.crop_cols)
        kw = dict(crop_rows=cfg.crop_rows, crop_cols=cfg.crop_cols)
        hit8 = csm.build_hit_images(hr, hc, valid, tmask, dtype=jnp.int8, **kw)
        hitb = csm.build_hit_images(hr, hc, valid, tmask, **kw)
        x0, y0 = jnp.int32(-wx), jnp.int32(-wy)
        in_rows = cfg.crop_rows + (nby - 1) * LR
        in_cols = cfg.crop_cols + (nbx - 1) * LR
        seg = csm.sweep_input_window(
            p, o, r0, c0, x0, y0, in_rows=in_rows + LR - 1,
            in_cols=in_cols + LR - 1, precision=cfg.precision)
        coarse_inp = pool.sliding_window_max2d(seg, LR)[:, :in_rows, :in_cols]
        rc = jnp.sum(valid & tmask[:, None], axis=1).astype(jnp.float32)
        c8 = csm.sweep_from_hits_int8(hit8, rc, coarse_inp,
                                      nx=nbx, ny=nby, stride=LR)
        cb = csm.sweep_from_hits(hitb, r0, c0, p, o, x0, y0, nx=nbx, ny=nby,
                                 stride=LR, precision=cfg.precision,
                                 precut_inp=coarse_inp)
        fine_inp = csm.sweep_input_window(
            p, o, r0, c0, x0, y0, in_rows=cfg.crop_rows + nyf - 1,
            in_cols=cfg.crop_cols + nxf - 1, precision=cfg.precision)
        f8 = csm.sweep_from_hits_int8(hit8, rc, fine_inp,
                                      nx=nxf, ny=nyf, stride=1)
        fb = csm.sweep_from_hits(hitb, r0, c0, p, o, x0, y0, nx=nxf, ny=nyf,
                                 stride=1, precision=cfg.precision)
        return hit8, hitb, c8, cb, f8, fb, coarse_inp, fine_inp

    return jax.jit(jax.vmap(one))


def _exact_window_scores(hit, inp, ny, nx, stride):
    """Exact window sweep in float64 NumPy (integer sums below 2**53):
    ``[n, 2, T, ny, nx]`` scores as float32 of sum * float32(1/255), the
    rounding both device paths apply."""
    n, T, cr, cc = hit.shape
    out = np.zeros((n, 2, T, ny, nx), np.float64)
    for b in range(n):
        h = hit[b].reshape(T, -1).astype(np.float64)
        for j in range(ny):
            for i in range(nx):
                patch = inp[b, :, j * stride:j * stride + cr,
                            i * stride:i * stride + cc]
                out[b, :, :, j, i] = (
                    h @ patch.reshape(2, -1).astype(np.float64).T).T
    return (out.astype(np.float32) * np.float32(1.0 / 255.0)).astype(
        np.float64)


def _core_batch(cfg, dense=False, thresholds=(0.0, 0.0)):
    import jax
    import jax.numpy as jnp

    from my_lidar_graph_slam_v2_tpu.matching.correlative import (
        _correlative_core,
    )
    from my_lidar_graph_slam_v2_tpu.ops import pool

    def one(p, o, r, a, m, sp, off):
        cp = pool.sliding_window_max2d(p, cfg.low_resolution)
        co = pool.sliding_window_max2d(o, cfg.low_resolution)
        return _correlative_core(
            cfg, p, o, cp, co, r, a, m, sp, off,
            jnp.float32(thresholds[0]), jnp.float32(thresholds[1]),
            dense=dense,
        )

    return jax.jit(jax.vmap(one))


def _oracle_pose(case, pose, cfg):
    """Winner of utils/oracle.correlative_search_oracle (the reference's
    loop nest, float64 NumPy) on one case."""
    from my_lidar_graph_slam_v2_tpu.grid.geometry import GridGeometry
    from my_lidar_graph_slam_v2_tpu.ops import quant
    from my_lidar_graph_slam_v2_tpu.utils import oracle

    raster, arrays = case[0], case[1]
    fine = np.asarray(quant.dequant_prob(raster.prob), np.float64)
    win = cfg.low_resolution
    # Sliding-window max anchored at each cell (edge-repeat at the end),
    # the coarse map of grid_map_builder.cpp:917-1065
    coarse = fine
    for axis in (0, 1):
        pad = [(0, 0), (0, 0)]
        pad[axis] = (0, win - 1)
        padded = np.pad(coarse, pad, mode="edge")
        n = coarse.shape[axis]
        coarse = np.max(
            [np.take(padded, np.arange(k, k + n), axis=axis)
             for k in range(win)], axis=0)
    rows, cols = fine.shape
    off = np.asarray(raster.offset_xy, np.float64)
    geom = GridGeometry(cfg.resolution, rows, cols, off[0], off[1])
    n = arrays.num_valid
    best, *_ = oracle.correlative_search_oracle(
        fine, coarse, geom,
        np.asarray(arrays.ranges, np.float64)[:n],
        np.asarray(arrays.angles, np.float64)[:n],
        np.asarray(pose, np.float64),
        cfg.range_x, cfg.range_y, cfg.range_theta, cfg.low_resolution,
    )
    return best


def kernel_frontend(tol_pose=1e-4, batch=8, n_oracle=3,
                    tol_bf16=1e-6) -> None:
    """(a) The frontend correlative core at bench shapes (crop 320,
    n_theta_max 176, 512 beams, batch 8).

    The int8 sweeps must equal the exact integer sums bit for bit.  The
    bf16 sweeps on u8 maps multiply exact integers too, but XLA:GPU does
    not keep them exact in every fusion (the coarse sweep on an H100 is
    off by f32 rounding, up to 6.1e-5), so they get ``tol_bf16``."""
    import jax

    from my_lidar_graph_slam_v2_tpu.matching.correlative import (
        CorrelativeConfig,
    )

    cfg = CorrelativeConfig(n_theta_max=176, crop_rows=320, crop_cols=320)
    cases, sel, args = _bench_batch(batch)
    hit8, hitb, c8, cb, f8, fb, cin, fin = jax.device_get(
        _sweeps_both_ways(cfg)(*args))
    np.testing.assert_array_equal(hit8.astype(np.int32),
                                  hitb.astype(np.int32))
    LR = cfg.low_resolution
    bad = []
    for name, x8, xb, inp, stride, n in (
        ("coarse", c8, cb, cin, LR, len(sel)),
        ("fine", f8, fb, fin, 1, 2),
    ):
        ny, nx = x8[0].shape[-2:]
        exact = _exact_window_scores(hit8[:n], inp[:n], ny, nx, stride)
        for label, got, rtol in (("int8", x8, 0.0), ("bf16", xb, tol_bf16)):
            got = np.stack([got[0][:n], got[1][:n]], 1).astype(np.float64)
            err = np.abs(got - exact) / np.maximum(np.abs(exact), 1e-30)
            n_diff = int((got != exact).sum())
            log(f"(a) {name} sweep, {label} path vs exact integer sums "
                f"({n} cases): {n_diff} of {got.size} scores differ, max "
                f"relative error {err.max():.3g} (allowed {rtol})")
            if err.max() > rtol:
                bad.append(f"{name}/{label}")
    check(not bad, bad)
    log(f"(a) hit images {hit8.shape}: int8 and bf16 counts equal")

    out_i8 = jax.device_get(_core_batch(cfg)(*args))
    out_bf = jax.device_get(
        _core_batch(dataclasses.replace(cfg, coarse_int8=False))(*args))
    out_ga = jax.device_get(
        _core_batch(dataclasses.replace(cfg, sweep_backend="gather"))(*args))
    np.testing.assert_array_equal(out_i8[0], out_bf[0])
    np.testing.assert_allclose(out_i8[1], out_bf[1], rtol=tol_bf16)
    np.testing.assert_allclose(out_i8[0], out_ga[0], rtol=0, atol=tol_pose)
    log(f"(a) full core, batch {len(sel)}: int8 == bf16 (same pose, score "
        f"within rtol {tol_bf16}), == gather sweep (pose within "
        f"{tol_pose}); exact flags {out_i8[8].tolist()}")
    for i in range(n_oracle):
        want = _oracle_pose(cases[i], sel[i][2], cfg)
        np.testing.assert_allclose(out_i8[0][i], want, rtol=0, atol=tol_pose)
    log(f"(a) == utils/oracle.correlative_search_oracle on {n_oracle} cases "
        f"(pose within {tol_pose}; f32 device vs f64 oracle)")


def kernel_loop_window(tol_pose=1e-4, batch=4) -> None:
    """(b) The loop window (2.5 m, crop 448, n_theta_max 208): block-pruned
    and chunked sweeps against the dense re-run and the gather sweep."""
    import jax

    from my_lidar_graph_slam_v2_tpu.matching.correlative import (
        CorrelativeConfig,
    )

    cfg = CorrelativeConfig(range_x=2.5, range_y=2.5, range_theta=0.5,
                            n_theta_max=208, crop_rows=448, crop_cols=448)
    _, sel, args = _bench_batch(batch)
    # Start the search away from the true pose, as a loop candidate does
    kick = np.array([0.6, -0.45, 0.12], np.float32)
    args = args[:5] + (args[5] + kick[None],) + args[6:]
    thr = (0.55, 0.6)  # the loop detector's score and known-rate gates
    pruned = jax.device_get(_core_batch(cfg, thresholds=thr)(*args))
    dense = jax.device_get(
        _core_batch(cfg, dense=True, thresholds=thr)(*args))
    gather = jax.device_get(_core_batch(
        dataclasses.replace(cfg, sweep_backend="gather"), dense=True,
        thresholds=thr)(*args))
    check(dense[3].all(), f"loop window found no pose: {dense[3]}")
    exact = pruned[8]
    np.testing.assert_allclose(pruned[0][exact], dense[0][exact],
                               rtol=0, atol=tol_pose)
    np.testing.assert_allclose(dense[0], gather[0], rtol=0, atol=tol_pose)
    np.testing.assert_allclose(dense[1], gather[1], rtol=1e-5)
    log(f"(b) loop window, {len(sel)} cases: block-pruned == dense chunked "
        f"on the {int(exact.sum())} certified cases (pose within "
        f"{tol_pose}), dense == gather (pose within {tol_pose}, score "
        f"rtol 1e-5); winners found {dense[3].tolist()}")


def kernel_rasterizer() -> None:
    """(c) Map integration: matmul vs scatter backend, and the Bresenham
    oracle, at 512 beams x 768 samples on a 1024^2 map."""
    import jax.numpy as jnp

    from my_lidar_graph_slam_v2_tpu.grid import values as gv
    from my_lidar_graph_slam_v2_tpu.grid.builder import GridMapBuilderConfig
    from my_lidar_graph_slam_v2_tpu.grid.geometry import GridGeometry
    from my_lidar_graph_slam_v2_tpu.ops import rasterize
    from my_lidar_graph_slam_v2_tpu.utils import oracle

    bcfg = GridMapBuilderConfig()
    H = W = 1024
    B, K = 512, 768
    rng = np.random.default_rng(3)
    angles = np.linspace(-np.pi, np.pi, B, endpoint=False)
    ranges = rng.uniform(0.5, 15.0, B)
    sensor = np.array([0.312, -0.207])
    hits = np.stack([sensor[0] + ranges * np.cos(angles),
                     sensor[1] + ranges * np.sin(angles)], -1)
    off = np.float32([-25.6, -25.6])
    common = (
        (H, W), jnp.asarray(sensor, jnp.float32),
        jnp.asarray(hits, jnp.float32), jnp.ones(B, bool), 0.05,
        jnp.asarray(off),
    )

    def delta(backend, lh, lm):
        return np.asarray(rasterize.scan_delta(
            *common, lh, lm, num_samples=K, backend=backend,
            crop=bcfg.rasterize_crop))

    # Miss counts (hit weight 0, miss weight 1): integers, equal exactly
    cm, cs = delta("matmul", 0.0, 1.0), delta("scatter", 0.0, 1.0)
    np.testing.assert_array_equal(cm, cs)
    lh, lm = bcfg.logodds_hit, bcfg.logodds_miss
    dm, ds = delta("matmul", lh, lm), delta("scatter", lh, lm)
    np.testing.assert_allclose(dm, ds, rtol=1e-5, atol=1e-6)
    log(f"(c) rasterizer 512 beams x 768 samples, 1024^2: matmul == scatter "
        f"miss counts exactly ({int(cm.sum())} misses, up to "
        f"{int(cm.max())} in one cell), log-odds deltas within rtol 1e-5 "
        f"(k*w vs k additions of w)")

    geom = GridGeometry(0.05, H, W, float(off[0]), float(off[1]))
    vals = np.zeros((H, W), np.uint16)
    oracle.integrate_scan_oracle(vals, geom, sensor, hits,
                                 gv.prob_to_odds(bcfg.probability_hit),
                                 gv.prob_to_odds(bcfg.probability_miss))
    prob_ref = gv.value_to_prob(vals)
    prob_dev = np.where(dm != 0.0, 1.0 / (1.0 + np.exp(-dm)), 0.0)
    ref_known, dev_known = prob_ref != 0.0, prob_dev != 0.0
    mismatch = float(np.mean(ref_known != dev_known))
    both = ref_known & dev_known
    err = np.abs(prob_ref[both] - prob_dev[both])
    check(mismatch < 0.01, mismatch)
    check(np.quantile(err, 0.99) < 0.05 and err.mean() < 0.005, err.mean())
    log(f"(c) vs Bresenham u16 oracle: known-cell mismatch {mismatch:.5f} "
        f"(< 0.01), |dp| p99 {np.quantile(err, 0.99):.4f} (< 0.05), mean "
        f"{err.mean():.5f} (< 0.005) -- the bounds of tests/test_rasterize.py")


def kernel_gn(tol_pose=1e-5, tol_cov=1e-3, batch=8) -> None:
    """(d) GN refine and covariance on the card (f32, HIGHEST) against the
    same call on the host CPU."""
    import jax

    from my_lidar_graph_slam_v2_tpu.ops import gauss_newton

    _, sel, args = _bench_batch(batch)
    kick = np.array([0.02, -0.015, 0.01], np.float32)
    args = args[:5] + (args[5] + kick[None],) + args[6:]

    def refine(p, o, r, a, m, sp, off):
        return gauss_newton.gn_refine(p, o, r, a, m, sp, 0.05, off,
                                      max_iterations=10,
                                      convergence_threshold=1e-4,
                                      initial_lambda=1e-4)

    def cov(p, o, r, a, m, sp, off):
        return gauss_newton.covariance(p, o, r, a, m, sp, 0.05, off, 1e4)

    cpu = jax.devices("cpu")[0]
    f_ref, f_cov = jax.jit(jax.vmap(refine)), jax.jit(jax.vmap(cov))
    pose_g, cost_g, it_g = jax.device_get(f_ref(*args))
    host_args = jax.device_put(args, cpu)
    pose_c, cost_c, it_c = jax.device_get(f_ref(*host_args))
    np.testing.assert_allclose(pose_g, pose_c, rtol=0, atol=tol_pose)
    at = args[:5] + (jax.numpy.asarray(pose_c),) + args[6:]
    cov_g = np.asarray(f_cov(*at))
    cov_c = np.asarray(f_cov(*jax.device_put(at, cpu)))
    rel = (np.linalg.norm(cov_g - cov_c, axis=(1, 2))
           / np.linalg.norm(cov_c, axis=(1, 2)))
    check((rel <= tol_cov).all(), rel)
    log(f"(d) GN refine, batch {len(sel)}: GPU vs CPU pose max |d| "
        f"{np.abs(pose_g - pose_c).max():.2e} (<= {tol_pose} m / rad), "
        f"iterations {it_g.tolist()} vs {it_c.tolist()}; covariance "
        f"relative Frobenius error max {rel.max():.2e} (<= {tol_cov})")


def robust_error_f64(mp, sp, edges, loss) -> float:
    """ComputeTotalError (pose_graph_optimizer_lm.cpp:418-452) in float64
    NumPy, with the unclipped information matrices."""
    mi, si, _, rel, info = edges
    s, e_ = np.asarray(mp, np.float64)[mi], np.asarray(sp, np.float64)[si]
    st, ct = np.sin(s[:, 2]), np.cos(s[:, 2])
    d = e_ - s
    x = ct * d[:, 0] + st * d[:, 1] - rel[:, 0]
    y = -st * d[:, 0] + ct * d[:, 1] - rel[:, 1]
    t = d[:, 2] - rel[:, 2]
    t = np.arctan2(np.sin(t), np.cos(t))
    e = np.stack([x, y, t], -1)
    chi2 = np.einsum("ei,eij,ej->e", e, info, e)
    return float(np.sum(np.asarray(loss.loss(chi2), np.float64)))


def kernel_optimizer(tol=1e-3) -> None:
    """(e) The production f32 LM optimizer re-optimizing the reference's
    final 997-node graph, on the card and on the host CPU."""
    import jax

    from head_to_head import load_reference_graph
    from my_lidar_graph_slam_v2_tpu.graph.optimizer import (
        OptimizerConfig,
        PoseGraphOptimizer,
    )

    mp, sp, edges = load_reference_graph(SYNTH3["ref_graph"])
    ref = SYNTH3["ref_final_error"]

    def run(cfg, device=None):
        opt = PoseGraphOptimizer(cfg)
        with jax.default_device(device or jax.devices()[0]):
            mp2, sp2, stats = opt.optimize(mp, sp, edges)
        return stats["error"], robust_error_f64(mp2, sp2, edges, cfg.loss)

    cfg = OptimizerConfig()
    err_g, f64_g = run(cfg)
    err_c, f64_c = run(cfg, jax.devices("cpu")[0])
    err_d, f64_d = run(dataclasses.replace(cfg, precision="default"))
    log(f"(e) LM on the reference's final graph ({len(mp)} maps, {len(sp)} "
        f"scans, {len(edges[0])} edges): robust total error GPU {err_g:.6f}, "
        f"CPU {err_c:.6f}, reference FinalError {ref}; float64 re-evaluation "
        f"of the solutions GPU {f64_g:.6f}, CPU {f64_c:.6f}")
    log(f"(e) default matmul precision (TF32 allowed) on the GPU: robust "
        f"total error {err_d:.6f}, float64 re-evaluation {f64_d:.6f}")
    check(abs(err_g - err_c) <= tol * abs(err_c), (err_g, err_c))
    check(abs(err_g - ref) <= tol * ref, (err_g, ref))


# ---------------------------------------------------------- four cards --
def _run_slam_on_mesh(n_devices: int) -> dict:
    import jax

    from my_lidar_graph_slam_v2_tpu.io.carmen import read_carmen_log
    from my_lidar_graph_slam_v2_tpu.io import map_saver
    from my_lidar_graph_slam_v2_tpu.parallel.mesh import make_mesh
    from my_lidar_graph_slam_v2_tpu.pipeline.factory import (
        create_default_slam,
        create_distributed_backend,
    )
    from my_lidar_graph_slam_v2_tpu.sensor.data import ScanData

    mesh = make_mesh(n_devices)
    scans = [r for r in read_carmen_log(str(SYNTH3["log"]))
             if isinstance(r, ScanData)]
    slam = create_default_slam(
        backend=create_distributed_backend(mesh, inline=False))
    t0 = time.perf_counter()
    slam.start_backend()
    for scan in scans:
        slam.process_scan(scan, scan.odom_pose)
    slam.stop_backend()
    wall = time.perf_counter() - t0
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    pg_path = OUT_DIR / f"synth3_mesh{n_devices}.posegraph.json"
    map_saver.save_pose_graph(slam.pose_graph, str(pg_path))
    res = evaluate_run(pg_path, SYNTH3["gt"])
    peaks = [peak_bytes(d) for d in jax.devices()[:n_devices]]
    log(f"mesh {n_devices} ({[str(d) for d in mesh.devices.ravel()]}): "
        f"keyframes {res['nodes']}, loop edges {res['loop_edges']}, ATE "
        f"{res['ate_m']:.4f} m, wall {wall:.1f} s, peak memory per device "
        f"{[_gib(p) for p in peaks]}")
    return dict(res, wall_s=wall, peaks=peaks)


def four_card_phase() -> None:
    import jax

    import __graft_entry__

    before = [peak_bytes(d) for d in jax.devices()[:4]]
    four = _run_slam_on_mesh(4)
    # Devices 1..3 serve only the sharded loop batch and the sharded LM,
    # so their memory use shows that the shards landed there.
    grew = [p > b for p, b in zip(four["peaks"], before)]
    log(f"shards on devices 1-3: peak memory grew {grew[1:]}")
    check(all(grew[1:]), "sharded backend never used devices 1-3")
    one = _run_slam_on_mesh(1)
    bad = mesh_pair_failures(one, four)
    check(not bad, "; ".join(bad))
    __graft_entry__.dryrun_multichip(4)
    log("__graft_entry__.dryrun_multichip(4) ok")


# ----------------------------------------------------------------- main --
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device backend on 4 GPUs")
    args = ap.parse_args(argv)

    if not (REPO / "my_lidar_graph_slam_v2_tpu").is_dir():
        log(f"{REPO} holds no my_lidar_graph_slam_v2_tpu package: run "
            f"chip_smoke.py from the repository checkout")
        return 2
    dev = device_phase(4 if args.four_cards else 1)
    from my_lidar_graph_slam_v2_tpu.utils import jaxcache

    cache = Path(jaxcache.enable())
    n_cached = len(list(cache.iterdir())) if cache.exists() else 0
    log(f"persistent compile cache {cache}: {n_cached} entries at start"
        f"{' (cold)' if n_cached == 0 else ''}")
    clock = CompileClock()
    if args.four_cards:
        phases = [("four cards", four_card_phase)]
    else:
        phases = [
            ("pipeline", lambda: pipeline_phase(clock)),
            ("(a) frontend core", kernel_frontend),
            ("(b) loop window", kernel_loop_window),
            ("(c) rasterizer", kernel_rasterizer),
            ("(d) GN refine", kernel_gn),
            ("(e) LM optimizer", kernel_optimizer),
        ]
    failed = []
    for name, fn in phases:
        log(f"--- phase {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            traceback.print_exc(file=sys.stdout)
            failed.append(name)
        log(f"--- phase {name}: {'FAILED' if name in failed else 'ok'} "
            f"in {time.perf_counter() - t0:.1f} s")
    log(f"XLA compiles in this process: {clock.count}, {clock.seconds:.1f} s")
    log(f"card (name, power limit): {card_line()}")
    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    log(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
