#!/usr/bin/env python
"""Benchmark harness: CSM scan-matching throughput on one GPU vs a CPU
baseline.

Headline metric (BASELINE.json): scan matches/sec/chip for the frontend's
local correlative search (0.25 m x 0.25 m x 0.5 rad window at 5 cm
resolution, Intel-like scans) against a 10-scan latest map.  The CPU
baseline is a faithful -O3 C++ implementation of the reference's
coarse-prune + fine-descend algorithm (native/csm_baseline.cpp), run
live on the same host after the device timing, standing in for the
reference's software matcher.

    python bench.py               # prints ONE JSON line
    python bench.py --trace DIR   # device time per stage from one trace

Needs a GPU; on any other platform it exits with an error.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def build_workload(seed=0, n_maps=4):
    """Latest-map rasters + query scans, Intel-like (5 cm, ~300 beams)."""
    import jax.numpy as jnp

    from my_lidar_graph_slam_v2_tpu.datasets import synthetic
    from my_lidar_graph_slam_v2_tpu.grid.builder import (
        GridMapBuilder,
        GridMapBuilderConfig,
    )
    from my_lidar_graph_slam_v2_tpu.matching.types import MapRaster, ScanArrays
    from my_lidar_graph_slam_v2_tpu.sensor.filters import ScanInterpolator

    world = synthetic.World.office(seed=seed, size=16.0)
    traj = synthetic.loop_trajectory(size=16.0, laps=0.3, step=0.5)
    seq = synthetic.generate(world, traj, n_beams=181, max_range=16.0,
                             range_noise=0.01, seed=seed)
    interp = ScanInterpolator(dist_scans=0.05)
    cfg = GridMapBuilderConfig(latest_map_rows=1024, latest_map_cols=1024)
    builder = GridMapBuilder(cfg)

    cases = []
    for i in range(n_maps):
        base = i * 3
        scans = [interp.interpolate(seq.scans[base + k]) for k in range(3)]
        poses = [seq.ground_truth[base + k] for k in range(3)]
        anchor = poses[0]
        lo, obs, off = builder._new_raster(1024, 1024)
        lo, obs = builder._integrate(
            lo, obs, off, anchor, list(zip(poses, scans))
        )
        from my_lidar_graph_slam_v2_tpu.ops import quant

        # Production form: u8-quantized raster (grid/builder.latest_raster)
        raster = MapRaster(quant.quantize_prob(lo, obs), obs, 0.05, off)
        query = interp.interpolate(seq.scans[base + 1])
        r = np.zeros(512, np.float32)
        a = np.zeros(512, np.float32)
        m = np.zeros(512, bool)
        n = min(query.num_scans, 512)
        idx = np.linspace(0, query.num_scans - 1, n).astype(int)
        r[:n] = query.ranges[idx]
        a[:n] = query.angles[idx]
        m[:n] = True
        arrays = ScanArrays(jnp.asarray(r), jnp.asarray(a), jnp.asarray(m),
                            np.zeros(3), n)
        from my_lidar_graph_slam_v2_tpu.core import pose as P

        local_pose = P.inverse_compound(anchor, poses[1])
        cases.append((raster, arrays, np.asarray(local_pose)))
    return cases


# Published dense peaks per device_kind: NVIDIA H100 data sheet (SXM5 at
# 700 W, PCIe at 350 W), without sparsity.  A card below its maximum
# power limit cannot hold these; report nvidia-smi's power.limit beside
# every rate.
PEAKS_SOURCE = "NVIDIA H100 Tensor Core GPU data sheet, dense rates"
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(
        hbm_gbps=3350.0, bf16_tflops=989.0, int8_tops=1979.0,
        tf32_tflops=495.0,
    ),
    "NVIDIA H100 PCIe": dict(
        hbm_gbps=2000.0, bf16_tflops=756.0, int8_tops=1513.0,
        tf32_tflops=378.0,
    ),
}


def device_peaks(device_kind: str) -> dict:
    """Published peaks of one device kind; an unknown kind is an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device_kind {device_kind!r}; add it "
            f"to bench.PEAKS with its source"
        ) from None


def card_line() -> str:
    """``name, power.limit`` of the cards, from nvidia-smi (a child that
    stays off JAX)."""
    import subprocess

    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip()


def frontend_core(**overrides):
    """The jitted vmapped frontend correlative core at bench shapes
    (``overrides``: CorrelativeConfig fields to change)."""
    import jax
    import jax.numpy as jnp

    from my_lidar_graph_slam_v2_tpu.matching.correlative import (
        CorrelativeConfig,
        _correlative_core,
    )

    # crop 320: the reference FPGA's map-window contract
    # (scan_matcher_correlative_fpga.cpp:484-527 stages <=320^2 BRAM
    # blocks); beams outside the window are dropped from the score same
    # as there.  1.44x fewer patch/hit bytes than the old 384 crop.
    # n_theta_max 176: the static bound on this workload's theta window
    # (max_range 16 m -> step 2*asin(res/2R) = 3.125 mrad -> win_t = 80
    # -> 161 candidate rows; 176 leaves margin).  The window is FULLY
    # covered — this trims only all-masked padding rows from the hit
    # matrix, exactly like sizing the CPU baseline's loops to its window.
    cfg = CorrelativeConfig(n_theta_max=176, crop_rows=320, crop_cols=320,
                            **overrides)

    def single(prob, observed, ranges, angles, mask, sensor_pose, offset_xy):
        # coarse maps None -> pool-on-crop inside the core (the per-call
        # ComputeCoarserMap analog, restricted to the swept window)
        return _correlative_core(
            cfg, prob, observed, None, None, ranges, angles, mask,
            sensor_pose, offset_xy, jnp.float32(0.0), jnp.float32(0.0),
        )

    return cfg, jax.jit(jax.vmap(single))


def stage_batch(cases, batch):
    """A batch of the prepared cases staged on the device."""
    import jax.numpy as jnp

    sel = [cases[i % len(cases)] for i in range(batch)]
    prob = jnp.stack([c[0].prob for c in sel])
    obs = jnp.stack([c[0].observed for c in sel])
    ranges = jnp.stack([c[1].ranges for c in sel])
    angles = jnp.stack([c[1].angles for c in sel])
    mask = jnp.stack([c[1].mask for c in sel])
    poses = jnp.asarray(np.stack([c[2] for c in sel]).astype(np.float32))
    offs = jnp.asarray(
        np.stack([np.asarray(c[0].offset_xy) for c in sel]).astype(np.float32)
    )
    return prob, obs, ranges, angles, mask, poses, offs


def bench_device(cases, iters=20, batch=8, with_stages=True):
    """Device throughput: matches are dispatched as vmapped batches (the
    production sharded path, parallel/loop_sharded.py) with inputs staged
    on device.

    The per-batch work includes the coarse-map precompute, the coarse +
    fine window sweeps, and cost/covariance at the winner (everything
    ``ScanMatcherCorrelative::OptimizePose`` does per call)."""
    import jax

    cfg, batched = frontend_core()
    prob, obs, ranges, angles, mask, poses, offs = stage_batch(cases, batch)
    out = batched(prob, obs, ranges, angles, mask, poses, offs)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = batched(prob, obs, ranges, angles, mask, poses, offs)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    rate = iters * batch / dt

    stages = (
        bench_stages(
            cfg, prob, obs, ranges, angles, mask, poses, offs, batch, iters
        )
        if with_stages else None
    )
    return rate, stages, out


def _time_jit(fn, iters, *args):
    import jax

    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def bench_stages(cfg, prob, obs, ranges, angles, mask, poses, offs,
                 batch, iters):
    """Per-stage device time (ms per batch) via timed jitted prefixes of
    the production (hit-image matmul) matcher pipeline; stage cost =
    difference of adjacent prefixes.  Also emits the HBM roofline for the
    sweeps (BASELINE.json target #1, "speed-of-light HBM bandwidth per
    chip"): the dominant HBM traffic of the patch-matmul formulation is
    the materialized map-patch matrices (one crop-sized row per window
    offset) plus the hit images, so bytes-per-case is computed from
    those and achieved GB/s is reported against the device's peak."""
    import jax
    import jax.numpy as jnp

    from my_lidar_graph_slam_v2_tpu.ops import csm, gauss_newton, pool

    wx, wy = cfg.win_cells
    nbx, nby = cfg.blocks
    nxf, nyf = nbx * cfg.low_resolution, nby * cfg.low_resolution
    T = cfg.n_theta_max
    K = cfg.fine_theta_k if 0 < cfg.fine_theta_k < T else T

    def prefix(depth):
        # Each prefix RETURNS its real intermediate arrays (device-side,
        # not fetched).  Scalar-sum accumulators must not be used here:
        # XLA's algebraic simplifier rewrites sum(dot(A, B)) into
        # dot(sum A, sum B) and similar, silently deleting the very work
        # being timed (burned us in round 4 — probes read 0.03 ms for a
        # 2.6 ms stage).
        def one(p, o, r, a, m, sp, off):
            step_t, t0i, tmask = csm.theta_search_params(
                r, m, cfg.resolution, cfg.range_theta, T)
            hr, hc, valid, r0, c0 = csm.beam_cells(
                r, a, m, sp, t0i, step_t, tmask, cfg.resolution, off,
                n_theta=T, crop_rows=cfg.crop_rows, crop_cols=cfg.crop_cols)
            # int8 hit images + int8 coarse sweep: the production u8-map
            # path (matching/correlative.py use_int8)
            hit = csm.build_hit_images(
                hr, hc, valid, tmask,
                crop_rows=cfg.crop_rows, crop_cols=cfg.crop_cols,
                dtype=jnp.int8)
            if depth == 0:
                return hit
            x0, y0 = jnp.int32(-wx), jnp.int32(-wy)
            # pool-on-crop (production: _correlative_core with
            # coarse_prob=None)
            win = cfg.low_resolution
            in_rows = cfg.crop_rows + (nby - 1) * win
            in_cols = cfg.crop_cols + (nbx - 1) * win
            seg = csm.sweep_input_window(
                p, o, r0, c0, x0, y0,
                in_rows=in_rows + win - 1, in_cols=in_cols + win - 1,
                precision=cfg.precision)
            pooled = pool.sliding_window_max2d(seg, win)
            coarse_inp = pooled[:, :in_rows, :in_cols]
            if depth == 1:
                # return hit too: otherwise DCE deletes the hit build from
                # this prefix and the stage difference goes negative
                return hit, coarse_inp
            row_counts = jnp.sum(
                valid & tmask[:, None], axis=1
            ).astype(jnp.float32)
            cs, ck = csm.sweep_from_hits_int8(
                hit, row_counts, coarse_inp,
                nx=nbx, ny=nby, stride=cfg.low_resolution)
            if depth == 2:
                return cs, ck
            # Mirror the production top-K theta prune (matching/
            # correlative.py): fine-sweep only the K thetas with the
            # largest coarse upper bound.
            if K < T:
                bound = jnp.max(
                    jnp.where(tmask[:, None, None], cs, -jnp.inf),
                    axis=(1, 2),
                )
                _, sel = jax.lax.top_k(bound, K)
                hit_sel = jnp.take(hit, sel, axis=0)
                rc_sel = jnp.take(row_counts, sel, axis=0)
            else:
                hit_sel, rc_sel = hit, row_counts
            # int8 fine sweep (production fine_int8 path)
            fine_inp = csm.sweep_input_window(
                p, o, r0, c0, x0, y0,
                in_rows=cfg.crop_rows + nyf - 1,
                in_cols=cfg.crop_cols + nxf - 1,
                precision=cfg.precision)
            fs, fk = csm.sweep_from_hits_int8(
                hit_sel, rc_sel, fine_inp, nx=nxf, ny=nyf, stride=1)
            if depth == 3:
                return fs, fk, cs, ck
            # Data-dependent winner pose keeps the chain live
            win = sp.at[0].add(0.001 * jnp.max(fs))
            cost = gauss_newton.cost(
                p, o, r, a, m, win, cfg.resolution, off)
            cov = gauss_newton.covariance(
                p, o, r, a, m, win, cfg.resolution, off,
                cfg.covariance_scale)
            return fs, cost, cov

        return jax.jit(jax.vmap(one))

    args = (prob, obs, ranges, angles, mask, poses, offs)
    t = [_time_jit(prefix(d), iters, *args) for d in range(5)]

    def refine(p, o, r, a, m, sp, off):
        return gauss_newton.gn_refine(
            p, o, r, a, m, sp, cfg.resolution, off,
            max_iterations=10, convergence_threshold=1e-4,
            initial_lambda=1e-4)

    t_gn = _time_jit(jax.jit(jax.vmap(refine)), iters, *args)

    ms = lambda x: round(1e3 * x, 3)
    stages = {
        "hit_images": ms(t[0]),
        "coarse_pool_crop": ms(t[1] - t[0]),
        "coarse_sweep": ms(t[2] - t[1]),
        "fine_sweep": ms(t[3] - t[2]),
        "cost_cov": ms(t[4] - t[3]),
        "gn_refine_10it": ms(t_gn),
        "full_core": None,  # filled by caller from the end-to-end rate
    }

    # ---- HBM roofline for the sweeps -----------------------------------
    # Patch-matmul traffic model per case: each window offset
    # materializes a (2, crop^2) map patch (written once, read once by
    # the matmul), the hit images are written once and read once per
    # sweep, and the score grids are tiny.  u8 maps take the exact
    # single-pass bf16 path (patches bf16: 2 bytes/el); f32 "split" takes
    # two bf16 passes.
    kcrop = cfg.crop_rows * cfg.crop_cols
    parts = 1 if prob.dtype == jnp.uint8 else (
        2 if cfg.precision == "split" else 1)
    # u8 maps: int8 hit images (1 B/el, written by the build and read by
    # the int8 coarse matmul); fine patches + selected hit rows in bf16
    esz_hit = 1 if prob.dtype == jnp.uint8 else 2
    patch_bytes = lambda n_off, esz: 2 * n_off * 2 * kcrop * esz * parts
    hit_bytes = 2 * T * kcrop * esz_hit  # write + read
    # u8 maps: BOTH sweeps in int8 matmuls (1 B/el patches + hit rows)
    bytes_fine = (
        patch_bytes(nxf * nyf, esz_hit) + 2 * K * kcrop * esz_hit
    )
    bytes_coarse = patch_bytes(nbx * nby, esz_hit) + hit_bytes
    hbm_bytes = bytes_fine + bytes_coarse
    sweep_time = t[3] - t[1]  # coarse + fine sweep per batch
    achieved_gbps = (
        batch * hbm_bytes / sweep_time / 1e9 if sweep_time > 0 else None
    )
    peak_gbps = device_peaks(jax.devices()[0].device_kind)["hbm_gbps"]
    roofline = dict(
        hbm_bytes_per_case=hbm_bytes,
        hbm_achieved_gbps=round(achieved_gbps, 1) if achieved_gbps else None,
        hbm_peak_spec_gbps=peak_gbps,
        hbm_peak_source=PEAKS_SOURCE,
        utilization_vs_spec=(
            round(achieved_gbps / peak_gbps, 4) if achieved_gbps else None
        ),
        note=(
            "bytes = materialized map-patch matrices + hit images of the "
            "two sweeps; to go faster, move FEWER bytes (offset pruning, "
            "narrower patches), not schedule better"
        ),
    )
    return dict(stages_ms_per_batch=stages, batch=batch,
                sweep_roofline=roofline)


def bench_cpu(cases, iters=3):
    from my_lidar_graph_slam_v2_tpu.native import (
        cpu_correlative_search,
        cpu_precompute_coarse,
    )

    prepared = []
    for raster, arrays, pose in cases:
        fine = np.asarray(raster.prob).astype(np.float32)
        if raster.prob.dtype == np.uint8 or fine.max() > 1.5:
            fine /= 255.0
        n = arrays.num_valid
        ranges = np.asarray(arrays.ranges)[:n]
        angles = np.asarray(arrays.angles)[:n]
        max_range = ranges.max()
        tt = 0.05 / max_range
        step_theta = float(np.arccos(1.0 - 0.5 * tt * tt))
        win_t = int(np.ceil(0.25 / step_theta))
        prepared.append((fine, ranges, angles, pose, step_theta, win_t,
                         np.asarray(raster.offset_xy)))
    t0 = time.perf_counter()
    count = 0
    for _ in range(iters):
        for fine, ranges, angles, pose, step_theta, win_t, off in prepared:
            # Coarse precompute is part of the reference's per-call work
            # (ComputeCoarserMap, scan_matcher_correlative.cpp:104)
            coarse = cpu_precompute_coarse(fine, 5)
            cpu_correlative_search(
                fine, coarse, ranges, angles, pose, 0.05, off,
                3, 3, win_t, step_theta, 5,
            )
            count += 1
    dt = time.perf_counter() - t0
    return count / dt


def hlo_op_names(compiled) -> dict:
    """HLO instruction name -> JAX op_name (with its name-scope path) from
    a compiled executable's optimized HLO text."""
    import re

    pat = re.compile(r'\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]*)"')
    out = {}
    for line in compiled.as_text().splitlines():
        m = pat.match(line)
        if m:
            out[m.group(1)] = m.group(2)
    return out


def device_times(trace_dir, scopes, names=None):
    """Device time per named scope from a jax.profiler trace.

    Sums the durations of the kernels on every GPU plane's compute-stream
    lines; a kernel belongs to the first of ``scopes`` that appears in its
    op_name in ``names`` (``hlo_op_names``; the op's JAX name-scope
    path), its ``hlo_op`` or its name.  Also returns the busy time (union
    of kernel intervals) and the window.  Kernels launched inside a CUDA
    graph carry no op names, so trace with command buffers off (see
    ``trace_frontend``)."""
    import glob

    from jax.profiler import ProfileData

    (path,) = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                        recursive=True)
    names = names or {}
    per = {k: 0 for k in scopes}
    per["other"] = 0
    ops = {}
    spans = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                stats = dict(ev.stats)
                hlo = stats.get("hlo_op", ev.name)
                label = f"{names.get(hlo, '')} {hlo} {ev.name}"
                key = next((k for k in scopes if k in label), "other")
                per[key] += ev.duration_ns
                op = f"{key}:{hlo}"
                ops[op] = ops.get(op, 0) + ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = (spans[-1][1] - spans[0][0]) if spans else 0
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:25]
    return dict(per_scope_ns=per, busy_ns=busy, window_ns=window,
                top_ops_ns=top)


def trace_frontend(cases, trace_dir, batch=8, iters=10, **overrides):
    """Trace ``iters`` batches of the frontend core; returns device ms per
    batch for each stage scope (matching/correlative.py)."""
    import jax

    _, batched = frontend_core(**overrides)
    args = stage_batch(cases, batch)
    names = hlo_op_names(batched.lower(*args).compile())
    jax.block_until_ready(batched(*args))
    with jax.profiler.trace(trace_dir):
        for _ in range(iters):
            out = batched(*args)
        jax.block_until_ready(out)
    scopes = ("csm_hit_images", "csm_coarse_sweep", "csm_fine_sweep",
              "csm_winner_cost_cov")
    t = device_times(trace_dir, scopes, names)
    ms = lambda ns: ns / iters / 1e6
    return dict(
        batch=batch,
        iters=iters,
        device_ms_per_batch={k: ms(v) for k, v in t["per_scope_ns"].items()},
        busy_ms_per_batch=ms(t["busy_ns"]),
        window_ms_per_batch=ms(t["window_ns"]),
        top_ops_ms_per_batch=[(n, ms(v)) for n, v in t["top_ops_ns"]],
    )


def main():
    import jax

    if "--trace" in sys.argv:
        # One kernel launch per op (no CUDA graphs), so the trace names
        # every kernel's op; must be set before the backend starts.
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_gpu_enable_command_buffer="
        ).strip()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX's platform is {dev.platform!r}")
    from my_lidar_graph_slam_v2_tpu.utils import jaxcache

    jaxcache.enable()
    card = card_line()
    cases = build_workload()
    if "--trace" in sys.argv:
        trace_dir = sys.argv[sys.argv.index("--trace") + 1]
        # The production core (int8 coarse sweep), then the bf16 variant
        for name, ov in (("int8", {}), ("bf16", dict(coarse_int8=False))):
            t = trace_frontend(cases, os.path.join(trace_dir, name), **ov)
            print(json.dumps(dict(t, variant=name, card=card,
                                  device_kind=dev.device_kind,
                                  xla_flags=os.environ["XLA_FLAGS"])))
        return
    device_peaks(dev.device_kind)  # fail early on an unknown device
    rate, stages, _ = bench_device(cases)
    stages["stages_ms_per_batch"]["full_core"] = round(
        1e3 * stages["batch"] / rate, 3
    )
    rate16, _, _ = bench_device(cases, iters=12, batch=16, with_stages=False)
    # The native CPU baseline runs after the device timing, in-process,
    # on the same host.
    cpu_rate = bench_cpu(cases)
    result = {
        "metric": "csm_scan_matches_per_sec_per_chip",
        "value": round(rate, 2),
        "unit": "matches/s",
        "vs_baseline": round(rate / cpu_rate, 2),
        "cpu_baseline_live": round(cpu_rate, 2),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "card": card,
        "value_batch16": round(rate16, 2),
        "vs_baseline_batch16": round(rate16 / cpu_rate, 2),
        **stages,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
