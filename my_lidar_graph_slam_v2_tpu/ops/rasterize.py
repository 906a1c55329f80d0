"""Scan -> occupancy-map integration on device.

Device replacement for the reference's per-beam subpixel Bresenham +
sequential odds updates (``grid_map_builder.cpp:390-494``,
``bresenham.cpp:58+``). Design (SURVEY.md section 7, hard part 1):

* Maps are ``[H, W]`` f32 **log-odds** rasters plus a bool observed mask
  (see ``grid/values.py`` for the codec contract).  In log-odds the binary
  Bayes update is additive, so a whole scan becomes ONE ``scatter-add`` of
  per-sample deltas followed by a dense clip — no per-cell read-modify-write
  loop.
* Free-space cells are found by sampling ``K`` points uniformly along each
  beam (fixed shape ``[B, K]``) instead of data-dependent Bresenham walks.
  Consecutive-duplicate samples are masked so each beam contributes at most
  one miss per traversed cell, matching the reference's one-update-per-
  beam-per-cell semantics; the hit cell is excluded from misses and gets
  one hit update (``grid_map_builder.cpp:455-470``).
* Scans in a batch are integrated sequentially (``lax.fori_loop``) with a
  per-scan clip to [logodds(0.001), logodds(0.999)], reproducing the u16
  codec's saturation behaviour.

Sampling density: spacing along a beam is ``range / K``; with the default
``K`` this is below half a cell for all usable ranges, so no traversed cell
is skipped except occasional corner grazes (validated against the NumPy
Bresenham oracle in tests/test_rasterize.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..grid import values as gv

DEFAULT_SAMPLES_PER_BEAM = 768


@functools.partial(
    jax.jit,
    static_argnames=("num_samples", "backend", "crop", "chunk",
                     "return_oob"),
)
def integrate_scans(
    logodds: jax.Array,  # [H, W] f32
    observed: jax.Array,  # [H, W] bool
    sensor_xy: jax.Array,  # [S, 2] f32 map-local sensor positions
    hits_xy: jax.Array,  # [S, B, 2] f32 map-local hit points
    hit_mask: jax.Array,  # [S, B] bool (valid beams, already range-filtered)
    resolution: float,
    offset_xy: jax.Array,  # [2] f32 raster offset (map-local)
    logodds_hit: float,
    logodds_miss: float,
    num_samples: int = DEFAULT_SAMPLES_PER_BEAM,
    backend: str = "scatter",
    crop: int | None = None,
    chunk: int = 2048,
    return_oob: bool = False,
):
    """Integrate S scans (sequentially) into the raster. Returns updated
    (logodds, observed), plus — with ``return_oob`` — the i32 count of
    valid HIT endpoints that fell outside the raster extent (computed on
    device so the host never re-derives cells just to count them; the
    caller accumulates the device scalar and fetches it lazily).

    ``backend`` selects how the per-sample miss updates reach the raster:

    * ``"scatter"`` — one ``scatter-add`` of all samples.
    * ``"matmul"`` — the free-space count image is built by matmuls as a
      sum of one-hot outer products (same trick as the CSM hit images,
      ops/csm.py): per sample chunk, ``onehot_rows^T @ onehot_cols`` over
      a ``crop x crop`` window anchored at the scan's sample bounding box.
      Counts are exact (0/1 bf16 operands, f32 accumulation); the count
      image is scaled by ``logodds_miss`` afterwards, so no bf16 rounding
      of the update weights.  ``crop`` must cover one scan's sample bbox
      (2 * usable_range / resolution + margin); it defaults to the full
      raster.  Hit-cell updates (<= B per scan) stay a scatter.
    """
    if not (
        sensor_xy.shape[0] == hits_xy.shape[0] == hit_mask.shape[0]
        and hits_xy.shape[1] == hit_mask.shape[1]
    ):
        raise ValueError(
            f"inconsistent scan batch: sensor {sensor_xy.shape}, "
            f"hits {hits_xy.shape}, mask {hit_mask.shape}"
        )
    h, w = logodds.shape
    res = jnp.float32(resolution)
    off = offset_xy.astype(jnp.float32)

    def cell_of(p):  # p: [..., 2] -> (row, col) int32
        rc = jnp.floor((p - off) / res).astype(jnp.int32)
        return rc[..., 1], rc[..., 0]

    def one_scan(i, carry):
        lo, obs = carry
        delta = _delta_impl(
            h, w, sensor_xy[i], hits_xy[i], hit_mask[i], res, off,
            logodds_hit, logodds_miss, num_samples, backend,
            crop if crop is not None else max(h, w), chunk,
        )
        return _apply_delta(lo, obs, delta)

    n_scans = sensor_xy.shape[0]
    logodds, observed = jax.lax.fori_loop(
        0, n_scans, one_scan, (logodds, observed)
    )
    if not return_oob:
        return logodds, observed
    hit_rc = jnp.floor((hits_xy - off) / res).astype(jnp.int32)
    hit_r, hit_c = hit_rc[..., 1], hit_rc[..., 0]
    oob = hit_mask & ~(
        (hit_r >= 0) & (hit_r < h) & (hit_c >= 0) & (hit_c < w)
    )
    return logodds, observed, jnp.sum(oob).astype(jnp.int32)


def _apply_delta(lo, obs, delta):
    """One sequential Bayes step: add a scan's log-odds delta and clip —
    the u16 codec's per-scan saturation behaviour."""
    touched = delta != 0.0
    # Unknown cells act as log-odds 0 (p=0.5) on first observation
    new_lo = jnp.where(obs, lo, 0.0) + delta
    new_lo = jnp.clip(new_lo, gv.LOGODDS_MIN, gv.LOGODDS_MAX)
    lo = jnp.where(touched | obs, jnp.where(touched, new_lo, lo), lo)
    obs = obs | touched
    return lo, obs


def _delta_impl(h, w, s_xy, h_xy, mask, res, off, logodds_hit, logodds_miss,
                num_samples, backend, crop, chunk):
    """Raw (pre-clip) log-odds delta image of ONE scan."""

    def cell_of(p):  # p: [..., 2] -> (row, col) int32
        rc = jnp.floor((p - off) / res).astype(jnp.int32)
        return rc[..., 1], rc[..., 0]

    d = h_xy - s_xy[None, :]  # [B, 2]
    # Sample positions along each beam, excluding the endpoint region
    t = (jnp.arange(num_samples, dtype=jnp.float32) + 0.5) / num_samples
    pts = s_xy[None, None, :] + d[:, None, :] * t[None, :, None]  # [B,K,2]
    rows, cols = cell_of(pts)  # [B, K]
    hit_r, hit_c = cell_of(h_xy)  # [B]

    # One miss per traversed cell per beam: drop consecutive duplicates
    same_as_prev = jnp.zeros(rows.shape, dtype=bool)
    same_as_prev = same_as_prev.at[:, 1:].set(
        (rows[:, 1:] == rows[:, :-1]) & (cols[:, 1:] == cols[:, :-1])
    )
    is_hit_cell = (rows == hit_r[:, None]) & (cols == hit_c[:, None])
    inside = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    miss_valid = mask[:, None] & ~same_as_prev & ~is_hit_cell & inside

    if backend == "scatter":
        delta = jnp.zeros((h, w), dtype=jnp.float32)
        delta = delta.at[rows, cols].add(
            jnp.where(miss_valid, jnp.float32(logodds_miss), 0.0),
            mode="drop",
        )
    else:
        delta = _miss_counts_matmul(
            rows, cols, miss_valid, h, w, crop, chunk,
        ) * jnp.float32(logodds_miss)
    hit_inside = (
        mask & (hit_r >= 0) & (hit_r < h) & (hit_c >= 0) & (hit_c < w)
    )
    delta = delta.at[hit_r, hit_c].add(
        jnp.where(hit_inside, jnp.float32(logodds_hit), 0.0),
        mode="drop",
    )
    return delta


@functools.partial(
    jax.jit, static_argnames=("shape", "num_samples", "backend", "crop",
                              "chunk")
)
def scan_delta(
    shape,  # (H, W) static
    sensor_xy: jax.Array,  # [2]
    hits_xy: jax.Array,  # [B, 2]
    hit_mask: jax.Array,  # [B]
    resolution: float,
    offset_xy: jax.Array,  # [2]
    logodds_hit: float,
    logodds_miss: float,
    num_samples: int = DEFAULT_SAMPLES_PER_BEAM,
    backend: str = "scatter",
    crop: int | None = None,
    chunk: int = 2048,
):
    """Raw (pre-clip) log-odds delta image of one scan — the cacheable
    unit of the incremental latest-map maintenance (grid/builder.py):
    ``integrate_scans`` over a window == sequential ``_apply_delta`` of the
    per-scan deltas, so deltas can be cached per scan node and re-folded
    in O(window) dense ops instead of re-rasterized."""
    h, w = shape
    return _delta_impl(
        h, w, sensor_xy, hits_xy, hit_mask, jnp.float32(resolution),
        offset_xy.astype(jnp.float32), logodds_hit, logodds_miss,
        num_samples, backend, crop if crop is not None else max(h, w), chunk,
    )


def fold_shifted_deltas_impl(deltas, shifts, valid, *, max_shift: int):
    """Un-jitted fold body — call this from INSIDE larger jitted
    computations (e.g. the single-dispatch fused frontend matcher);
    a nested jit would be an XLA call boundary that blocks fusion."""
    S, H, W = deltas.shape
    p = max_shift
    lo = jnp.zeros((H, W), jnp.float32)
    obs = jnp.zeros((H, W), bool)

    def step(i, carry):
        lo, obs = carry
        dr = jnp.clip(shifts[i, 0], -p, p)
        dc = jnp.clip(shifts[i, 1], -p, p)
        padded = jnp.pad(deltas[i], ((p, p), (p, p)))
        shifted = jax.lax.dynamic_slice(padded, (p - dr, p - dc), (H, W))
        shifted = jnp.where(valid[i], shifted, 0.0)
        return _apply_delta(lo, obs, shifted)

    return jax.lax.fori_loop(0, S, step, (lo, obs))


@functools.partial(jax.jit, static_argnames=("max_shift",))
def fold_shifted_deltas(
    deltas: jax.Array,  # [S, H, W] raw per-scan deltas (own anchors)
    shifts: jax.Array,  # [S, 2] i32 (dr, dc): latest[r, c] = delta[r-dr, c-dc]
    valid: jax.Array,  # [S] bool
    *,
    max_shift: int,
):
    """Sequential Bayes fold of per-scan delta images into a fresh raster,
    translating each delta by an integer cell shift first (the latest-map
    and delta rasters share axis orientation; anchors are cell-quantized).
    Shifts beyond ``max_shift`` are clipped — the caller must fall back to
    a full rebuild in that case."""
    return fold_shifted_deltas_impl(deltas, shifts, valid, max_shift=max_shift)


def _miss_counts_matmul(rows, cols, valid, h, w, crop, chunk):
    """Free-space visit counts as chunked one-hot matmuls.

    ``rows/cols/valid``: [B, K] per-sample cells.  Returns an [h, w] f32
    count image.  The one-hot operands live over a ``crop x crop`` window
    anchored at the (valid-)sample bounding box so the contraction stays
    small; the window is clamped inside the raster, and the caller
    guarantees ``crop`` covers a scan's spread (see integrate_scans).
    """
    cr = min(crop, h)
    cc = min(crop, w)
    big = jnp.int32(1 << 30)
    r0 = jnp.clip(
        jnp.min(jnp.where(valid, rows, big)), 0, max(h - cr, 0)
    )
    c0 = jnp.clip(
        jnp.min(jnp.where(valid, cols, big)), 0, max(w - cc, 0)
    )
    rr = jnp.where(valid, rows - r0, -1).reshape(-1)
    cc_idx = jnp.where(valid, cols - c0, -1).reshape(-1)
    n = rr.shape[0]
    n_chunks = max(1, (n + chunk - 1) // chunk)
    pad = n_chunks * chunk - n
    if pad:
        rr = jnp.pad(rr, (0, pad), constant_values=-1)
        cc_idx = jnp.pad(cc_idx, (0, pad), constant_values=-1)
    rr = rr.reshape(n_chunks, chunk)
    cc_idx = cc_idx.reshape(n_chunks, chunk)
    iota_r = jnp.arange(cr, dtype=jnp.int32)
    iota_c = jnp.arange(cc, dtype=jnp.int32)

    def step(acc, rc):
        r, c = rc
        onehot_rT = (iota_r[:, None] == r[None, :]).astype(jnp.bfloat16)
        onehot_c = (c[:, None] == iota_c[None, :]).astype(jnp.bfloat16)
        acc = acc + jax.lax.dot_general(
            onehot_rT,
            onehot_c,
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        return acc, None

    counts_crop, _ = jax.lax.scan(
        step, jnp.zeros((cr, cc), jnp.float32), (rr, cc_idx)
    )
    out = jnp.zeros((h, w), jnp.float32)
    return jax.lax.dynamic_update_slice(out, counts_crop, (r0, c0))


@jax.jit
def prob_map(logodds: jax.Array, observed: jax.Array) -> jax.Array:
    """Probability raster with 0.0 = unknown (the matching convention of
    ``GridMapInterface::ProbabilityOr``)."""
    return jnp.where(observed, jax.nn.sigmoid(logodds), 0.0)
