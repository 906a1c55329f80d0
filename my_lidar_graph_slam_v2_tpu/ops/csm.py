"""Correlative scan matching (CSM) sweep as dense matrix products.

This is the device replacement for both the reference's software CSM
inner loops (``scan_matcher_correlative.cpp:301-368``) and its FPGA CSM IP
core (``scan_matcher_correlative_fpga.cpp:188-371``): the matching score
over an entire pose search window ``[n_theta, n_y, n_x]`` is produced by
two dense operations instead of per-candidate scalar loops:

1. **Hit-image build** (per theta): each beam's endpoint cell is encoded as
   the outer product of row/column one-hot vectors; summing over beams via
   a batched matmul yields a per-theta "hit count" image.  This is exact in
   bfloat16 (values are small integers) and runs on the matrix units.
2. **Window sweep**: the score at translation offset (dy, dx) is the
   correlation of the hit image with the occupancy-probability crop, i.e. a
   single ``lax.conv`` with the hit images as filters and the (prob,
   observed) planes as a 2-image batch; ``window_strides`` implements the
   coarse-grid stride of the reference's low-resolution pass for free.

Score semantics follow ``score_function_pixel_accurate.cpp:16-58``:
``scores`` is the plain sum of probabilities at known cells (normalize by
the true beam count outside), ``known`` the count of known cells.  Cells
outside the crop contribute unknown (0), exactly like out-of-map lookups.

The caller fixes all shapes statically (beam capacity, crop size, window
extents); data-dependent quantities (theta step, window validity) are
traced values handled by masking.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import quant


def _extract_patches(part, ny, nx, stride, crop_rows, crop_cols):
    """im2col patch matrix ``[planes, ny*nx, crop_r*crop_c]`` from an
    input window ``[planes, in_rows, in_cols]`` — one slice per window
    offset."""
    p = part.shape[0]
    sl = [
        jax.lax.dynamic_slice(
            part, (0,) * (part.ndim - 2) + (j * stride, i * stride),
            (p, crop_rows, crop_cols),
        ).reshape(p, -1)
        for j in range(ny)
        for i in range(nx)
    ]
    return jnp.stack(sl, axis=1)


# NOTE: deliberately NOT @jax.jit — embedded in jitted matcher cores; a
# nested jit is an XLA call boundary that blocks fusion.  Host callers
# wrap it in jax.jit.
def csm_sweep(
    prob: jax.Array,  # [H, W] f32 probability map, 0 = unknown
    observed: jax.Array,  # [H, W] bool
    ranges: jax.Array,  # [B] f32
    angles: jax.Array,  # [B] f32
    beam_mask: jax.Array,  # [B] bool
    sensor_pose: jax.Array,  # [3] f32 map-local sensor pose (search center)
    theta0_index: jax.Array,  # [] i32: t index of the first theta candidate
    step_theta: jax.Array,  # [] f32
    theta_mask: jax.Array,  # [n_theta] bool: candidate validity
    x0: jax.Array,  # [] i32 first x offset (cells)
    y0: jax.Array,  # [] i32 first y offset (cells)
    resolution: float,
    offset_xy: jax.Array,  # [2] f32 raster offset of `prob` (map-local)
    *,
    n_theta: int,
    nx: int,
    ny: int,
    stride: int = 1,
    crop_rows: int = 256,
    crop_cols: int = 256,
    precision: str = "highest",
):
    """Evaluate the CSM score over the pose grid.

    Candidate poses: ``theta_t = pose.theta + (theta0_index + t) * step_theta``
    for ``t in [0, n_theta)``; translation offsets ``(x0 + i*stride,
    y0 + j*stride)`` grid cells for ``i in [0, nx)``, ``j in [0, ny)``.

    Returns ``(scores, known)`` of shape ``[n_theta, ny, nx]`` (f32): the
    summed probability and known-cell count per candidate.
    """
    if precision not in ("fast", "split", "highest"):
        raise ValueError(f"unknown precision {precision!r}")

    hr, hc, valid, r0, c0 = beam_cells(
        ranges, angles, beam_mask, sensor_pose, theta0_index, step_theta,
        theta_mask, resolution, offset_xy,
        n_theta=n_theta, crop_rows=crop_rows, crop_cols=crop_cols,
    )

    hit_img = build_hit_images(
        hr, hc, valid, theta_mask, crop_rows=crop_rows, crop_cols=crop_cols
    )
    return sweep_from_hits(
        hit_img, r0, c0, prob, observed, x0, y0,
        nx=nx, ny=ny, stride=stride, precision=precision,
    )


def beam_cells(
    ranges, angles, beam_mask, sensor_pose, theta0_index, step_theta,
    theta_mask, resolution, offset_xy, *, n_theta, crop_rows, crop_cols,
):
    """Per-(theta, beam) endpoint cells in hit-image coordinates.

    Returns (hr, hc, valid, r0, c0): [T, B] crop coords, validity, and the
    crop anchor in full-map cell coordinates.
    """
    res = jnp.float32(resolution)
    t_idx = theta0_index + jnp.arange(n_theta, dtype=jnp.int32)
    thetas = sensor_pose[2] + t_idx.astype(jnp.float32) * step_theta
    ang = thetas[:, None] + angles[None, :]  # [T, B]
    hx = sensor_pose[0] + ranges[None, :] * jnp.cos(ang)
    hy = sensor_pose[1] + ranges[None, :] * jnp.sin(ang)
    col = jnp.floor((hx - offset_xy[0]) / res).astype(jnp.int32)  # [T, B]
    row = jnp.floor((hy - offset_xy[1]) / res).astype(jnp.int32)

    # Crop anchor: only *valid* (beam, theta) combinations participate in
    # the bbox — padded theta indices can rotate beams far away and would
    # otherwise drag the crop anchor off the real candidates.
    big = jnp.int32(1 << 30)
    bbox_mask = beam_mask[None, :] & theta_mask[:, None]
    masked_row = jnp.where(bbox_mask, row, big)
    masked_col = jnp.where(bbox_mask, col, big)
    # Anchor a touch early so floor-rounding never clips the first beam
    r0 = jnp.min(masked_row) - 2
    c0 = jnp.min(masked_col) - 2

    hr = row - r0  # [T, B] hit-image coords
    hc = col - c0
    valid = (
        beam_mask[None, :]
        & (hr >= 0)
        & (hr < crop_rows)
        & (hc >= 0)
        & (hc < crop_cols)
    )
    return hr, hc, valid, r0, c0


def build_hit_images(hr, hc, valid, theta_mask, *, crop_rows, crop_cols,
                     dtype=jnp.bfloat16):
    """One-hot hit images via batched outer-product matmul.

    One-hot operands are 0/1, and per-cell hit counts stay far below 256,
    so bf16 operands with f32 accumulation are EXACT here — the build
    runs at the bf16 matmul rate regardless of the requested precision.
    Returns ``dtype`` [T, crop_rows, crop_cols] (exact small-integer
    counts).  ``dtype=jnp.int8`` halves the dominant HBM write (the hit
    images are the largest sweep intermediate: T x crop^2); counts above
    127 would wrap, so int8 callers must check ``max count <= 127``
    (matching/correlative.py folds that into its exactness certificate).
    """
    iota_r = jnp.arange(crop_rows, dtype=jnp.int32)
    iota_c = jnp.arange(crop_cols, dtype=jnp.int32)
    onehot_r = (hr[:, :, None] == iota_r[None, None, :]) & valid[:, :, None]
    onehot_c = hc[:, :, None] == iota_c[None, None, :]
    if dtype == jnp.int8:
        oh_r = (
            onehot_r & theta_mask[:, None, None]
        ).astype(jnp.int8)
        oh_c = onehot_c.astype(jnp.int8)
        out = jax.lax.dot_general(
            jnp.swapaxes(oh_r, 1, 2), oh_c,
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.int32,
        )
        return out.astype(jnp.int8)
    onehot_r = (
        onehot_r.astype(jnp.bfloat16)
        * theta_mask[:, None, None].astype(jnp.bfloat16)
    )
    onehot_c = onehot_c.astype(jnp.bfloat16)
    # [T, crop_rows, B] @ [T, B, crop_cols] -> [T, crop_rows, crop_cols]
    return jax.lax.dot_general(
        jnp.swapaxes(onehot_r, 1, 2),
        onehot_c,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.bfloat16,
    )


def sweep_input_window(
    prob, observed, r0, c0, x0, y0,
    *, in_rows, in_cols, precision,
):
    """Extract the ``[2, in_rows, in_cols]`` (prob, observed) window the
    sweep correlates against: ``inp[r, c] = map[r0+y0+r, c0+x0+c]`` with
    zeros (unknown) outside the raster.  u8 maps stay u8 levels with
    ``observed`` as 0/255 (see the exact-bf16 note in
    :func:`sweep_from_hits`); float maps are f32."""
    pad = max(in_rows, in_cols)
    u8_exact = prob.dtype == jnp.uint8 and precision != "highest"
    if u8_exact:
        planes = jnp.stack(
            [prob, observed.astype(jnp.uint8) * jnp.uint8(255)], axis=0
        )
    else:
        planes = jnp.stack(
            [quant.dequant_prob(prob), observed.astype(jnp.float32)], axis=0
        )
    planes = jnp.pad(planes, ((0, 0), (pad, pad), (pad, pad)))
    start_r = jnp.clip(r0 + y0 + pad, 0, planes.shape[1] - in_rows)
    start_c = jnp.clip(c0 + x0 + pad, 0, planes.shape[2] - in_cols)
    return jax.lax.dynamic_slice(
        planes,
        (jnp.int32(0), start_r, start_c),
        (2, in_rows, in_cols),
    )


def _sweep_operands(inp, hit_img, u8_exact, precision):
    """Operands of the score contraction for one precision mode: the map
    window as one or two (hi + lo) parts, the hit images in the matching
    dtype, the score rescale (u8 levels -> probabilities) and the
    contraction precision.  Only the f32 ("highest") mode has f32
    operands, and only it needs HIGHEST (a GPU would otherwise run the
    f32 product as TF32)."""
    if u8_exact:
        return ([inp.astype(jnp.bfloat16)], hit_img, np.float32(1.0 / 255.0),
                jax.lax.Precision.DEFAULT)
    if precision == "highest":
        return ([inp], hit_img.astype(jnp.float32), None,
                jax.lax.Precision.HIGHEST)
    hi = inp.astype(jnp.bfloat16)
    parts = [hi]
    if precision == "split":
        parts.append((inp - hi.astype(jnp.float32)).astype(jnp.bfloat16))
    return parts, hit_img, None, jax.lax.Precision.DEFAULT


def sweep_from_hits(
    hit_img, r0, c0, prob, observed, x0, y0,
    *, nx, ny, stride, precision, precut_inp=None, force_chunked=False,
):
    """Window sweep of precomputed hit images against a map.

    The hit image is the dominant HBM intermediate (T * crop^2); sharing
    it between the coarse and fine sweeps (identical beam geometry) halves
    the build cost — see matching/correlative.py.

    ``precut_inp`` optionally supplies the ``[2, in_rows, in_cols]``
    input window directly (e.g. a pooled-on-crop coarse window,
    matching/correlative.py) — ``prob``/``observed``/``r0``/``c0`` are
    then only used for dtype dispatch.

    ``force_chunked`` takes the chunked patch path for windows of more
    than 256 offsets on the CPU too (where the convolution is otherwise
    used), so the accelerator's path can be tested on a host.
    """
    crop_rows, crop_cols = hit_img.shape[1], hit_img.shape[2]
    # --- conv input: (prob, observed) crop shifted by the window origin --
    in_rows = crop_rows + (ny - 1) * stride
    in_cols = crop_cols + (nx - 1) * stride
    # u8-quantized maps (grid/map_cache.py) take a single-pass bf16
    # path: integers 0..255 are exactly representable in bf16, the
    # one-hot hit counts are exact, and the matmul accumulates in f32, so
    # one bf16 matmul on the raw u8 levels (rescaled by 1/255 afterwards)
    # multiplies exact integers, at half the FLOPs and bytes of the hi+lo
    # split the f32 path needs.  XLA:GPU does not keep every such fusion
    # exact: on an H100 the pooled coarse sweep came out within f32
    # rounding (3.6e-7 relative) of the exact sums, while the int8 path
    # (sweep_from_hits_int8) stays exact -- chip_smoke.py phase (a).
    u8_exact = prob.dtype == jnp.uint8 and precision != "highest"
    if precut_inp is not None:
        inp = precut_inp
    else:
        inp = sweep_input_window(
            prob, observed, r0, c0, x0, y0,
            in_rows=in_rows, in_cols=in_cols, precision=precision,
        )

    # Precision of the score contraction (hit counts are exact in bf16):
    #   u8 map  — exact single bf16 matmul (see above), any precision
    #   fast    — map probs rounded to bf16, one bf16 matmul (~0.4% score
    #             error; fine for coarse gating / loop candidate triage)
    #   split   — probs split hi+lo bf16, two bf16 matmuls: ~f32-accurate
    #             at a fraction of the f32 matmul cost (the default)
    #   highest — f32 operands end-to-end, full-f32 contraction
    #             (oracle/parity tests)
    parts, hit_c, scale, prec = _sweep_operands(
        inp, hit_img, u8_exact, precision
    )

    # The window sweep is expressed as matmuls against explicitly shifted
    # map patches.  Small windows (the frontend hot path) unroll
    # statically into one matmul; large windows run a lax.scan over
    # <=256-offset chunks — one compiled body regardless of window size,
    # with the transient patch matrix held to a few hundred MB.
    T_dim = hit_c.shape[0]
    hit_flat = hit_c.reshape(T_dim, -1)
    n_off = ny * nx

    if n_off > 256 and jax.default_backend() == "cpu" and not force_chunked:
        # XLA:CPU's Eigen-backed conv beats the chunked patch matmul for
        # big windows on host; trace-time backend dispatch.
        out = None
        for part in parts:
            o = jax.lax.conv_general_dilated(
                part[:, None, :, :],  # [2, 1, in_rows, in_cols]
                hit_c[:, None, :, :],  # [T, 1, crop_rows, crop_cols]
                window_strides=(stride, stride),
                padding="VALID",
                dimension_numbers=("NCHW", "OIHW", "NCHW"),
                precision=prec,
                preferred_element_type=jnp.float32,
            )  # [2, T, ny, nx]
            out = o if out is None else out + o
        if scale is not None:
            out = out * scale
        return out[0], out[1]

    if n_off <= 256:
        out = None
        for part in parts:
            patches = _extract_patches(
                part, ny, nx, stride, crop_rows, crop_cols
            )  # [2, ny*nx, crop_r*crop_c]
            o = jax.lax.dot_general(
                hit_flat,
                patches,
                dimension_numbers=(((1,), (2,)), ((), ())),
                precision=prec,
                preferred_element_type=jnp.float32,
            )  # [T, 2, ny*nx]
            out = o if out is None else out + o
        if scale is not None:
            out = out * scale
        scores = out[:, 0, :].reshape(-1, ny, nx)
        known = out[:, 1, :].reshape(-1, ny, nx)
        return scores, known

    chunk = 256
    n_chunks = (n_off + chunk - 1) // chunk
    jj, ii = jnp.divmod(jnp.arange(n_chunks * chunk, dtype=jnp.int32), nx)
    off_chunks = jnp.stack([jj, ii], -1).reshape(n_chunks, chunk, 2)

    def one_patch(part, j, i):
        return jax.lax.dynamic_slice(
            part, (jnp.int32(0), j * stride, i * stride),
            (2, crop_rows, crop_cols),
        ).reshape(2, -1)

    def chunk_body(_, offs):
        acc = None
        for part in parts:
            patches = jax.vmap(
                lambda j, i: one_patch(part, j, i)
            )(offs[:, 0], offs[:, 1])  # [chunk, 2, K]
            o = jax.lax.dot_general(
                hit_flat,
                patches,
                dimension_numbers=(((1,), (2,)), ((), ())),
                precision=prec,
                preferred_element_type=jnp.float32,
            )  # [T, chunk, 2]
            acc = o if acc is None else acc + o
        return None, acc

    _, outs = jax.lax.scan(chunk_body, None, off_chunks)
    # outs: [n_chunks, T, chunk, 2] -> [T, n_chunks*chunk, 2]
    out = jnp.moveaxis(outs, 0, 1).reshape(T_dim, n_chunks * chunk, 2)
    out = out[:, :n_off, :]
    if scale is not None:
        out = out * scale
    scores = out[:, :, 0].reshape(-1, ny, nx)
    known = out[:, :, 1].reshape(-1, ny, nx)
    return scores, known


def beam_cells_abs(
    ranges, angles, beam_mask, sensor_pose, theta0_index, step_theta,
    theta_mask, resolution, offset_xy, *, n_theta,
):
    """Per-(theta, beam) endpoint cells in MAP cell coordinates.

    Unlike :func:`beam_cells` there is no crop: every valid beam
    participates (the reference evaluates all beams with out-of-map
    lookups reading unknown, ``score_function_pixel_accurate.cpp:16-58``).
    Returns ``(row, col, ok)`` with shape [n_theta, B]; ``ok`` folds beam
    validity and theta-window membership.
    """
    res = jnp.float32(resolution)
    t_idx = theta0_index + jnp.arange(n_theta, dtype=jnp.int32)
    thetas = sensor_pose[2] + t_idx.astype(jnp.float32) * step_theta
    ang = thetas[:, None] + angles[None, :]  # [T, B]
    hx = sensor_pose[0] + ranges[None, :] * jnp.cos(ang)
    hy = sensor_pose[1] + ranges[None, :] * jnp.sin(ang)
    col = jnp.floor((hx - offset_xy[0]) / res).astype(jnp.int32)
    row = jnp.floor((hy - offset_xy[1]) / res).astype(jnp.int32)
    ok = beam_mask[None, :] & theta_mask[:, None]
    return row, col, ok


def sweep_windows(
    prob, observed, row, col, ok, y0, x0,
    *, ny, nx, stride=1,
):
    """CSM score sweep by per-beam window gather.

    ``S[t, j, i] = sum_b prob[row[t,b] + y0 + j*stride,
    col[t,b] + x0 + i*stride]`` over valid beams, with out-of-map cells
    contributing unknown (0) — exactly the reference's per-candidate
    scoring loop (``scan_matcher_correlative.cpp:301-368``) with the
    (theta, beam) axes laid out for the VPU.

    Algorithmically this moves the fewest possible bytes — each window
    cell is read once, vs the matmul path duplicating the map crop per
    window offset (~720 MB of patch traffic per case).  It is the
    semantics oracle of the matmul path (no crop clipping — every beam
    scores, exactly like the reference's per-beam map lookups).  Scores
    are EXACT: u8 maps gather integer levels (exact in bf16, f32
    accumulation), f32 maps contract in full f32.

    Out-of-map semantics come for free from the zero padding: window
    starts are clipped into the padded plane, so a window that hangs off
    the map reads zeros exactly where the reference reads unknown.
    Invalid (beam, theta) pairs are redirected to the all-zero pad corner.

    Returns ``(scores, known)`` f32 ``[T, ny, nx]``.
    """
    ext_y = (ny - 1) * stride + 1
    ext_x = (nx - 1) * stride + 1
    pad = max(ext_y, ext_x)
    u8 = prob.dtype == jnp.uint8
    if u8:
        planes = jnp.stack(
            [prob, observed.astype(jnp.uint8) * jnp.uint8(255)], axis=0
        )
    else:
        planes = jnp.stack(
            [quant.dequant_prob(prob), observed.astype(jnp.float32)], axis=0
        )
    planes = jnp.pad(planes, ((0, 0), (pad, pad), (pad, pad)))
    # Window start per (theta, beam); invalid pairs land in the zero pad.
    sr = jnp.where(ok, row + y0 + pad, 0)
    sc = jnp.where(ok, col + x0 + pad, 0)
    sr = jnp.clip(sr, 0, planes.shape[1] - ext_y)
    sc = jnp.clip(sc, 0, planes.shape[2] - ext_x)

    def win(a, b):
        return jax.lax.dynamic_slice(
            planes, (jnp.int32(0), a, b), (2, ext_y, ext_x)
        )

    w = jax.vmap(jax.vmap(win))(sr, sc)  # [T, B, 2, ext_y, ext_x]
    if stride > 1:
        w = w[..., ::stride, ::stride]
    T_dim, B_dim = row.shape
    wf = w.reshape(T_dim, B_dim, -1)
    # Beam sum as a ones-contraction: keeps the reduction on the matmul
    # path XLA fuses with the gather (a plain jnp.sum over the major beam
    # axis materializes the [T, B, window] intermediate in device memory).
    if u8:
        out = jax.lax.dot_general(
            jnp.ones((B_dim,), jnp.bfloat16), wf.astype(jnp.bfloat16),
            dimension_numbers=(((0,), (1,)), ((), ())),
            precision=jax.lax.Precision.DEFAULT,
            preferred_element_type=jnp.float32,
        ) * np.float32(1.0 / 255.0)
    else:
        out = jax.lax.dot_general(
            jnp.ones((B_dim,), jnp.float32), wf,
            dimension_numbers=(((0,), (1,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
    out = out.reshape(T_dim, 2, ny, nx)
    return out[:, 0], out[:, 1]


def sweep_from_hits_int8(hit_i8, row_counts, inp_u8, *, nx, ny, stride):
    """Strided window sweep in int8 matmul arithmetic — EXACT for u8 maps.

    ``hit_i8``: [T, crop_r, crop_c] int8 hit counts (<= 127, certified by
    the caller via :func:`max_hit_multiplicity`).  ``inp_u8``: the
    [2, in_rows, in_cols] u8 input window (prob levels, observed*255),
    e.g. from :func:`sweep_input_window`.  The map side is centered to
    int8 (v - 128) and the exact offset restored afterwards:

        sum_k hit*v = sum_k hit*(v-128) + 128 * sum_k hit
                    = int8-dot + 128 * row_counts[t]

    with ``row_counts[t] = number of in-crop beams at theta t`` (the
    per-theta hit-image sum, independent of the window offset).  All
    sums stay well inside int32, so scores equal the bf16 path
    bit-for-bit at HALF the hit-image read bytes — the hit images are
    the dominant sweep traffic on the coarse pass (T x crop^2).  Integer
    products are exact at any precision setting.

    Returns ``(scores, known)`` f32 ``[T, ny, nx]``.
    """
    T_dim = hit_i8.shape[0]
    crop_r, crop_c = hit_i8.shape[1], hit_i8.shape[2]
    centered = (inp_u8.astype(jnp.int32) - 128).astype(jnp.int8)
    patches = _extract_patches(
        centered, ny, nx, stride, crop_r, crop_c
    )  # [2, n_off, K]
    out = jax.lax.dot_general(
        hit_i8.reshape(T_dim, -1),
        patches,
        dimension_numbers=(((1,), (2,)), ((), ())),
        preferred_element_type=jnp.int32,
    )  # [T, 2, n_off]
    out = (
        out.astype(jnp.float32) + 128.0 * row_counts[:, None, None]
    ) * np.float32(1.0 / 255.0)
    scores = out[:, 0, :].reshape(T_dim, ny, nx)
    known = out[:, 1, :].reshape(T_dim, ny, nx)
    return scores, known


def max_hit_multiplicity(hr, hc, ok, *, crop_cols):
    """Max number of beams sharing one hit cell at any theta (the int8
    overflow certificate for :func:`sweep_from_hits_int8`): computed from
    the per-(theta, beam) cells directly — sort each theta's cell keys
    and take the longest equal run — so the int32 hit counts never have
    to be materialized just to check them."""
    B = hr.shape[1]
    # invalid beams get unique negative keys so they never form runs
    uniq = -1 - jnp.arange(B, dtype=jnp.int32)[None, :]
    key = jnp.where(ok, hr * jnp.int32(crop_cols) + hc, uniq)
    skey = jnp.sort(key, axis=1)
    same = skey[:, 1:] == skey[:, :-1]  # [T, B-1]
    idx = jnp.arange(1, B, dtype=jnp.int32)[None, :]
    last_break = jax.lax.cummax(
        jnp.where(same, jnp.int32(0), idx), axis=1
    )
    run = jnp.where(same, idx - last_break, 0)
    return jnp.max(run) + 1


def sweep_from_hits_at(
    hit_img, r0, c0, prob, observed, x0, y0, off_ji,
    *, max_j, max_i, precision,
):
    """Window sweep of hit images against a map at an EXPLICIT (traced)
    offset list.

    ``off_ji`` is int32 [n_off, 2]: candidate (j, i) grid offsets in
    cells relative to the window origin ``(y0, x0)`` (same convention as
    :func:`sweep_from_hits` with stride 1, i.e. candidate translation =
    ``(x0 + i, y0 + j)``).  ``max_j``/``max_i`` statically bound the
    offsets (they are clipped).  Used by the top-B block prune of the
    fine sweep (matching/correlative.py): instead of materializing one
    crop-sized map patch per offset of the FULL window (the dominant
    HBM traffic of the matmul formulation), only the offsets of the B
    most promising coarse blocks are evaluated — same per-offset math,
    ~(window/B*blocksize) x fewer bytes.

    Returns ``(scores, known)`` f32 ``[T_rows, n_off]``.
    """
    crop_rows, crop_cols = hit_img.shape[1], hit_img.shape[2]
    in_rows = crop_rows + max_j
    in_cols = crop_cols + max_i
    pad = max(in_rows, in_cols)
    u8_exact = prob.dtype == jnp.uint8 and precision != "highest"
    if u8_exact:
        planes = jnp.stack(
            [prob, observed.astype(jnp.uint8) * jnp.uint8(255)], axis=0
        )
    else:
        planes = jnp.stack(
            [quant.dequant_prob(prob), observed.astype(jnp.float32)], axis=0
        )
    planes = jnp.pad(planes, ((0, 0), (pad, pad), (pad, pad)))
    start_r = jnp.clip(r0 + y0 + pad, 0, planes.shape[1] - in_rows)
    start_c = jnp.clip(c0 + x0 + pad, 0, planes.shape[2] - in_cols)
    inp = jax.lax.dynamic_slice(
        planes, (jnp.int32(0), start_r, start_c), (2, in_rows, in_cols)
    )

    parts, hit_c, scale, prec = _sweep_operands(
        inp, hit_img, u8_exact, precision
    )

    jj = jnp.clip(off_ji[:, 0], 0, max_j)
    ii = jnp.clip(off_ji[:, 1], 0, max_i)
    hit_flat = hit_c.reshape(hit_c.shape[0], -1)

    out = None
    for part in parts:
        patches = jax.vmap(
            lambda j, i: jax.lax.dynamic_slice(
                part, (jnp.int32(0), j, i), (2, crop_rows, crop_cols)
            ).reshape(2, -1)
        )(jj, ii)  # [n_off, 2, crop^2]
        o = jax.lax.dot_general(
            hit_flat,
            patches,
            dimension_numbers=(((1,), (2,)), ((), ())),
            precision=prec,
            preferred_element_type=jnp.float32,
        )  # [T_rows, n_off, 2]
        out = o if out is None else out + o
    if scale is not None:
        out = out * scale
    return out[:, :, 0], out[:, :, 1]


def theta_search_params(ranges, beam_mask, resolution, range_theta, n_theta):
    """Search step and window in theta, per the reference
    (``scan_matcher_correlative.cpp:255-274``): ``step = acos(1 - 0.5 *
    (res / max_range)^2)``, ``win = ceil(0.5 * range_theta / step)``.

    Returns (step_theta, theta0_index, theta_mask[n_theta]) where candidate
    ``t`` has index ``theta0_index + t`` and is valid iff within the window.
    All are traced values; ``n_theta`` bounds the window statically.
    """
    max_range = jnp.max(jnp.where(beam_mask, ranges, 0.0))
    tt = jnp.float32(resolution) / max_range
    # acos(1 - 0.5 t^2) == 2 asin(t / 2); the latter is f32-stable for the
    # tiny arguments involved (the naive form loses ~0.5% at t ~ 2.5e-3)
    step_theta = 2.0 * jnp.arcsin(0.5 * tt)
    win_t = jnp.ceil(0.5 * range_theta / step_theta).astype(jnp.int32)
    half = n_theta // 2
    theta0_index = -jnp.minimum(win_t, half)
    t_idx = theta0_index + jnp.arange(n_theta, dtype=jnp.int32)
    theta_mask = (t_idx >= -win_t) & (t_idx <= win_t)
    return step_theta, theta0_index, theta_mask
