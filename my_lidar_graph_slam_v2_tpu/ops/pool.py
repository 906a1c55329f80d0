"""Sliding-window max pooling for coarse-map precompute.

Device equivalent of the reference's separable monotonic-deque max filter
(``grid_map_builder.cpp:917-1065``, ``util.hpp:370-420``): the coarse map
stores, at each cell, the max over the ``win x win`` window *starting* at
that cell (extending toward higher indices), with shrinking windows at the
high edge.

Implementation: per-axis doubling of shifted maxima — ``O(log win)`` dense
elementwise ``maximum`` ops (``2^k``-wide partial maxima combined as two
overlapping windows), instead of ``lax.reduce_window``, which can evaluate
all ``win^2`` window positions (this formulation needs ~60x fewer ops at
win=5).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _pad_value(dtype):
    if dtype == jnp.bool_:
        return False
    if jnp.issubdtype(dtype, jnp.floating):
        return -jnp.inf
    return jnp.iinfo(dtype).min


def _shift(arr: jax.Array, axis: int, s: int, fill) -> jax.Array:
    """arr shifted s cells toward lower indices along axis, high edge
    filled with ``fill`` (so out[i] = arr[i+s] or fill)."""
    if s == 0:
        return arr
    n = arr.shape[axis]
    sl = [slice(None)] * arr.ndim
    sl[axis] = slice(s, n)
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, s)
    return jnp.pad(arr[tuple(sl)], pad, constant_values=fill)


def _axis_window_max(arr: jax.Array, axis: int, win: int) -> jax.Array:
    """out[i] = max(arr[i:i+win]) along ``axis`` (high edge shrinks)."""
    if win == 1:
        return arr
    fill = _pad_value(arr.dtype)
    # Partial maxima g_k of width 2^k by doubling, then combine the two
    # overlapping 2^k-windows [0, 2^k) and [win - 2^k, win).
    g = arr
    width = 1
    while width * 2 <= win:
        g = jnp.maximum(g, _shift(g, axis, width, fill))
        width *= 2
    if width == win:
        return g
    return jnp.maximum(g, _shift(g, axis, win - width, fill))


# NOTE: deliberately NOT @jax.jit — this op is called inside other jitted
# computations (matcher cores, vmapped batch matchers), and a nested jit
# becomes an XLA call boundary that blocks fusion.  Callers jit at the
# API boundary.
def sliding_window_max2d(arr: jax.Array, win: int) -> jax.Array:
    """out[i, j] = max(arr[i:i+win, j:j+win]) with dtype-min padding
    beyond the high edge."""
    if win == 1:
        return arr
    if arr.dtype == jnp.bool_:
        # bool max == logical or; compute in uint8 to keep XLA on the
        # fast elementwise path, then cast back
        out = sliding_window_max2d(arr.astype(jnp.uint8), win)
        return out.astype(jnp.bool_)
    out = _axis_window_max(arr, arr.ndim - 2, win)
    return _axis_window_max(out, arr.ndim - 1, win)


def pyramid(arr: jax.Array, max_height: int):
    # Plain (un-jitted) for the same fusion reason as sliding_window_max2d
    # above: the branch-and-bound core calls this inside its own jit.
    """Coarse-map pyramid for branch-and-bound: heights 0..max_height with
    window 2^h, all at the original resolution and geometry
    (``PrecomputeGridMaps``, ``grid_map_builder.cpp:986-1012``).

    Level h is built from level h-1 as the max of 4 shifted copies
    (2-D doubling), so the whole pyramid costs one fused op per level.
    """
    if arr.dtype == jnp.bool_:
        return [m.astype(jnp.bool_)
                for m in pyramid(arr.astype(jnp.uint8), max_height)]
    fill = _pad_value(arr.dtype)
    maps = [arr]
    for h in range(1, max_height + 1):
        prev = maps[-1]
        s = 1 << (h - 1)
        row = jnp.maximum(prev, _shift(prev, prev.ndim - 2, s, fill))
        maps.append(jnp.maximum(row, _shift(row, prev.ndim - 1, s, fill)))
    return maps


# Jitted entry points for HOST callers (e.g. per-local-map coarse caches).
# Calling the un-jitted ops above from host code runs them eagerly — each
# elementwise shift/max becomes its own device dispatch, which costs a full
# host<->device round trip per op on remote-attached devices.  Device-side
# callers keep using the plain functions so everything fuses into their jit.
sliding_window_max2d_jit = functools.partial(
    jax.jit, static_argnames=("win",)
)(sliding_window_max2d)

pyramid_jit = functools.partial(
    jax.jit, static_argnames=("max_height",)
)(pyramid)
