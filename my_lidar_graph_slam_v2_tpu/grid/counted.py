"""Counting-cell occupancy raster (hit count / observation count).

Device equivalent of the reference's ``GridCounted`` cell family
(``grid_map_new/grid_counted.{hpp,cpp}``): each cell stores the number of
hits and the number of observations, and its occupancy probability is
their ratio ``p = hits / counts`` (``GridCounted::UpdateUnchecked``,
``grid_counted.cpp:286-305``), encoded through the same u16 value codec
as the Bayes cells (``grid/values.py``: 0 = unknown, [1, 65535] linear
over [0.001, 0.999] with saturation).

The reference builds this type but its live pipeline never instantiates
it (the builder uses GridBinaryBayes throughout); it is provided here for
cell-family completeness.  Design is device-first regardless: updates are
batched scatter-adds over ``[N]`` index arrays (one fused device op per
scan batch) instead of per-cell calls, and the u16/u8/probability views
are dense vectorized conversions.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import values as gv


class GridCounted:
    """Fixed-extent counting raster.

    State lives as two device ``int32`` planes (hits, counts); the u16
    value plane of the reference is a derived view (:meth:`values_u16`),
    not stored — recomputing it is one fused elementwise op, cheaper on
    device than keeping three planes coherent per scatter.
    """

    def __init__(self, rows: int, cols: int):
        self.rows = rows
        self.cols = cols
        self.hits = jnp.zeros((rows, cols), jnp.int32)
        self.counts = jnp.zeros((rows, cols), jnp.int32)

    # ------------------------------------------------------------------
    def reset(self):
        """``GridCounted::ResetValues`` — all cells back to unknown."""
        self.hits = jnp.zeros_like(self.hits)
        self.counts = jnp.zeros_like(self.counts)

    def update(self, rows_idx, cols_idx, hit, valid=None):
        """Batched observation update (``GridCounted::Update`` over a
        whole index set): ``counts += 1`` and ``hits += hit`` at each
        (row, col); out-of-raster or invalid entries are dropped.
        Duplicate indices accumulate (scatter-add), matching sequential
        per-cell updates."""
        rows_idx = jnp.asarray(rows_idx, jnp.int32)
        cols_idx = jnp.asarray(cols_idx, jnp.int32)
        hit = jnp.asarray(hit, bool)
        ok = (
            (rows_idx >= 0) & (rows_idx < self.rows)
            & (cols_idx >= 0) & (cols_idx < self.cols)
        )
        if valid is not None:
            ok = ok & jnp.asarray(valid, bool)
        r = jnp.where(ok, rows_idx, 0)
        c = jnp.where(ok, cols_idx, 0)
        inc = ok.astype(jnp.int32)
        self.counts = self.counts.at[r, c].add(inc, mode="drop")
        self.hits = self.hits.at[r, c].add(
            inc * hit.astype(jnp.int32), mode="drop"
        )

    # ------------------------------------------------------------------
    def prob(self):
        """f32 probability plane, unknown (never observed) = 0.0."""
        p = self.hits.astype(jnp.float32) / jnp.maximum(
            self.counts.astype(jnp.float32), 1.0
        )
        return jnp.where(self.counts > 0, p, jnp.float32(gv.UNKNOWN_PROB))

    @property
    def observed(self):
        return self.counts > 0

    def values_u16(self):
        """u16 value plane through the shared codec
        (``GridCounted::ProbabilityToValue``, grid_counted.cpp:332-346):
        0 for unknown, clamped linear code otherwise."""
        p = self.prob()
        v = gv.VALUE_MIN + (p - gv.PROB_MIN) * (
            (gv.VALUE_MAX - gv.VALUE_MIN) / (gv.PROB_MAX - gv.PROB_MIN)
        )
        v = jnp.clip(jnp.round(v), gv.VALUE_MIN, gv.VALUE_MAX)
        return jnp.where(
            self.counts > 0, v, jnp.float32(gv.UNKNOWN_VALUE)
        ).astype(jnp.uint16)

    def values_u8(self):
        """u8 view = value >> 8 (``GridCounted::CopyValuesU8``)."""
        return (self.values_u16() >> 8).astype(jnp.uint8)

    def memory_usage(self) -> int:
        """Device bytes held (two int32 planes; the reference also keeps
        a stored u16 plane — ``InspectMemoryUsage``, counted.cpp:308-324
        — which is a derived view here)."""
        return int(self.hits.size * 4 + self.counts.size * 4)
