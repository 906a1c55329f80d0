"""Device-resident quantized local-map raster cache.

Device analogue of the reference FPGA matcher's BRAM map cache: the FPGA
skips the (expensive) map transfer whenever the requested local map id
and size match what is already on chip
(``mapping/scan_matcher_correlative_fpga.cpp:254-270,589-646``).  Here
the equivalent contract is an HBM-resident cache keyed by
``(local_map_id, version)``:

* on miss, the f32 log-odds raster is collapsed to a u8 probability
  raster in ONE fused device kernel (ops/quant.py) — 1/4 the HBM bytes,
  and the form in which maps are stacked/shipped during loop-candidate
  fan-out;
* on hit, nothing is computed or moved — the cached u8 array (plus the
  shared observed mask and the per-entry coarse-map dict) is handed back;
* the per-entry ``coarse`` dict makes the matchers' pooled
  sliding-window-max maps stick for the lifetime of the entry, so a
  finished local map is pooled exactly once no matter how many loop
  queries hit it.

Entries are LRU-evicted beyond ``max_entries`` (the BRAM analogue of a
bounded on-chip store).  Hit/miss counters and materialized-bytes series
are exported through the metric registry so cache effectiveness shows up
in ``<out>.metric.json``.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict

import jax.numpy as jnp
import numpy as np

from ..matching.types import MapRaster
from ..ops import quant


@dataclass
class CacheEntry:
    prob_q: Any  # [H, W] u8 device raster
    observed: Any  # [H, W] bool device mask (shared with the LocalMap)
    offset_xy: np.ndarray
    version: int
    nbytes: int
    coarse: Dict = field(default_factory=dict)


class DeviceMapCache:
    """LRU cache of quantized local-map rasters keyed by LocalMapId."""

    def __init__(self, resolution: float = 0.05, max_entries: int = 64,
                 metrics=None):
        from ..metrics.registry import MetricManager

        self.resolution = resolution
        self.max_entries = max_entries
        self._entries: "OrderedDict[int, CacheEntry]" = OrderedDict()
        m = metrics or MetricManager.instance()
        self._m_hits = m.counter("MapCache.Hits")
        self._m_misses = m.counter("MapCache.Misses")
        self._m_evictions = m.counter("MapCache.Evictions")
        self._m_bytes = m.value_sequence("MapCache.MaterializedBytes")
        self._m_resident = m.gauge("MapCache.ResidentBytes")

    # ------------------------------------------------------------------
    def raster(self, local_map) -> MapRaster:
        """Quantized MapRaster for a LocalMap; device work only on miss."""
        key = local_map.local_map_id
        version = getattr(local_map, "version", 0)
        e = self._entries.get(key)
        if e is not None and e.version == version:
            self._entries.move_to_end(key)
            self._m_hits.increment()
        else:
            if getattr(local_map, "logodds", None) is not None:
                prob_q = quant.quantize_prob(
                    local_map.logodds, local_map.observed
                )
                observed = local_map.observed
                offset_xy = local_map.offset_xy
            else:
                # Compacted finished maps (grid/builder LocalMap.compact)
                # and maps carrying a prebuilt raster (tests, external
                # sources); a raster that is already u8 uploads as-is.
                r = local_map.raster(self.resolution)
                prob_q = (
                    r.prob if r.prob.dtype == jnp.uint8
                    else quant.quantize_prob_f32(r.prob)
                )
                observed = r.observed
                offset_xy = r.offset_xy
            h, w = prob_q.shape
            e = CacheEntry(
                prob_q=prob_q,
                observed=observed,
                offset_xy=offset_xy,
                version=version,
                nbytes=h * w,  # u8 plane; the bool mask aliases the map's
            )
            self._entries[key] = e
            self._entries.move_to_end(key)
            self._m_misses.increment()
            self._m_bytes.observe(e.nbytes)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self._m_evictions.increment()
            self._m_resident.set_value(
                float(sum(x.nbytes for x in self._entries.values()))
            )
        return MapRaster(
            e.prob_q, e.observed, self.resolution, e.offset_xy, coarse=e.coarse
        )

    # ------------------------------------------------------------------
    def invalidate(self, local_map_id: int) -> None:
        self._entries.pop(local_map_id, None)

    def clear(self) -> None:
        self._entries.clear()

    @property
    def stats(self) -> dict:
        return dict(
            entries=len(self._entries),
            hits=int(self._m_hits.value),
            misses=int(self._m_misses.value),
            evictions=int(self._m_evictions.value),
        )
