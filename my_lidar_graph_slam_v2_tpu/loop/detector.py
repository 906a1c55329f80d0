"""Loop detectors.

Equivalents of the reference's detector family
(``mapping/loop_detector_correlative.cpp``, ``loop_detector_empty.cpp``,
plus the multi-accelerator ``loop_detector_fpga_parallel.cpp`` whose
device fan-out lives in ``parallel/loop_sharded.py``): for each candidate,
match the query scan against the (finished) reference local map over a
wide window with score/known-rate gates, refine with the final matcher,
and emit a loop edge (map-local relative pose + covariance).

The reference caches per-local-map coarse maps (``mPrecompMaps``); here the
coarse rasters are cached on the LocalMap itself (device-resident HBM
arrays — the device analogue of the FPGA's BRAM map cache keyed by
LocalMapId, ``scan_matcher_correlative_fpga.cpp:254-270``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ..core import pose as P
from ..grid.builder import pad_scan
from ..matching.types import ScanArrays, ScanMatchingQuery

import jax.numpy as jnp


@dataclass(frozen=True)
class LoopDetectorConfig:
    score_threshold: float = 0.55
    known_rate_threshold: float = 0.6
    beam_capacity: int = 512
    usable_range_min: float = 0.01
    usable_range_max: float = 20.0


def scan_to_arrays(scan, capacity: int) -> ScanArrays:
    """Padded matching arrays: all (possibly subsampled) beams valid."""
    r, a, _ = pad_scan(scan, capacity, 0.0, np.inf)
    n = min(scan.num_scans, capacity)
    m = np.zeros(capacity, bool)
    m[:n] = True
    return ScanArrays(
        jnp.asarray(r),
        jnp.asarray(a),
        jnp.asarray(m),
        rel_sensor_pose=np.asarray(scan.relative_sensor_pose, np.float64),
        num_valid=n,
        max_range=float(r[:n].max()) if n else 0.0,
    )


class LoopDetectorEmpty:
    """No-op detector (odometry-only mode) — ``loop_detector_empty.cpp``."""

    def detect(self, queries) -> List[dict]:
        return []


class LoopDetectorCorrelative:
    """``LoopDetectorCorrelative::Detect``
    (``loop_detector_correlative.cpp:59-156``)."""

    def __init__(self, cfg: LoopDetectorConfig, scan_matcher, final_scan_matcher,
                 resolution: float = 0.05, map_cache=None,
                 name: str = "LoopDetector.Correlative"):
        from ..grid.map_cache import DeviceMapCache
        from ..metrics.registry import MetricManager

        self.cfg = cfg
        self.scan_matcher = scan_matcher
        self.final_scan_matcher = final_scan_matcher
        self.resolution = resolution
        # HBM-resident quantized raster cache keyed by (map id, version) —
        # the FPGA BRAM cache analogue (grid/map_cache.py)
        self.map_cache = map_cache or DeviceMapCache(resolution)
        # Reference series (loop_detector_correlative.cpp:17-35);
        # PrecompMapMemoryUsage reports the cache's resident HBM bytes
        # (quantized raster + coarse pools), the analogue of the
        # reference's precomputed-map stack bytes
        vs = MetricManager.instance().value_sequence
        self._m_setup_time = vs(f"{name}.InputSetupTime")
        self._m_detection_time = vs(f"{name}.LoopDetectionTime")
        self._m_num_queries = vs(f"{name}.NumOfQueries")
        self._m_num_detections = vs(f"{name}.NumOfDetections")
        self._m_precomp_memory = vs(f"{name}.PrecompMapMemoryUsage")

    def detect(self, queries) -> List[dict]:
        import time as _time

        results = []
        for q in queries:
            t0 = _time.perf_counter()
            scan_node = q["query_node"]
            local_map = q["local_map"]
            map_node = q["local_map_node"]
            assert local_map.finished, "loop detection against unfinished map"

            raster = self.map_cache.raster(local_map)
            map_local_pose = P.inverse_compound(
                map_node.global_pose, scan_node.global_pose
            )
            arrays = scan_to_arrays(scan_node.scan_data, self.cfg.beam_capacity)
            self._m_setup_time.observe(
                int((_time.perf_counter() - t0) * 1e6)
            )
            t1 = _time.perf_counter()
            summary = self.scan_matcher.optimize_pose(
                ScanMatchingQuery(raster, arrays, map_local_pose),
                score_threshold=self.cfg.score_threshold,
                known_rate_threshold=self.cfg.known_rate_threshold,
            )
            if not summary.pose_found:
                # Gate-failed candidates spent detection time too — the
                # reference observes the series on every Detect call
                # (loop_detector_correlative.cpp:17-35), so skipping the
                # observe here would bias the distribution upward.
                self._m_detection_time.observe(
                    int((_time.perf_counter() - t1) * 1e6)
                )
                continue
            if getattr(self.scan_matcher, "fused", False):
                # CSM + GN refinement already ran in one fused dispatch
                # (models/fused_matcher.py) — one result fetch per candidate
                final = summary
            else:
                final = self.final_scan_matcher.optimize_pose(
                    ScanMatchingQuery(raster, arrays, summary.estimated_pose)
                )
            self._m_detection_time.observe(
                int((_time.perf_counter() - t1) * 1e6)
            )
            results.append(
                dict(
                    relative_pose=final.estimated_pose,
                    local_map_id=local_map.local_map_id,
                    scan_node_id=scan_node.node_id,
                    covariance=final.covariance,
                    score=summary.normalized_score,
                )
            )
        self._m_num_queries.observe(len(queries))
        self._m_num_detections.observe(len(results))
        self._m_precomp_memory.observe(
            sum(e.nbytes for e in self.map_cache._entries.values())
        )
        return results


class LoopDetectorBranchBound(LoopDetectorCorrelative):
    """``LoopDetectorBranchBound`` (``loop_detector_branch_bound.cpp``):
    identical Detect flow with the branch-and-bound matcher (itself a
    dense coarse-gated sweep — see matching/branch_bound.py for why B&B
    pruning is not used on the device); map rasters come from the shared
    quantized device cache like every detector."""


class LoopDetectorGridSearch(LoopDetectorCorrelative):
    """``LoopDetectorGridSearch`` (``loop_detector_grid_search.cpp``):
    identical Detect flow with the exhaustive grid-search matcher."""
