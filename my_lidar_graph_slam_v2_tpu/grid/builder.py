"""Grid map builder: local-map lifecycle + latest-map maintenance.

Host-orchestration equivalent of ``GridMapBuilder``
(``src/my_lidar_graph_slam/mapping/grid_map_builder.cpp``):

* ``append_scan`` = ``UpdatePoseGraph`` (new scan node + odometry edge,
  new local map every ``travel_dist_threshold`` metres of travel, seeded
  with the last ``num_overlapped_scans`` scans) + ``UpdateGridMap``
  (integrate the newest scan into the current local map), lines 119-494.
* ``update_latest_map`` rebuilds the rolling matching map from the last
  ``num_scans_for_latest_map`` scans (lines 497-532).
* ``construct_map_from_scans`` (lines 561-695) builds any map from a node
  range; used for local-map seeding, the latest map and the global map.

Device-side differences: local maps are fixed-shape device rasters (f32
log-odds + observed mask, see ops/rasterize.py) anchored at the local map
origin, instead of dynamically growing block grids — a local map's extent
is travel-bounded (2.5 m travel + max usable range), so a pre-sized raster
always fits (SURVEY.md section 7, hard part 3).  The global map raster is
sized on demand from the scan bounding box.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from ..core import pose as P
from ..graph.pose_graph import (
    CONSTRAINT_ODOMETRY,
    EDGE_INTER,
    EDGE_INTRA,
    LocalMapNode,
    PoseGraph,
    PoseGraphEdge,
    ScanNode,
)
from ..matching.types import MapRaster
from ..ops import rasterize
from ..sensor.data import ScanData
from . import values as gv


@dataclass(frozen=True)
class GridMapBuilderConfig:
    resolution: float = 0.05
    local_map_rows: int = 1024
    local_map_cols: int = 1024
    latest_map_rows: int = 1024
    latest_map_cols: int = 1024
    num_scans_for_latest_map: int = 10
    travel_dist_threshold: float = 2.5
    num_overlapped_scans: int = 10
    usable_range_min: float = 0.01
    usable_range_max: float = 20.0
    probability_hit: float = 0.62
    probability_miss: float = 0.46
    beam_capacity: int = 512
    samples_per_beam: int = 768
    # Incremental latest-map maintenance: cache raw per-scan log-odds
    # deltas (axis-aligned, cell-quantized anchors) and re-fold the window
    # instead of re-rasterizing all N scans each keyframe.  Exact up to
    # floor-boundary cell jitter from the anchor change (see
    # tests/test_rasterize.py::test_incremental_latest_map).
    latest_map_incremental: bool = True
    latest_map_shift_pad: int = 256  # max inter-scan shift in cells
    # "matmul" builds free-space count images as one-hot matmuls
    # (ops/rasterize.py:_miss_counts_matmul); "scatter" scatter-adds them.
    # Both give identical counts (chip_smoke.py phase (c)); which is
    # faster on the GPU is still to be measured.
    rasterize_backend: str = "matmul"
    # Single-host memory policy: replace each FINISHED local map's f32
    # build raster with its u8 matching form + bit-packed observed mask
    # (LocalMap.compact; ~4.5x smaller).  Loop detection and the global
    # map are unchanged (see compact()); multi-host owner retention
    # composes with it (drop_heavy releases the compact form too).
    compact_finished_maps: bool = True

    @property
    def rasterize_crop(self) -> int:
        """Matmul-backend window: covers one scan's sample bounding box
        (2 * usable_range / resolution, 128-aligned with margin)."""
        cells = int(math.ceil(
            2.0 * self.usable_range_max / self.resolution / 128.0
        )) * 128 + 128
        return cells

    @property
    def logodds_hit(self) -> float:
        return float(np.log(self.probability_hit / (1 - self.probability_hit)))

    @property
    def logodds_miss(self) -> float:
        return float(np.log(self.probability_miss / (1 - self.probability_miss)))


@dataclass
class LocalMap:
    local_map_id: int
    logodds: object  # [H, W] f32 device (None once dropped on a non-owner)
    observed: object  # [H, W] bool device (None once dropped)
    offset_xy: np.ndarray  # (2,) raster offset in the local map frame
    scan_node_id_min: int
    scan_node_id_max: int
    finished: bool = False
    # Bumped on every raster write; the device map cache keys entries by
    # (local_map_id, version) — grid/map_cache.py.
    version: int = 0
    # cached coarse maps for loop detection, keyed by window size
    coarse_cache: dict = field(default_factory=dict)
    # Raster extent, retained as metadata after drop_heavy() so sharded
    # batch layouts can be computed without the arrays (multi-host Stage
    # 5b: non-owners keep poses + metadata only).
    shape: Optional[tuple] = None
    dropped: bool = False
    # Compact finished-map storage (single-host memory policy, reference
    # peak: 82-94 MB at Intel scale, experiments_old.md:199-225): the f32
    # build raster of a FINISHED map is dead weight — matching uses the
    # u8-quantized copy (grid/map_cache.py) and the global map rebuilds
    # from scans (construct_global_map) — so compact() replaces it with
    # the u8 probability raster ON DEVICE (2 MB vs 5 MB per 1024^2 map in
    # HBM; the observed mask is kept as-is).  Device-resident on purpose:
    # a host copy would shift the bytes into process RSS while leaving
    # HBM/host untouched-by-measurement, and the compact raster is read
    # by device matchers anyway.
    prob_q: object = None  # [H, W] u8 device (compacted form)
    compacted: bool = False

    def __post_init__(self):
        if self.shape is None and self.observed is not None:
            self.shape = tuple(self.observed.shape)

    @property
    def holds_raster(self) -> bool:
        """True when this process can produce the map's raster (either the
        live f32 build raster or the compacted u8 form)."""
        return self.logodds is not None or self.compacted

    def compact(self):
        """Quantize to the matching form and release the f32 build raster.

        Loop-detection scores are unchanged: the device map cache
        quantizes to exactly this u8 representation on miss anyway
        (ops/quant.quantize_prob), and the global map is constructed from
        scans, never from local rasters.  No host transfer happens here —
        the u8 plane stays on device."""
        if self.compacted or self.logodds is None:
            return
        from ..ops import quant

        self.shape = tuple(self.observed.shape)
        self.prob_q = quant.quantize_prob(self.logodds, self.observed)
        self.logodds = None
        self.coarse_cache.clear()
        self.compacted = True

    def drop_heavy(self):
        """Release the device rasters + pooled coarse maps, keeping ids,
        offsets and extent.  Used by the multi-host owner-retention policy
        (parallel/multihost.py): only the owning process of a finished
        local map keeps its raster; everyone else holds metadata."""
        if self.observed is not None and self.shape is None:
            self.shape = tuple(self.observed.shape)
        self.logodds = None
        self.observed = None
        self.prob_q = None
        self.compacted = False
        self.coarse_cache.clear()
        self.dropped = True

    def raster(self, resolution: float) -> MapRaster:
        if self.compacted:
            return MapRaster(
                self.prob_q,
                self.observed,
                resolution,
                self.offset_xy,
                coarse=self.coarse_cache,
            )
        if self.logodds is None:
            raise RuntimeError(
                f"local map {self.local_map_id} raster was dropped by the "
                "owner-retention policy (owned by another process); route "
                "the request to its owner"
            )
        return MapRaster(
            rasterize.prob_map(self.logodds, self.observed),
            self.observed,
            resolution,
            self.offset_xy,
            coarse=self.coarse_cache,
        )


def pad_scan(scan: ScanData, capacity: int, usable_min: float, usable_max: float):
    """Padded (ranges, angles, mask) with the usable-range integration
    filter applied to the mask; uniform subsample if over capacity
    (the FPGA matcher does the same at 512 beams,
    ``scan_matcher_correlative_fpga.cpp:530-587``)."""
    min_range = max(usable_min, scan.min_range)
    max_range = min(usable_max, scan.max_range)
    ranges, angles = scan.ranges, scan.angles
    n = len(ranges)
    if n > capacity:
        idx = np.linspace(0, n - 1, capacity).astype(int)
        ranges, angles = ranges[idx], angles[idx]
        n = capacity
    valid = (ranges > min_range) & (ranges < max_range)
    r = np.zeros(capacity, np.float32)
    a = np.zeros(capacity, np.float32)
    m = np.zeros(capacity, bool)
    r[:n] = ranges
    a[:n] = angles
    m[:n] = valid
    return r, a, m


class GridMapBuilder:
    def __init__(self, cfg: GridMapBuilderConfig):
        from ..metrics.registry import MetricManager

        self.cfg = cfg
        vs = MetricManager.instance().value_sequence
        # Parity series with grid_map_builder.cpp:20-52; times in us,
        # memory in bytes (device raster bytes: f32 log-odds + bool mask).
        self._m_pg_update_time = vs("GridMapBuilder.PoseGraphUpdateTime")
        self._m_lm_update_time = vs("GridMapBuilder.LocalMapUpdateTime")
        self._m_latest_update_time = vs("GridMapBuilder.LatestMapUpdateTime")
        self._m_lm_interval_dist = vs("GridMapBuilder.LocalMapIntervalTravelDist")
        self._m_num_local_maps = vs("GridMapBuilder.NumOfLocalMapNodes")
        self._m_num_edges = vs("GridMapBuilder.NumOfEdges")
        self._m_lm_memory = vs("GridMapBuilder.LocalMapMemoryUsage")
        self._m_latest_memory = vs("GridMapBuilder.LatestMapMemoryUsage")
        self._m_pg_memory = vs("GridMapBuilder.PoseGraphMemoryUsage")
        # Hits landing outside the fixed raster extent are dropped by the
        # rasterizer (ops/rasterize.py mode="drop"); the pre-sized extent
        # is travel-bounded so this should stay 0 (SURVEY hard part 3) —
        # the counter makes any violation visible instead of silent.
        self._m_oob_hits = MetricManager.instance().counter(
            "GridMapBuilder.OutOfExtentHits"
        )
        self.local_maps: List[LocalMap] = []
        self._oob_dev = None  # device-accumulated OOB hit count
        self.accum_travel_dist = 0.0
        self.travel_dist_last_local_map = 0.0
        # Latest (rolling) map state
        self.latest_logodds = None
        self.latest_observed = None
        self.latest_offset = None
        self.latest_map_pose = np.zeros(3)
        self.latest_scan_id_min = 0
        self.latest_scan_id_max = 0
        # node_id -> (pose_fingerprint, anchor_cell (2,) int64, delta [H,W])
        self._latest_cache: dict = {}

    # ------------------------------------------------------------------
    def latest_local_map(self) -> LocalMap:
        return self.local_maps[-1]

    def local_map_at(self, local_map_id: int) -> LocalMap:
        return self.local_maps[local_map_id]

    # ------------------------------------------------------------------
    def append_scan(
        self,
        pose_graph: PoseGraph,
        relative_scan_pose: np.ndarray,
        scan_pose_covariance: np.ndarray,
        scan_data: ScanData,
    ) -> bool:
        import time as _time

        t = _time.perf_counter()
        inserted = self._update_pose_graph(
            pose_graph, relative_scan_pose, scan_pose_covariance, scan_data
        )
        self._m_pg_update_time.observe(int((_time.perf_counter() - t) * 1e6))
        t = _time.perf_counter()
        self._update_grid_map(pose_graph)
        self._m_lm_update_time.observe(int((_time.perf_counter() - t) * 1e6))
        self._m_num_local_maps.observe(len(pose_graph.local_map_nodes))
        self._m_num_edges.observe(len(pose_graph.edges))
        lm = self.latest_local_map()
        self._m_lm_memory.observe(5 * lm.logodds.shape[0] * lm.logodds.shape[1])
        self._m_pg_memory.observe(
            24 * (len(pose_graph.scan_nodes) + len(pose_graph.local_map_nodes))
            + 112 * len(pose_graph.edges)
        )
        return inserted

    # ------------------------------------------------------------------
    def _new_raster(self, rows, cols):
        lo = jnp.zeros((rows, cols), jnp.float32)
        obs = jnp.zeros((rows, cols), bool)
        offset = np.array(
            [-self.cfg.resolution * (cols // 2), -self.cfg.resolution * (rows // 2)]
        )
        return lo, obs, offset

    def _integrate(
        self, lo, obs, offset_xy, map_pose, scan_entries
    ):
        """Integrate scans (list of (global_node_pose, scan_data)) into a
        raster anchored at ``map_pose``."""
        cfg = self.cfg
        sensors, hits, masks = [], [], []
        for node_pose, scan in scan_entries:
            g_sensor = P.compound(node_pose, scan.relative_sensor_pose)
            l_sensor = P.inverse_compound(map_pose, g_sensor)
            r, a, m = pad_scan(
                scan, cfg.beam_capacity, cfg.usable_range_min, cfg.usable_range_max
            )
            ang = l_sensor[2] + a
            hx = l_sensor[0] + r * np.cos(ang)
            hy = l_sensor[1] + r * np.sin(ang)
            sensors.append(l_sensor[:2])
            hits.append(np.stack([hx, hy], -1))
            masks.append(m)
        # Out-of-extent hits are counted ON DEVICE by the integrate kernel
        # (return_oob) and accumulated as a device scalar; flush_oob()
        # fetches the total lazily (end of run / checkpoint) so the hot
        # path pays neither host re-derivation nor a per-scan round trip.
        lo, obs, n_oob = rasterize.integrate_scans(
            lo,
            obs,
            jnp.asarray(np.array(sensors), jnp.float32),
            jnp.asarray(np.array(hits), jnp.float32),
            jnp.asarray(np.array(masks)),
            cfg.resolution,
            jnp.asarray(offset_xy, jnp.float32),
            cfg.logodds_hit,
            cfg.logodds_miss,
            num_samples=cfg.samples_per_beam,
            backend=cfg.rasterize_backend,
            crop=min(cfg.rasterize_crop, min(lo.shape)),
            return_oob=True,
        )
        self._oob_dev = (
            n_oob if self._oob_dev is None else self._oob_dev + n_oob
        )
        return lo, obs

    def flush_oob(self):
        """Fetch the device-accumulated out-of-extent hit count into the
        ``GridMapBuilder.OutOfExtentHits`` counter (one transfer)."""
        if self._oob_dev is not None:
            v = int(self._oob_dev)
            if v:
                self._m_oob_hits.increment(v)
            self._oob_dev = None

    # ------------------------------------------------------------------
    def _append_local_map(
        self, pose_graph: PoseGraph, scan_pose, scan_pose_cov, scan_node_id
    ):
        """``GridMapBuilder::AppendLocalMap`` (grid_map_builder.cpp:187-286)."""
        cfg = self.cfg
        # Finish the current local map
        if self.local_maps:
            lm = self.latest_local_map()
            lm.finished = True
            pose_graph.local_map_nodes[lm.local_map_id].finished = True
            self._m_lm_interval_dist.observe(self.travel_dist_last_local_map)
            if cfg.compact_finished_maps:
                lm.compact()

        local_map_id = len(self.local_maps)
        local_map_pose = np.asarray(scan_pose, np.float64)

        if self.local_maps:
            old_node = pose_graph.local_map_nodes[-1]
            map_local_scan_pose = P.normalize_pose(
                P.inverse_compound(old_node.global_pose, scan_pose)
            )
            local_cov = P.covariance_world_to_local(
                old_node.global_pose, scan_pose_cov
            )
            pose_graph.edges.append(
                PoseGraphEdge(
                    old_node.local_map_id,
                    scan_node_id,
                    EDGE_INTER,
                    CONSTRAINT_ODOMETRY,
                    map_local_scan_pose,
                    np.linalg.inv(local_cov),
                )
            )

        pose_graph.local_map_nodes.append(
            LocalMapNode(local_map_id, local_map_pose.copy())
        )

        lo, obs, offset = self._new_raster(cfg.local_map_rows, cfg.local_map_cols)
        if self.local_maps:
            # Seed with the most recent scans (grid_map_builder.cpp:252-276)
            last_max = self.latest_local_map().scan_node_id_max
            n_seed = min(len(pose_graph.scan_nodes), cfg.num_overlapped_scans)
            first = max(0, last_max - (n_seed - 1))
            entries = [
                (pose_graph.scan_nodes[i].global_pose, pose_graph.scan_nodes[i].scan_data)
                for i in range(first, last_max + 1)
            ]
            lo, obs = self._integrate(lo, obs, offset, local_map_pose, entries)

        self.local_maps.append(
            LocalMap(
                local_map_id,
                lo,
                obs,
                offset,
                scan_node_id_min=scan_node_id,
                scan_node_id_max=scan_node_id,
            )
        )
        self.travel_dist_last_local_map = 0.0

    # ------------------------------------------------------------------
    def _update_pose_graph(
        self, pose_graph, relative_scan_pose, scan_pose_cov, scan_data
    ) -> bool:
        """``GridMapBuilder::UpdatePoseGraph`` (grid_map_builder.cpp:289-388)."""
        scan_node_id = len(pose_graph.scan_nodes)
        prev_pose = (
            pose_graph.scan_nodes[-1].global_pose
            if pose_graph.scan_nodes
            else np.zeros(3)
        )
        scan_pose = P.compound(prev_pose, relative_scan_pose)

        d = float(P.distance(relative_scan_pose))
        self.accum_travel_dist += d
        self.travel_dist_last_local_map += d

        inserted = (
            not self.local_maps
            or self.travel_dist_last_local_map >= self.cfg.travel_dist_threshold
            or self.latest_local_map().finished
        )
        if inserted:
            self._append_local_map(pose_graph, scan_pose, scan_pose_cov, scan_node_id)

        lm = self.latest_local_map()
        lm_node = pose_graph.local_map_nodes[-1]
        map_local_scan_pose = P.normalize_pose(
            P.inverse_compound(lm_node.global_pose, scan_pose)
        )
        pose_graph.scan_nodes.append(
            ScanNode(
                scan_node_id,
                lm.local_map_id,
                map_local_scan_pose,
                np.asarray(scan_pose, np.float64),
                scan_data,
            )
        )
        local_cov = P.covariance_world_to_local(lm_node.global_pose, scan_pose_cov)
        pose_graph.edges.append(
            PoseGraphEdge(
                lm_node.local_map_id,
                scan_node_id,
                EDGE_INTRA,
                CONSTRAINT_ODOMETRY,
                map_local_scan_pose,
                np.linalg.inv(local_cov),
            )
        )
        return inserted

    # ------------------------------------------------------------------
    def _update_grid_map(self, pose_graph: PoseGraph):
        """Integrate the newest scan into the current local map
        (``GridMapBuilder::UpdateGridMap``, grid_map_builder.cpp:390-494)."""
        lm = self.latest_local_map()
        lm_node = pose_graph.local_map_nodes[-1]
        node = pose_graph.scan_nodes[-1]
        lm.logodds, lm.observed = self._integrate(
            lm.logodds,
            lm.observed,
            lm.offset_xy,
            lm_node.global_pose,
            [(node.global_pose, node.scan_data)],
        )
        lm.scan_node_id_max = node.node_id
        lm.version += 1
        lm.coarse_cache.clear()

    # ------------------------------------------------------------------
    def update_latest_map(self, pose_graph: PoseGraph):
        """Rebuild the rolling matching map from the last N scans
        (``GridMapBuilder::UpdateLatestMap``, grid_map_builder.cpp:497-532).

        Incremental mode: the map is anchored axis-aligned at the first
        window node's cell-quantized position, so each scan's raw delta
        image (cached per node, invalidated on pose change) is reusable
        across keyframes up to an integer cell shift; the window is then
        re-folded sequentially (exact Bayes-clip semantics) in O(N) dense
        ops instead of O(N) rasterizations."""
        import time as _time

        t0 = _time.perf_counter()
        cfg = self.cfg
        nodes = pose_graph.scan_nodes
        n = min(len(nodes), cfg.num_scans_for_latest_map)
        first = len(nodes) - n
        self.latest_scan_id_min = nodes[first].node_id
        self.latest_scan_id_max = nodes[-1].node_id
        try:
            if cfg.latest_map_incremental and self._update_latest_incremental(
                nodes[first:]
            ):
                return
            self.latest_map_pose = nodes[first].global_pose.copy()
            lo, obs, offset = self._new_raster(
                cfg.latest_map_rows, cfg.latest_map_cols
            )
            entries = [(nd.global_pose, nd.scan_data) for nd in nodes[first:]]
            self.latest_logodds, self.latest_observed = self._integrate(
                lo, obs, offset, self.latest_map_pose, entries
            )
            self.latest_offset = offset
        finally:
            self._m_latest_update_time.observe(
                int((_time.perf_counter() - t0) * 1e6)
            )
            if self.latest_logodds is not None:
                self._m_latest_memory.observe(
                    5 * self.latest_logodds.shape[0] * self.latest_logodds.shape[1]
                )

    def _fold_window_inputs(self, window_nodes):
        """Per-scan cached delta images + integer shifts for the latest-map
        window, WITHOUT materializing the fold.  Returns a dict of fold
        inputs, or None when the window spread exceeds the shift pad (the
        caller must do a full rebuild)."""
        cfg = self.cfg
        res = cfg.resolution
        rows, cols = cfg.latest_map_rows, cfg.latest_map_cols
        offset = np.array([-res * (cols // 2), -res * (rows // 2)])
        anchor_cell = np.floor(
            window_nodes[0].global_pose[:2] / res
        ).astype(np.int64)

        deltas, shifts = [], []
        keep = set()
        for nd in window_nodes:
            keep.add(nd.node_id)
            fp = nd.global_pose.tobytes()
            ent = self._latest_cache.get(nd.node_id)
            if ent is None or ent[0] != fp:
                cell_k = np.floor(nd.global_pose[:2] / res).astype(np.int64)
                anchor_k = np.array(
                    [cell_k[0] * res, cell_k[1] * res, 0.0]
                )
                delta = self._scan_delta(anchor_k, offset, nd)
                ent = (fp, cell_k, delta)
                self._latest_cache[nd.node_id] = ent
            _, cell_k, delta = ent
            # latest[r, c] = delta[r - dr, c - dc]
            dr = int(cell_k[1] - anchor_cell[1])
            dc = int(cell_k[0] - anchor_cell[0])
            if abs(dr) > cfg.latest_map_shift_pad or abs(dc) > cfg.latest_map_shift_pad:
                return None  # window spread exceeds pad: full rebuild
            deltas.append(delta)
            shifts.append((dr, dc))
        for nid in [k for k in self._latest_cache if k not in keep]:
            del self._latest_cache[nid]

        # Pad to the fixed window size so the fold compiles once
        n_cap = cfg.num_scans_for_latest_map
        valid = np.zeros(n_cap, bool)
        valid[: len(deltas)] = True
        while len(deltas) < n_cap:
            deltas.append(deltas[0])
            shifts.append((0, 0))
        return dict(
            deltas=tuple(deltas),
            shifts=jnp.asarray(np.array(shifts, np.int32)),
            valid=jnp.asarray(valid),
            offset_xy=offset,
            map_pose=np.array(
                [anchor_cell[0] * res, anchor_cell[1] * res, 0.0]
            ),
            max_shift=cfg.latest_map_shift_pad,
        )

    def latest_fold_inputs(self, pose_graph: PoseGraph):
        """Latest-map fold inputs for the single-launch fused matcher
        (models/fused_matcher.py:_fused_core_deltas): the frontend hot
        path folds + quantizes + pools + matches in ONE device dispatch,
        so the latest raster never needs to be materialized separately
        per keyframe.  Returns None when the incremental path does not
        apply (caller falls back to update_latest_map + latest_raster).

        INVARIANT (advisor r04): this method updates latest_map_pose and
        latest_scan_id_min/max but deliberately leaves latest_logodds/
        latest_observed/latest_offset stale (the fold happens inside the
        fused matcher, never on the builder).  Raster readers must go
        through get_latest_data()/get_latest_map()/latest_raster(), all
        of which call update_latest_map() first; never pair a direct
        latest_logodds read with latest_map_pose after this call."""
        import time as _time

        t0 = _time.perf_counter()
        cfg = self.cfg
        if not cfg.latest_map_incremental:
            return None
        nodes = pose_graph.scan_nodes
        if not nodes:
            return None
        n = min(len(nodes), cfg.num_scans_for_latest_map)
        fold = self._fold_window_inputs(nodes[len(nodes) - n:])
        if fold is None:
            return None
        self.latest_scan_id_min = nodes[len(nodes) - n].node_id
        self.latest_scan_id_max = nodes[-1].node_id
        self.latest_map_pose = fold["map_pose"].copy()
        self._m_latest_update_time.observe(
            int((_time.perf_counter() - t0) * 1e6)
        )
        return fold

    def _update_latest_incremental(self, window_nodes) -> bool:
        fold = self._fold_window_inputs(window_nodes)
        if fold is None:
            return False
        lo, obs = rasterize.fold_shifted_deltas(
            jnp.stack(fold["deltas"]),
            fold["shifts"],
            fold["valid"],
            max_shift=fold["max_shift"],
        )
        self.latest_logodds, self.latest_observed = lo, obs
        self.latest_offset = fold["offset_xy"]
        self.latest_map_pose = fold["map_pose"]
        return True

    def _scan_delta(self, map_pose, offset, node):
        """Raw delta image of one scan in an axis-aligned raster anchored
        at ``map_pose`` (theta = 0)."""
        cfg = self.cfg
        scan = node.scan_data
        g_sensor = P.compound(node.global_pose, scan.relative_sensor_pose)
        l_sensor = P.inverse_compound(map_pose, g_sensor)
        r, a, m = pad_scan(
            scan, cfg.beam_capacity, cfg.usable_range_min, cfg.usable_range_max
        )
        ang = l_sensor[2] + a
        hx = l_sensor[0] + r * np.cos(ang)
        hy = l_sensor[1] + r * np.sin(ang)
        return rasterize.scan_delta(
            (cfg.latest_map_rows, cfg.latest_map_cols),
            jnp.asarray(l_sensor[:2], jnp.float32),
            jnp.asarray(np.stack([hx, hy], -1), jnp.float32),
            jnp.asarray(m),
            cfg.resolution,
            jnp.asarray(offset, jnp.float32),
            cfg.logodds_hit,
            cfg.logodds_miss,
            num_samples=cfg.samples_per_beam,
            backend=cfg.rasterize_backend,
            crop=min(cfg.rasterize_crop, cfg.latest_map_rows,
                     cfg.latest_map_cols),
        )

    def prefill_latest_delta(self, pose_graph: PoseGraph):
        """Dispatch (async) the newest scan node's latest-map delta image
        into the per-node cache right after it is appended, so the next
        keyframe's single-launch match (latest_fold_inputs) finds it
        already computed — the rasterization overlaps the inter-keyframe
        host work instead of sitting on the match fetch's critical path."""
        cfg = self.cfg
        if not cfg.latest_map_incremental or not pose_graph.scan_nodes:
            return
        nd = pose_graph.scan_nodes[-1]
        fp = nd.global_pose.tobytes()
        ent = self._latest_cache.get(nd.node_id)
        if ent is not None and ent[0] == fp:
            return
        res = cfg.resolution
        offset = np.array([
            -res * (cfg.latest_map_cols // 2),
            -res * (cfg.latest_map_rows // 2),
        ])
        cell_k = np.floor(nd.global_pose[:2] / res).astype(np.int64)
        anchor_k = np.array([cell_k[0] * res, cell_k[1] * res, 0.0])
        delta = self._scan_delta(anchor_k, offset, nd)
        self._latest_cache[nd.node_id] = (fp, cell_k, delta)

    def latest_raster(self) -> MapRaster:
        """Matching raster of the rolling latest map, u8-quantized: the
        sweep kernels take the exact single-pass bf16 path on u8 maps
        (ops/csm.py) and the GN ops dequantize inside the gather, so the
        frontend hot path moves 1/4 the map bytes per dispatch."""
        from ..ops import quant

        return MapRaster(
            quant.quantize_prob(self.latest_logodds, self.latest_observed),
            self.latest_observed,
            self.cfg.resolution,
            self.latest_offset,
        )

    # ------------------------------------------------------------------
    def after_loop_closure(self, pose_graph: PoseGraph):
        """Recompute the accumulated travel distance from the optimized
        poses (``GridMapBuilder::UpdateAccumTravelDist``,
        grid_map_builder.cpp:535-558). Local map rasters are NOT rebuilt."""
        nodes = pose_graph.scan_nodes
        if len(nodes) < 2:
            self.accum_travel_dist = 0.0
            return
        poses = pose_graph.scan_poses()
        self.accum_travel_dist = float(
            np.sum(np.hypot(np.diff(poses[:, 0]), np.diff(poses[:, 1])))
        )

    # ------------------------------------------------------------------
    def construct_map_from_scans(
        self, map_pose, entries, rows=None, cols=None, margin_cells=8,
        offset_xy=None,
    ):
        """Build a map raster covering all given scans; raster size derived
        from the hit-point bounding box unless given.  Returns MapRaster.

        Entries whose scan data is ``None`` (dropped by the multi-host
        owner-retention policy) are skipped, so each process can build its
        *partial* map from owned scans; partial log-odds rasters built on a
        shared (rows, cols, offset_xy) extent sum into the exact global map
        (multihost.construct_global_map_sharded)."""
        cfg = self.cfg
        entries = [(p, s) for p, s in entries if s is not None]
        if not entries:
            if rows is None or offset_xy is None:
                raise ValueError(
                    "no scan data held by this process; pass an explicit "
                    "(rows, cols, offset_xy) extent to build an empty "
                    "partial map"
                )
            lo = jnp.zeros((rows, cols), jnp.float32)
            obs = jnp.zeros((rows, cols), bool)
            return MapRaster(
                rasterize.prob_map(lo, obs), obs, cfg.resolution,
                np.asarray(offset_xy, np.float64),
            )
        pts = []
        for node_pose, scan in entries:
            g_sensor = P.compound(node_pose, scan.relative_sensor_pose)
            l_sensor = P.inverse_compound(map_pose, g_sensor)
            r, a, m = pad_scan(
                scan, cfg.beam_capacity, cfg.usable_range_min, cfg.usable_range_max
            )
            ang = l_sensor[2] + a[m]
            pts.append(
                np.stack(
                    [l_sensor[0] + r[m] * np.cos(ang), l_sensor[1] + r[m] * np.sin(ang)],
                    -1,
                )
            )
            pts.append(l_sensor[None, :2])
        allpts = np.concatenate(pts, axis=0)
        lo_xy = allpts.min(0) - margin_cells * cfg.resolution
        hi_xy = allpts.max(0) + margin_cells * cfg.resolution
        if rows is None:
            cols = int(math.ceil((hi_xy[0] - lo_xy[0]) / cfg.resolution / 128.0)) * 128
            rows = int(math.ceil((hi_xy[1] - lo_xy[1]) / cfg.resolution / 128.0)) * 128
        lo = jnp.zeros((rows, cols), jnp.float32)
        obs = jnp.zeros((rows, cols), bool)
        offset = np.asarray(
            lo_xy if offset_xy is None else offset_xy, np.float64
        )
        lo, obs = self._integrate(lo, obs, offset, map_pose, entries)
        return MapRaster(
            rasterize.prob_map(lo, obs), obs, cfg.resolution, offset
        )

    def construct_global_map(self, pose_graph: PoseGraph):
        """Global map anchored at the first scan node's pose
        (``ConstructGlobalMap``, grid_map_builder.cpp:161-185)."""
        nodes = pose_graph.scan_nodes
        map_pose = nodes[0].global_pose
        entries = [(nd.global_pose, nd.scan_data) for nd in nodes]
        return map_pose, self.construct_map_from_scans(map_pose, entries)
