"""Multi-host (multi-process) distributed SLAM runtime.

The reference's scaling story is "split the loop-candidate list across
accelerators driven by host threads" with maps cached accelerator-side
(``loop_detector_fpga_parallel.cpp:32-68``,
``scan_matcher_correlative_fpga.cpp:254-270``).  This module generalizes
it from 2 FPGA cores on one board to N devices across P processes/hosts
via ``jax.distributed``:

* **Replicated control state, owner-sharded heavy state.**  Every
  process runs the identical (deterministic) host-side pipeline — pose
  graph poses/edges, builder counters, frontend — so no host-to-host
  state synchronization protocol is needed; all cross-host traffic is
  XLA collectives inside jit plus one small per-detect result exchange.
* **Local-map ownership.**  Local map ``m`` is owned by process
  ``m % P``.  Loop candidates are *routed to the owner*: the global
  candidate batch is laid out so each candidate lands on one of its
  owner's devices, and only the owner rasterizes + uploads the map crop
  (``make_array_from_callback`` materializes addressable shards only).
  Per-host raster H2D therefore scales ~1/P, mirroring the reference's
  BRAM map cache keyed by ``LocalMapId``.
* **Owner retention (SURVEY Stage 5b).**  ``apply_owner_retention``
  drops the device rasters AND raw scan buffers of finished, aged-out
  local maps on every process except the owner — non-owners keep poses
  and metadata only — so per-process memory for a length-T trajectory
  scales ~T/P instead of T.  The final GN refine of each detected loop
  runs on the owner and the (tiny) refined poses are exchanged with one
  ``process_allgather``, keeping the trajectories lockstep without
  replicated rasters.
* **Distributed Schur LM over the global axis.**  The pose-graph solve
  reuses ``parallel/distributed.py``: edge shards stay on the devices of
  a host, the reduced-system psum crosses hosts once per LM iteration.

Validated by ``tests/test_multihost.py``, which spawns real
``jax.distributed`` processes on CPU (SURVEY section 4d recipe) and by
``scripts/multihost_worker.py`` (the runnable per-process entry).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import pose as P2
from ..matching.correlative import (
    CorrelativeConfig,
    _correlative_core,
    correlative_core_jit,
)
from ..ops import pool
from .mesh import AXIS_CANDIDATES


def init_multihost(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_count: Optional[int] = None,
    local_device_ids: Optional[List[int]] = None,
) -> None:
    """Initialize the jax.distributed runtime (call once, before any other
    backend use).  ``local_device_count`` forces N virtual CPU devices per
    process (test/CI mode).  On a GPU host running several processes,
    give each its own cards with ``local_device_ids`` (e.g. ``[k]`` for
    process k of one-card-per-process): without it every process opens,
    and reserves memory on, every card of the host."""
    import os

    if local_device_count is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags
                + f" --xla_force_host_platform_device_count={local_device_count}"
            ).strip()
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def global_mesh() -> Mesh:
    """1-D candidate mesh over every device of every process.

    ``jax.devices()`` orders devices by process index, so the global
    candidate axis is contiguous per process — slot ranges map directly
    to owners."""
    return Mesh(np.array(jax.devices()), (AXIS_CANDIDATES,))


def owner_of(local_map_id: int, num_processes: int) -> int:
    """Owning process of a local map (id-range sharding by modulo)."""
    return int(local_map_id) % num_processes


def apply_owner_retention(
    pose_graph,
    builder,
    *,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    keep_last_maps: int = 2,
) -> dict:
    """Drop non-owned heavy host state (SURVEY section 5.7 / Stage 5b).

    For every *finished* local map older than the last ``keep_last_maps``
    maps whose owner is another process, release its device rasters and
    the raw scan buffers of its scan nodes; poses, edges, ids and extents
    stay everywhere.  The recent-map window is never touched because the
    frontend's latest-map rebuild and new-map seeding read the last
    ``num_scans_for_latest_map`` / ``num_overlapped_scans`` scans
    (grid_map_builder.cpp:252-276,497-532).

    Call after each processed scan (idempotent, cheap: pure refcount
    drops).  Returns cumulative holdings for telemetry/tests."""
    Pn = num_processes if num_processes is not None else jax.process_count()
    pid = process_id if process_id is not None else jax.process_index()
    dropped_rasters = dropped_scans = 0
    if Pn > 1 and builder.local_maps:
        cutoff_map = len(builder.local_maps) - keep_last_maps
        # Static safety margin on top of latest_scan_id_min: never drop a
        # scan the latest-map window or map seeding could still read.
        n_nodes = len(pose_graph.scan_nodes)
        keep_from = min(
            builder.latest_scan_id_min,
            n_nodes
            - builder.cfg.num_scans_for_latest_map
            - builder.cfg.num_overlapped_scans,
        )
        # No seed-scan protection is needed: owner checkpoints persist the
        # owned rasters themselves (pipeline/checkpoint.py saves
        # ``<prefix>.maps.npz``), so a map never has to be re-rasterized
        # from scans another process dropped.
        for lm in builder.local_maps[:cutoff_map]:
            if not lm.finished or owner_of(lm.local_map_id, Pn) == pid:
                continue
            if lm.holds_raster:
                lm.drop_heavy()
                dropped_rasters += 1
            for nid in range(lm.scan_node_id_min,
                             min(lm.scan_node_id_max + 1, keep_from)):
                if pose_graph.scan_nodes[nid].scan_data is not None:
                    pose_graph.scan_nodes[nid].scan_data = None
                    dropped_scans += 1
    return dict(
        dropped_rasters=dropped_rasters,
        dropped_scans=dropped_scans,
        rasters_held=sum(
            1 for lm in builder.local_maps if lm.holds_raster
        ),
        scan_buffers_held=sum(
            1 for n in pose_graph.scan_nodes if n.scan_data is not None
        ),
    )


def construct_global_map_sharded(slam, *, margin_cells: int = 8):
    """Exact global map under owner-sharded scan retention.

    Each process rasterizes its *owned* scans into a partial log-odds
    raster on a shared extent derived from the (replicated) scan-node
    poses, then one ``process_allgather`` sums the partials — log-odds
    add under per-scan independence, which is exactly how the sequential
    integration composes (``ConstructGlobalMap``,
    grid_map_builder.cpp:161-185).  Returns (map_pose, MapRaster)."""
    import math

    from jax.experimental import multihost_utils

    from ..matching.types import MapRaster
    from ..ops import rasterize

    pg, builder = slam.pose_graph, slam.builder
    cfg = builder.cfg
    nodes = pg.scan_nodes
    map_pose = nodes[0].global_pose
    # Shared extent from poses only (replicated on every process)
    poses_g = pg.scan_poses()
    local_xy = np.stack(
        [P2.inverse_compound(map_pose, p)[:2] for p in poses_g]
    )
    reach = cfg.usable_range_max + margin_cells * cfg.resolution
    lo_xy = local_xy.min(0) - reach
    hi_xy = local_xy.max(0) + reach
    cols = int(math.ceil((hi_xy[0] - lo_xy[0]) / cfg.resolution / 128.0)) * 128
    rows = int(math.ceil((hi_xy[1] - lo_xy[1]) / cfg.resolution / 128.0)) * 128
    entries = [
        (nd.global_pose, nd.scan_data) for nd in nodes
        if nd.scan_data is not None
    ]
    lo = jnp.zeros((rows, cols), jnp.float32)
    obs = jnp.zeros((rows, cols), bool)
    if entries:
        lo, obs = builder._integrate(lo, obs, lo_xy, map_pose, entries)
    if jax.process_count() > 1:
        # Each scan was integrated by exactly one process, so the raw
        # log-odds partials sum to the global map (exact up to clip
        # saturation ordering in heavily-observed cells, where both
        # orderings saturate to the same probability).
        from ..grid import values as gv

        lo = jnp.clip(
            multihost_utils.process_allgather(lo).sum(0),
            gv.LOGODDS_MIN, gv.LOGODDS_MAX,
        )
        obs = multihost_utils.process_allgather(obs).any(0)
    return map_pose, MapRaster(
        rasterize.prob_map(lo, obs), obs,
        cfg.resolution, np.asarray(lo_xy, np.float64),
    )


from .mesh import to_global  # noqa: F401  (re-export; used by workers)


def make_routed_loop_csm(mesh: Mesh, cfg: CorrelativeConfig):
    """Sharded batched loop CSM whose outputs are all-gathered so every
    process sees every candidate's result (host state stays replicated)."""

    def single(prob, observed, ranges, angles, mask, sensor_pose, offset_xy,
               score_thr, known_thr):
        coarse_p = pool.sliding_window_max2d(prob, cfg.low_resolution)
        coarse_o = pool.sliding_window_max2d(observed, cfg.low_resolution)
        # Drop the per-candidate node-accounting tail (batch detectors
        # aggregate their own counters) but keep the top-K exactness flag
        # so owners can re-run pruned-inexact candidates densely.
        out = _correlative_core(
            cfg, prob, observed, coarse_p, coarse_o,
            ranges, angles, mask, sensor_pose, offset_xy,
            score_thr, known_thr,
        )
        return out[:6] + (out[8],)

    batched = jax.vmap(single, in_axes=(0, 0, 0, 0, 0, 0, 0, None, None))

    def body(prob, observed, ranges, angles, mask, poses, offs, s_thr, k_thr):
        out = batched(prob, observed, ranges, angles, mask, poses, offs,
                      s_thr, k_thr)
        # Replicate the (small) per-candidate results to every device so
        # each host can fetch all of them: one all_gather.
        return tuple(
            jax.lax.all_gather(o, AXIS_CANDIDATES, tiled=True) for o in out
        )

    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P(AXIS_CANDIDATES), P(AXIS_CANDIDATES), P(AXIS_CANDIDATES),
            P(AXIS_CANDIDATES), P(AXIS_CANDIDATES), P(AXIS_CANDIDATES),
            P(AXIS_CANDIDATES), P(), P(),
        ),
        out_specs=(P(), P(), P(), P(), P(), P(), P()),
        # The tiled all_gather makes every output replicated by value, but
        # the static varying-mesh-axes check cannot infer that.
        check_vma=False,
    )
    return jax.jit(sharded)


class MultiHostLoopDetector:
    """Loop detector with owner-routed candidate fan-out across processes.

    Same matcher core and result contract as
    ``loop.detector.LoopDetectorCorrelative``; the candidate batch is laid
    out so each query runs on a device of the process owning the reference
    local map, and only that process materializes the raster."""

    def __init__(self, cfg, scan_matcher_cfg: CorrelativeConfig,
                 final_scan_matcher, mesh: Mesh, resolution: float = 0.05,
                 map_cache=None):
        from ..grid.map_cache import DeviceMapCache
        from ..metrics.registry import MetricManager

        self.cfg = cfg
        self.mcfg = scan_matcher_cfg
        self.final = final_scan_matcher
        self.mesh = mesh
        self.resolution = resolution
        self.map_cache = map_cache or DeviceMapCache(resolution)
        self._fn = make_routed_loop_csm(mesh, scan_matcher_cfg)
        self.num_processes = jax.process_count()
        self.process_id = jax.process_index()
        self.rasterized_map_ids: set = set()  # owner-side uploads (telemetry)
        self._m_h2d_bytes = MetricManager.instance().value_sequence(
            "LoopDetector.MapH2DBytes"
        )

    # -- candidate layout ------------------------------------------------
    def _layout(self, queries):
        """Assign each query a global slot on one of its owner's devices.

        Returns (slots, C): ``slots[i]`` is query i's global candidate
        index; C is the padded global batch size (P * L * k)."""
        devs = self.mesh.devices.ravel()
        D = devs.size
        Pn = self.num_processes
        L = D // Pn  # local devices per process (uniform by construction)
        by_owner: List[List[int]] = [[] for _ in range(Pn)]
        for i, q in enumerate(queries):
            by_owner[owner_of(q["local_map"].local_map_id, Pn)].append(i)
        k = max(1, max((len(b) + L - 1) // L for b in by_owner))
        C = Pn * L * k
        slots = np.zeros(len(queries), np.int64)
        for p, idxs in enumerate(by_owner):
            base = p * L * k
            for j, i in enumerate(idxs):
                slots[i] = base + j
        return slots, C

    def detect(self, queries) -> List[dict]:
        from ..loop.detector import scan_to_arrays
        from ..matching.types import ScanMatchingQuery

        if not queries:
            return []
        slots, C = self._layout(queries)
        slot_to_query = {int(s): q for s, q in zip(slots, queries)}
        H = W = None
        arrays_by_slot = {}
        for s, q in slot_to_query.items():
            arrays_by_slot[s] = scan_to_arrays(
                q["query_node"].scan_data, self.cfg.beam_capacity
            )

        # Quantized rasters, ONE cache lookup per distinct owned map
        # (grid/map_cache.py; reference FPGA skips the map transfer on a
        # BRAM id hit, scan_matcher_correlative_fpga.cpp:254-270).
        # Extent from metadata: non-owners may hold no raster at all
        # (owner retention, Stage 5b).
        H, W = queries[0]["local_map"].shape
        B = self.cfg.beam_capacity
        sharding = NamedSharding(self.mesh, P(AXIS_CANDIDATES))
        raster_by_slot = {}
        h2d_bytes = 0
        for s, q in slot_to_query.items():
            lm = q["local_map"]
            if owner_of(lm.local_map_id, self.num_processes) != self.process_id:
                continue
            raster_by_slot[s] = self.map_cache.raster(lm)
            self.rasterized_map_ids.add(lm.local_map_id)
            h2d_bytes += H * W * 2  # u8 prob + bool mask per slot
        self._m_h2d_bytes.observe(h2d_bytes)

        def map_cb(kind):
            def cb(index):
                # index[0] is the slice of candidate slots for one
                # addressable shard; only owner slots are materialized.
                lo, hi = index[0].start or 0, index[0].stop or C
                blocks = []
                for s in range(lo, hi):
                    raster = raster_by_slot.get(s)
                    if raster is None:
                        blocks.append(
                            np.zeros((1, H, W),
                                     np.uint8 if kind == "prob" else bool)
                        )
                        continue
                    arr = raster.prob if kind == "prob" else raster.observed
                    blocks.append(np.asarray(arr)[None])
                return np.concatenate(blocks, 0)

            return cb

        def small_cb(fill):
            def cb(index):
                lo, hi = index[0].start or 0, index[0].stop or C
                blocks = []
                for s in range(lo, hi):
                    q = slot_to_query.get(s)
                    blocks.append(fill(s, q)[None])
                return np.concatenate(blocks, 0)

            return cb

        def fill_ranges(s, q):
            if q is None:
                return np.zeros(B, np.float32)
            return np.asarray(arrays_by_slot[s].ranges, np.float32)

        def fill_angles(s, q):
            if q is None:
                return np.zeros(B, np.float32)
            return np.asarray(arrays_by_slot[s].angles, np.float32)

        def fill_mask(s, q):
            if q is None:
                return np.zeros(B, bool)
            return np.asarray(arrays_by_slot[s].mask, bool)

        def fill_pose(s, q):
            if q is None:
                return np.zeros(3, np.float32)
            arrays = arrays_by_slot[s]
            map_local = P2.inverse_compound(
                q["local_map_node"].global_pose, q["query_node"].global_pose
            )
            return np.asarray(
                P2.compound(map_local, arrays.rel_sensor_pose), np.float32
            )

        def fill_off(s, q):
            if q is None:
                return np.zeros(2, np.float32)
            return np.asarray(q["local_map"].offset_xy, np.float32)

        mk = jax.make_array_from_callback
        prob_g = mk((C, H, W), sharding, map_cb("prob"))
        obs_g = mk((C, H, W), sharding, map_cb("observed"))
        rng_g = mk((C, B), sharding, small_cb(fill_ranges))
        ang_g = mk((C, B), sharding, small_cb(fill_angles))
        msk_g = mk((C, B), sharding, small_cb(fill_mask))
        pos_g = mk((C, 3), sharding, small_cb(fill_pose))
        off_g = mk((C, 2), sharding, small_cb(fill_off))

        out = self._fn(
            prob_g, obs_g, rng_g, ang_g, msk_g, pos_g, off_g,
            jnp.float32(self.cfg.score_threshold),
            jnp.float32(self.cfg.known_rate_threshold),
        )
        # Replicated outputs: every local device holds a full copy, but the
        # global array is not fully addressable in multi-process runs.
        # np.array (copy, not asarray): jax buffers view as READ-ONLY
        # numpy, and the pruned-inexact fallback below overwrites
        # per-candidate rows.
        best_pose, score, known, found, ncost, cov, exact = (
            np.array(o.addressable_data(0)) for o in out
        )

        # Final GN refine runs ONLY on the owner (it already holds the
        # cached raster; non-owners may have dropped theirs under the
        # Stage 5b retention policy), then the tiny refined poses are
        # exchanged so every process appends identical loop edges.  The
        # owner also resolves pruned-inexact candidates densely, and its
        # score rides along in the exchange so all processes agree.
        refined = np.zeros((C, 14), np.float64)
        for s, q in sorted(slot_to_query.items()):
            raster = raster_by_slot.get(s)
            if raster is None:  # not the owner of this map
                continue
            if not exact[s]:
                from .loop_sharded import _coarse_of

                arrays = arrays_by_slot[s]
                d = correlative_core_jit(
                    self.mcfg, raster.prob, raster.observed,
                    *_coarse_of(raster, self.mcfg.low_resolution),
                    arrays.ranges, arrays.angles, arrays.mask,
                    jnp.asarray(fill_pose(s, q)),
                    jnp.asarray(fill_off(s, q)),
                    jnp.float32(self.cfg.score_threshold),
                    jnp.float32(self.cfg.known_rate_threshold),
                    dense=True,
                )
                best_pose[s], score[s], found[s] = (
                    np.asarray(d[0]), float(d[1]), bool(d[3])
                )
            if not found[s]:
                continue
            arrays = arrays_by_slot[s]
            est_robot = P2.move_backward(
                np.asarray(best_pose[s], np.float64), arrays.rel_sensor_pose
            )
            final = self.final.optimize_pose(
                ScanMatchingQuery(raster, arrays, est_robot)
            )
            refined[s, :3] = final.estimated_pose
            refined[s, 3:12] = np.asarray(final.covariance).ravel()
            refined[s, 12] = 1.0
            refined[s, 13] = float(score[s])
        if self.num_processes > 1:
            from jax.experimental import multihost_utils

            # [P, C, 14]; each row is written by exactly one owner
            refined = np.asarray(
                multihost_utils.process_allgather(refined)
            ).sum(0)

        results = []
        for s, q in sorted(slot_to_query.items()):
            if not refined[s, 12]:
                continue
            results.append(
                dict(
                    relative_pose=refined[s, :3].copy(),
                    local_map_id=q["local_map"].local_map_id,
                    scan_node_id=q["query_node"].node_id,
                    covariance=refined[s, 3:12].reshape(3, 3).copy(),
                    score=float(refined[s, 13]),
                )
            )
        return results


def create_multihost_backend(
    mesh: Mesh,
    *,
    resolution: float = 0.05,
    beam_capacity: int = 512,
    usable_range_max: float = 20.0,
    n_theta_max: int = 208,
    crop: int = 448,
    score_threshold: float = 0.55,
    known_rate_threshold: float = 0.6,
    searcher_overrides: Optional[dict] = None,
    optimizer_overrides: Optional[dict] = None,
    inline: bool = True,
):
    """Backend with owner-routed multi-host loop detection + distributed
    Schur LM (the multi-host generalization of
    ``factory.create_distributed_backend``)."""
    from ..graph.optimizer import OptimizerConfig
    from ..loop.detector import LoopDetectorConfig
    from ..loop.searcher import LoopSearcherConfig, LoopSearcherNearest
    from ..matching.linear_solver import LinearSolverConfig, ScanMatcherLinearSolver
    from ..pipeline.backend import LidarGraphSlamBackend
    from .distributed import DistributedPoseGraphOptimizer

    searcher = LoopSearcherNearest(
        LoopSearcherConfig(**(searcher_overrides or {}))
    )
    mcfg = CorrelativeConfig(
        resolution=resolution,
        range_x=2.5, range_y=2.5, range_theta=0.5,
        n_theta_max=n_theta_max, crop_rows=crop, crop_cols=crop,
    )
    dcfg = LoopDetectorConfig(
        score_threshold=score_threshold,
        known_rate_threshold=known_rate_threshold,
        beam_capacity=beam_capacity,
        usable_range_max=usable_range_max,
    )
    final = ScanMatcherLinearSolver(LinearSolverConfig(resolution=resolution))
    detector = MultiHostLoopDetector(dcfg, mcfg, final, mesh, resolution)
    optimizer = DistributedPoseGraphOptimizer(
        mesh, OptimizerConfig(**(optimizer_overrides or {}))
    )
    return LidarGraphSlamBackend(searcher, detector, optimizer, inline=inline)
