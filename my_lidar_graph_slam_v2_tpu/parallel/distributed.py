"""Distributed pose-graph optimization: Schur-complement BA over psum.

The multi-host/multi-device generalization of ``graph/optimizer.py`` and
the device replacement for the reference's single-threaded g2o solve:
edges are sharded across the mesh's candidate axis (grouped by scan node,
so all edges of one scan node are colocated and the Schur fill-in pairs
stay device-local); each device forms its partial reduced system; ``psum``
assembles the global reduced local-map system; the (small) dense solve is
replicated; back-substitution of scan-node increments is another psum.
Node poses are replicated — only constraint data shards.

This is the "keyframe/map-block sharding with distributed Schur-complement
BA over psum/all_gather collectives" axis of BASELINE.json.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..graph.loss import LossFunction
from ..graph.optimizer import (
    OptimizerConfig,
    _bucket,
    _edge_blocks,
    _total_error,
)
from .mesh import AXIS_CANDIDATES, to_global


def _local_schur_step(
    n_maps, n_scans, mp, sp, map_idx, scan_idx, is_loop, rel, info,
    pair_e1, pair_e2, lam, loss, axis, prec,
):
    """One LM step with device-local edge shards; returns (dpm, dps)
    replicated."""
    eye = jnp.eye(3, dtype=jnp.float32)
    Hss, Hee, Hse, bs, be, _, _ = _edge_blocks(
        mp, sp, map_idx, scan_idx, rel, info, is_loop, loss, prec
    )
    # Global per-scan diagonal blocks and RHS (psum over edge shards)
    Hee_n = jax.lax.psum(
        jax.ops.segment_sum(Hee, scan_idx, num_segments=n_scans), axis
    ) + lam * eye
    be_n = jax.lax.psum(
        jax.ops.segment_sum(be, scan_idx, num_segments=n_scans), axis
    )
    Hee_inv = jnp.linalg.inv(Hee_n)

    W = jnp.matmul(Hse, Hee_inv[scan_idx], precision=prec)
    bm = jax.ops.segment_sum(bs, map_idx, num_segments=n_maps)
    bm_red = bm - jax.ops.segment_sum(
        jnp.einsum("eij,ej->ei", W, be_n[scan_idx], precision=prec),
        map_idx, num_segments=n_maps,
    )
    bm_red = jax.lax.psum(bm_red, axis)

    nv = 3 * n_maps
    Hm = jnp.zeros((nv, nv), jnp.float32)
    r = map_idx[:, None, None] * 3 + jnp.arange(3)[None, :, None]
    c = map_idx[:, None, None] * 3 + jnp.arange(3)[None, None, :]
    Hm = Hm.at[r, c].add(Hss)
    fill = -jnp.matmul(
        W[pair_e1], jnp.swapaxes(Hse[pair_e2], 1, 2), precision=prec
    )
    rr = map_idx[pair_e1][:, None, None] * 3 + jnp.arange(3)[None, :, None]
    cc = map_idx[pair_e2][:, None, None] * 3 + jnp.arange(3)[None, None, :]
    Hm = Hm.at[rr, cc].add(fill)
    Hm = jax.lax.psum(Hm, axis)

    Hm = Hm + lam * jnp.eye(nv, dtype=jnp.float32)
    mask = jnp.arange(nv) >= 3
    Hm = jnp.where(mask[:, None] & mask[None, :], Hm, 0.0)
    Hm = Hm.at[jnp.arange(3), jnp.arange(3)].set(1.0)
    bmf = jnp.where(mask, bm_red.reshape(-1), 0.0)
    dpm = jax.scipy.linalg.solve(Hm, bmf, assume_a="pos").reshape(n_maps, 3)

    cross = jax.lax.psum(
        jax.ops.segment_sum(
            jnp.einsum("eji,ej->ei", Hse, dpm[map_idx], precision=prec),
            scan_idx,
            num_segments=n_scans,
        ),
        axis,
    )
    dps = jnp.einsum("nij,nj->ni", Hee_inv, be_n - cross, precision=prec)
    return dpm, dps


def _local_total_error(mp, sp, map_idx, scan_idx, rel, info, loss, axis,
                       prec):
    return jax.lax.psum(
        _total_error(mp, sp, map_idx, scan_idx, rel, info, loss, prec), axis
    )


def make_distributed_optimize(mesh: Mesh, cfg: OptimizerConfig, n_maps: int, n_scans: int):
    """Build the jitted distributed LM optimize function for static
    (bucketed) sizes. Edge arrays are sharded over the mesh axis; poses
    replicated."""
    axis = AXIS_CANDIDATES
    loss = cfg.loss
    prec = jax.lax.Precision(cfg.precision)

    def opt(mp, sp, map_idx, scan_idx, is_loop, rel, info, p1, p2, lam0):
        def cond(state):
            return jnp.logical_not(state[-1])

        def body(state):
            mp, sp, prev_err, lam, it, done = state
            dpm, dps = _local_schur_step(
                n_maps, n_scans, mp, sp, map_idx, scan_idx, is_loop, rel,
                info, p1, p2, lam, loss, axis, prec,
            )
            mp2, sp2 = mp + dpm, sp + dps
            err = _local_total_error(
                mp2, sp2, map_idx, scan_idx, rel, info, loss, axis, prec
            )
            it2 = it + 1
            # LM accept/reject (see graph/optimizer.py): revert uphill/NaN
            # steps and raise lambda instead of poisoning the iterate.
            good = err < prev_err
            mp3 = jnp.where(good, mp2, mp)
            sp3 = jnp.where(good, sp2, sp)
            err3 = jnp.where(good, err, prev_err)
            lam2 = jnp.where(good, lam * 0.5, lam * 2.0)
            stop = (it2 >= cfg.num_iterations_max) | (
                good & (prev_err - err < cfg.error_tolerance)
            ) | (lam2 > 1e12)
            return (mp3, sp3, err3, lam2, it2, stop)

        init_err = _local_total_error(
            mp, sp, map_idx, scan_idx, rel, info, loss, axis, prec
        )
        state = (mp, sp, init_err, jnp.float32(lam0), jnp.int32(0), jnp.bool_(False))
        mp, sp, err, lam, iters, _ = jax.lax.while_loop(cond, body, state)
        return mp, sp, err, lam, iters

    sharded = jax.shard_map(
        opt,
        mesh=mesh,
        in_specs=(
            P(), P(),  # poses replicated
            P(axis), P(axis), P(axis), P(axis), P(axis),  # edge shards
            P(axis), P(axis),  # pair shards
            P(),
        ),
        out_specs=(P(), P(), P(), P(), P()),
    )
    return jax.jit(sharded)


class DistributedPoseGraphOptimizer:
    """Host wrapper: partitions edges by scan node across devices (keeps
    Schur pairs local), pads shards, runs the distributed LM."""

    def __init__(self, mesh: Mesh, cfg: OptimizerConfig = OptimizerConfig()):
        from ..metrics.registry import MetricManager

        self.mesh = mesh
        self.cfg = cfg
        self.lam = cfg.initial_lambda
        self._cache = {}
        # Same reference series as the single-chip LM
        # (pose_graph_optimizer_lm.cpp:17-35)
        vs = MetricManager.instance().value_sequence
        pre = "PoseGraphOptimizerLM."
        self._m = {
            n: vs(pre + n)
            for n in ("NumOfIterations", "FinalError",
                      "NumOfLocalMapNodes", "NumOfScanNodes", "NumOfEdges")
        }

    def optimize(self, map_poses, scan_poses, edges):
        map_idx, scan_idx, is_loop, rel, info = edges
        M, N, E = len(map_poses), len(scan_poses), len(map_idx)
        D = self.mesh.devices.size
        if E == 0:
            return map_poses, scan_poses, dict(iterations=0, error=0.0)

        # Group edges by scan node, round-robin scan nodes over devices
        by_scan = {}
        for eidx in range(E):
            by_scan.setdefault(int(scan_idx[eidx]), []).append(eidx)
        shards = [[] for _ in range(D)]
        for k, (sid, eidxs) in enumerate(sorted(by_scan.items())):
            shards[k % D].extend(eidxs)
        per_dev = _bucket(max(max(len(s) for s in shards), 1) + 1)

        Mb, Nb = _bucket(M), _bucket(N)
        mi = np.zeros((D, per_dev), np.int32)
        si = np.zeros((D, per_dev), np.int32)
        il = np.zeros((D, per_dev), np.int32)
        rl = np.zeros((D, per_dev, 3), np.float32)
        im = np.zeros((D, per_dev, 3, 3), np.float32)
        mi[:, :] = Mb - 1 if Mb > M else 0
        si[:, :] = Nb - 1 if Nb > N else 0
        pairs = [[] for _ in range(D)]
        for d, eidxs in enumerate(shards):
            for j, eidx in enumerate(eidxs):
                mi[d, j] = map_idx[eidx]
                si[d, j] = scan_idx[eidx]
                il[d, j] = is_loop[eidx]
                rl[d, j] = rel[eidx]
                im[d, j] = info[eidx]
            # local Schur pairs (incl. diagonal) within this shard
            local_by_scan = {}
            for j, eidx in enumerate(eidxs):
                local_by_scan.setdefault(int(scan_idx[eidx]), []).append(j)
            for group in local_by_scan.values():
                for a in group:
                    for b in group:
                        pairs[d].append((a, b))
        norms = np.linalg.norm(im.reshape(-1, 3, 3), ord=2, axis=(1, 2))
        big = norms > 1e5
        if big.any():
            im = im.reshape(-1, 3, 3)
            im[big] *= (1e5 / norms[big])[:, None, None]
            im = im.reshape(D, per_dev, 3, 3)

        pair_count = _bucket(max(max(len(p) for p in pairs), 1))
        p1 = np.full((D, pair_count), per_dev - 1, np.int32)
        p2 = np.full((D, pair_count), per_dev - 1, np.int32)
        for d, pl in enumerate(pairs):
            for k, (a, b) in enumerate(pl):
                p1[d, k] = a
                p2[d, k] = b

        mp = np.zeros((Mb, 3), np.float32)
        mp[:M] = map_poses
        sp = np.zeros((Nb, 3), np.float32)
        sp[:N] = scan_poses

        key = (Mb, Nb, per_dev, pair_count)
        if key not in self._cache:
            self._cache[key] = make_distributed_optimize(
                self.mesh, self.cfg, Mb, Nb
            )
        fn = self._cache[key]
        if jax.process_count() > 1:
            # Multi-host: every process computed the identical edge layout
            # (replicated host state); convert to global arrays so each
            # process uploads only its addressable edge shards.
            A = P(AXIS_CANDIDATES)
            R = P()
            args = (
                to_global(mp, self.mesh, R),
                to_global(sp, self.mesh, R),
                to_global(mi.reshape(-1), self.mesh, A),
                to_global(si.reshape(-1), self.mesh, A),
                to_global(il.reshape(-1), self.mesh, A),
                to_global(rl.reshape(-1, 3), self.mesh, A),
                to_global(im.reshape(-1, 3, 3), self.mesh, A),
                to_global(p1.reshape(-1), self.mesh, A),
                to_global(p2.reshape(-1), self.mesh, A),
                jnp.float32(self.lam),
            )
        else:
            args = (
                jnp.asarray(mp),
                jnp.asarray(sp),
                jnp.asarray(mi.reshape(-1)),
                jnp.asarray(si.reshape(-1)),
                jnp.asarray(il.reshape(-1)),
                jnp.asarray(rl.reshape(-1, 3)),
                jnp.asarray(im.reshape(-1, 3, 3)),
                jnp.asarray(p1.reshape(-1)),
                jnp.asarray(p2.reshape(-1)),
                jnp.float32(self.lam),
            )
        mp2, sp2, err, lam, iters = fn(*args)
        if jax.process_count() > 1:
            # Replicated outputs are not fully addressable across
            # processes; every local device holds a complete copy.
            mp2, sp2, err, lam, iters = (
                np.asarray(a.addressable_data(0))
                for a in (mp2, sp2, err, lam, iters)
            )
        self.lam = float(lam)
        self._m["NumOfIterations"].observe(int(iters))
        self._m["FinalError"].observe(float(err))
        self._m["NumOfLocalMapNodes"].observe(M)
        self._m["NumOfScanNodes"].observe(N)
        self._m["NumOfEdges"].observe(E)
        return (
            np.asarray(mp2[:M], np.float64),
            np.asarray(sp2[:N], np.float64),
            dict(iterations=int(iters), error=float(err)),
        )
