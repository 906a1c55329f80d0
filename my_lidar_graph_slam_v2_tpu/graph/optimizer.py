"""Batched SE(2) pose-graph optimization (Levenberg-Marquardt).

Device replacement for both reference optimizers — the self-contained
sparse LM (``mapping/pose_graph_optimizer_lm.cpp``) and the g2o/Cholmod
delegate (``mapping/pose_graph_optimizer_g2o.cpp``).  Same problem
structure: bipartite graph of local-map nodes and scan nodes; edge error
``e = h(c_i, c_j) - z`` with ``h`` the relative pose of the scan node in
the map node's frame (``pose_graph_optimizer_lm.cpp:380-415``), robust
IRLS weight on loop edges only (lines 175-177), gauge fixed by adding 1e9
to the first map node's diagonal block, lambda halve/double schedule.

Instead of triplet assembly + Eigen SimplicialLDLT, everything is batched:
per-edge errors/Jacobians/blocks are computed for all edges at once, and
the normal equations are solved by one of

* ``dense``  — scatter blocks into the full [3(M+N)]^2 matrix, Cholesky;
* ``schur``  — eliminate scan nodes (block-diagonal after elimination
  because every edge touches exactly one scan node), solve the reduced
  local-map system densely, back-substitute.  This is the path that
  distributes across hosts (partial reduced systems -> psum), see
  parallel/distributed.py.

Shapes are padded to buckets so jit recompiles only O(log E) times as the
graph grows; padded edges carry zero information and contribute nothing.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from .loss import LossFunction


@dataclass(frozen=True)
class OptimizerConfig:
    solver: str = "schur"  # "dense" | "schur"
    num_iterations_max: int = 10
    error_tolerance: float = 1e-4
    initial_lambda: float = 1e-4
    loss: LossFunction = field(default_factory=LossFunction)
    # Max spectral norm for edge information matrices. The reference pins
    # the first scan node with a 1e-9-covariance edge (information 1e9,
    # lidar_graph_slam.cpp:427-429) and fixes the gauge with +1e9 on the
    # first diagonal block — both are catastrophic in f32. We clip edge
    # information and fix the gauge by hard elimination of the first map
    # node instead (exactly equivalent in the limit).
    info_clip: float = 1e5
    # Precision of the f32 contractions (jax.lax.Precision name).  "highest"
    # keeps them in full f32; "default" lets a GPU run them as TF32 (about
    # three decimal digits), kept only to measure that effect.
    precision: str = "highest"


def _edge_errors_jacobians(map_poses, scan_poses, map_idx, scan_idx, rel):
    """Errors and Jacobians for all edges
    (``ComputeErrorAndJacobians``, pose_graph_optimizer_lm.cpp:380-415)."""
    sp = map_poses[map_idx]  # [E, 3] start (local map) node
    ep = scan_poses[scan_idx]  # [E, 3] end (scan) node
    st, ct = jnp.sin(sp[:, 2]), jnp.cos(sp[:, 2])
    d = ep - sp
    x = ct * d[:, 0] + st * d[:, 1]
    y = -st * d[:, 0] + ct * d[:, 1]
    et = d[:, 2] - rel[:, 2]
    et = jnp.arctan2(jnp.sin(et), jnp.cos(et))  # normalize to (-pi, pi]
    e = jnp.stack([x - rel[:, 0], y - rel[:, 1], et], axis=-1)
    zeros = jnp.zeros_like(ct)
    ones = jnp.ones_like(ct)
    Js = jnp.stack(
        [
            jnp.stack([-ct, -st, y], -1),
            jnp.stack([st, -ct, -x], -1),
            jnp.stack([zeros, zeros, -ones], -1),
        ],
        axis=-2,
    )  # [E, 3, 3]
    Je = jnp.stack(
        [
            jnp.stack([ct, st, zeros], -1),
            jnp.stack([-st, ct, zeros], -1),
            jnp.stack([zeros, zeros, ones], -1),
        ],
        axis=-2,
    )
    return e, Js, Je


def _edge_blocks(map_poses, scan_poses, map_idx, scan_idx, rel, info, is_loop,
                 loss, precision):
    e, Js, Je = _edge_errors_jacobians(map_poses, scan_poses, map_idx, scan_idx, rel)
    ein = functools.partial(jnp.einsum, precision=precision)
    chi2 = ein("ei,eij,ej->e", e, info, e)
    w = jnp.where(is_loop > 0, loss.weight(chi2), 1.0)
    winfo = info * w[:, None, None]
    JsT_i = ein("eji,ejk->eik", Js, winfo)  # Js^T W
    JeT_i = ein("eji,ejk->eik", Je, winfo)
    Hss = jnp.matmul(JsT_i, Js, precision=precision)
    Hee = jnp.matmul(JeT_i, Je, precision=precision)
    Hse = jnp.matmul(JsT_i, Je, precision=precision)
    bs = -ein("eij,ej->ei", JsT_i, e)
    be = -ein("eij,ej->ei", JeT_i, e)
    return Hss, Hee, Hse, bs, be, chi2, e


def _total_error(map_poses, scan_poses, map_idx, scan_idx, rel, info, loss,
                 precision):
    """Robust total error (``ComputeTotalError``, lines 418-452: the loss
    is applied to every edge here, while IRLS weights gate loops only)."""
    e, _, _ = _edge_errors_jacobians(map_poses, scan_poses, map_idx, scan_idx, rel)
    chi2 = jnp.einsum("ei,eij,ej->e", e, info, e, precision=precision)
    return jnp.sum(loss.loss(chi2))


def _solve_dense(n_maps, n_scans, Hss, Hee, Hse, bs, be, map_idx, scan_idx, lam):
    nv = 3 * (n_maps + n_scans)
    H = jnp.zeros((nv, nv), jnp.float32)
    b = jnp.zeros((nv,), jnp.float32)

    def block_ix(base_idx):  # [E] -> row/col index grids for 3x3 blocks
        r = base_idx[:, None, None] * 3 + jnp.arange(3)[None, :, None]
        c = base_idx[:, None, None] * 3 + jnp.arange(3)[None, None, :]
        return r, c

    sm = map_idx
    se = n_maps + scan_idx
    for blocks, (bi, bj) in (
        (Hss, (sm, sm)),
        (Hee, (se, se)),
        (Hse, (sm, se)),
        (jnp.swapaxes(Hse, 1, 2), (se, sm)),
    ):
        r = bi[:, None, None] * 3 + jnp.arange(3)[None, :, None]
        c = bj[:, None, None] * 3 + jnp.arange(3)[None, None, :]
        H = H.at[r, c].add(blocks)
    b = b.at[sm[:, None] * 3 + jnp.arange(3)[None, :]].add(bs)
    b = b.at[se[:, None] * 3 + jnp.arange(3)[None, :]].add(be)

    H = H + lam * jnp.eye(nv, dtype=jnp.float32)
    # Gauge: hard-fix the first map node (zero its rows/cols, identity diag)
    mask = jnp.arange(nv) >= 3
    H = jnp.where(mask[:, None] & mask[None, :], H, 0.0)
    H = H.at[jnp.arange(3), jnp.arange(3)].set(1.0)
    b = jnp.where(mask, b, 0.0)
    dp = jax.scipy.linalg.solve(H, b, assume_a="pos")
    return dp[: 3 * n_maps].reshape(n_maps, 3), dp[3 * n_maps :].reshape(n_scans, 3)


def _solve_schur(
    n_maps, n_scans, Hss, Hee, Hse, bs, be, map_idx, scan_idx,
    pair_e1, pair_e2, lam, precision,
):
    """Schur-complement solve: eliminate scan nodes.

    ``pair_e1/pair_e2`` enumerate ordered pairs of edges sharing a scan
    node (host-precomputed); they generate the fill-in between map nodes in
    the reduced system."""
    eye = jnp.eye(3, dtype=jnp.float32)
    # Per-scan-node diagonal blocks (+ lambda)
    Hee_n = jax.ops.segment_sum(Hee, scan_idx, num_segments=n_scans)
    Hee_n = Hee_n + lam * eye
    be_n = jax.ops.segment_sum(be, scan_idx, num_segments=n_scans)
    Hee_inv = jnp.linalg.inv(Hee_n)  # [N, 3, 3]

    # W_e = Hse_e * Hee(scan_e)^-1
    W = jnp.matmul(Hse, Hee_inv[scan_idx], precision=precision)

    # Reduced RHS: bm - sum_e W_e be(scan_e)
    bm = jax.ops.segment_sum(bs, map_idx, num_segments=n_maps)
    bm_red = bm - jax.ops.segment_sum(
        jnp.einsum("eij,ej->ei", W, be_n[scan_idx], precision=precision),
        map_idx, num_segments=n_maps,
    )

    # Reduced matrix over map nodes
    nv = 3 * n_maps
    Hm = jnp.zeros((nv, nv), jnp.float32)
    r = map_idx[:, None, None] * 3 + jnp.arange(3)[None, :, None]
    c = map_idx[:, None, None] * 3 + jnp.arange(3)[None, None, :]
    Hm = Hm.at[r, c].add(Hss)
    # Fill-in: -(W_e1) Hse_e2^T at (map_e1, map_e2) for edge pairs sharing
    # a scan node
    fill = -jnp.matmul(
        W[pair_e1], jnp.swapaxes(Hse[pair_e2], 1, 2), precision=precision
    )
    rr = map_idx[pair_e1][:, None, None] * 3 + jnp.arange(3)[None, :, None]
    cc = map_idx[pair_e2][:, None, None] * 3 + jnp.arange(3)[None, None, :]
    Hm = Hm.at[rr, cc].add(fill)

    Hm = Hm + lam * jnp.eye(nv, dtype=jnp.float32)
    # Gauge: hard-fix the first map node
    mask = jnp.arange(nv) >= 3
    Hm = jnp.where(mask[:, None] & mask[None, :], Hm, 0.0)
    Hm = Hm.at[jnp.arange(3), jnp.arange(3)].set(1.0)
    bm_flat = jnp.where(mask, bm_red.reshape(-1), 0.0)

    dpm = jax.scipy.linalg.solve(Hm, bm_flat, assume_a="pos").reshape(
        n_maps, 3
    )
    # Back-substitute scan nodes:
    # dps_j = Hee_j^-1 (be_j - sum_{e: scan_e=j} Hse_e^T dpm(map_e))
    cross = jax.ops.segment_sum(
        jnp.einsum("eji,ej->ei", Hse, dpm[map_idx], precision=precision),
        scan_idx, num_segments=n_scans,
    )
    dps = jnp.einsum("nij,nj->ni", Hee_inv, be_n - cross, precision=precision)
    return dpm, dps


@functools.partial(
    jax.jit, static_argnames=("cfg", "n_maps", "n_scans")
)
def _optimize_core(
    cfg: OptimizerConfig,
    n_maps: int,
    n_scans: int,
    map_poses,
    scan_poses,
    map_idx,
    scan_idx,
    is_loop,
    rel,
    info,
    pair_e1,
    pair_e2,
    lam0,
):
    loss = cfg.loss
    prec = jax.lax.Precision(cfg.precision)

    def total(mp, sp):
        return _total_error(mp, sp, map_idx, scan_idx, rel, info, loss, prec)

    def step(mp, sp, lam):
        Hss, Hee, Hse, bs, be, _, _ = _edge_blocks(
            mp, sp, map_idx, scan_idx, rel, info, is_loop, loss, prec
        )
        if cfg.solver == "dense":
            dpm, dps = _solve_dense(
                n_maps, n_scans, Hss, Hee, Hse, bs, be, map_idx, scan_idx,
                lam,
            )
        else:
            dpm, dps = _solve_schur(
                n_maps, n_scans, Hss, Hee, Hse, bs, be, map_idx, scan_idx,
                pair_e1, pair_e2, lam, prec,
            )
        return mp + dpm, sp + dps

    def cond(state):
        mp, sp, prev_err, lam, it, done = state
        return jnp.logical_not(done)

    def body(state):
        mp, sp, prev_err, lam, it, done = state
        mp2, sp2 = step(mp, sp, lam)
        err = total(mp2, sp2)
        it2 = it + 1
        # LM accept/reject (pose_graph_optimizer_lm.cpp:88-94): keep the
        # step only if the error decreased, else revert and raise lambda.
        # A NaN err (failed Cholesky at tiny lambda) compares False and is
        # therefore rejected like any uphill step.
        good = err < prev_err
        mp3 = jnp.where(good, mp2, mp)
        sp3 = jnp.where(good, sp2, sp)
        err3 = jnp.where(good, err, prev_err)
        lam2 = jnp.where(good, lam * 0.5, lam * 2.0)
        stop = (it2 >= cfg.num_iterations_max) | (
            good & (prev_err - err < cfg.error_tolerance)
        ) | (lam2 > 1e12)
        return (mp3, sp3, err3, lam2, it2, stop)

    init_err = total(map_poses, scan_poses)
    state = (
        map_poses,
        scan_poses,
        jnp.float32(init_err),
        jnp.float32(lam0),
        jnp.int32(0),
        jnp.bool_(False),
    )
    mp, sp, err, lam, iters, _ = jax.lax.while_loop(cond, body, state)
    return mp, sp, err, lam, iters, init_err


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


class PoseGraphOptimizer:
    """Host wrapper: pads shapes to buckets, keeps the persistent lambda
    (the reference keeps ``mLambda`` across Optimize() calls)."""

    def __init__(self, cfg: OptimizerConfig = OptimizerConfig()):
        from ..metrics.registry import MetricManager

        self.cfg = cfg
        self.lam = cfg.initial_lambda
        # Register the reference series at construction so they appear in
        # the export even on runs with no loop closure
        # (pose_graph_optimizer_lm.cpp:17-35)
        vs = MetricManager.instance().value_sequence
        pre = "PoseGraphOptimizerLM."
        self._m = {
            n: vs(pre + n)
            for n in ("NumOfIterations", "InitialError", "FinalError",
                      "NumOfLocalMapNodes", "NumOfScanNodes", "NumOfEdges")
        }

    def optimize(self, map_poses, scan_poses, edges):
        """edges = (map_idx, scan_idx, is_loop, rel, info) as numpy arrays.
        Returns (map_poses, scan_poses, stats dict)."""
        map_idx, scan_idx, is_loop, rel, info = edges
        M, N, E = len(map_poses), len(scan_poses), len(map_idx)
        if E == 0:
            return map_poses, scan_poses, dict(iterations=0, error=0.0)
        # Always keep at least one padded (zero-information) edge slot: padded
        # Schur pair entries point at it so they contribute nothing.
        Mb, Nb, Eb = _bucket(M), _bucket(N), _bucket(E + 1)

        mp = np.zeros((Mb, 3), np.float32)
        mp[:M] = map_poses
        sp = np.zeros((Nb, 3), np.float32)
        sp[:N] = scan_poses
        mi = np.zeros(Eb, np.int32)
        mi[:E] = map_idx
        si = np.zeros(Eb, np.int32)
        si[:E] = scan_idx
        il = np.zeros(Eb, np.int32)
        il[:E] = is_loop
        rl = np.zeros((Eb, 3), np.float32)
        rl[:E] = rel
        im = np.zeros((Eb, 3, 3), np.float32)
        im[:E] = info
        # Clip edge information spectral norm (see cfg.info_clip)
        norms = np.linalg.norm(im[:E], ord=2, axis=(1, 2))
        big = norms > self.cfg.info_clip
        if big.any():
            im[:E][big] *= (self.cfg.info_clip / norms[big])[:, None, None]
        # Padded edges must not touch real nodes: point them at padded
        # node slots with zero information.
        mi[E:] = Mb - 1 if Mb > M else 0
        si[E:] = Nb - 1 if Nb > N else 0

        # Ordered pairs of distinct edges sharing a scan node (for Schur
        # fill-in); scan nodes with degree 1 generate none.
        pairs_1, pairs_2 = [], []
        by_scan = {}
        for eidx in range(E):
            by_scan.setdefault(int(scan_idx[eidx]), []).append(eidx)
        for edges_of_scan in by_scan.values():
            if len(edges_of_scan) > 1:
                for a in edges_of_scan:
                    for b in edges_of_scan:
                        if a != b:
                            pairs_1.append(a)
                            pairs_2.append(b)
        # Diagonal pairs (a == a) are NOT included: the diagonal reduced
        # term -W_e Hse_e^T for e itself must be there — include them.
        for eidx in range(E):
            pairs_1.append(eidx)
            pairs_2.append(eidx)
        P = len(pairs_1)
        Pb = _bucket(max(P, 1))
        p1 = np.zeros(Pb, np.int32)
        p2 = np.zeros(Pb, np.int32)
        p1[:P] = pairs_1
        p2[:P] = pairs_2
        # padded pairs reference the padded (zero-info) edge: contribute 0
        p1[P:] = Eb - 1
        p2[P:] = Eb - 1

        # Single device->host fetch of the whole solver result (per-scalar
        # lazy reads each cost a device round trip)
        mp2, sp2, err, lam, iters, init_err = jax.device_get(_optimize_core(
            self.cfg,
            Mb,
            Nb,
            jnp.asarray(mp),
            jnp.asarray(sp),
            jnp.asarray(mi),
            jnp.asarray(si),
            jnp.asarray(il),
            jnp.asarray(rl),
            jnp.asarray(im),
            jnp.asarray(p1),
            jnp.asarray(p2),
            jnp.float32(self.lam),
        ))
        self.lam = float(lam)
        stats = dict(
            iterations=int(iters),
            error=float(err),
            initial_error=float(init_err),
        )
        self._observe_metrics(M, N, E, stats)
        return (
            np.asarray(mp2[:M], np.float64),
            np.asarray(sp2[:N], np.float64),
            stats,
        )

    def _observe_metrics(self, n_maps, n_scans, n_edges, stats):
        """Parity series with ``pose_graph_optimizer_lm.cpp:17-35``."""
        self._m["NumOfIterations"].observe(stats["iterations"])
        self._m["InitialError"].observe(stats["initial_error"])
        self._m["FinalError"].observe(stats["error"])
        self._m["NumOfLocalMapNodes"].observe(n_maps)
        self._m["NumOfScanNodes"].observe(n_scans)
        self._m["NumOfEdges"].observe(n_edges)
