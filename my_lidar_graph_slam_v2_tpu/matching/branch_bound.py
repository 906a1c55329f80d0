"""Branch-and-bound scan matcher (bound-ordered block descent on device).

The reference (``mapping/scan_matcher_branch_bound.cpp:111-278``) runs a
best-first priority queue over a coarse-to-fine max pyramid (heights
0..node_height_max, window 2^h), with 4-way spatial splits and full theta
enumeration at the root.  Its bounds are admissible (the pyramid stores
window maxima), so the search returns exactly the leaf that maximizes the
fine score subject to the per-node gates.

Device formulation (this module): a data-dependent best-first QUEUE cannot
run inside one XLA program, but a data-dependent TRIP COUNT can — via
``lax.while_loop``:

1. one strided sweep of the level-h pyramid scores every 2^h-cell block
   across all thetas (one small matmul) — each block's max over theta
   is an admissible upper bound on every leaf inside it;
2. blocks are sorted by bound, descending;
3. a ``while_loop`` fine-sweeps one block per iteration (all thetas, one
   64-offset matmul at h=3) and stops as soon as the next block's bound
   cannot beat the running best (or fails the score threshold) — exactly
   the reference's prune rule, so the returned leaf is the same gated
   argmax the dense sweep finds.

The pyramid prune pays at loop windows, where few blocks survive; at
small frontend windows the dense sweep in one matmul is the better
choice.  ``scripts/eval_bb_pyramid.py`` times both on the device (not
yet measured on the GPU).

Block granularity: pruning bounds are evaluated at height
``min(node_height_max, 3)`` (8-cell blocks) — coarser levels make the
root bound vacuous at typical windows, finer ones spend more on bound
evaluation than they prune; the reference's multi-level splits collapse
to this single bound level without changing the winner (its intermediate
levels only ever prune supersets of what the finest bound level prunes).

Search-window coverage mirrors the reference: blocks of 2^h cells from
-win, i.e. fine offsets span [-win, -win + n_blocks * 2^h).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..core import pose as P
from ..ops import csm, gauss_newton, pool
from .cost import CostConfig, cost_at, covariance_at
from .types import ScanMatchingQuery, ScanMatchingSummary


@dataclass(frozen=True)
class BranchBoundConfig:
    node_height_max: int = 6
    range_x: float = 2.5
    range_y: float = 2.5
    range_theta: float = 0.5
    resolution: float = 0.05
    n_theta_max: int = 208
    crop_rows: int = 448
    crop_cols: int = 448
    covariance_scale: float = 1e4
    precision: str = "split"
    # Winner cost/covariance evaluator (reference CostType dispatch,
    # scan_matcher_factory.cpp:30-100); None = SquareError.
    cost: CostConfig = None

    @property
    def win_cells(self):
        wx = int(math.ceil(0.5 * self.range_x / self.resolution))
        wy = int(math.ceil(0.5 * self.range_y / self.resolution))
        return wx, wy

    @property
    def bound_height(self):
        """Pyramid level used for pruning bounds (see module docstring)."""
        return max(1, min(self.node_height_max, 3))

    @property
    def blocks(self):
        wx, wy = self.win_cells
        step = 1 << self.bound_height
        nbx = (2 * wx) // step + 1
        nby = (2 * wy) // step + 1
        return nbx, nby


@functools.partial(jax.jit, static_argnames=("cfg",))
def _branch_bound_core(
    cfg: BranchBoundConfig,
    prob,
    observed,
    pyr_p,
    pyr_o,
    ranges,
    angles,
    mask,
    sensor_pose,
    offset_xy,
    score_threshold,
    known_rate_threshold,
):
    wx, wy = cfg.win_cells
    nbx, nby = cfg.blocks
    block = 1 << cfg.bound_height
    T = cfg.n_theta_max

    step_theta, theta0, theta_mask = csm.theta_search_params(
        ranges, mask, cfg.resolution, cfg.range_theta, T
    )
    n_valid = jnp.maximum(jnp.sum(mask).astype(jnp.float32), 1.0)
    norm = 1.0 / n_valid

    # Shared hit images (one build for the bound sweep + every block)
    hr, hc, valid, r0, c0 = csm.beam_cells(
        ranges, angles, mask, sensor_pose, theta0, step_theta, theta_mask,
        cfg.resolution, offset_xy,
        n_theta=T, crop_rows=cfg.crop_rows, crop_cols=cfg.crop_cols,
    )
    hit_img = csm.build_hit_images(
        hr, hc, valid, theta_mask,
        crop_rows=cfg.crop_rows, crop_cols=cfg.crop_cols,
    )
    x0 = jnp.int32(-wx)
    y0 = jnp.int32(-wy)

    # 1. admissible block bounds from the level-h pyramid (window maxima
    #    upper-bound every leaf; PrecomputeGridMaps analogue).  The pyramid
    #    is an ARGUMENT: the host wrapper caches it per local map like the
    #    reference caches precomputed maps per map id
    #    (loop_detector_branch_bound.cpp:83-89), so repeat detections
    #    against the same (finished) map skip the recompute.
    c_scores, c_known = csm.sweep_from_hits(
        hit_img, r0, c0, pyr_p, pyr_o, x0, y0,
        nx=nbx, ny=nby, stride=block, precision=cfg.precision,
    )  # [T, nby, nbx] sums
    # known-rate bound gate (coarse known upper-bounds leaf known)
    known_ok = (c_known * norm > known_rate_threshold)
    bound = jnp.max(
        jnp.where(theta_mask[:, None, None] & known_ok, c_scores, -jnp.inf),
        axis=0,
    ).reshape(-1)  # [nby*nbx]

    # 2. blocks in descending-bound order
    order = jnp.argsort(-bound)
    n_blocks = nby * nbx
    thr_sum = score_threshold * n_valid  # gates compare score SUMS

    # 3. fine-sweep blocks until the next bound cannot win (the
    #    reference's prune rule; exact, data-dependent trip count)
    def cond(state):
        i, best_sum, _, _, _ = state
        return (i < n_blocks) & (
            bound[order[jnp.minimum(i, n_blocks - 1)]]
            > jnp.maximum(best_sum, thr_sum)
        )

    def body(state):
        i, best_sum, bt, bx, by = state
        blk = order[i]
        bj = blk // nbx
        bi = blk % nbx
        fx0 = x0 + (bi * block).astype(jnp.int32)
        fy0 = y0 + (bj * block).astype(jnp.int32)
        fs, fk = csm.sweep_from_hits(
            hit_img, r0, c0, prob, observed, fx0, fy0,
            nx=block, ny=block, stride=1, precision=cfg.precision,
        )  # [T, block, block]
        elig = theta_mask[:, None, None] & (fk * norm > known_rate_threshold)
        s_txy = jnp.where(elig, fs, -jnp.inf).transpose(0, 2, 1)
        flat = s_txy.reshape(-1)
        a = jnp.argmax(flat)
        s = flat[a]
        at = a // (block * block)
        ax = (a // block) % block
        ay = a % block
        better = s > best_sum
        return (
            i + 1,
            jnp.where(better, s, best_sum),
            jnp.where(better, at, bt),
            jnp.where(better, bi * block + ax, bx),
            jnp.where(better, bj * block + ay, by),
        )

    init = (jnp.int32(0), jnp.float32(-jnp.inf),
            jnp.int32(0), jnp.int32(0), jnp.int32(0))
    _, best_sum, bt, bx, by = jax.lax.while_loop(cond, body, init)

    best_score = best_sum * norm
    pose_found = best_score > score_threshold
    # Reference defaults best offsets to 0 when nothing clears the gates
    bx = jnp.where(pose_found, bx - wx, 0)
    by = jnp.where(pose_found, by - wy, 0)
    btt = jnp.where(pose_found, theta0 + bt, 0)

    best_sensor_pose = jnp.stack(
        [
            sensor_pose[0] + bx.astype(jnp.float32) * cfg.resolution,
            sensor_pose[1] + by.astype(jnp.float32) * cfg.resolution,
            sensor_pose[2] + btt.astype(jnp.float32) * step_theta,
        ]
    )
    # Winner cost/covariance through the configured CostType (reference
    # dispatch: scan_matcher_factory.cpp:30-100) — NOT hard-wired square
    # error; a GreedyEndpoint-configured matcher must evaluate greedy
    # endpoint cost here.
    ccfg = cfg.cost or CostConfig(covariance_scale=cfg.covariance_scale)
    ncost = cost_at(
        ccfg, prob, observed, ranges, angles, mask, best_sensor_pose,
        cfg.resolution, offset_xy,
    ) * norm
    cov = covariance_at(
        ccfg, prob, observed, ranges, angles, mask, best_sensor_pose,
        cfg.resolution, offset_xy,
    )
    return best_sensor_pose, best_score, pose_found, ncost, cov


class ScanMatcherBranchBound:
    def __init__(self, cfg: BranchBoundConfig):
        self.cfg = cfg

    def pyramid_of(self, grid_map):
        """Level-``bound_height`` pyramid maps, cached on the raster (the
        per-local-map precomputed-map cache of the reference,
        ``loop_detector_branch_bound.cpp:83-89``; entries live in the same
        ``coarse`` dict the map cache persists per (map id, version))."""
        key = ("pyr", self.cfg.bound_height)
        if key not in grid_map.coarse:
            grid_map.coarse[key] = (
                pool.pyramid_jit(grid_map.prob, self.cfg.bound_height)[-1],
                pool.pyramid_jit(grid_map.observed, self.cfg.bound_height)[-1],
            )
        return grid_map.coarse[key]

    def optimize_pose(
        self, query: ScanMatchingQuery,
        score_threshold: float = 0.0, known_rate_threshold: float = 0.0,
    ) -> ScanMatchingSummary:
        gm, scan = query.grid_map, query.scan
        sensor_pose = P.compound(query.initial_pose, scan.rel_sensor_pose)
        pyr_p, pyr_o = self.pyramid_of(gm)
        # Single device->host fetch of the whole result tuple (per-scalar
        # lazy reads would each pay a device round trip)
        pose_s, score, found, ncost, cov = jax.device_get(_branch_bound_core(
            self.cfg, gm.prob, gm.observed, pyr_p, pyr_o,
            scan.ranges, scan.angles,
            scan.mask, jnp.asarray(sensor_pose, jnp.float32),
            jnp.asarray(gm.offset_xy, jnp.float32),
            jnp.float32(score_threshold), jnp.float32(known_rate_threshold),
        ))
        est = P.move_backward(np.asarray(pose_s, np.float64), scan.rel_sensor_pose)
        return ScanMatchingSummary(
            pose_found=bool(found),
            normalized_cost=float(ncost),
            initial_pose=np.asarray(query.initial_pose),
            estimated_pose=est,
            covariance=np.asarray(cov, np.float64),
            normalized_score=float(score),
        )
