"""Real-time correlative scan matcher on the device.

Functional equivalent of ``ScanMatcherCorrelative``
(``scan_matcher_correlative.cpp:116-368``) and its FPGA twin
(``scan_matcher_correlative_fpga.cpp``): instead of walking candidates
sequentially with coarse-map pruning against a running maximum, the whole
window is evaluated as two dense sweeps (ops/csm.py) and the winner picked
by a masked argmax:

* coarse sweep: stride ``low_resolution`` on the sliding-window-max map —
  used only for the score/known-rate *gating* semantics of the reference
  (a fine candidate is eligible iff its coarse block passes both
  thresholds; since the coarse map upper-bounds the fine scores, the
  surviving argmax is identical to the reference's prune-then-descend).
* fine sweep: stride 1 over the union of all coarse blocks
  ``[-win, -win + n_blocks*low_res)``, matching the reference's
  ``EvaluateHighResolutionMap`` block extent.
* tie-break: candidates ordered (theta, x, y) with first-wins argmax,
  matching the reference loop nesting.

The argmax pose is then polished by the caller's final matcher (GN); this
class also reports cost and covariance at the winner like the reference
(``scan_matcher_correlative.cpp:209-216``).
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
from .types import MapRaster, ScanArrays, ScanMatchingQuery, ScanMatchingSummary


@dataclass(frozen=True)
class CorrelativeConfig:
    low_resolution: int = 5
    range_x: float = 0.25
    range_y: float = 0.25
    range_theta: float = 0.5
    resolution: float = 0.05
    n_theta_max: int = 208
    crop_rows: int = 384
    crop_cols: int = 384
    covariance_scale: float = 1e4
    precision: str = "split"
    # Winner cost/covariance evaluator (reference: CostType/CostConfigGroup
    # per matcher group, scan_matcher_factory.cpp:160-189).  None selects
    # SquareError with this config's covariance_scale.
    cost: CostConfig = None
    # Fine sweep runs only the top-K thetas ranked by their coarse upper
    # bound (0 disables).  Exact whenever the winning fine score beats the
    # (K+1)-th theta's bound — the sliding-window-max coarse map bounds
    # every fine score in the block, the same invariant the reference's
    # prune-then-descend relies on (scan_matcher_correlative.cpp:178-189).
    # The core reports an `exact` flag; the host wrapper re-runs the dense
    # sweep on the (rare) inexact case.
    fine_theta_k: int = 32
    # "matmul" (default): hit-image x map-patch matmul formulation.
    # "gather": per-beam window gathers (ops/csm.sweep_windows) —
    # algorithmically minimal bytes and no crop clipping (every beam
    # scores, like the reference).  Kept as the semantics oracle; which
    # of the two is faster on the GPU is still to be measured.
    sweep_backend: str = "matmul"
    # Fine sweep evaluates only the offsets of the B coarse blocks with
    # the largest gated coarse bound (0 disables; ignored when the
    # window has <= B blocks).  Same certified-prune pattern as
    # fine_theta_k: the coarse block value upper-bounds every fine score
    # in the block, so the result is exact whenever the winner beats the
    # (B+1)-th block bound; the core's `exact` flag covers both prunes
    # and the host wrapper re-runs densely otherwise.  Matters most for
    # loop-detection windows (11x11 blocks -> ~15x less fine-sweep
    # traffic); the frontend's 2x2-block window is below the threshold.
    fine_block_b: int = 10
    # int8 hit images + int8 matmul coarse sweep for u8 maps: halves the
    # dominant sweep bytes (the T x crop^2 hit images, written by the
    # build and read by the coarse matmul) with bit-identical scores
    # (ops/csm.sweep_from_hits_int8).  Hit counts above 127 would wrap;
    # the core folds a max-multiplicity check into its `exact` flag and
    # the host wrapper re-runs densely (bf16) on the degenerate case.
    coarse_int8: bool = True

    @property
    def win_cells(self):
        wx = int(math.ceil(0.5 * self.range_x / self.resolution))
        wy = int(math.ceil(0.5 * self.range_y / self.resolution))
        return wx, wy

    @property
    def blocks(self):
        wx, wy = self.win_cells
        nbx = (2 * wx) // self.low_resolution + 1
        nby = (2 * wy) // self.low_resolution + 1
        return nbx, nby


# NOTE: deliberately NOT @jax.jit.  This core is embedded in larger jitted
# computations (the fused frontend matcher, the vmapped/sharded batch loop
# detectors, the benchmark); a nested jit becomes an XLA call boundary
# that blocks fusion across the hit-image build and sweeps.  Host-side
# callers use ``correlative_core_jit`` below.  The stages carry stable
# named scopes (csm_hit_images, csm_coarse_sweep, csm_fine_sweep,
# csm_winner_cost_cov) so a profiler trace attributes device time to
# them (bench.py --trace).
def _correlative_core(
    cfg: CorrelativeConfig,
    prob,
    observed,
    coarse_prob,
    coarse_observed,
    ranges,
    angles,
    mask,
    sensor_pose,
    offset_xy,
    score_threshold,
    known_rate_threshold,
    *,
    dense: bool = False,
):
    wx, wy = cfg.win_cells
    nbx, nby = cfg.blocks
    nxf, nyf = nbx * cfg.low_resolution, nby * cfg.low_resolution
    T = cfg.n_theta_max

    step_theta, theta0, theta_mask = csm.theta_search_params(
        ranges, mask, cfg.resolution, cfg.range_theta, T
    )
    n_valid = jnp.sum(mask).astype(jnp.float32)
    norm = 1.0 / jnp.maximum(n_valid, 1.0)

    x0 = jnp.int32(-wx)
    y0 = jnp.int32(-wy)
    gather = cfg.sweep_backend == "gather"
    if gather:
        # Per-beam window gathers (ops/csm.sweep_windows): shared absolute
        # endpoint cells for both sweeps, no crop, no hit images.
        if coarse_prob is None:
            coarse_prob = pool.sliding_window_max2d(
                prob, cfg.low_resolution
            )
            coarse_observed = pool.sliding_window_max2d(
                observed, cfg.low_resolution
            )
        row, col, ok = csm.beam_cells_abs(
            ranges, angles, mask, sensor_pose, theta0, step_theta,
            theta_mask, cfg.resolution, offset_xy, n_theta=T,
        )
        c_scores, c_known = csm.sweep_windows(
            coarse_prob, coarse_observed, row, col, ok, y0, x0,
            ny=nby, nx=nbx, stride=cfg.low_resolution,
        )
    else:
        # Shared beam geometry + hit images: the coarse and fine sweeps
        # use identical per-theta endpoint cells, so the (dominant)
        # one-hot hit image build happens once.
        hr, hc, valid, r0, c0 = csm.beam_cells(
            ranges, angles, mask, sensor_pose, theta0, step_theta,
            theta_mask, cfg.resolution, offset_xy,
            n_theta=T, crop_rows=cfg.crop_rows, crop_cols=cfg.crop_cols,
        )
        use_int8 = (
            (not dense)
            and cfg.coarse_int8
            and prob.dtype == jnp.uint8
            and cfg.precision != "highest"
        )
        with jax.named_scope("csm_hit_images"):
            hit_img = csm.build_hit_images(
                hr, hc, valid, theta_mask,
                crop_rows=cfg.crop_rows, crop_cols=cfg.crop_cols,
                dtype=jnp.int8 if use_int8 else jnp.bfloat16,
            )
        if use_int8:
            ok_tb = valid & theta_mask[:, None]
            row_counts = jnp.sum(ok_tb, axis=1).astype(jnp.float32)
            int8_ok = (
                csm.max_hit_multiplicity(
                    hr, hc, ok_tb, crop_cols=cfg.crop_cols
                )
                <= 127
            )
        if coarse_prob is None:
            # Pool-on-crop: the sliding-window-max precompute only needs
            # the coarse sweep's input window (crop + window extent), not
            # the whole raster — ~6x less pooled area for a 1024^2 map at
            # crop 384.  Values are identical to slicing a full pooled
            # map: the slice carries a (win-1)-cell margin so every
            # output cell sees its complete window, and out-of-raster
            # cells are zero in both formulations.  Callers with a cached
            # full pooled map (loop detectors) pass it instead.
            win = cfg.low_resolution
            in_rows = cfg.crop_rows + (nby - 1) * win
            in_cols = cfg.crop_cols + (nbx - 1) * win
            with jax.named_scope("csm_coarse_sweep"):
                seg = csm.sweep_input_window(
                    prob, observed, r0, c0, x0, y0,
                    in_rows=in_rows + win - 1, in_cols=in_cols + win - 1,
                    precision=cfg.precision,
                )
                pooled = pool.sliding_window_max2d(seg, win)
                coarse_inp = pooled[:, :in_rows, :in_cols]
        else:
            coarse_inp = None
        if use_int8:
            if coarse_inp is None:
                win = cfg.low_resolution
                coarse_inp = csm.sweep_input_window(
                    coarse_prob, coarse_observed, r0, c0, x0, y0,
                    in_rows=cfg.crop_rows + (nby - 1) * win,
                    in_cols=cfg.crop_cols + (nbx - 1) * win,
                    precision=cfg.precision,
                )
            with jax.named_scope("csm_coarse_sweep"):
                c_scores, c_known = csm.sweep_from_hits_int8(
                    hit_img, row_counts, coarse_inp,
                    nx=nbx, ny=nby, stride=cfg.low_resolution,
                )
        else:
            with jax.named_scope("csm_coarse_sweep"):
                c_scores, c_known = csm.sweep_from_hits(
                    hit_img, r0, c0,
                    coarse_prob if coarse_prob is not None else prob,
                    coarse_observed if coarse_prob is not None else observed,
                    x0, y0,
                    nx=nbx, ny=nby, stride=cfg.low_resolution,
                    precision=cfg.precision, precut_inp=coarse_inp,
                )

    # Reference gating: a fine candidate is reachable iff its coarse block
    # beats BOTH thresholds (scan_matcher_correlative.cpp:178-189)
    block_ok = (c_scores * norm > score_threshold) & (
        c_known * norm > known_rate_threshold
    ) & theta_mask[:, None, None]  # [T, nby, nbx]

    use_topk = (not dense) and 0 < cfg.fine_theta_k < T
    if use_topk:
        # Fine-sweep only the K thetas whose best gated coarse block (an
        # upper bound on every fine score at that theta) is largest.
        K = cfg.fine_theta_k
        bound = jnp.max(
            jnp.where(block_ok, c_scores, -jnp.inf), axis=(1, 2)
        )  # [T]
        kth_bound, sel_theta = jax.lax.top_k(bound, K)
        kth_bound = kth_bound[K - 1]
        ok_rows = jnp.take(block_ok, sel_theta, axis=0)
    else:
        sel_theta = jnp.arange(T, dtype=jnp.int32)
        ok_rows = block_ok

    # Top-B coarse-block prune of the fine sweep (matmul path): evaluate
    # only the offsets of the B blocks whose gated coarse bound is
    # largest — the dominant fine-sweep cost (one crop-sized map patch
    # materialized per offset) scales with the offset count.  Certified
    # like the theta prune: exact iff the winner beats the (B+1)-th
    # block bound.
    LR = cfg.low_resolution
    n_blocks = nby * nbx
    use_blocks = (
        (not dense) and (not gather) and 0 < cfg.fine_block_b < n_blocks
    )
    c_sel = jnp.take(c_scores, sel_theta, axis=0) if use_topk else c_scores

    if gather:
        if use_topk:
            row_sel = jnp.take(row, sel_theta, axis=0)
            col_sel = jnp.take(col, sel_theta, axis=0)
            ok_sel = jnp.take(ok, sel_theta, axis=0)
        else:
            row_sel, col_sel, ok_sel = row, col, ok
        f_scores, f_known = csm.sweep_windows(
            prob, observed, row_sel, col_sel, ok_sel, y0, x0,
            ny=nyf, nx=nxf, stride=1,
        )  # [R, nyf, nxf] with R = K or T
    else:
        hit_sel = (
            jnp.take(hit_img, sel_theta, axis=0) if use_topk else hit_img
        )
        # Small windows ride the int8 matmul for the FINE sweep too (same
        # exact centering-correction arithmetic, half the patch bytes);
        # big windows (dense loop sweeps) and the block-pruned path stay
        # bf16 (their patch builders chunk/select differently).
        fine_int8 = (
            (not gather)
            and hit_sel.dtype == jnp.int8
            and not use_blocks
            and nxf * nyf <= 256
        )
        if hit_sel.dtype == jnp.int8 and not fine_int8:
            hit_sel = hit_sel.astype(jnp.bfloat16)
        if use_blocks:
            Bb = cfg.fine_block_b
            blk_bound = jnp.max(
                jnp.where(ok_rows, c_sel, -jnp.inf), axis=0
            ).reshape(-1)  # [n_blocks], flattened by * nbx + bx
            bvals, bidx = jax.lax.top_k(blk_bound, Bb + 1)
            blk_next_bound = bvals[Bb]
            bsel = bidx[:Bb]
            by_b, bx_b = bsel // nbx, bsel % nbx
            dj, di = np.meshgrid(np.arange(LR), np.arange(LR),
                                 indexing="ij")
            dj = jnp.asarray(dj.reshape(-1), jnp.int32)
            di = jnp.asarray(di.reshape(-1), jnp.int32)
            offs_y = (by_b[:, None] * LR + dj[None, :]).reshape(-1)
            offs_x = (bx_b[:, None] * LR + di[None, :]).reshape(-1)
            off_ji = jnp.stack([offs_y, offs_x], axis=-1)
            with jax.named_scope("csm_fine_sweep"):
                f_scores, f_known = csm.sweep_from_hits_at(
                    hit_sel, r0, c0, prob, observed, x0, y0, off_ji,
                    max_j=nyf - 1, max_i=nxf - 1, precision=cfg.precision,
                )  # [R, Bb*LR*LR]
        elif fine_int8:
            fine_inp = csm.sweep_input_window(
                prob, observed, r0, c0, x0, y0,
                in_rows=cfg.crop_rows + nyf - 1,
                in_cols=cfg.crop_cols + nxf - 1,
                precision=cfg.precision,
            )
            rc_sel = (
                jnp.take(row_counts, sel_theta, axis=0)
                if use_topk else row_counts
            )
            with jax.named_scope("csm_fine_sweep"):
                f_scores, f_known = csm.sweep_from_hits_int8(
                    hit_sel, rc_sel, fine_inp, nx=nxf, ny=nyf, stride=1,
                )
        else:
            with jax.named_scope("csm_fine_sweep"):
                f_scores, f_known = csm.sweep_from_hits(
                    hit_sel, r0, c0, prob, observed, x0, y0,
                    nx=nxf, ny=nyf, stride=1, precision=cfg.precision,
                )

    # Flatten (scores, known, eligibility, window coords) to a unified
    # [R, n_off] layout so the winner selection below is identical for
    # the dense, gather, and block-pruned shapes.
    if use_blocks:
        elig_f = jnp.repeat(
            jnp.take(
                ok_rows.reshape(ok_rows.shape[0], -1), bsel, axis=1
            ),
            LR * LR,
            axis=1,
        )  # [R, Bb*LR*LR]
        f_scores_f, f_known_f = f_scores, f_known
    else:
        eligible = jnp.repeat(
            jnp.repeat(ok_rows, LR, axis=1), LR, axis=2
        )  # [R, nyf, nxf]
        elig_f = eligible.reshape(eligible.shape[0], -1)
        f_scores_f = f_scores.reshape(f_scores.shape[0], -1)
        f_known_f = f_known.reshape(f_known.shape[0], -1)
        jg, ig = np.meshgrid(np.arange(nyf), np.arange(nxf),
                             indexing="ij")
        offs_y = jnp.asarray(jg.reshape(-1), jnp.int32)
        offs_x = jnp.asarray(ig.reshape(-1), jnp.int32)
    n_off = f_scores_f.shape[1]

    # Winner with the reference's (theta, x, y) loop-nesting tie-break:
    # max score, ties broken by smallest global candidate order.  (The
    # top-K rows are bound-ordered, so plain first-wins argmax would not
    # reproduce the dense ordering.)
    flat = jnp.where(elig_f, f_scores_f, -jnp.inf).reshape(-1)
    best_sum = jnp.max(flat)
    order = (
        (sel_theta[:, None] * nxf + offs_x[None, :]) * nyf
        + offs_y[None, :]
    ).reshape(-1)
    big = jnp.int32(np.iinfo(np.int32).max)
    best = jnp.argmin(jnp.where(flat == best_sum, order, big))
    rt, oi = best // n_off, best % n_off
    bt = sel_theta[rt]
    bx = offs_x[oi]
    by = offs_y[oi]
    best_score = best_sum * norm
    best_known = f_known_f.reshape(-1)[best] * norm
    pose_found = best_score > score_threshold
    # Exact unless a pruned theta's (or block's) bound could still beat
    # the winner.
    exact = jnp.bool_(True)
    if use_topk:
        exact = exact & (best_sum >= kth_bound)
    if use_blocks:
        exact = exact & (best_sum >= blk_next_bound)
    if (not gather) and use_int8:
        # int8 hit counts wrap above 127 beams per cell — degenerate
        # scans fall back to the dense bf16 path via the host wrapper.
        exact = exact & int8_ok

    best_sensor_pose = jnp.stack(
        [
            sensor_pose[0] + (bx.astype(jnp.float32) - wx) * cfg.resolution,
            sensor_pose[1] + (by.astype(jnp.float32) - wy) * cfg.resolution,
            sensor_pose[2]
            + (theta0 + bt).astype(jnp.float32) * step_theta,
        ]
    )

    ccfg = cfg.cost or CostConfig(covariance_scale=cfg.covariance_scale)
    with jax.named_scope("csm_winner_cost_cov"):
        cost_val = cost_at(
            ccfg, prob, observed, ranges, angles, mask, best_sensor_pose,
            cfg.resolution, offset_xy,
        )
        cov = covariance_at(
            ccfg, prob, observed, ranges, angles, mask, best_sensor_pose,
            cfg.resolution, offset_xy,
        )
    # Candidate accounting (parity with the reference's NumOfProcessedNodes/
    # NumOfIgnoredNodes series, scan_matcher_correlative.cpp:16-71): fine
    # nodes whose coarse block passed both gates were "processed", the rest
    # of the window was pruned.  Counted over the FULL theta window (from
    # block_ok) so the series is identical under top-K pruning.
    n_processed = (
        jnp.sum(block_ok).astype(jnp.int32)
        * jnp.int32(cfg.low_resolution**2)
    )
    n_total = (
        jnp.sum(theta_mask).astype(jnp.int32) * jnp.int32(nxf) * jnp.int32(nyf)
    )
    return (
        best_sensor_pose,
        best_score,
        best_known,
        pose_found,
        cost_val * norm,
        cov,
        n_processed,
        n_total,
        exact,
    )


correlative_core_jit = functools.partial(
    jax.jit, static_argnames=("cfg", "dense")
)(_correlative_core)


class MatcherMetrics:
    """The reference's per-matcher series set
    (``scan_matcher_correlative.cpp:16-71``), registered lazily under the
    matcher's name (times in microseconds like the reference's
    ``Timer::ElapsedMicro``)."""

    _NAMES = (
        "InputSetupTime", "OptimizationTime", "DiffTranslation",
        "DiffRotation", "WinSizeX", "WinSizeY", "WinSizeTheta",
        "StepSizeX", "StepSizeY", "StepSizeTheta", "NumOfIgnoredNodes",
        "NumOfProcessedNodes", "ScoreValue", "CostValue", "NumOfScans",
    )

    def __init__(self, matcher_name: str):
        from ..metrics.registry import MetricManager

        vs = MetricManager.instance().value_sequence
        for n in self._NAMES:
            setattr(self, n, vs(f"{matcher_name}.{n}"))


class ScanMatcherCorrelative:
    """Host-side wrapper holding the static config and coarse-map cache."""

    def __init__(self, cfg: CorrelativeConfig, name: str = "ScanMatcherCorrelative"):
        self.cfg = cfg
        self.name = name
        self.metrics = MatcherMetrics(name)

    def coarse_of(self, grid_map: MapRaster):
        key = ("swmax", self.cfg.low_resolution)
        if key not in grid_map.coarse:
            # Jitted wrapper: from host code the plain op would run its
            # O(log win) shift/max chain eagerly, one device dispatch each.
            cp = pool.sliding_window_max2d_jit(
                grid_map.prob, self.cfg.low_resolution
            )
            co = pool.sliding_window_max2d_jit(
                grid_map.observed, self.cfg.low_resolution
            )
            grid_map.coarse[key] = (cp, co)
        return grid_map.coarse[key]

    def optimize_pose(
        self,
        query: ScanMatchingQuery,
        score_threshold: float = 0.0,
        known_rate_threshold: float = 0.0,
    ) -> ScanMatchingSummary:
        import time as _time

        t0 = _time.perf_counter()
        gm, scan = query.grid_map, query.scan
        sensor_pose = P.compound(query.initial_pose, scan.rel_sensor_pose)
        coarse_prob, coarse_obs = self.coarse_of(gm)
        mm = self.metrics
        mm.InputSetupTime.observe(int((_time.perf_counter() - t0) * 1e6))
        t1 = _time.perf_counter()
        args = (
            self.cfg,
            gm.prob,
            gm.observed,
            coarse_prob,
            coarse_obs,
            scan.ranges,
            scan.angles,
            scan.mask,
            jnp.asarray(sensor_pose, jnp.float32),
            jnp.asarray(gm.offset_xy, jnp.float32),
            jnp.float32(score_threshold),
            jnp.float32(known_rate_threshold),
        )
        # ONE device->host fetch for the whole result tuple: each separate
        # scalar read (bool()/float()/np.asarray of a lazy device value)
        # would be its own host<->device round trip.
        out = jax.device_get(correlative_core_jit(*args))
        if not bool(out[-1]):
            # A prune (top-K theta / top-B block / int8) could not certify
            # the argmax — rare; redo densely.  Counted so artifacts show
            # the true fallback rate.
            from ..metrics.registry import MetricManager

            MetricManager.instance().counter(
                f"{self.name}.DenseFallbacks"
            ).increment()
            out = jax.device_get(correlative_core_jit(*args, dense=True))
        (pose_s, score, known, found, ncost, cov, n_proc, n_total, _) = out
        est_pose = P.move_backward(
            np.asarray(pose_s, np.float64), scan.rel_sensor_pose
        )
        mm.OptimizationTime.observe(int((_time.perf_counter() - t1) * 1e6))
        self._observe_metrics(
            query, scan, est_pose, score, ncost, int(n_proc), int(n_total)
        )
        return ScanMatchingSummary(
            pose_found=bool(found),
            normalized_cost=float(ncost),
            initial_pose=np.asarray(query.initial_pose),
            estimated_pose=est_pose,
            covariance=np.asarray(cov, np.float64),
            normalized_score=float(score),
            known_rate=float(known),
        )

    def _observe_metrics(
        self, query, scan, est_pose, score, ncost, n_proc, n_total
    ):
        """Observe the reference series (``scan_matcher_correlative.cpp:
        304-345``); window/step sizes recomputed host-side from the same
        formulas the jitted core uses."""
        cfg = self.cfg
        mm = self.metrics
        diff = P.inverse_compound(query.initial_pose, est_pose)
        mm.DiffTranslation.observe(float(P.distance(diff)))
        mm.DiffRotation.observe(abs(float(diff[2])))
        wx, wy = cfg.win_cells
        nbx, nby = cfg.blocks
        n_theta = n_total // (nbx * nby * cfg.low_resolution**2)
        # Host-side metadata only (ScanArrays.num_valid / .max_range):
        # reading scan.mask / scan.ranges here would fetch device arrays.
        max_range = float(scan.max_range)
        step_theta = 2.0 * math.asin(
            min(1.0, 0.5 * cfg.resolution / max(max_range, 1e-6))
        )
        mm.WinSizeX.observe(2 * wx)
        mm.WinSizeY.observe(2 * wy)
        mm.WinSizeTheta.observe(n_theta)
        mm.StepSizeX.observe(cfg.resolution)
        mm.StepSizeY.observe(cfg.resolution)
        mm.StepSizeTheta.observe(step_theta)
        mm.NumOfIgnoredNodes.observe(n_total - n_proc)
        mm.NumOfProcessedNodes.observe(n_proc)
        mm.ScoreValue.observe(float(score))
        mm.CostValue.observe(float(ncost))
        mm.NumOfScans.observe(int(scan.num_valid))
