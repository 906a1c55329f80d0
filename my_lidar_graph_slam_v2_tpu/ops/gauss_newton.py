"""Square-error cost, gradient, Gauss-Newton step and pose covariance.

Vectorized re-formulation of ``cost_function_square_error.cpp``:

* cost(pose)   = sum_b (1 - M_smooth(hit_b))^2 over valid beams, where
  ``M_smooth`` is the bilinear interpolation of the probability map with
  unknown cells read as 0.5 and indices clamped to the raster
  (``GetClosestMapValues``, ``cost_function_square_error.cpp:326-351``).

  One deliberate deviation from the reference: fractional indices are
  shifted by -0.5 so grid values are interpolated as samples at **cell
  centers** rather than at cell corners.  The rasterizer deposits a
  beam endpoint's evidence into the whole cell containing it, so the
  occupancy sample point is the cell center; the reference interpolates
  at corner lattice points (``PositionToIndexF`` has no center shift,
  ``grid_map_geometry.cpp:125-132``), which biases every refined pose
  toward the cell's lower-left corner by up to half a cell.  Measured on
  the synthetic config-#1 eval this convention fix removes a consistent
  ~4.6 mm/keyframe lateral bias and brings SLAM ATE below raw-odometry
  ATE (see tests/test_e2e_odometry.py::test_slam_not_worse_than_odometry).
* H, b         = J^T J and J^T r with the analytic map-gradient Jacobian
  (``ComputeHessianAndResidual``, lines 151-194).
* covariance   = scale * H^{-1} (lines 131-146; scale = 1e4 default).
* one LM step  = solve (H + lambda I) dp = b  (``ScanMatcherLinearSolver::
  OptimizeStep``, ``scan_matcher_linear_solver.cpp:143-167``).

The full iterative matcher (lambda schedule, convergence test) lives in
``matching/linear_solver.py``; these are the fused device kernels.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import quant


def _bilinear_values(prob, observed, frow, fcol):
    """Four corner probabilities + fractional offsets for float indices.

    Unknown or out-of-range corners read 0.5 (``ProbabilityOr(..., 0.5)``
    with clamped indices).  Accepts f32 or cached-u8 maps (ops/quant.py);
    the dequant fuses into the gather."""
    prob = quant.dequant_prob(prob)
    H, W = prob.shape
    r0 = jnp.floor(frow)
    c0 = jnp.floor(fcol)
    dr = (frow - r0).astype(jnp.float32)
    dc = (fcol - c0).astype(jnp.float32)
    # Corner indices as in the reference (low corner clamped to >= 0, high
    # corner to <= size-1, cost_function_square_error.cpp:333-338); any
    # corner still outside the raster or unknown reads 0.5.
    rc0 = jnp.maximum(r0.astype(jnp.int32), 0)
    cc0 = jnp.maximum(c0.astype(jnp.int32), 0)
    rc1 = jnp.minimum(rc0 + 1, H - 1)
    cc1 = jnp.minimum(cc0 + 1, W - 1)

    def read(r, c):
        inside = (r >= 0) & (r < H) & (c >= 0) & (c < W)
        rs = jnp.clip(r, 0, H - 1)
        cs = jnp.clip(c, 0, W - 1)
        p = prob[rs, cs]
        known = observed[rs, cs] & inside
        return jnp.where(known, p, 0.5)

    m00 = read(rc0, cc0)  # (row0, col0)
    m01 = read(rc1, cc0)  # (row1, col0)
    m10 = read(rc0, cc1)  # (row0, col1)
    m11 = read(rc1, cc1)  # (row1, col1)
    return m00, m01, m10, m11, dr, dc


def _interp_and_grad(prob, observed, frow, fcol):
    """Smoothed value + scaled gradient (d/d(col), d/d(row)), matching
    ``BilinearInterpolation`` and ``ComputeScaledMapGradMapPoint``.

    In reference terms deltaX ~ fractional col, deltaY ~ fractional row."""
    m00, m01, m10, m11, dr, dc = _bilinear_values(prob, observed, frow, fcol)
    value = dr * (dc * m11 + (1.0 - dc) * m01) + (1.0 - dr) * (
        dc * m10 + (1.0 - dc) * m00
    )
    grad_x = dr * (m11 - m01) + (1.0 - dr) * (m10 - m00)  # d/d(col) scaled
    grad_y = dc * (m11 - m10) + (1.0 - dc) * (m01 - m00)  # d/d(row) scaled
    return value, grad_x, grad_y


def _hit_points(sensor_pose, ranges, angles):
    ang = sensor_pose[2] + angles
    hx = sensor_pose[0] + ranges * jnp.cos(ang)
    hy = sensor_pose[1] + ranges * jnp.sin(ang)
    return hx, hy


def cost(prob, observed, ranges, angles, mask, sensor_pose, resolution, offset_xy):
    """Total squared-error cost over valid beams."""
    hx, hy = _hit_points(sensor_pose, ranges, angles)
    fcol = (hx - offset_xy[0]) / resolution - 0.5
    frow = (hy - offset_xy[1]) / resolution - 0.5
    value, _, _ = _interp_and_grad(prob, observed, frow, fcol)
    err = jnp.where(mask, 1.0 - value, 0.0)
    return jnp.sum(err * err)


def hessian_and_residual(
    prob, observed, ranges, angles, mask, sensor_pose, resolution, offset_xy
):
    """(H [3,3], b [3], cost) at the given map-local sensor pose."""
    hx, hy = _hit_points(sensor_pose, ranges, angles)
    fcol = (hx - offset_xy[0]) / resolution - 0.5
    frow = (hy - offset_xy[1]) / resolution - 0.5
    value, gx, gy = _interp_and_grad(prob, observed, frow, fcol)
    inv_res = 1.0 / resolution
    gx = gx * inv_res
    gy = gy * inv_res
    # Rotated scan point relative to the sensor (localHitPoint - sensorPos)
    rx = hx - sensor_pose[0]
    ry = hy - sensor_pose[1]
    gt = -ry * gx + rx * gy
    J = jnp.stack([gx, gy, gt], axis=-1)  # [B, 3]
    r = 1.0 - value  # [B]
    w = mask.astype(jnp.float32)
    Jw = J * w[:, None]
    # Full f32: on a GPU a default-precision f32 product may run as TF32
    # (about three decimal digits), too coarse for the covariance.
    H = jnp.matmul(Jw.T, J, precision=jax.lax.Precision.HIGHEST)
    b = jnp.matmul(Jw.T, r, precision=jax.lax.Precision.HIGHEST)
    c = jnp.sum(w * r * r)
    return H, b, c


def covariance(
    prob, observed, ranges, angles, mask, sensor_pose, resolution, offset_xy,
    scale=1e4,
):
    """Pose covariance = scale * H^{-1} (map-local frame)."""
    H, _, _ = hessian_and_residual(
        prob, observed, ranges, angles, mask, sensor_pose, resolution, offset_xy
    )
    return jnp.linalg.inv(H) * scale


def gn_refine(
    prob,
    observed,
    ranges,
    angles,
    mask,
    sensor_pose0,
    resolution,
    offset_xy,
    max_iterations=10,
    convergence_threshold=1e-4,
    initial_lambda=1e-4,
):
    """Iterative damped Gauss-Newton (Levenberg-Marquardt) refinement.

    Follows ``ScanMatcherLinearSolver::OptimizePose``
    (``scan_matcher_linear_solver.cpp:66-167``) with one deliberate
    robustness upgrade: steps that *increase* the cost are rejected (pose
    reverted, lambda increased) instead of accepted, and lambda may grow
    beyond the reference's 1e-4 cap.  The reference's variant accepts every
    step, which diverges when the 3x3 system is ill-conditioned (e.g. a
    thin-walled single-scan map lets one huge step carry all beams into
    unknown space).  For converging runs the two are identical; ours has
    the same fixed points but cannot diverge.

    Returns (pose, cost, n_iterations).

    The loop state carries (H, b) of the *accepted* pose, so each
    iteration performs exactly ONE map-gather pass (the evaluation of
    H/b/cost at the trial pose) instead of the naive two (H/b at the
    current pose + cost at the trial pose).  The iterate sequence is
    identical — H/b at an accepted pose were computed by the iteration
    that accepted it — but the sequential per-iteration depth (the
    latency bound of this tiny 3x3 problem) halves."""

    def eval_at(p):
        return hessian_and_residual(
            prob, observed, ranges, angles, mask, p, resolution, offset_xy
        )

    def cond(state):
        return jnp.logical_not(state[-1])

    def body(state):
        p, cur_cost, H, b, lam, it, done = state
        Hd = H + lam * jnp.eye(3, dtype=H.dtype)
        p_new = p + jnp.linalg.solve(Hd, b)
        H_new, b_new, c_new = eval_at(p_new)
        accept = c_new < cur_cost
        it_new = it + 1
        stop = (it_new >= max_iterations) | (
            accept & (jnp.abs(cur_cost - c_new) < convergence_threshold)
        )
        p_next = jnp.where(accept, p_new, p)
        c_next = jnp.where(accept, c_new, cur_cost)
        H_next = jnp.where(accept, H_new, H)
        b_next = jnp.where(accept, b_new, b)
        lam_new = jnp.where(
            accept,
            jnp.maximum(1e-8, lam * 0.5),
            jnp.minimum(1e6, lam * 4.0),
        )
        return (p_next, c_next, H_next, b_next, lam_new, it_new, stop)

    H0, b0, init_cost = eval_at(sensor_pose0)
    state = (
        sensor_pose0,
        init_cost,
        H0,
        b0,
        jnp.float32(initial_lambda),
        jnp.int32(0),
        jnp.bool_(False),
    )
    p, final_cost, _, _, _, iters, _ = jax.lax.while_loop(cond, body, state)
    return p, final_cost, iters
