"""SE(2) pose algebra, vectorized for the device.

Re-implements the pose composition operators of the reference
(``include/my_lidar_graph_slam/pose.hpp:155-230`` and
``include/my_lidar_graph_slam/util.hpp:282-300``) as array functions that
work on single poses ``(3,)`` and batches ``(..., 3)`` alike, for both NumPy
arrays (host bookkeeping, f64) and JAX arrays (device compute, f32).

A pose is ``[x, y, theta]``.
"""
from __future__ import annotations

import numpy as np

try:  # jnp functions dispatch on input type via the array namespace
    import jax.numpy as jnp
except Exception:  # pragma: no cover
    jnp = None


def _xp(a):
    """Pick the array namespace (numpy or jax.numpy) for ``a``."""
    if jnp is not None and isinstance(a, jnp.ndarray) and not isinstance(a, np.ndarray):
        return jnp
    return np


def compound(start, diff):
    """``Compound(startPose, diffPose)`` — reference ``pose.hpp:155-166``.

    Returns the pose of ``diff`` expressed in the frame reached by ``start``.
    """
    xp = _xp(start)
    start = xp.asarray(start)
    diff = xp.asarray(diff)
    s, c = xp.sin(start[..., 2]), xp.cos(start[..., 2])
    x = c * diff[..., 0] - s * diff[..., 1] + start[..., 0]
    y = s * diff[..., 0] + c * diff[..., 1] + start[..., 1]
    t = start[..., 2] + diff[..., 2]
    return xp.stack([x, y, t], axis=-1)


def inverse_compound(start, end):
    """``InverseCompound(startPose, endPose)`` — reference ``pose.hpp:183-200``.

    Relative pose of ``end`` in the frame of ``start``.
    """
    xp = _xp(start)
    start = xp.asarray(start)
    end = xp.asarray(end)
    s, c = xp.sin(start[..., 2]), xp.cos(start[..., 2])
    dx = end[..., 0] - start[..., 0]
    dy = end[..., 1] - start[..., 1]
    x = c * dx + s * dy
    y = -s * dx + c * dy
    t = end[..., 2] - start[..., 2]
    return xp.stack([x, y, t], axis=-1)


def move_backward(end, diff):
    """``MoveBackward(endPose, diffPose)`` — reference ``pose.hpp:213-226``.

    The pose ``p`` such that ``compound(p, diff) == end``.
    """
    xp = _xp(end)
    end = xp.asarray(end)
    diff = xp.asarray(diff)
    t = end[..., 2] - diff[..., 2]
    s, c = xp.sin(t), xp.cos(t)
    x = end[..., 0] - c * diff[..., 0] + s * diff[..., 1]
    y = end[..., 1] - s * diff[..., 0] - c * diff[..., 1]
    return xp.stack([x, y, t], axis=-1)


def compound_point(pose, point):
    """Transform 2D point(s) by a pose — reference ``pose.hpp:169-180``."""
    xp = _xp(pose)
    pose = xp.asarray(pose)
    point = xp.asarray(point)
    s, c = xp.sin(pose[..., 2]), xp.cos(pose[..., 2])
    x = c * point[..., 0] - s * point[..., 1] + pose[..., 0]
    y = s * point[..., 0] + c * point[..., 1] + pose[..., 1]
    return xp.stack([x, y], axis=-1)


def distance(p0, p1=None):
    """Euclidean (x, y) distance — reference ``pose.hpp:124-137``."""
    xp = _xp(p0)
    p0 = xp.asarray(p0)
    if p1 is None:
        return xp.hypot(p0[..., 0], p0[..., 1])
    p1 = xp.asarray(p1)
    return xp.hypot(p0[..., 0] - p1[..., 0], p0[..., 1] - p1[..., 1])


def squared_distance(p0, p1=None):
    xp = _xp(p0)
    p0 = xp.asarray(p0)
    if p1 is None:
        return p0[..., 0] ** 2 + p0[..., 1] ** 2
    p1 = xp.asarray(p1)
    return (p0[..., 0] - p1[..., 0]) ** 2 + (p0[..., 1] - p1[..., 1]) ** 2


def normalize_angle(theta):
    """Normalize angle(s) to (-pi, pi] — reference ``util.hpp:282-293``.

    Matches the reference exactly: ``fmod`` to (-2pi, 2pi) then a single
    +/- 2pi correction.
    """
    xp = _xp(theta)
    theta = xp.asarray(theta)
    two_pi = 2.0 * xp.pi
    t = xp.fmod(theta, two_pi)
    t = xp.where(t > xp.pi, t - two_pi, t)
    t = xp.where(t < -xp.pi, t + two_pi, t)
    return t


def normalize_pose(pose):
    """Normalize the angular component of pose(s)."""
    xp = _xp(pose)
    pose = xp.asarray(pose)
    return xp.stack(
        [pose[..., 0], pose[..., 1], normalize_angle(pose[..., 2])], axis=-1
    )


def rotate_covariance(angle, cov):
    """Rotate 3x3 pose covariance(s) — reference ``util.hpp:320-336``."""
    xp = _xp(cov)
    cov = xp.asarray(cov)
    angle = xp.asarray(angle)
    c, s = xp.cos(angle), xp.sin(angle)
    zero = xp.zeros_like(c)
    one = xp.ones_like(c)
    rot = xp.stack(
        [
            xp.stack([c, -s, zero], axis=-1),
            xp.stack([s, c, zero], axis=-1),
            xp.stack([zero, zero, one], axis=-1),
        ],
        axis=-2,
    )
    return rot @ cov @ xp.swapaxes(rot, -1, -2)


def covariance_world_to_local(pose_to_local, cov_world):
    """Reference ``util.hpp:339-345``."""
    xp = _xp(cov_world)
    return rotate_covariance(-xp.asarray(pose_to_local)[..., 2], cov_world)


def covariance_local_to_world(pose_to_local, cov_local):
    """Reference ``util.hpp:347-352``."""
    xp = _xp(cov_local)
    return rotate_covariance(xp.asarray(pose_to_local)[..., 2], cov_local)
