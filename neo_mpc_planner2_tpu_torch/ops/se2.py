"""SE(2) geometry primitives (PyTorch port of the JAX package's
`ops/se2.py`).

Poses are (..., 3) tensors [x, y, yaw]; quaternions (..., 4) [x, y, z, w]
(ROS field order). Every function broadcasts over leading batch dimensions.
"""

from __future__ import annotations

import math

import torch

__all__ = ["yaw_from_quat", "quat_from_yaw", "rot2", "se2_apply",
           "se2_inverse", "se2_compose", "world_to_body", "body_to_world",
           "wrap_angle"]


def yaw_from_quat(q: torch.Tensor) -> torch.Tensor:
    """yaw = atan2(2(wz + xy), 1 - 2(y² + z²)) (py:176-178)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def quat_from_yaw(yaw: torch.Tensor) -> torch.Tensor:
    half = yaw * 0.5
    zeros = torch.zeros_like(yaw)
    return torch.stack([zeros, zeros, torch.sin(half), torch.cos(half)], -1)


def rot2(theta: torch.Tensor) -> torch.Tensor:
    """(..., 2, 2) rotation matrix."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], dim=-1),
                        torch.stack([s, c], dim=-1)], dim=-2)


def se2_apply(pose: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """R(yaw) @ p + t for points (..., 2). `pose` broadcasts against the
    leading dims of `points` once its trailing axis is dropped."""
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    px, py = points[..., 0], points[..., 1]
    return torch.stack([pose[..., 0] + px * c - py * s,
                        pose[..., 1] + px * s + py * c], dim=-1)


def se2_inverse(pose: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    x, y = pose[..., 0], pose[..., 1]
    return torch.stack([-(x * c + y * s), -(-x * s + y * c), -pose[..., 2]],
                       dim=-1)


def se2_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    xy = se2_apply(a, b[..., :2])
    return torch.cat([xy, a[..., 2:3] + b[..., 2:3]], dim=-1)


def world_to_body(robot_pose: torch.Tensor, world_pose: torch.Tensor):
    return se2_compose(se2_inverse(robot_pose), world_pose)


def body_to_world(robot_pose: torch.Tensor, body_pose: torch.Tensor):
    return se2_compose(robot_pose, body_pose)


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap to [-pi, pi). `torch.remainder` is floor-mod like `jnp.mod`
    (`torch.fmod` truncates and would keep the sign of a negative angle)."""
    return torch.remainder(theta + math.pi, 2.0 * math.pi) - math.pi
