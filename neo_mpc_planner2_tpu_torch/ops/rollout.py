"""Omnidirectional kinematic rollout (port of `ops/rollout.py`).

Yaw is updated before the position, so the position update uses the
post-step yaw (mpc_optimization_server.py:230-236):

    yaw_{i+1} = yaw_i + w_i * dt
    x_{i+1}   = x_i + (vx_i * cos(yaw_{i+1}) - vy_i * sin(yaw_{i+1})) * dt
    y_{i+1}   = y_i + (vx_i * sin(yaw_{i+1}) + vy_i * cos(yaw_{i+1})) * dt
"""

from __future__ import annotations

import torch

__all__ = ["rollout"]


def rollout(cmd_vel: torch.Tensor, dt, init_pose: torch.Tensor) -> torch.Tensor:
    """cmd_vel (..., N, 3), dt scalar, init_pose (..., 3) -> (..., N, 3)
    poses after each step. A Python loop over the N (small, static) steps."""
    x, y, yaw = init_pose[..., 0], init_pose[..., 1], init_pose[..., 2]
    out = []
    for i in range(cmd_vel.shape[-2]):
        u = cmd_vel[..., i, :]
        yaw = yaw + u[..., 2] * dt
        c, s = torch.cos(yaw), torch.sin(yaw)
        x = x + (u[..., 0] * c - u[..., 1] * s) * dt
        y = y + (u[..., 0] * s + u[..., 1] * c) * dt
        out.append(torch.stack([x, y, yaw], dim=-1))
    return torch.stack(out, dim=-2)
