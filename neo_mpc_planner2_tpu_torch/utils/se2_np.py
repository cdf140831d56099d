"""Host-side (numpy) SE(2)/quaternion helpers shared by viz and simulation —
no jax import so they stay usable in processes that must not touch a backend."""

from __future__ import annotations

import numpy as np

__all__ = ["quat_from_yaw_np", "yaw_from_quat_np", "integrate_cmd_np"]


def quat_from_yaw_np(yaw: float):
    """ROS-order (x, y, z, w) pure-yaw quaternion (quaternion_from_euler with
    roll=pitch=0, mpc_optimization_server.py:182-196)."""
    half = float(yaw) * 0.5
    return 0.0, 0.0, float(np.sin(half)), float(np.cos(half))


def yaw_from_quat_np(x: float, y: float, z: float, w: float) -> float:
    """euler_from_quaternion yaw (py:176-178)."""
    return float(np.arctan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z)))


def integrate_cmd_np(pose: np.ndarray, cmd: np.ndarray, dt: float) -> np.ndarray:
    """One yaw-first omni integration step (the reference's kinematic model,
    py:230-236) — used by host-side simulators."""
    yaw = pose[2] + cmd[2] * dt
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([
        pose[0] + (cmd[0] * c - cmd[1] * s) * dt,
        pose[1] + (cmd[0] * s + cmd[1] * c) * dt,
        yaw,
    ])
