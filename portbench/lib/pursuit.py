"""The Nav2 plugin's carrot rule in NumPy (NeoMpcPlanner.cpp:66-189), for
the client that stands in for one robot: the closest pose of the plan
from the consumed prefix on, the window up to the first pose beyond half
the local map, and the first window pose at least the lookahead distance
away, else the window's last; the carrot in the robot's frame. With the
lookahead distances of the deployment all equal, the slow-down hysteresis
picks nothing, so it is not kept here. The plant is the omni kinematic
model the controller assumes."""

from __future__ import annotations

import numpy as np


def carrot(plan, start: int, pose, half_extent: float, lookahead: float):
    """plan (P, 3) map frame, pose (3,) -> (carrot (3,) in the robot's
    frame, new start, closer to goal)."""
    P = plan.shape[0]
    d = np.hypot(plan[:, 0] - pose[0], plan[:, 1] - pose[1])
    idx = np.arange(P)
    alive = idx >= start
    begin = int(np.argmin(np.where(alive, d, np.inf)))
    closer = np.hypot(*(plan[-1, :2] - pose[:2])) <= lookahead
    beyond = (d > half_extent) & (idx >= begin)
    end = int(idx[beyond].min()) if beyond.any() else P
    window = (idx >= begin) & (idx < end)
    c, s = np.cos(pose[2]), np.sin(pose[2])
    rx, ry = plan[:, 0] - pose[0], plan[:, 1] - pose[1]
    lx, ly = rx * c + ry * s, -rx * s + ry * c
    lyaw = plan[:, 2] - pose[2]
    far = window & (np.hypot(lx, ly) >= lookahead)
    if far.any():
        i = int(idx[far].min())
    elif window.any():
        i = int(idx[window].max())
    else:
        i = 0
    return np.array([lx[i], ly[i], lyaw[i]]), begin, bool(closer)


def plant(pose, u, dt: float):
    """The pose after the command u (3,) held for dt: yaw first, then the
    position with the new yaw."""
    th = pose[2] + u[2] * dt
    c, s = np.cos(th), np.sin(th)
    return np.array([pose[0] + (u[0] * c - u[1] * s) * dt,
                     pose[1] + (u[0] * s + u[1] * c) * dt, th])
