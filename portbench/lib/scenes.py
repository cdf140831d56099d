"""The benchmark's inputs, made from the run's seed.

A scene batch is what a fleet of robots is handed: one curved plan a
robot, one local costmap a robot (the max of Gaussian blobs, synthesized
on the device from drawn centres and amplitudes), the start pose and
velocity, and the robot's footprint. The draws are numpy's from the seed
(small arrays: a few floats a robot); the maps are made on `device` in a
few large tensor calls. The same seed gives the same scenes on any device
up to the device's rounding of exp.

The program under test and the reference both read exactly these tensors.
"""

from __future__ import annotations

import numpy as np
import torch

BLOB_SIGMA2 = 0.08


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of the run's seed (any whole number)."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def footprint(c: dict) -> np.ndarray:
    """The robot's rectangle (4, 2) float32, centred on its base, from the
    configuration."""
    hl, hw = c["robot"]["length_m"] / 2.0, c["robot"]["width_m"] / 2.0
    return np.array([[hl, hw], [-hl, hw], [-hl, -hw], [hl, -hw]], np.float32)


def blob_maps(centers, amp, origin, cells: int, res: float):
    """(B, cells, cells) float32: the max of Gaussian blobs centres (B, O, 2)
    and amplitudes (B, O), clipped to [0, 1], on the grid whose (0, 0)
    corner is origin (B, 2)."""
    dev = amp.device
    c = torch.arange(cells, dtype=torch.float32, device=dev) * res + res / 2
    xw = origin[:, 0, None] + c[None]
    yw = origin[:, 1, None] + c[None]
    out = torch.zeros(amp.shape[0], cells, cells, dtype=torch.float32,
                      device=dev)
    for i in range(amp.shape[1]):
        dx = xw[:, None, :] - centers[:, i, 0, None, None]
        dy = yw[:, :, None] - centers[:, i, 1, None, None]
        out = torch.maximum(out, amp[:, i, None, None]
                            * torch.exp(-(dx * dx + dy * dy)
                                        / (2 * BLOB_SIGMA2)))
    return out.clamp(0.0, 1.0)


def fleet_scenes(g: np.random.Generator, lanes: int, cells: int, res: float,
                 plan_points: int, max_plan_points: int, plan_length,
                 obstacles: int, pose_jitter: float, center_on: str,
                 device) -> dict:
    """One batch of scenes: arcs of random curvature (±0.6 1/m) and length
    from the origin, maps of `obstacles` blobs (amplitude 0.3-0.95, never
    lethal inside the grid) kept 0.8 m off the start, starts jittered by
    `pose_jitter` and velocities U(-0.3, 0.3). The map window is centred on
    the start ("start") or on the plan's extent ("plan")."""
    curv = g.uniform(-0.6, 0.6, lanes)
    length = g.uniform(plan_length[0], plan_length[1], lanes)
    s = np.linspace(0.0, 1.0, plan_points)[None, :] * length[:, None]
    yaw = curv[:, None] * s
    bent = np.abs(curv[:, None]) > 1e-6
    k = np.where(bent, curv[:, None], 1.0)
    xs = np.where(bent, np.sin(yaw) / k, s)
    ys = np.where(bent, (1.0 - np.cos(yaw)) / k, 0.0)
    poses = np.stack([xs, ys, yaw], -1).astype(np.float32)
    poses = np.concatenate(
        [poses, np.repeat(poses[:, -1:], max_plan_points - plan_points, 1)], 1)
    half = cells * res / 2.0
    if center_on == "plan":
        ext = poses[:, :plan_points, :2]
        shift = ((ext.min(1) + ext.max(1)) / 2.0).astype(np.float32)
    else:
        shift = np.zeros((lanes, 2), np.float32)
    centers = g.uniform(-half + 0.8, half - 0.3, (lanes, obstacles, 2))
    near = np.linalg.norm(centers + shift[:, None], axis=-1,
                          keepdims=True) < 0.8
    centers = np.where(near, centers + 1.2, centers) + shift[:, None]
    amp = g.uniform(0.3, 0.95, (lanes, obstacles))
    pose = g.uniform(-pose_jitter, pose_jitter, (lanes, 3))
    vel = g.uniform(-0.3, 0.3, (lanes, 3))
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    origin = f32(shift - half)
    data = blob_maps(f32(centers), f32(amp), origin, cells, res)
    return dict(plan=f32(poses),
                n_valid=torch.full((lanes,), plan_points, dtype=torch.int32,
                                   device=device),
                data=data, origin=origin,
                res=torch.full((lanes,), res, dtype=torch.float32,
                               device=device),
                pose=f32(pose), vel=f32(vel))


def moving_obstacles(g: np.random.Generator, lanes: int, per_lane: int,
                     cells: int, res: float, speed: float, device):
    """Obstacles that move at constant velocity: centres U(-half + 0.8,
    half - 0.3), amplitudes U(0.3, 0.95), velocities U(-speed, speed) m/s,
    (B, O, 2), (B, O), (B, O, 2) float32."""
    half = cells * res / 2
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return (f32(g.uniform(-half + 0.8, half - 0.3, (lanes, per_lane, 2))),
            f32(g.uniform(0.3, 0.95, (lanes, per_lane))),
            f32(g.uniform(-speed, speed, (lanes, per_lane, 2))))
