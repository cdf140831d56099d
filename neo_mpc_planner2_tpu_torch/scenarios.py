"""Synthetic MPO-700 scenario batches (port of `scenarios.py`).

Plans, start poses, velocities and obstacle layouts are drawn with numpy's
RNG in the same order as the JAX package, so they are bit-identical for the
same seed. The (B, H, W) obstacle maps are synthesized with torch on the
target device from the drawn blob parameters (float32, like the JAX
package's on-device synthesis).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import MpcConfig
from .engine import ControlState, batch_state, init_state
from .ops.costmap import Costmap
from .ops.footprint import Footprint
from .ops.pursuit import Plan
from .tree import tree_map

__all__ = ["ScenarioBatch", "make_scenario_batch", "mpo700_footprint",
           "mpo500_footprint", "blob_maps", "BLOB_SIGMA2"]

MPO700_LENGTH = 0.73
MPO700_WIDTH = 0.55
MPO500_LENGTH = 0.99
MPO500_WIDTH = 0.67
# Gaussian-blob obstacle variance (m²).
BLOB_SIGMA2 = 0.08


def mpo700_footprint(max_vertices: int = 8, device=None) -> Footprint:
    return Footprint.rectangle(MPO700_LENGTH, MPO700_WIDTH, max_vertices,
                               device)


def mpo500_footprint(max_vertices: int = 8, device=None) -> Footprint:
    return Footprint.rectangle(MPO500_LENGTH, MPO500_WIDTH, max_vertices,
                               device)


def blob_maps(centers: torch.Tensor, amp: torch.Tensor, map_size: int,
              resolution: float, lethal_threshold: float | None = None,
              origin: "torch.Tensor | None" = None) -> torch.Tensor:
    """(B, H, W) obstacle maps: the max of Gaussian blobs, clipped to [0, 1],
    optionally saturated to exactly 1.0 above `lethal_threshold`.
    centers (B, O, 2) world coords; origin (B, 2) corner of cell (0, 0)
    (None: a window centered on the world origin). Accumulates one obstacle
    at a time, so memory stays O(B·H·W)."""
    B, n_obstacles = amp.shape
    dev = amp.device
    half = map_size * resolution / 2.0
    c = (torch.arange(map_size, dtype=torch.float32, device=dev) * resolution
         + resolution / 2)
    if origin is None:
        origin = torch.full((B, 2), -half, dtype=torch.float32, device=dev)
    xw = origin[:, 0, None] + c[None, :]          # (B, W)
    yw = origin[:, 1, None] + c[None, :]          # (B, H)
    data = torch.zeros((B, map_size, map_size), dtype=torch.float32,
                       device=dev)
    for i in range(n_obstacles):
        ddx = xw[:, None, :] - centers[:, i, 0, None, None]
        ddy = yw[:, :, None] - centers[:, i, 1, None, None]
        d2 = ddx * ddx + ddy * ddy
        data = torch.maximum(data, amp[:, i, None, None]
                             * torch.exp(-d2 / (2 * BLOB_SIGMA2)))
    data = data.clamp(0.0, 1.0)
    if lethal_threshold is not None:
        data = torch.where(data > lethal_threshold, 1.0, data)
    return data


def _corridor_clamp(data, corridor_pts, map_size, resolution,
                    clear_corridor_m, corridor_max_cost):
    """Clamp cells within clear_corridor_m of any corridor point
    (window-local coords) to corridor_max_cost."""
    half = map_size * resolution / 2.0
    c = (torch.arange(map_size, dtype=torch.float32, device=data.device)
         * resolution - half + resolution / 2)
    xx = c[None, :].expand(map_size, map_size)
    yy = c[:, None].expand(map_size, map_size)
    mind2 = torch.full_like(data, torch.inf)
    for i in range(corridor_pts.shape[1]):
        ddx = xx[None] - corridor_pts[:, i, 0, None, None]
        ddy = yy[None] - corridor_pts[:, i, 1, None, None]
        mind2 = torch.minimum(mind2, ddx * ddx + ddy * ddy)
    r2 = torch.tensor(clear_corridor_m, dtype=torch.float32) ** 2
    return torch.where(mind2 < r2.to(data.device),
                       data.clamp_max(corridor_max_cost), data)


class ScenarioBatch(NamedTuple):
    state: ControlState       # (B, ...) control state
    plan: Plan                # (B, P)
    robot_pose: torch.Tensor  # (B, 3)
    current_vel: torch.Tensor  # (B, 3)
    costmap: Costmap          # (B, H, W)
    footprint: Footprint      # (B, V, 2)
    delta_t: torch.Tensor     # (B,)


def make_scenario_batch(cfg: MpcConfig, batch: int, seed: int = 0,
                        map_size: int = 120, resolution: float = 0.05,
                        n_obstacles: int = 6, plan_points: int = 64,
                        lethal_threshold: float | None = None,
                        pose_jitter: float = 0.05,
                        plan_length_range: tuple = (1.5, 3.0),
                        clear_corridor_m: float | None = None,
                        corridor_max_cost: float = 0.6,
                        center_on: str = "start",
                        footprint: Footprint | None = None,
                        device=None) -> ScenarioBatch:
    """Random curved plans + Gaussian-blob obstacle maps + perturbed starts;
    the arguments are the JAX package's (maps always on `device`)."""
    rng = np.random.default_rng(seed)

    # --- plans: arcs with random curvature/length, starting at the origin ---
    curv = rng.uniform(-0.6, 0.6, batch)
    length = rng.uniform(*plan_length_range, batch)
    s = np.linspace(0.0, 1.0, plan_points)[None, :] * length[:, None]
    yaw = curv[:, None] * s
    safe_curv = np.where(np.abs(curv[:, None]) > 1e-6, curv[:, None], 1.0)
    xs = np.where(np.abs(curv[:, None]) > 1e-6, np.sin(yaw) / safe_curv, s)
    ys = np.where(np.abs(curv[:, None]) > 1e-6,
                  (1.0 - np.cos(yaw)) / safe_curv, np.zeros_like(s))
    poses = np.stack([xs, ys, yaw], axis=-1).astype(np.float32)
    pad = cfg.max_plan_points - plan_points
    if pad < 0:
        raise ValueError("plan_points exceeds cfg.max_plan_points")
    poses = np.concatenate(
        [poses, np.repeat(poses[:, -1:, :], pad, axis=1)], axis=1)
    plan = Plan.from_poses(poses, np.full((batch,), plan_points, np.int32),
                           device=device)

    # --- costmaps: max of Gaussian blobs away from the start pose ---
    half = map_size * resolution / 2.0
    if center_on == "plan":
        ext = poses[:, :plan_points, :2]
        shift = ((ext.min(axis=1) + ext.max(axis=1)) / 2.0).astype(np.float32)
    elif center_on == "start":
        shift = np.zeros((batch, 2), np.float32)
    else:
        raise ValueError(f"center_on must be 'start' or 'plan': {center_on!r}")
    centers = rng.uniform(-half + 0.8, half - 0.3, (batch, n_obstacles, 2))
    centers = np.where(
        np.linalg.norm(centers + shift[:, None, :], axis=-1, keepdims=True)
        < 0.8, centers + 1.2, centers)
    amp = rng.uniform(0.3, 0.95, (batch, n_obstacles))
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    data = blob_maps(f32(centers), f32(amp), map_size, resolution,
                     lethal_threshold)
    if clear_corridor_m is not None:
        corridor_pts = (poses[:, :plan_points:2, :2]
                        - shift[:, None, :]).astype(np.float32)
        data = _corridor_clamp(data, f32(corridor_pts), map_size, resolution,
                               clear_corridor_m, corridor_max_cost)
    costmap = Costmap(data=data, origin=f32(shift - half),
                      resolution=torch.full((batch,), resolution,
                                            dtype=torch.float32,
                                            device=device))

    # --- robot state ---
    robot_pose = f32(rng.uniform(-pose_jitter, pose_jitter, (batch, 3)))
    current_vel = f32(rng.uniform(-0.3, 0.3, (batch, 3)))

    fp1 = (footprint if footprint is not None
           else mpo700_footprint(cfg.max_footprint_vertices, device))
    fps = tree_map(lambda x: x.expand((batch,) + x.shape).contiguous(), fp1)
    state = batch_state(init_state(cfg, device), batch)
    delta_t = torch.full((batch,), 1.0 / cfg.controller_frequency,
                         dtype=torch.float32, device=device)
    return ScenarioBatch(state=state, plan=plan, robot_pose=robot_pose,
                         current_vel=current_vel, costmap=costmap,
                         footprint=fps, delta_t=delta_t)
