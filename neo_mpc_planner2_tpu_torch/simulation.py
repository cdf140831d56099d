"""Closed-loop FollowPath simulation (port of `simulation.py`).

Each tick runs the batched controller step (pursuit + solve +
post-processing) and integrates the command with the same omni kinematic
model the controller assumes (mpc_optimization_server.py:230-236). Besides
a static map it runs the JAX package's three live-map regimes: a rolling
window re-centred on each robot every tick (nav2's rolling local costmap,
NeoMpcPlanner.cpp:80-82), obstacles that move and re-synthesize the map
every tick, and one incremental dirty-window write a lane a tick into a
carried map (the live costmap behind every solve,
mpc_optimization_server.py:118).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import MpcConfig
from .engine import ControlState, batch_state, init_state
from .ops.costmap import (Costmap, extract_window, u8_source_enabled,
                          world_to_map, write_window_)
from .ops.rollout import rollout
from .scenarios import BLOB_SIGMA2, ScenarioBatch, blob_maps
from .tree import tree_map
from .utils.profiling import span

__all__ = ["SimResult", "simulate_follow_path", "batch_simulate",
           "rolling_window", "rolling_view", "dynamic_obstacle_map",
           "obstacle_update"]


def _window_corner(world: Costmap, pose: torch.Tensor, cells: int):
    """The (col, row) corner cell of the (cells)² window centred on each
    lane's robot and clamped inside the world, each (*lead,) int32."""
    H, W = world.data.shape[-2], world.data.shape[-1]
    mx, my = world_to_map(world, pose[..., 0], pose[..., 1])
    return ((mx - cells // 2).clamp(0, W - cells),
            (my - cells // 2).clamp(0, H - cells))


def rolling_window(world: Costmap, pose: torch.Tensor, cells: int) -> Costmap:
    """The (cells, cells) local window of each lane's WORLD map (*lead, H, W)
    centred on its robot pose (*lead, 3) and clamped inside the world, as
    its own map with its own origin: the materializing form, kept as the
    oracle that the view is held against."""
    sx, sy = _window_corner(world, pose, cells)
    data = extract_window(world.data, sy, sx, cells, cells)
    origin = (world.origin + torch.stack([sx, sy], dim=-1).to(torch.float32)
              * world.resolution[..., None])
    return Costmap(data=data, origin=origin, resolution=world.resolution)


def rolling_view(world: Costmap, pose: torch.Tensor, cells: int) -> Costmap:
    """The same window as `rolling_window`, as a view: the world map with
    the window's corner (win_lo) and side (win_cells). Every sampler reads
    the world map in place and samples what the window would; nothing is
    copied."""
    sx, sy = _window_corner(world, pose, cells)
    return world.replace(win_lo=torch.stack([sx, sy], dim=-1),
                         win_cells=int(cells))


def _elapsed(t: int, dt: float) -> float:
    """f32(t) · f32(dt), the JAX package's time of tick t, as a float that
    a float32 tensor multiplies exactly."""
    return float(np.float32(t) * np.float32(dt))


def dynamic_obstacle_map(costmap: Costmap, obstacles, t: int, dt: float,
                         lethal_threshold: float | None = None,
                         u8: bool = False) -> Costmap:
    """The map of the dynamic-obstacle regime at tick t: blobs
    (centres (B, O, 2), amplitudes (B, O), velocities (B, O, 2), world
    frame) at centres + t·dt·velocity, synthesized on `costmap`'s grid (its
    shape, origin and lane 0's resolution) and flattened."""
    centers, amp, vel = obstacles
    ct = centers + _elapsed(t, dt) * vel
    data = blob_maps(ct, amp, costmap.data.shape[-1], costmap.resolution[0],
                     lethal_threshold, origin=costmap.origin)
    return Costmap(data=data, origin=costmap.origin,
                   resolution=costmap.resolution).with_flat(u8=u8)


def obstacle_update(costmap: Costmap, base_data: torch.Tensor, updates,
                    t: int, dt: float, cells: int,
                    lethal_threshold: float | None = None):
    """The dirty-window write of the update regime at tick t: each lane's
    (cells)² block around its obstacle (centre (B, 2), amplitude (B,),
    velocity (B, 2)) at centre + t·dt·velocity, holding max(base window,
    blob), saturated to 1.0 above lethal_threshold. Returns the block
    (B, cells, cells) and its (col, row) corner (B, 2) int32 on
    `costmap`'s grid; base_data (B, H, W) is the static belief. The float
    expressions keep the JAX package's order: a reordering moves the block
    by a cell on some lanes."""
    upd_c, upd_a, upd_v = updates
    H, W = costmap.data.shape[-2], costmap.data.shape[-1]
    ct = upd_c + _elapsed(t, dt) * upd_v
    res = costmap.resolution
    ox, oy = costmap.origin[:, 0], costmap.origin[:, 1]
    cx = (torch.floor((ct[:, 0] - ox) / res).to(torch.int32)
          - cells // 2).clamp(0, W - cells)
    cy = (torch.floor((ct[:, 1] - oy) / res).to(torch.int32)
          - cells // 2).clamp(0, H - cells)
    idx = torch.arange(cells, dtype=torch.float32, device=res.device)
    r1 = res[:, None]
    wxs = ox[:, None] + (cx[:, None].to(torch.float32) + idx) * r1 + r1 / 2
    wys = oy[:, None] + (cy[:, None].to(torch.float32) + idx) * r1 + r1 / 2
    ddx = wxs[:, None, :] - ct[:, 0, None, None]
    ddy = wys[:, :, None] - ct[:, 1, None, None]
    d2 = ddx * ddx + ddy * ddy                                   # (B, U, U)
    blob = (upd_a[:, None, None]
            * torch.exp(-d2 / (2 * BLOB_SIGMA2))).clamp(0.0, 1.0)
    val = torch.maximum(extract_window(base_data, cy, cx, cells, cells),
                        blob)
    if lethal_threshold is not None:
        val = torch.where(val > lethal_threshold, 1.0, val)
    return val, torch.stack([cx, cy], dim=-1)


class SimResult(NamedTuple):
    poses: torch.Tensor         # (B, T, 3) robot trajectory (world frame)
    cmds: torch.Tensor          # (B, T, 3) commanded velocities
    collisions: torch.Tensor    # (B, T) bool predicted-collision latch
    lethal: torch.Tensor        # (B, T) bool plugin hard-stop flag
    goal_dist: torch.Tensor     # (B, T) distance to the plan goal
    converged: torch.Tensor     # (B, T) bool solver converged this tick
    solver_iters: torch.Tensor  # (B, T) SQP iterations this tick
    final_state: ControlState
    # costmap_updates regime only: the carried world map after the run's
    # writes, the handle to resume it (init_costmap=); None otherwise.
    final_costmap: Costmap | None = None


def simulate_follow_path(cfg: MpcConfig, plan, costmap: Costmap, footprint,
                         start_pose, start_vel, n_ticks: int,
                         parity: bool = True, window_cells: int | None = None,
                         window_view: bool = True) -> SimResult:
    """One robot's closed loop (plan, costmap and footprint without batch
    dims): batch_simulate at batch 1, its results without the batch dim.
    window_cells: `costmap` is the world map and the controller sees the
    rolling window (a view, or with window_view=False the materialized
    window)."""
    dev = costmap.data.device
    one = lambda x: x[None]
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)[None]
    sb = ScenarioBatch(state=None, plan=tree_map(one, plan),
                       robot_pose=f32(start_pose), current_vel=f32(start_vel),
                       costmap=tree_map(one, costmap),
                       footprint=tree_map(one, footprint), delta_t=None)
    res = batch_simulate(cfg, sb, n_ticks, parity=parity,
                         window_cells=window_cells, window_view=window_view)
    return tree_map(lambda x: x[0], res)


def batch_simulate(cfg: MpcConfig, scenario_batch, n_ticks: int,
                   parity: bool = True, init=None,
                   window_cells: int | None = None, window_view: bool = True,
                   dynamic_obstacles=None,
                   obstacle_lethal_threshold: float | None = None,
                   costmap_updates=None, update_cells: int = 16,
                   init_costmap: Costmap | None = None,
                   solver_batch=None) -> SimResult:
    """Closed-loop sim over a ScenarioBatch for n_ticks ticks; the arguments
    are the JAX package's.

    init: optional (state, pose, vel) carry from a previous segment.
    window_cells: scenario_batch.costmap is each lane's WORLD map and the
    controller sees the (window_cells)² window re-centred on its robot every
    tick: a view of the world map (window_view=True) or the materialized
    window, flattened every tick (window_view=False).
    dynamic_obstacles: (centres (B, O, 2), amplitudes (B, O), velocities
    (B, O, 2)); the map is re-synthesized every tick on scenario_batch's
    grid (dynamic_obstacle_map), blob cells above obstacle_lethal_threshold
    saturated to 1.0. The tick clock restarts at 0 every call.
    costmap_updates: (centres (B, 2), amplitudes (B,), velocities (B, 2));
    every tick each lane's carried map takes one (update_cells)² write
    (obstacle_update) with its flat views refreshed, and the controller
    reads the carried map (through the rolling view with window_cells).
    scenario_batch.costmap stays the static belief the writes repaint from;
    the run writes into a copy of it, or of init_costmap (a previous
    segment's SimResult.final_costmap), and never into a tensor it was
    given. The tick clock restarts at 0: advance the centres yourself when
    chaining segments.
    solver_batch: optional batched solver in place of the SQP."""
    from .engine import make_batched_controller_step

    sb = scenario_batch
    step = make_batched_controller_step(cfg, parity=parity,
                                        solver_batch=solver_batch)
    costmap = sb.costmap
    H, W = costmap.data.shape[-2], costmap.data.shape[-1]
    slicing = window_cells is not None and not window_view
    # The u8 source is resolved against the map the solver samples: the
    # world map under a view, the window when it is materialized.
    u8 = u8_source_enabled(cfg.solver_costmap_u8,
                           window_cells * window_cells if slicing else H * W)
    if slicing:
        costmap = costmap.replace(flat=None, flat_u8=None)
    elif costmap.flat is None or (u8 and costmap.flat_u8 is None):
        # The map is fixed for the run: flatten it once.
        costmap = costmap.with_flat(u8=u8)
    if dynamic_obstacles is not None:
        if window_cells is not None:
            raise ValueError(
                "dynamic_obstacles and window_cells are mutually exclusive")
        if costmap_updates is not None:
            raise ValueError(
                "dynamic_obstacles and costmap_updates are mutually exclusive")
        if H != W:
            raise ValueError("dynamic_obstacles needs a square grid")
        # The blobs are synthesized on one grid from lane 0's resolution.
        res = sb.costmap.resolution
        if res.dim() and not bool((res == res.reshape(-1)[0]).all()):
            raise ValueError("dynamic_obstacles requires one shared "
                             "resolution across the batch")
    carry = None
    if costmap_updates is not None:
        if slicing:
            raise ValueError("costmap_updates needs the zero-copy window "
                             "view (window_view=True)")
        if update_cells > min(H, W):
            raise ValueError("update_cells exceeds the map")
        src = costmap
        if init_costmap is not None:
            if init_costmap.data.shape != costmap.data.shape:
                raise ValueError(
                    f"init_costmap shape {tuple(init_costmap.data.shape)} != "
                    f"scenario costmap shape {tuple(costmap.data.shape)}")
            src = init_costmap
        # The carried map: this run's own copy, written in place.
        carry = src.replace(data=src.data.clone(), flat=None,
                            flat_u8=None).with_flat(
            u8=u8 or src.flat_u8 is not None)
    elif init_costmap is not None:
        raise ValueError("init_costmap is only meaningful with "
                         "costmap_updates")
    batch = sb.robot_pose.shape[0]
    device = sb.robot_pose.device
    dt = cfg.control_interval
    dts = torch.full((batch,), dt, dtype=torch.float32, device=device)
    goals = sb.plan.goal()

    if init is None:
        state = batch_state(init_state(cfg, device), batch)
        pose = sb.robot_pose.to(torch.float32)
        vel = sb.current_vel.to(torch.float32)
    else:
        state, pose, vel = init

    outs = []
    for t in range(n_ticks):
        with span("tick", trace=t):
            # "tick.map": a tick that makes or writes a map.
            if carry is not None:
                with span("tick.map"):
                    block, lo = obstacle_update(
                        carry, costmap.data, costmap_updates, t, dt,
                        int(update_cells), obstacle_lethal_threshold)
                    write_window_(carry, block, lo)
                    cm = (carry if window_cells is None
                          else rolling_view(carry, pose, window_cells))
            elif dynamic_obstacles is not None:
                with span("tick.map"):
                    cm = dynamic_obstacle_map(sb.costmap, dynamic_obstacles,
                                              t, dt,
                                              obstacle_lethal_threshold, u8)
            elif window_cells is None:
                cm = costmap
            elif window_view:
                cm = rolling_view(costmap, pose, window_cells)
            else:
                with span("tick.map"):
                    cm = rolling_window(costmap, pose,
                                        window_cells).with_flat(u8=u8)
            out = step(state, sb.plan, pose, vel, cm, sb.footprint, dts)
            cmd = out.cmd_vel
            with torch.no_grad(), span("tick.plant"):
                pose = rollout(cmd[:, None, :], dt, pose)[:, 0]
                dg = pose[:, :2] - goals[:, :2]
                gd = torch.sqrt((dg * dg).sum(-1))
        state, vel = out.state, cmd
        outs.append((pose, cmd, out.collision, out.lethal, gd,
                     out.solver_converged, out.solver_iters))
    poses, cmds, cols, lethal, gd, conv, iters = (
        torch.stack(seq, dim=1) for seq in zip(*outs))
    return SimResult(poses=poses, cmds=cmds, collisions=cols, lethal=lethal,
                     goal_dist=gd, converged=conv, solver_iters=iters,
                     final_state=state, final_costmap=carry)
