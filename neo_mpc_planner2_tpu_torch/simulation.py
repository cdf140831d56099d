"""Closed-loop FollowPath simulation on a static map (port of
`simulation.batch_simulate`, static-map regime).

Each tick runs the batched controller step (pursuit + solve +
post-processing) and integrates the command with the same omni kinematic
model the controller assumes (mpc_optimization_server.py:230-236).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import MpcConfig
from .engine import ControlState, batch_state, init_state
from .ops.costmap import Costmap, u8_source_enabled
from .ops.rollout import rollout

__all__ = ["SimResult", "batch_simulate"]


class SimResult(NamedTuple):
    poses: torch.Tensor         # (B, T, 3) robot trajectory (world frame)
    cmds: torch.Tensor          # (B, T, 3) commanded velocities
    collisions: torch.Tensor    # (B, T) bool predicted-collision latch
    lethal: torch.Tensor        # (B, T) bool plugin hard-stop flag
    goal_dist: torch.Tensor     # (B, T) distance to the plan goal
    converged: torch.Tensor     # (B, T) bool solver converged this tick
    solver_iters: torch.Tensor  # (B, T) SQP iterations this tick
    final_state: ControlState
    final_costmap: Costmap | None = None


def batch_simulate(cfg: MpcConfig, scenario_batch, n_ticks: int,
                   parity: bool = True, init=None, window_cells=None,
                   dynamic_obstacles=None, costmap_updates=None,
                   init_costmap=None, solver_batch=None) -> SimResult:
    """Closed-loop sim over a ScenarioBatch for n_ticks ticks.

    init: optional (state, pose, vel) carry from a previous segment. The
    rolling-window, dynamic-obstacle and incremental-update regimes of the
    JAX package are not ported yet and raise NotImplementedError."""
    if (window_cells is not None or dynamic_obstacles is not None
            or costmap_updates is not None or init_costmap is not None):
        raise NotImplementedError(
            "only the static-map regime of batch_simulate is ported; the "
            "rolling, dynamic and update regimes are queued in ROADMAP.md")
    from .engine import make_batched_controller_step

    sb = scenario_batch
    step = make_batched_controller_step(cfg, parity=parity,
                                        solver_batch=solver_batch)
    # The map is fixed for the whole run: flatten it once.
    costmap = sb.costmap
    u8 = u8_source_enabled(cfg.solver_costmap_u8,
                           costmap.data.shape[-2] * costmap.data.shape[-1])
    if costmap.flat is None or (u8 and costmap.flat_u8 is None):
        costmap = costmap.with_flat(u8=u8)
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
    for _ in range(n_ticks):
        out = step(state, sb.plan, pose, vel, costmap, sb.footprint, dts)
        cmd = out.cmd_vel
        with torch.no_grad():
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
                     final_state=state)
