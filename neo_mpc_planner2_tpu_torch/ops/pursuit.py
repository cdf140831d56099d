"""Pure-pursuit front-end: plan pruning, carrot selection, slow-down
hysteresis (port of `ops/pursuit.py`; the reference plugin's
NeoMpcPlanner.cpp:66-236).

The plan is a fixed-shape pose array with a valid count; the reference's
prefix erase (cpp:127) is a monotonic `start` index in the control state.
Every function takes a leading batch dim of lanes.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import MpcConfig
from .costmap import Costmap
from .footprint import Footprint, footprint_cost_at_pose
from .se2 import se2_inverse

__all__ = ["Plan", "PursuitResult", "pursuit_tick", "SLOW_DOWN_COST_GATE",
           "LETHAL_GATE"]

# cpp:225/228 — footprint cost > 200 on the 0-255 scale.
SLOW_DOWN_COST_GATE = 200.0 / 255.0
# cpp:234 — footprint cost == 255 throws "MPC detected collision!".
LETHAL_GATE = 1.0
_BIG = 1e30


@dataclasses.dataclass
class Plan:
    """Global plan in the map frame: (*lead, P) px/py/pyaw, (*lead,) n_valid."""

    px: torch.Tensor
    py: torch.Tensor
    pyaw: torch.Tensor
    n_valid: torch.Tensor

    @property
    def poses(self) -> torch.Tensor:
        return torch.stack([self.px, self.py, self.pyaw], dim=-1)

    @staticmethod
    def from_poses(poses, n_valid, device=None) -> "Plan":
        p = torch.as_tensor(poses, dtype=torch.float32, device=device)
        return Plan(px=p[..., 0], py=p[..., 1], pyaw=p[..., 2],
                    n_valid=torch.as_tensor(n_valid, dtype=torch.int32,
                                            device=p.device))

    @staticmethod
    def create(poses, max_points: int = 128, device=None) -> "Plan":
        p = torch.as_tensor(poses, dtype=torch.float32, device=device)
        n = p.shape[0]
        if n == 0:
            raise ValueError("plan has zero length")
        if n > max_points:
            raise ValueError(f"plan has {n} poses > max {max_points}")
        pad = p[-1:].expand(max_points - n, 3)
        return Plan.from_poses(torch.cat([p, pad], dim=0), n)

    def goal(self) -> torch.Tensor:
        """Final pose (cpp:280), (*lead, 3)."""
        i = (self.n_valid - 1).long()[..., None]
        return torch.stack([a.gather(-1, i)[..., 0]
                            for a in (self.px, self.py, self.pyaw)], dim=-1)


class PursuitResult(NamedTuple):
    carrot_pose: torch.Tensor      # (B, 3) in base frame
    closer_to_goal: torch.Tensor   # (B,) bool
    slow_down: torch.Tensor        # (B,) bool — updated hysteresis state
    lethal: torch.Tensor           # (B,) bool — cpp:234's collision throw
    footprint_cost: torch.Tensor   # (B,) current-pose footprint cost
    new_start: torch.Tensor        # (B,) int32 consumed-prefix index
    lookahead_dist: torch.Tensor   # (B,)
    plan_empty: torch.Tensor       # (B,) bool — empty window (cpp:130 throw)
    window_begin: torch.Tensor     # (B,) int32
    window_end: torch.Tensor       # (B,) int32


def _lookahead_distance(cfg: MpcConfig, slow_down, closer_to_goal):
    """getLookAheadDistance (cpp:157-171); the reference ignores speed."""
    f = lambda v: torch.full_like(closer_to_goal, v, dtype=torch.float32)
    return torch.where(~slow_down | closer_to_goal,
                       torch.where(closer_to_goal,
                                   f(cfg.lookahead_dist_close_to_goal),
                                   f(cfg.lookahead_dist_max)),
                       f(cfg.lookahead_dist_min))


def _take(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return a.gather(-1, i.long()[..., None])[..., 0]


def pursuit_tick(cfg: MpcConfig, plan: Plan, start: torch.Tensor,
                 slow_down: torch.Tensor, robot_pose: torch.Tensor,
                 costmap: Costmap, base_footprint: Footprint) -> PursuitResult:
    """One plugin tick's geometry (cpp:208-238) for a batch of lanes."""
    P = plan.px.shape[-1]
    idx = torch.arange(P, dtype=torch.int32, device=plan.px.device)
    n_valid = plan.n_valid[..., None]
    alive = (idx >= start[..., None]) & (idx < n_valid)

    # Closest pose (cpp:85-90); argmin takes the first minimum, as in JAX.
    dx = plan.px - robot_pose[..., 0:1]
    dy = plan.py - robot_pose[..., 1:2]
    d = torch.sqrt(dx * dx + dy * dy)
    begin = torch.argmin(torch.where(alive, d, _BIG), dim=-1).to(torch.int32)

    # closer_to_goal (cpp:92-100).
    g = plan.goal()[..., :2] - robot_pose[..., :2]
    closer_to_goal = (torch.sqrt((g * g).sum(-1))
                      <= cfg.lookahead_dist_close_to_goal)

    # Window end: first pose at/after `begin` beyond half the map extent.
    max_dist = costmap.extent_world()
    beyond = (d > max_dist[..., None]) & (idx >= begin[..., None]) & alive
    end = torch.where(beyond, idx, n_valid).amin(-1).to(torch.int32)

    window = ((idx >= begin[..., None]) & (idx < end[..., None])
              & (idx < n_valid))
    plan_empty = ~window.any(-1)

    # Window in the base frame (cpp:109-124).
    inv = se2_inverse(robot_pose)
    ci = torch.cos(inv[..., 2:3])
    si = torch.sin(inv[..., 2:3])
    lx = inv[..., 0:1] + plan.px * ci - plan.py * si
    ly = inv[..., 1:2] + plan.px * si + plan.py * ci
    lyaw = inv[..., 2:3] + plan.pyaw

    # Lookahead point (cpp:173-189): first window pose at >= lookahead,
    # else the last window pose.
    lookahead_dist = _lookahead_distance(cfg, slow_down, closer_to_goal)
    far_enough = window & (torch.sqrt(lx * lx + ly * ly)
                           >= lookahead_dist[..., None])
    first_far = torch.where(far_enough, idx, P).amin(-1)
    last_window = torch.where(window, idx, -1).amax(-1)
    carrot_idx = torch.where(first_far < P, first_far,
                             last_window.clamp(min=0))
    carrot = torch.stack([_take(lx, carrot_idx), _take(ly, carrot_idx),
                          _take(lyaw, carrot_idx)], dim=-1)

    # Slow-down hysteresis + collision gate (cpp:216-236).
    fp_cost = footprint_cost_at_pose(costmap, base_footprint, robot_pose,
                                     cfg.footprint_edge_samples,
                                     cfg.footprint_mode)
    yaw_mag = carrot[..., 2].abs()
    new_slow_down = (yaw_mag >= 1.0) & (fp_cost > SLOW_DOWN_COST_GATE)
    return PursuitResult(
        carrot_pose=carrot,
        closer_to_goal=closer_to_goal,
        slow_down=new_slow_down,
        lethal=fp_cost >= LETHAL_GATE,
        footprint_cost=fp_cost,
        new_start=begin,
        lookahead_dist=lookahead_dist,
        plan_empty=plan_empty,
        window_begin=begin,
        window_end=end,
    )
