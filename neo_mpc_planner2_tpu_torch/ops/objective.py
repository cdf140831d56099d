"""The MPC objective, parity half (port of `ops/objective.py`).

Reproduces mpc_optimization_server.py:204-269 with the reference's quirks:
buggy odom yaw (py:213), the footprint-aliasing no-op (py:227/238-244), the
exactly-lethal x1000 branch (py:257-260), the un-squared control cost
(py:253-254), un-wrapped angle errors and nearest-cell costmap sampling.

Every function takes a leading batch dim of lanes: the decision vector is
(B, 3N) and the objective (B,). Lanes are independent, so the gradient of the
sum over lanes is the per-lane gradient. The costmap term reads the map
through integer indices, so its gradient is zero, as in JAX.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import MpcConfig
from .costmap import Costmap, cost_at_world
from .footprint import Footprint, footprint_cost, transform_footprint
from .rollout import rollout
from .se2 import wrap_angle

__all__ = ["Scenario", "Weights", "Limits", "resolve_weights",
           "resolve_limits", "buggy_odom_yaw", "control_cost",
           "parity_footprint_term", "objective_parity", "make_objective"]

_WEIGHT_NAMES = ("w_trans", "w_orient", "w_control", "w_terminal",
                 "w_costmap", "w_footprint")


@dataclasses.dataclass
class Weights:
    """Per-lane cost-weight overrides, each (B,)."""

    w_trans: torch.Tensor
    w_orient: torch.Tensor
    w_control: torch.Tensor
    w_terminal: torch.Tensor
    w_costmap: torch.Tensor
    w_footprint: torch.Tensor

    @staticmethod
    def from_config(cfg: MpcConfig, batch: int, device=None) -> "Weights":
        return Weights(*(torch.full((batch,), getattr(cfg, n),
                                    dtype=torch.float32, device=device)
                         for n in _WEIGHT_NAMES))


@dataclasses.dataclass
class Limits:
    """Per-lane runtime velocity/acceleration limits."""

    vel_lo: torch.Tensor         # (B, 3) min_vel_x, min_vel_y, min_vel_theta
    vel_hi: torch.Tensor         # (B, 3)
    max_vel_trans: torch.Tensor  # (B,)
    acc: torch.Tensor            # (B, 3) acc_x_limit, acc_y_limit, acc_theta

    @staticmethod
    def from_config(cfg: MpcConfig, batch: int, device=None) -> "Limits":
        f = lambda *v: torch.tensor(v, dtype=torch.float32,
                                    device=device).expand(batch, len(v))
        return Limits(
            vel_lo=f(cfg.min_vel_x, cfg.min_vel_y, cfg.min_vel_theta),
            vel_hi=f(cfg.max_vel_x, cfg.max_vel_y, cfg.max_vel_theta),
            max_vel_trans=f(cfg.max_vel_trans)[:, 0],
            acc=f(cfg.acc_x_limit, cfg.acc_y_limit, cfg.acc_theta_limit))


@dataclasses.dataclass
class Scenario:
    """One solve request per lane (the neo_srvs2 Optimizer request packed at
    NeoMpcPlanner.cpp:240-246, plus costmap and base-frame footprint).

    current_pose (B, 3) odom frame; carrot_pose (B, 3) base frame; goal_pose
    (B, 3) map frame; current_vel (B, 3) body frame; switch_opt (B,) bool.
    weights / limits: optional per-lane overrides (None: the config values).
    control_interval: optional (B,) clamp interval (None: the config's).
    """

    current_pose: torch.Tensor
    carrot_pose: torch.Tensor
    goal_pose: torch.Tensor
    current_vel: torch.Tensor
    footprint: Footprint
    costmap: Costmap
    switch_opt: torch.Tensor
    weights: "Weights | None" = None
    control_interval: "torch.Tensor | None" = None
    limits: "Limits | None" = None

    def replace(self, **kw) -> "Scenario":
        return dataclasses.replace(self, **kw)


def buggy_odom_yaw(current_yaw: torch.Tensor, goal_yaw: torch.Tensor):
    """py:213: the current quaternion's z with the goal quaternion's w,
    yaw = atan2(2 w_goal z_cur, 1 - 2 z_cur²)."""
    zc = torch.sin(current_yaw * 0.5)
    wg = torch.cos(goal_yaw * 0.5)
    return torch.atan2(2.0 * wg * zc, 1.0 - 2.0 * zc * zc)


def resolve_weights(scen: Scenario, cfg: MpcConfig):
    """Per-lane weights as (B, 1) tensors, or the config's floats."""
    if scen.weights is None:
        return {n: getattr(cfg, n) for n in _WEIGHT_NAMES}
    return {n: getattr(scen.weights, n)[:, None] for n in _WEIGHT_NAMES}


def resolve_limits(scen: Scenario, cfg: MpcConfig) -> Limits:
    if scen.limits is not None:
        return scen.limits
    return Limits.from_config(cfg, scen.current_pose.shape[0],
                              scen.current_pose.device)


def control_cost(cmd_flat: torch.Tensor, current_vel: torch.Tensor,
                 cfg: MpcConfig, w_control=None) -> torch.Tensor:
    """w_control · Σ_i ‖current_vel − u_i‖ / N (py:253-254), or the squared
    norm with the quirk off. The sqrt is guarded so its gradient at a zero
    difference is 0, not NaN."""
    cmd = cmd_flat.reshape(cmd_flat.shape[:-1] + (cfg.control_steps, 3))
    diff = current_vel[..., None, :] - cmd
    d2 = (diff * diff).sum(-1)
    wc = cfg.w_control if w_control is None else w_control
    if cfg.compat.unsquared_control_cost:
        zero = d2 == 0.0
        dv = torch.where(zero, 0.0, torch.sqrt(torch.where(zero, 1.0, d2)))
        return (wc * dv.sum(-1, keepdim=True))[..., 0] / cfg.control_steps
    return (wc * d2.sum(-1, keepdim=True))[..., 0] / cfg.control_steps


def _sq(v):
    return v * v


def _stage_and_terminal(cfg, scen, cmd, body_traj, odom_traj,
                        costmap_point_cost, fp_term_per_step, orient_err_fn,
                        include_control=True):
    """Shared cost accumulation (py:250-268). Per-step terms are (B, N)."""
    n = cfg.control_steps
    w = resolve_weights(scen, cfg)
    carrot_xy = scen.carrot_pose[..., :2]
    d2 = _sq(carrot_xy[..., None, :] - body_traj[..., :2]).sum(-1)
    oerr = orient_err_fn(scen.carrot_pose[..., 2:3] - body_traj[..., 2])
    cost = (w["w_trans"] * d2 + w["w_orient"] * _sq(oerr)).sum(-1) / n

    if include_control:
        cost = cost + control_cost(cmd.flatten(-2), scen.current_vel, cfg,
                                   w["w_control"])

    sq = _sq(costmap_point_cost)
    if cfg.compat.lethal_1000x:
        wcm = w["w_costmap"]
        if not torch.is_tensor(wcm):
            wcm = torch.full_like(sq, wcm)
        scale = torch.where(costmap_point_cost == 1.0, 1000.0, wcm)
    else:
        scale = w["w_costmap"]
    cost = cost + (scale * sq).sum(-1) / n
    cost = cost + fp_term_per_step.sum(-1) / n

    term_o = orient_err_fn(scen.goal_pose[..., 2] - body_traj[..., -1, 2])
    if cfg.compat.footprint_alias_noop:
        term_d2 = _sq(carrot_xy - scen.goal_pose[..., :2]).sum(-1)
    else:
        term_d2 = _sq(odom_traj[..., -1, :2] - scen.goal_pose[..., :2]).sum(-1)
    sq1 = lambda v: v if not torch.is_tensor(v) else v[..., 0]
    cost = cost + (sq1(w["w_trans"]) * term_d2
                   + sq1(w["w_orient"]) * _sq(term_o)) * sq1(w["w_terminal"])
    return cost


def parity_footprint_term(scen: Scenario, cfg: MpcConfig) -> torch.Tensor:
    """The per-solve constant footprint term (py:262-263): w_footprint when
    the current footprint touches lethal cost, else 0. (B,)."""
    fp_world = transform_footprint(scen.current_pose, scen.footprint)
    fp_cost = footprint_cost(scen.costmap, fp_world,
                             cfg.footprint_edge_samples, cfg.footprint_mode)
    wf = resolve_weights(scen, cfg)["w_footprint"]
    wf = wf[..., 0] if torch.is_tensor(wf) else wf
    return torch.where(fp_cost == 1.0, fp_cost * fp_cost * wf, 0.0)


def objective_parity(cmd_flat: torch.Tensor, scen: Scenario, cfg: MpcConfig,
                     fp_term: "torch.Tensor | None" = None,
                     include_control: bool = True,
                     point_sampler=None) -> torch.Tensor:
    """Quirk-faithful objective. cmd_flat: (B, 3N) [vx0, vy0, w0, vx1, ...].

    fp_term: optional precomputed parity_footprint_term (B,).
    point_sampler: optional (wx, wy) -> costs for the per-step costmap read
    (the solver passes make_point_sampler's hoisted gather)."""
    n = cfg.control_steps
    cmd = cmd_flat.reshape(cmd_flat.shape[:-1] + (n, 3))
    dt = cfg.dt

    # Body-frame rollout from the origin (py:230-232).
    body_traj = rollout(cmd, dt, torch.zeros_like(scen.current_pose))

    # Odom rollout with the buggy yaw seed (py:213, :234-236).
    cp = scen.current_pose
    if cfg.compat.buggy_odom_yaw:
        yaw0 = buggy_odom_yaw(cp[..., 2], scen.goal_pose[..., 2])
    else:
        yaw0 = cp[..., 2]
    odom_traj = rollout(cmd, dt, torch.stack([cp[..., 0], cp[..., 1], yaw0],
                                             dim=-1))

    sample = point_sampler if point_sampler is not None else (
        lambda wx, wy: cost_at_world(scen.costmap, wx, wy))
    pc = sample(odom_traj[..., 0], odom_traj[..., 1])          # (B, N)

    if fp_term is None:
        fp_term = parity_footprint_term(scen, cfg)
    fp_per_step = fp_term[..., None].expand(pc.shape)

    err_fn = (lambda e: e) if cfg.compat.no_angle_wrap else wrap_angle
    return _stage_and_terminal(cfg, scen, cmd, body_traj, odom_traj, pc,
                               fp_per_step, orient_err_fn=err_fn,
                               include_control=include_control)


def make_objective(cfg: MpcConfig, parity: bool = True):
    """Close the config over the objective: f(cmd_flat, scen, fp_term=None,
    include_control=True, point_sampler=None) -> (B,) cost."""
    if not parity:
        raise NotImplementedError(
            "product mode (objective_product) is not ported yet (ROADMAP.md)")

    def f(cmd_flat, scen, fp_term=None, include_control=True,
          point_sampler=None):
        return objective_parity(cmd_flat, scen, cfg, fp_term=fp_term,
                                include_control=include_control,
                                point_sampler=point_sampler)

    f.parity = True
    f.cfg = cfg
    return f
