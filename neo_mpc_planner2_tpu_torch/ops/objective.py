"""The MPC objective (port of `ops/objective.py`).

Parity mode reproduces mpc_optimization_server.py:204-269 with the
reference's quirks: buggy odom yaw (py:213), the footprint-aliasing no-op
(py:227/238-244), the exactly-lethal x1000 branch (py:257-260), the
un-squared control cost (py:253-254), un-wrapped angle errors and
nearest-cell costmap sampling. Product mode is the smooth objective:
bilinear costmap sampling, the footprint cost at every predicted pose,
wrapped angle errors.

Every function takes a leading batch dim of lanes: the decision vector is
(B, 3N) and the objective (B,). The decision vector may carry candidate dims
after the lane dim, (B, *cand, 3N) -> (B, *cand), against the same (B, ...)
scenario: the line search's wave evaluates its K candidates so. Lanes are
independent, so the gradient of the sum over lanes is the per-lane gradient.
Nearest-cell reads go through integer indices, so their gradient is zero, as
in JAX.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import MpcConfig
from .costmap import Costmap, cost_at_world, cost_at_world_bilinear
from .footprint import Footprint, footprint_cost, transform_footprint
from .rollout import rollout
from .se2 import se2_apply, wrap_angle

__all__ = ["Scenario", "Weights", "Limits", "resolve_weights",
           "resolve_limits", "buggy_odom_yaw", "control_cost",
           "parity_footprint_term", "objective_parity", "objective_product",
           "make_objective"]

_WEIGHT_NAMES = ("w_trans", "w_orient", "w_control", "w_terminal",
                 "w_costmap", "w_footprint")


@dataclasses.dataclass
class Weights:
    """Per-lane cost-weight overrides, each (B,) (or () for one lane)."""

    w_trans: torch.Tensor
    w_orient: torch.Tensor
    w_control: torch.Tensor
    w_terminal: torch.Tensor
    w_costmap: torch.Tensor
    w_footprint: torch.Tensor

    def replace(self, **kw) -> "Weights":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def from_config(cfg: MpcConfig, batch: int | None = None,
                    device="cuda") -> "Weights":
        """The config's weights: each (batch,), or () with batch None (the
        JAX package's unbatched Weights)."""
        shape = () if batch is None else (batch,)
        return Weights(*(torch.full(shape, getattr(cfg, n),
                                    dtype=torch.float32, device=device)
                         for n in _WEIGHT_NAMES))

    @staticmethod
    def grid(cfg: MpcConfig, device="cuda", **axes) -> "Weights":
        """Cartesian weight grid flattened to a batch (the `ij` meshgrid of
        the axes, the config's value on an axis not given):
        Weights.grid(cfg, w_trans=[0.5, 0.82], w_control=[0.01, 0.05, 0.2])
        -> a batch of 6."""
        import numpy as np

        arrays = [np.asarray(axes.get(n, [getattr(cfg, n)]), np.float32)
                  for n in _WEIGHT_NAMES]
        mesh = np.meshgrid(*arrays, indexing="ij")
        return Weights(*(torch.as_tensor(m.reshape(-1), device=device)
                         for m in mesh))


@dataclasses.dataclass
class Limits:
    """Per-lane runtime velocity/acceleration limits (without the lane dim
    for one lane)."""

    vel_lo: torch.Tensor         # (B, 3) min_vel_x, min_vel_y, min_vel_theta
    vel_hi: torch.Tensor         # (B, 3)
    max_vel_trans: torch.Tensor  # (B,)
    acc: torch.Tensor            # (B, 3) acc_x_limit, acc_y_limit, acc_theta

    def replace(self, **kw) -> "Limits":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def from_config(cfg: MpcConfig, batch: int | None = None,
                    device="cuda") -> "Limits":
        """The config's limits: (batch, 3) and (batch,), or (3,) and ()
        with batch None (the JAX package's unbatched Limits)."""
        lead = () if batch is None else (batch,)
        f = lambda *v: torch.tensor(v, dtype=torch.float32,
                                    device=device).expand(lead + (len(v),))
        return Limits(
            vel_lo=f(cfg.min_vel_x, cfg.min_vel_y, cfg.min_vel_theta),
            vel_hi=f(cfg.max_vel_x, cfg.max_vel_y, cfg.max_vel_theta),
            max_vel_trans=f(cfg.max_vel_trans)[..., 0],
            acc=f(cfg.acc_x_limit, cfg.acc_y_limit, cfg.acc_theta_limit))

    def scaled(self, scale) -> "Limits":
        """The translational bounds scaled by a speed-limit fraction
        (setSpeedLimit's percentage of the robot's maximum speed); the yaw
        rate and the accelerations untouched."""
        s = torch.as_tensor(scale, dtype=torch.float32,
                            device=self.vel_lo.device)
        m = torch.stack([s, s, torch.ones_like(s)])
        return Limits(vel_lo=self.vel_lo * m, vel_hi=self.vel_hi * m,
                      max_vel_trans=self.max_vel_trans * s, acc=self.acc)


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

    @staticmethod
    def create(current_pose, carrot_pose, goal_pose, current_vel,
               footprint: Footprint, costmap: Costmap, switch_opt=False,
               weights=None, control_interval=None, limits=None,
               device=None) -> "Scenario":
        """One lane's request, without a lane dim (as solve_step takes
        it): the poses and velocity as float32 tensors on `device`, the
        costmap's by default."""
        device = costmap.data.device if device is None else device
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                        device=device)
        return Scenario(
            current_pose=f32(current_pose), carrot_pose=f32(carrot_pose),
            goal_pose=f32(goal_pose), current_vel=f32(current_vel),
            footprint=footprint, costmap=costmap,
            switch_opt=torch.as_tensor(switch_opt, dtype=torch.bool,
                                       device=device),
            weights=weights,
            control_interval=(None if control_interval is None
                              else f32(control_interval)),
            limits=limits)


def buggy_odom_yaw(current_yaw: torch.Tensor, goal_yaw: torch.Tensor):
    """py:213: the current quaternion's z with the goal quaternion's w,
    yaw = atan2(2 w_goal z_cur, 1 - 2 z_cur²)."""
    zc = torch.sin(current_yaw * 0.5)
    wg = torch.cos(goal_yaw * 0.5)
    return torch.atan2(2.0 * wg * zc, 1.0 - 2.0 * zc * zc)


def resolve_weights(scen: Scenario, cfg: MpcConfig):
    """Per-lane weights as the scenario holds them ((B,), or (B, *cand)
    after _with_candidates), or the config's floats."""
    if scen.weights is None:
        return {n: getattr(cfg, n) for n in _WEIGHT_NAMES}
    return {n: getattr(scen.weights, n) for n in _WEIGHT_NAMES}


def _with_candidates(scen: Scenario, extra: int) -> Scenario:
    """The scenario's per-lane poses, velocity and weights with `extra`
    singleton candidate axes after the lane axis, so that they broadcast
    against (B, *cand, ...) terms. The costmap and footprint keep their lane
    shape: they are read per lane, never copied per candidate."""
    if extra == 0:
        return scen
    c = lambda v: v.reshape(v.shape[:1] + (1,) * extra + v.shape[1:])
    weights = scen.weights
    if weights is not None:
        weights = Weights(*(c(getattr(weights, n)) for n in _WEIGHT_NAMES))
    return scen.replace(current_pose=c(scen.current_pose),
                        carrot_pose=c(scen.carrot_pose),
                        goal_pose=c(scen.goal_pose),
                        current_vel=c(scen.current_vel), weights=weights)


def _step(v):
    """A per-lane value broadcast over the trailing per-step axis."""
    return v[..., None] if torch.is_tensor(v) else v


def resolve_limits(scen: Scenario, cfg: MpcConfig) -> Limits:
    if scen.limits is not None:
        return scen.limits
    return Limits.from_config(cfg, scen.current_pose.shape[0],
                              scen.current_pose.device)


def control_cost(cmd_flat: torch.Tensor, current_vel: torch.Tensor,
                 cfg: MpcConfig, w_control=None) -> torch.Tensor:
    """w_control · Σ_i ‖current_vel − u_i‖ / N (py:253-254), or the squared
    norm with the quirk off. The sqrt is guarded so its gradient at a zero
    difference is 0, not NaN. w_control: a float, or per-lane values shaped
    like the result."""
    cmd = cmd_flat.reshape(cmd_flat.shape[:-1] + (cfg.control_steps, 3))
    diff = current_vel[..., None, :] - cmd
    d2 = (diff * diff).sum(-1)
    wc = cfg.w_control if w_control is None else w_control
    if cfg.compat.unsquared_control_cost:
        zero = d2 == 0.0
        dv = torch.where(zero, 0.0, torch.sqrt(torch.where(zero, 1.0, d2)))
        return wc * dv.sum(-1) / cfg.control_steps
    return wc * d2.sum(-1) / cfg.control_steps


def _sq(v):
    return v * v


def _stage_and_terminal(cfg, scen, cmd, body_traj, odom_traj,
                        costmap_point_cost, fp_term_per_step, orient_err_fn,
                        include_control=True):
    """Shared cost accumulation (py:250-268). `scen` is already shaped
    against the (B, *cand) lead dims (_with_candidates); per-step terms are
    (B, *cand, N)."""
    n = cfg.control_steps
    w = resolve_weights(scen, cfg)
    carrot_xy = scen.carrot_pose[..., :2]
    d2 = _sq(carrot_xy[..., None, :] - body_traj[..., :2]).sum(-1)
    oerr = orient_err_fn(scen.carrot_pose[..., 2:3] - body_traj[..., 2])
    cost = (_step(w["w_trans"]) * d2
            + _step(w["w_orient"]) * _sq(oerr)).sum(-1) / n

    if include_control:
        cost = cost + control_cost(cmd.flatten(-2), scen.current_vel, cfg,
                                   w["w_control"])

    sq = _sq(costmap_point_cost)
    if cfg.compat.lethal_1000x:
        wcm = _step(w["w_costmap"])
        if not torch.is_tensor(wcm):
            wcm = torch.full_like(sq, wcm)
        scale = torch.where(costmap_point_cost == 1.0, 1000.0, wcm)
    else:
        scale = _step(w["w_costmap"])
    cost = cost + (scale * sq).sum(-1) / n
    cost = cost + fp_term_per_step.sum(-1) / n

    term_o = orient_err_fn(scen.goal_pose[..., 2] - body_traj[..., -1, 2])
    if cfg.compat.footprint_alias_noop:
        term_d2 = _sq(carrot_xy - scen.goal_pose[..., :2]).sum(-1)
    else:
        term_d2 = _sq(odom_traj[..., -1, :2] - scen.goal_pose[..., :2]).sum(-1)
    cost = cost + (w["w_trans"] * term_d2
                   + w["w_orient"] * _sq(term_o)) * w["w_terminal"]
    return cost


def parity_footprint_term(scen: Scenario, cfg: MpcConfig) -> torch.Tensor:
    """The per-solve constant footprint term (py:262-263): w_footprint when
    the current footprint touches lethal cost, else 0. (B,)."""
    fp_world = transform_footprint(scen.current_pose, scen.footprint)
    fp_cost = footprint_cost(scen.costmap, fp_world,
                             cfg.footprint_edge_samples, cfg.footprint_mode)
    wf = resolve_weights(scen, cfg)["w_footprint"]
    return torch.where(fp_cost == 1.0, fp_cost * fp_cost * wf, 0.0)


def objective_parity(cmd_flat: torch.Tensor, scen: Scenario, cfg: MpcConfig,
                     fp_term: "torch.Tensor | None" = None,
                     include_control: bool = True,
                     point_sampler=None) -> torch.Tensor:
    """Quirk-faithful objective. cmd_flat: (B, *cand, 3N) [vx0, vy0, w0,
    vx1, ...].

    fp_term: optional precomputed parity_footprint_term (B,).
    point_sampler: optional (wx, wy) -> costs for the per-step costmap read
    (the solver passes make_point_sampler's hoisted gather)."""
    n = cfg.control_steps
    cmd = cmd_flat.reshape(cmd_flat.shape[:-1] + (n, 3))
    dt = cfg.dt
    if fp_term is None:
        fp_term = parity_footprint_term(scen, cfg)
    extra = cmd_flat.dim() - 2
    scen = _with_candidates(scen, extra)
    fp_term = fp_term.reshape(fp_term.shape[:1] + (1,) * extra)

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
    pc = sample(odom_traj[..., 0], odom_traj[..., 1])     # (B, *cand, N)
    fp_per_step = fp_term[..., None].expand(pc.shape)

    err_fn = (lambda e: e) if cfg.compat.no_angle_wrap else wrap_angle
    return _stage_and_terminal(cfg, scen, cmd, body_traj, odom_traj, pc,
                               fp_per_step, orient_err_fn=err_fn,
                               include_control=include_control)


def objective_product(cmd_flat: torch.Tensor, scen: Scenario, cfg: MpcConfig,
                      include_control: bool = True,
                      point_sampler=None) -> torch.Tensor:
    """Smooth product-mode objective: bilinear costmap sampling, the
    footprint cost at each predicted pose, wrapped angle errors; the same
    weights and structure as parity. cmd_flat: (B, *cand, 3N).

    point_sampler: optional per-solve ProductPatchSampler; the bilinear
    point costs and the footprint samples then read through its window
    (the same values inside its coverage guarantee); in exact mode the
    footprint walk reads the whole map instead. The footprint costs of
    all (B, *cand, N) predicted poses are one footprint_cost call; they
    carry no gradient, as in JAX."""
    n = cfg.control_steps
    cmd = cmd_flat.reshape(cmd_flat.shape[:-1] + (n, 3))
    fp, cm = scen.footprint, scen.costmap
    scen = _with_candidates(scen, cmd_flat.dim() - 2)

    body_traj = rollout(cmd, cfg.dt, torch.zeros_like(scen.current_pose))
    odom_traj = rollout(cmd, cfg.dt, scen.current_pose)   # (B, *cand, N, 3)

    if point_sampler is None:
        pc = cost_at_world_bilinear(cm, odom_traj[..., 0], odom_traj[..., 1])
    else:
        pc = point_sampler.bilinear(odom_traj[..., 0], odom_traj[..., 1])
    # The footprint reads go through the patch too, except in exact mode:
    # the walk reads the whole map (objective.py:333-335 in JAX).
    bounds = (None if point_sampler is None or cfg.footprint_mode == "exact"
              else point_sampler.bounds)

    lanes = lambda v, tail: v.reshape(
        v.shape[:1] + (1,) * (odom_traj.dim() - 2) + tail)
    placed = Footprint(
        vertices=se2_apply(odom_traj[..., None, :],
                           lanes(fp.vertices, fp.vertices.shape[1:])),
        n_valid=lanes(fp.n_valid, ()))
    fp_costs = footprint_cost(cm, placed, cfg.footprint_edge_samples,
                              cfg.footprint_mode, bounds=bounds)
    fp_per_step = _sq(fp_costs) * _step(resolve_weights(scen,
                                                        cfg)["w_footprint"])

    return _stage_and_terminal(cfg, scen, cmd, body_traj, odom_traj, pc,
                               fp_per_step, orient_err_fn=wrap_angle,
                               include_control=include_control)


def make_objective(cfg: MpcConfig, parity: bool = True):
    """Close the config over the chosen objective: f(cmd_flat, scen,
    fp_term=None, include_control=True, point_sampler=None) -> (B, *cand)
    cost. Product mode takes no fp_term."""
    if parity:
        def f(cmd_flat, scen, fp_term=None, include_control=True,
              point_sampler=None):
            return objective_parity(cmd_flat, scen, cfg, fp_term=fp_term,
                                    include_control=include_control,
                                    point_sampler=point_sampler)
    else:
        def f(cmd_flat, scen, fp_term=None, include_control=True,
              point_sampler=None):
            del fp_term
            return objective_product(cmd_flat, scen, cfg,
                                     include_control=include_control,
                                     point_sampler=point_sampler)

    f.parity = parity
    f.cfg = cfg
    return f
