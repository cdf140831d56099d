"""The MPC engine: one batched controller step (port of `engine.py`).

The reference's two-process tick — plugin geometry (NeoMpcPlanner.cpp:
202-254), then the SLSQP server's solve and post-processing
(mpc_optimization_server.py:349-403) — as one function of (config, state,
inputs). The control-loop memory of both halves lives in `ControlState`.
Every tensor of the batched functions carries a leading batch dim of
lanes; `solve_step` and `controller_step` take one lane without it and run
the batched path at batch 1 (lanes are independent).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .config import MpcConfig
from .ops.costmap import Costmap, cost_at_world, u8_source_enabled
from .ops.footprint import Footprint, footprint_cost, transform_footprint
from .ops.objective import Scenario, make_objective
from .ops.pursuit import Plan, pursuit_tick
from .ops.rollout import rollout
from .tree import tree_map
from .utils.profiling import span

__all__ = ["ControlState", "StepResult", "init_state", "batch_state",
           "solve_step", "controller_step", "make_batched_controller_step",
           "MpcEngine"]


@dataclasses.dataclass
class ControlState:
    """Per-lane persistent control-loop memory."""

    initial_guess: torch.Tensor   # (3N,) warm start (py:136)
    last_control: torch.Tensor    # (3,) previous command (py:117)
    waiting_time: torch.Tensor    # () stuck-wait accumulator (py:361)
    collision: torch.Tensor       # () bool predicted-collision latch (py:339)
    old_goal: torch.Tensor        # (3,) goal of the previous tick (py:146)
    has_old_goal: torch.Tensor    # () bool; False forces the first-call reset
    slow_down: torch.Tensor       # () bool plugin hysteresis (h:162)
    plan_start: torch.Tensor      # () int32 consumed plan prefix (cpp:127)

    def replace(self, **kw) -> "ControlState":
        return dataclasses.replace(self, **kw)


def init_state(cfg: MpcConfig, device="cuda") -> ControlState:
    """One lane's initial state (no batch dim); see batch_state."""
    n = cfg.control_steps
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    b = lambda v: torch.tensor(v, dtype=torch.bool, device=device)
    return ControlState(
        initial_guess=z(3 * n), last_control=z(3), waiting_time=z(),
        collision=b(False), old_goal=z(3), has_old_goal=b(False),
        slow_down=b(True),
        plan_start=torch.tensor(0, dtype=torch.int32, device=device))


def batch_state(state: ControlState, batch: int) -> ControlState:
    """Repeat one lane's state over a batch."""
    return tree_map(lambda x: x.expand((batch,) + x.shape).clone(), state)


class StepResult(NamedTuple):
    cmd_vel: torch.Tensor          # (B, 3) the answer (output_vel.twist)
    state: ControlState            # updated persistent state
    raw_solution: torch.Tensor     # (B, 3N) solver output before filtering
    solver_converged: torch.Tensor
    solver_iters: torch.Tensor
    fun: torch.Tensor
    collision: torch.Tensor
    collision_footprint: torch.Tensor
    lethal: torch.Tensor           # plugin-side hard stop (cpp:234-236)
    plan_empty: torch.Tensor       # empty transformed-plan window (cpp:130)
    carrot_pose: torch.Tensor
    closer_to_goal: torch.Tensor
    local_plan: torch.Tensor       # (B, N+1, 3) pose + raw-solution rollout
    plan_window_begin: torch.Tensor
    plan_window_end: torch.Tensor


def _shift_warm_start(x: torch.Tensor, n: int) -> torch.Tensor:
    """initial_guess_update (py:198-202): shift the controls left one step,
    wrap the (low-passed) first control to the back."""
    xs = x.reshape(x.shape[0], n, 3)
    return torch.cat([xs[:, 1:], xs[:, :1]], dim=1).reshape(x.shape)


def _pre_solve(cfg: MpcConfig, state: ControlState, scen: Scenario):
    """New-goal reset (py:357-361): (guess, last_control, waiting_time)."""
    same = state.has_old_goal & (state.old_goal == scen.goal_pose).all(-1)
    guess = torch.where(same[:, None], state.initial_guess, 0.0)
    last_control = torch.where(same[:, None], state.last_control, 0.0)
    waiting_time = torch.where(same, state.waiting_time, 0.0)
    return guess, last_control, waiting_time


def _post_solve(cfg: MpcConfig, state: ControlState, scen: Scenario,
                delta_t: torch.Tensor, res, last_control: torch.Tensor,
                waiting_time: torch.Tensor,
                fp_cost: "torch.Tensor | None" = None) -> StepResult:
    """Everything after the solve (py:365-403): visualization, low-pass,
    collision/stuck logic, acceleration clamp, state persistence."""
    n = cfg.control_steps
    B = res.x.shape[0]
    dt = cfg.dt

    # Local plan (py:271-310): the raw solution from the current pose.
    viz = rollout(res.x.reshape(B, n, 3), dt, scen.current_pose)
    local_plan = torch.cat([scen.current_pose[:, None], viz], dim=1)

    # Low-pass the first control only (py:366-367).
    g = res.x.new_tensor(cfg.low_pass_gain)
    first = res.x[:, :3] * g + last_control * (1.0 - g)
    x = torch.cat([first, res.x[:, 3:]], dim=-1)

    # Predicted-collision check (py:312-347).
    odom = rollout(x.reshape(B, n, 3), dt, scen.current_pose)
    point_costs = cost_at_world(scen.costmap, odom[..., 0], odom[..., 1])
    collision = state.collision | (point_costs >= 0.99).any(-1)

    if fp_cost is None:
        fp_world = transform_footprint(scen.current_pose, scen.footprint)
        fp_cost = footprint_cost(scen.costmap, fp_world,
                                 cfg.footprint_edge_samples,
                                 cfg.footprint_mode)
    collision_footprint = fp_cost == 1.0

    # Stuck-wait vs acceleration clamp (py:374-391).
    blocked = collision | collision_footprint
    waiting_time = torch.where(blocked, waiting_time + delta_t, waiting_time)
    stuck_thresh = (3.0 if cfg.compat.hardcoded_stuck_wait
                    else cfg.waiting_time)
    expire = blocked & (waiting_time >= stuck_thresh)
    collision = collision & ~expire
    waiting_time = torch.where(expire, 0.0, waiting_time)

    if scen.control_interval is None:
        ci = cfg.control_interval
    else:
        ci = scen.control_interval[:, None]
    if scen.limits is None:
        acc_lim = x.new_tensor([cfg.acc_x_limit, cfg.acc_y_limit,
                                cfg.acc_theta_limit])
    else:
        acc_lim = scen.limits.acc
    acc = acc_lim * ci
    # fmin/fmax ignore a NaN operand like the reference's np.fmin/fmax
    # (py:384-391): a diverged solve clamps into the finite band instead of
    # poisoning last_control. torch.clamp would propagate the NaN.
    clamped = torch.fmax(torch.fmin(x[:, :3], last_control + acc),
                         last_control - acc)
    cmd = torch.where(blocked[:, None], 0.0, clamped)

    # Persist (py:393-400).
    new_guess = torch.where(res.converged[:, None], _shift_warm_start(x, n), x)
    new_state = ControlState(
        initial_guess=new_guess, last_control=cmd, waiting_time=waiting_time,
        collision=collision, old_goal=scen.goal_pose,
        has_old_goal=torch.ones_like(collision),
        slow_down=state.slow_down, plan_start=state.plan_start)
    no = torch.zeros_like(collision)
    zi = torch.zeros_like(state.plan_start)
    return StepResult(
        cmd_vel=cmd, state=new_state, raw_solution=res.x,
        solver_converged=res.converged, solver_iters=res.iters, fun=res.fun,
        collision=collision, collision_footprint=collision_footprint,
        lethal=no, plan_empty=no, carrot_pose=scen.carrot_pose,
        closer_to_goal=scen.switch_opt, local_plan=local_plan,
        plan_window_begin=zi, plan_window_end=zi)


def _solve_lanes(cfg: MpcConfig, state: ControlState, scen: Scenario,
                 delta_t: torch.Tensor, solve_batch,
                 fp_cost: "torch.Tensor | None" = None) -> StepResult:
    """The optimization-server half of the tick (py:349-403) on a batch of
    lanes: the new-goal reset, the solve, the post-processing."""
    with torch.no_grad():
        guess, last_control, waiting_time = _pre_solve(cfg, state, scen)
    res = solve_batch(guess, scen)
    with torch.no_grad(), span("engine.post_solve"):
        return _post_solve(cfg, state, scen, delta_t, res, last_control,
                           waiting_time, fp_cost=fp_cost)


def _lane(x):
    return x[None]


def _unlane(x):
    return x[0]


def _batched_solver(cfg: MpcConfig, parity: bool, solver):
    """solve_batch(x0s, scens) at batch 1 for a single-lane `solver`
    (x0 (3N,), scen) -> SolveResult; the batched SQP when it is None."""
    if solver is None:
        from .sqp import make_sqp_solver_batched

        return make_sqp_solver_batched(cfg, make_objective(cfg, parity))

    def solve_batch(x0s, scens):
        return tree_map(_lane, solver(x0s[0], tree_map(_unlane, scens)))

    return solve_batch


def solve_step(cfg: MpcConfig, state: ControlState, scen: Scenario,
               delta_t, *, parity: bool = True, solver=None,
               fp_cost=None) -> StepResult:
    """The optimization-server half of the tick (py:349-403) for one lane:
    state and scen without a batch dim. delta_t: wall-clock seconds since
    the previous tick (py:369-371). solver: optional single-lane solve(x0,
    scen) -> SolveResult (sqp.make_sqp_solver); the SQP on the chosen
    objective by default. fp_cost: optional precomputed current-pose
    footprint cost (the pursuit gate's)."""
    dt = torch.as_tensor(delta_t, dtype=torch.float32,
                         device=scen.current_pose.device)
    out = _solve_lanes(cfg, tree_map(_lane, state), tree_map(_lane, scen),
                       dt[None], _batched_solver(cfg, parity, solver),
                       None if fp_cost is None else _lane(fp_cost))
    return tree_map(_unlane, out)


def controller_step(cfg: MpcConfig, state: ControlState, plan: Plan,
                    robot_pose, current_vel, costmap: Costmap,
                    base_footprint: Footprint, delta_t, *,
                    parity: bool = True, solver=None,
                    limits=None) -> StepResult:
    """The full tick (computeVelocityCommands, cpp:202-254, with the
    service hop in-process) for one lane, no batch dims: pursuit, solve,
    post-processing; the plugin gates come back as the `lethal` and
    `plan_empty` flags. solver: optional single-lane solver as in
    solve_step; limits: optional runtime Limits of this lane."""
    dt = torch.as_tensor(delta_t, dtype=torch.float32,
                         device=robot_pose.device)
    step = make_batched_controller_step(
        cfg, parity, None if solver is None
        else _batched_solver(cfg, parity, solver))
    args = tree_map(_lane, (state, plan, robot_pose, current_vel, costmap,
                            base_footprint, dt, limits))
    return tree_map(_unlane, step(*args))


def _tick_pre(cfg, state: ControlState, plan: Plan, robot_pose, current_vel,
              costmap: Costmap, base_footprint: Footprint, limits):
    """Plugin-side geometry + hysteresis-state update for one tick."""
    pr = pursuit_tick(cfg, plan, state.plan_start, state.slow_down,
                      robot_pose, costmap, base_footprint)
    scen = Scenario(current_pose=robot_pose, carrot_pose=pr.carrot_pose,
                    goal_pose=plan.goal(), current_vel=current_vel,
                    footprint=base_footprint, costmap=costmap,
                    switch_opt=pr.closer_to_goal, limits=limits)
    slow_down = torch.where(pr.plan_empty, state.slow_down, pr.slow_down)
    return pr, scen, state.replace(slow_down=slow_down,
                                   plan_start=pr.new_start)


def _tick_post(pr, state: ControlState, out: StepResult) -> StepResult:
    """Plugin-gate merge: on an empty-window or lethal-footprint tick the
    reference throws before the server runs (cpp:130-132, :234-236), so the
    solve's state writes and flags are discarded."""
    skip = pr.lethal | pr.plan_empty

    def keep(pre, post):
        return torch.where(skip.reshape(skip.shape + (1,) * (pre.dim() - 1)),
                           pre, post)

    return out._replace(
        cmd_vel=torch.where(skip[:, None], 0.0, out.cmd_vel),
        state=tree_map(keep, state, out.state),
        collision=torch.where(skip, state.collision, out.collision),
        collision_footprint=out.collision_footprint & ~skip,
        solver_converged=out.solver_converged & ~skip,
        lethal=pr.lethal,
        plan_empty=pr.plan_empty,
        carrot_pose=pr.carrot_pose,
        closer_to_goal=pr.closer_to_goal,
        plan_window_begin=pr.window_begin,
        plan_window_end=pr.window_end,
    )


def make_batched_controller_step(cfg: MpcConfig, parity: bool = True,
                                 solver_batch=None):
    """Build the batched full tick: step(state, plan, robot_pose,
    current_vel, costmap, footprint, delta_t, limits=None) -> StepResult,
    every argument with a leading batch dim."""
    if solver_batch is None:
        from .sqp import make_sqp_solver_batched

        solver_batch = make_sqp_solver_batched(
            cfg, make_objective(cfg, parity=parity))

    def step(state, plan, robot_pose, current_vel, costmap, footprint,
             delta_t, limits=None):
        with torch.no_grad(), span("engine.pre"):
            u8 = u8_source_enabled(
                cfg.solver_costmap_u8,
                costmap.data.shape[-2] * costmap.data.shape[-1])
            if costmap.flat is None or (u8 and costmap.flat_u8 is None):
                costmap = costmap.with_flat(u8=u8)
            pr, scen, st2 = _tick_pre(cfg, state, plan, robot_pose,
                                      current_vel, costmap, footprint, limits)
        with span("engine.solve_lanes"):
            out = _solve_lanes(cfg, st2, scen, delta_t, solver_batch,
                               fp_cost=pr.footprint_cost)
        with torch.no_grad(), span("engine.post"):
            return _tick_post(pr, st2, out)

    return step


class MpcEngine:
    """Convenience wrapper: single-robot and batched steps. Its states
    live on `device`, the card unless the caller asks for the CPU.

    >>> eng = MpcEngine(cfg)
    >>> state = eng.init_state()
    >>> out = eng.step(state, plan, robot_pose, vel, costmap, footprint, dt)
    """

    def __init__(self, cfg: MpcConfig, parity: bool = True,
                 device="cuda"):
        self.cfg = cfg
        self.parity = parity
        self.device = device
        self._batch_step = make_batched_controller_step(cfg, parity)

    def init_state(self) -> ControlState:
        return init_state(self.cfg, self.device)

    def init_batch_state(self, batch: int) -> ControlState:
        return batch_state(init_state(self.cfg, self.device), batch)

    def step(self, state, plan, robot_pose, current_vel, costmap, footprint,
             delta_t, limits=None):
        """One robot (no batch dims): the batched step at batch 1."""
        dt = torch.as_tensor(delta_t, dtype=torch.float32,
                             device=robot_pose.device)
        args = tree_map(lambda x: x[None], (state, plan, robot_pose,
                                            current_vel, costmap, footprint,
                                            dt, limits))
        out = self._batch_step(*args)
        return tree_map(lambda x: x[0], out)

    def batch_step(self, state, plan, robot_pose, current_vel, costmap,
                   footprint, delta_t, limits=None):
        return self._batch_step(state, plan, robot_pose, current_vel,
                                costmap, footprint, delta_t, limits)
