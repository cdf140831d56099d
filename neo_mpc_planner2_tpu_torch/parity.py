"""The MPO-700 scenario-suite gate: the port's device pipeline against the
scipy oracle (`oracle.py`), the north star's "bit-tolerant match to scipy
SLSQP commands on the MPO-700 scenario suite".

The suite and its gate are the JAX package's (tests/test_mpo700_suite.py):
the generator's batch (48x48 maps, 48-point plans, MPO-700 rectangle),
the batched pursuit and one batched solve on `device` (ftol 1e-8, 300
iterations), the oracle fed the identical request per scenario on the
host. A command matches within 1e-2 m/s; the gate passes when at least 0.9
of the checked scenarios match and the worst device-minus-oracle objective
gap is below 5e-4 (scipy agrees with itself at 0.993 under 1e-6 warm-start
perturbation; the worst oracle-better gap seen at n = 300 was 4.6e-4).

    >>> report = run_suite(suite_config(), 64, seed=123, device="cuda")
    >>> report["passed"]
"""

from __future__ import annotations

import numpy as np
import torch

from .config import MpcConfig, default_config
from .engine import _solve_lanes, batch_state, init_state
from .ops.footprint import Footprint
from .ops.objective import Scenario, make_objective
from .ops.pursuit import pursuit_tick
from .oracle import NpCostmap, NpScenario, OracleServer
from .scenarios import MPO700_LENGTH, MPO700_WIDTH, make_scenario_batch
from .sqp import make_sqp_solver_batched

__all__ = ["MATCH_TOL", "MATCH_FRAC_GATE", "UNMATCHED_GAP_TOL",
           "suite_config", "device_solves", "run_suite"]

MATCH_TOL = 1e-2           # m/s, a command's largest component
MATCH_FRAC_GATE = 0.9
UNMATCHED_GAP_TOL = 5e-4


def suite_config() -> MpcConfig:
    """The suite's config (tests/test_mpo700_suite.py's `suite_cfg`)."""
    return default_config().replace(
        prediction_horizon=0.8, control_steps=3, opt_tolerance=1e-8,
        footprint_edge_samples=8, max_plan_points=64,
        acc_x_limit=2.5, acc_y_limit=2.5, acc_theta_limit=3.0,
        min_vel_x=-0.7, min_vel_y=-0.7, min_vel_theta=-0.7,
        max_vel_x=0.7, max_vel_y=0.7, max_vel_trans=0.7, max_vel_theta=0.7,
        w_trans=0.82, w_orient=0.5, w_control=0.05, w_terminal=0.05,
        w_costmap=0.05, w_footprint=0.0,
        lookahead_dist_min=0.4, lookahead_dist_max=0.4,
        lookahead_dist_close_to_goal=0.4)


def device_solves(cfg: MpcConfig, sb, device, state=None, start=None,
                  slow=None, pose=None, vel=None, solve=None):
    """The device half of the gate on a scenario batch `sb` of n lanes:
    the batched pursuit, then ONE batched solve (by default the SQP at
    ftol 1e-8 and 300 iterations). By default from a fresh plan window
    and the initial state at the batch's poses and velocities; a stateful
    sequence passes its state, window start, slow-down latch, poses and
    velocities. Returns the PursuitResult, the StepResult and the plans'
    goals (n, 3)."""
    n = sb.robot_pose.shape[0]
    if state is None:
        state = batch_state(init_state(cfg, device), n)
    if start is None:
        start = torch.zeros(n, dtype=torch.int32, device=device)
    if slow is None:
        slow = torch.zeros(n, dtype=torch.bool, device=device)
    pose = sb.robot_pose if pose is None else pose
    vel = sb.current_vel if vel is None else vel
    if solve is None:
        solve = make_sqp_solver_batched(cfg, make_objective(cfg), ftol=1e-8,
                                        max_iters=300)
    with torch.no_grad():
        pr = pursuit_tick(cfg, sb.plan, start, slow, pose, sb.costmap,
                          sb.footprint)
        goal = sb.plan.goal()
        scen = Scenario(
            current_pose=pose, carrot_pose=pr.carrot_pose,
            goal_pose=goal, current_vel=vel,
            footprint=sb.footprint, costmap=sb.costmap,
            switch_opt=pr.closer_to_goal,
            control_interval=torch.full((n,), 1 / 30, device=device))
    dt = torch.full((n,), 1 / 30, device=device)
    return pr, _solve_lanes(cfg, state, scen, dt, solve), goal


def run_suite(cfg: MpcConfig, n: int, seed: int, device="cuda") -> dict:
    """Drive n suite scenarios through the port on `device` and the oracle
    on the host. Scenarios with an empty plan window or a lethal footprint
    are skipped (the plugin throws before the service call). Returns
    checked, matched, their fraction, the worst objective gap, the
    scenarios where the oracle's footprint branch fired and the port's
    command was not zero, the device side's wall seconds and `passed`
    (the gate)."""
    import time

    fp_dev = Footprint.rectangle(MPO700_LENGTH, MPO700_WIDTH,
                                 cfg.max_footprint_vertices, device=device)
    sb = make_scenario_batch(cfg, n, seed=seed, map_size=48, plan_points=48,
                             footprint=fp_dev, device=device)
    hl, hw = MPO700_LENGTH / 2, MPO700_WIDTH / 2
    fp_np = np.array([[hl, hw], [-hl, hw], [-hl, -hw], [hl, -hw]])

    t0 = time.perf_counter()
    pr, out, goal = device_solves(cfg, sb, device)
    cmd_dev = out.cmd_vel.double().cpu().numpy()
    seconds = time.perf_counter() - t0
    fun_dev = out.fun.double().cpu().numpy()
    host = lambda t: t.double().cpu().numpy()
    plan_empty, lethal = host(pr.plan_empty), host(pr.lethal)
    carrot, closer, goal = (host(pr.carrot_pose), host(pr.closer_to_goal),
                            host(goal))
    data, origin, res = (host(sb.costmap.data), host(sb.costmap.origin),
                         host(sb.costmap.resolution))
    pose, vel = host(sb.robot_pose), host(sb.current_vel)

    # A scenario whose footprint branch fires on the oracle's side
    # (py:262-263) must get a zero command from the port too.
    checked = matched = fp_disagree = 0
    worst_gap = -np.inf
    for i in range(n):
        if plan_empty[i] or lethal[i]:
            continue
        nps = NpScenario(pose[i], carrot[i], goal[i], vel[i], fp_np,
                         NpCostmap(data[i], origin[i], float(res[i])),
                         switch_opt=bool(closer[i]), control_interval=1 / 30)
        cmd_o, diag = OracleServer(cfg).solve(nps, 1 / 30)
        fp_disagree += int(diag["collision_footprint"]
                           and bool(np.any(cmd_dev[i] != 0.0)))
        worst_gap = max(worst_gap, fun_dev[i] - diag["fun"])
        checked += 1
        matched += int(np.abs(cmd_dev[i] - cmd_o).max() < MATCH_TOL)
    frac = matched / checked if checked else 0.0
    return {"checked": checked, "matched": matched, "frac": frac,
            "worst_gap": float(worst_gap), "footprint_disagree": fp_disagree,
            "device_s": seconds,
            "passed": bool(checked and frac >= MATCH_FRAC_GATE
                           and worst_gap < UNMATCHED_GAP_TOL
                           and not fp_disagree)}
