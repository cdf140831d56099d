"""The port's stuck-wait, collision-latch and goal-change sequences against
its scipy oracle, on the CPU (the twin of tests/test_stuck_parity.py, at
its tolerance: commands within 8e-3, waiting times within 1e-5).

An obstacle band appears and clears: the collision latch, the waiting
time's growth, its 3 s expiry and the recovery must evolve tick for tick
as the oracle's (the reference's server state machine). A goal change
resets the guesses and the last control on both sides.
"""

import dataclasses

import numpy as np

import neo_mpc_planner2_tpu_torch as tp
from neo_mpc_planner2_tpu_torch.engine import solve_step
from neo_mpc_planner2_tpu_torch.oracle import (NpCostmap, NpScenario,
                                               OracleServer)

CPU = "cpu"
ATOL = 8e-3


def _tight(jc):
    """The conftest config in the port, with the JAX file's tight
    tolerance."""
    kw = {f: getattr(jc, f) for f in jc.__dataclass_fields__ if f != "compat"}
    compat = tp.CompatConfig(**dataclasses.asdict(jc.compat))
    return tp.MpcConfig(compat=compat, **kw).replace(opt_tolerance=1e-8)


def _solver(cfg):
    return tp.make_sqp_solver(cfg, tp.make_objective(cfg), ftol=1e-8,
                              max_iters=300)


def _footprint():
    return tp.Footprint.rectangle(0.6, 0.4, device=CPU)


def test_stuck_sequence_matches_oracle(cfg, footprint_np):
    tight = _tight(cfg)
    solver = _solver(tight)
    clear = np.zeros((40, 40))
    blocked = np.zeros((40, 40))
    blocked[:, 28:] = 0.995          # high but not lethal, x > 0.4
    origin = (-1.0, -1.0)
    srv = OracleServer(tight)
    state = tp.init_state(tight, device=CPU)
    dt = 0.7                         # the 3 s expiry within a few ticks
    # 3 clear ticks, 6 blocked (latch, wait, expiry), 4 clear (recovery).
    phases = ["clear"] * 3 + ["blocked"] * 6 + ["clear"] * 4
    flags, oracle_flags = [], []
    for i, phase in enumerate(phases):
        data = clear if phase == "clear" else blocked
        cm = tp.Costmap.create(data, origin=origin, resolution=0.05,
                               device=CPU)
        scen = tp.Scenario.create([0, 0, 0], [0.6, 0.0, 0.0],
                                  [1.0, 0.0, 0.0], [0.5, 0, 0],
                                  _footprint(), cm, control_interval=1 / 30)
        out = solve_step(tight, state, scen, dt, solver=solver)
        state = out.state
        nps = NpScenario(np.zeros(3), np.array([0.6, 0.0, 0.0]),
                         np.array([1.0, 0.0, 0.0]), np.array([0.5, 0, 0]),
                         footprint_np, NpCostmap(data, np.array(origin), 0.05),
                         control_interval=1 / 30)
        cmd_o, diag = srv.solve(nps, dt)
        np.testing.assert_allclose(out.cmd_vel.numpy(), cmd_o, atol=ATOL,
                                   err_msg=f"tick {i} ({phase})")
        flags.append(bool(out.collision))
        oracle_flags.append(bool(diag["collision"]))
        assert abs(float(state.waiting_time) - srv.waiting_time) < 1e-5, (
            i, phase, float(state.waiting_time), srv.waiting_time)
    assert flags == oracle_flags
    # The latch was exercised and dropped again.
    assert any(flags) and not flags[-1]


def test_goal_change_resets_match_oracle(cfg, footprint_np):
    """The new-goal reset (py:357-361) on both sides; the commands stay
    matched across the change."""
    tight = _tight(cfg)
    solver = _solver(tight)
    cm = tp.Costmap.create(np.zeros((40, 40)), origin=(-1.0, -1.0),
                           resolution=0.05, device=CPU)
    npcm = NpCostmap(np.zeros((40, 40)), np.array([-1.0, -1.0]), 0.05)
    srv = OracleServer(tight)
    state = tp.init_state(tight, device=CPU)
    goals = [[1.0, 0.5, 0.3]] * 4 + [[-1.0, 0.8, 1.0]] * 4
    for i, goal in enumerate(goals):
        scen = tp.Scenario.create([0, 0, 0], [0.4, 0.1, 0.2], goal,
                                  [0.3, 0, 0], _footprint(), cm,
                                  control_interval=1 / 30)
        out = solve_step(tight, state, scen, 1 / 30, solver=solver)
        state = out.state
        nps = NpScenario(np.zeros(3), np.array([0.4, 0.1, 0.2]),
                         np.array(goal, float), np.array([0.3, 0, 0]),
                         footprint_np, npcm, control_interval=1 / 30)
        cmd_o, _ = srv.solve(nps, 1 / 30)
        np.testing.assert_allclose(out.cmd_vel.numpy(), cmd_o, atol=ATOL,
                                   err_msg=f"tick {i} goal={goal}")
