"""The port's plugin gates against the JAX package's, on the CPU (the twin
of tests/test_gates.py).

- The empty-window and lethal gates throw before the service call
  (NeoMpcPlanner.cpp:130-132, :234-236): the controller's state is left
  exactly as it was, and the fleet path flags the lane and zeroes its
  command without a raise.
- The raw nav2 scale: `Costmap.from_nav2_costmap` maps 254 to 254/255,
  which latches the predicted-collision stop without the lethal throw;
  255 throws. Both constructors equal JAX's cell for cell.
- The local plan is the raw solution rolled out from the current pose
  with a leading pose (mpc_optimization_server.py:284-305), through
  `Scenario.create` and `solve_step`, equal to JAX's within 1e-4 (the
  golden gate).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neo_mpc_planner2_tpu as mpc
from neo_mpc_planner2_tpu.engine import solve_step as jsolve_step

import neo_mpc_planner2_tpu_torch as tp
from neo_mpc_planner2_tpu_torch import ros_adapter
from neo_mpc_planner2_tpu_torch.controller import (ControllerException,
                                                   NeoMpcController)
from neo_mpc_planner2_tpu_torch.engine import controller_step, solve_step
from neo_mpc_planner2_tpu_torch.oracle import _rollout_np

CPU = "cpu"


def _tcfg(jc):
    kw = {f: getattr(jc, f) for f in jc.__dataclass_fields__ if f != "compat"}
    compat = tp.CompatConfig(**dataclasses.asdict(jc.compat))
    return tp.MpcConfig(compat=compat, **kw)


def _line_plan(n=50, length=2.0):
    return np.stack([np.linspace(0, length, n), np.zeros(n), np.zeros(n)], 1)


def _empty():
    return tp.Costmap.create(np.zeros((40, 40)), origin=(-1.0, -1.0),
                             resolution=0.05, device=CPU)


def _footprint():
    return tp.Footprint.rectangle(0.6, 0.4, device=CPU)


def _ctrl(cfg, costmap=None):
    c = NeoMpcController(device=CPU)
    c.configure(_tcfg(cfg), costmap=_empty() if costmap is None else costmap,
                footprint=_footprint())
    c.activate()
    c.set_plan(_line_plan())
    return c


def _same_state(before, after):
    for name in ("initial_guess", "last_control", "waiting_time",
                 "slow_down"):
        assert torch.equal(getattr(before, name), getattr(after, name)), name


def test_plan_empty_gate_raises_and_leaves_the_state(cfg):
    """A robot beyond half the map's extent from every plan pose: the
    empty window throws cpp:130-132's exception; the warm start, last
    control, waiting time and slow-down are the pre-tick values."""
    c = _ctrl(cfg)
    c.compute_velocity_commands([0, 0, 0], [0.1, 0, 0], 0.033)
    before = c._state
    with pytest.raises(ControllerException,
                       match="Resulting plan has 0 poses in it."):
        c.compute_velocity_commands([10.0, 10.0, 0.0], [0, 0, 0], 0.033)
    _same_state(before, c._state)


def test_plan_empty_gate_flags_the_lane_on_the_fleet_path(cfg):
    """The fleet path surfaces the gate as a flag and a zero command."""
    tcfg = _tcfg(cfg)
    plan = tp.Plan.create(_line_plan(), max_points=tcfg.max_plan_points,
                          device=CPU)
    state = tp.init_state(tcfg, device=CPU)
    step = lambda pose: controller_step(
        tcfg, state, plan, torch.tensor(pose), torch.zeros(3), _empty(),
        _footprint(), 0.033)
    far = step([10.0, 10.0, 0.0])
    assert bool(far.plan_empty)
    assert torch.equal(far.cmd_vel, torch.zeros(3))
    assert not bool(step([0.0, 0.0, 0.0]).plan_empty)


def test_lethal_gate_leaves_the_state_and_recovers(cfg):
    """On the lethal gate the reference throws before the service call:
    the state is untouched, and after the map clears the accel clamp
    ramps from the last command actually sent."""
    c = _ctrl(cfg)
    c.compute_velocity_commands([0, 0, 0], [0.1, 0, 0], 0.033)
    before = c._state
    c.set_costmap(tp.Costmap.create(np.ones((40, 40)), origin=(-1.0, -1.0),
                                    resolution=0.05, device=CPU))
    with pytest.raises(ControllerException, match="MPC detected collision"):
        c.compute_velocity_commands([0, 0, 0], [0.1, 0, 0], 0.033)
    _same_state(before, c._state)
    c.set_costmap(_empty())
    cmd = c.compute_velocity_commands([0, 0, 0], [0.1, 0, 0], 0.033)
    lim = before.last_control.numpy() + np.array(
        [cfg.acc_x_limit, cfg.acc_y_limit,
         cfg.acc_theta_limit]) * cfg.control_interval
    assert np.all(cmd <= lim + 1e-5)


@pytest.mark.parametrize("raw_value,throws", [(254, False), (255, True)])
def test_raw_nav2_scale_gates(cfg, raw_value, throws):
    """Raw 254 (inscribed) latches the predicted-collision stop without the
    lethal throw, which the reference keeps for 255 (cpp:234)."""
    cm = tp.Costmap.from_nav2_costmap(np.full((40, 40), raw_value, np.uint8),
                                      origin=(-1.0, -1.0), resolution=0.05,
                                      device=CPU)
    c = _ctrl(cfg, cm)
    if throws:
        with pytest.raises(ControllerException,
                           match="MPC detected collision"):
            c.compute_velocity_commands([0, 0, 0], [0.1, 0, 0], 0.033)
        return
    cmd = c.compute_velocity_commands([0, 0, 0], [0.1, 0, 0], 0.033)
    assert not bool(c.last_result.lethal)
    assert bool(c.last_result.collision)
    np.testing.assert_array_equal(cmd, np.zeros(3))


@pytest.mark.parametrize("inscribed_is_lethal", [False, True])
def test_from_nav2_costmap_matches_jax(inscribed_is_lethal):
    raw = np.arange(256, dtype=np.uint8).reshape(16, 16)
    want = mpc.Costmap.from_nav2_costmap(raw, (-0.4, 0.2), 0.025,
                                         inscribed_is_lethal)
    got = tp.Costmap.from_nav2_costmap(raw, (-0.4, 0.2), 0.025,
                                       inscribed_is_lethal, device=CPU)
    for name in ("data", "origin", "resolution"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert float(got.data.view(-1)[254]) < 1.0 or inscribed_is_lethal
    assert float(got.data.view(-1)[255]) == 1.0


@pytest.mark.parametrize("unknown_is_lethal", [True, False])
def test_from_occupancy_grid_matches_jax(unknown_is_lethal):
    """-1 unknown, 0..100 occupancy and out-of-range values, as JAX's
    constructor reads them; the ROS adapter's topic conversion is the same
    function at unknown_is_lethal=True."""
    rng = np.random.default_rng(3)
    grid = rng.integers(-1, 120, (12, 20)).astype(np.int8)
    grid[0, :3] = (-1, 0, 100)
    want = mpc.Costmap.from_occupancy_grid(grid, (0.5, -1.0), 0.05,
                                           unknown_is_lethal)
    got = tp.Costmap.from_occupancy_grid(grid, (0.5, -1.0), 0.05,
                                         unknown_is_lethal, device=CPU)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.origin.numpy(),
                                  np.asarray(want.origin))
    if unknown_is_lethal:
        np.testing.assert_array_equal(
            ros_adapter.occupancy_values_to_cost(grid.reshape(-1).tolist(),
                                                 12, 20),
            got.data.numpy())


def test_local_plan_is_the_raw_solution_with_a_leading_pose(cfg):
    """local_plan = [current pose] + the yaw-first rollout of the raw solver
    output from it (published before the low-pass, py:365), through
    Scenario.create; equal to JAX's solve_step within 1e-4."""
    tcfg = _tcfg(cfg)
    args = ([0.3, -0.1, 0.2], [0.5, 0.0, 0.0], [2.0, 0.0, 0.0],
            [0.2, 0.0, 0.0])
    scen = tp.Scenario.create(*args, _footprint(), _empty(),
                              control_interval=1 / 30)
    assert scen.current_pose.dtype == torch.float32
    assert scen.switch_opt.dtype == torch.bool and scen.switch_opt.dim() == 0
    out = solve_step(tcfg, tp.init_state(tcfg, device=CPU), scen, 1 / 30)
    lp = out.local_plan.numpy()
    assert lp.shape == (cfg.control_steps + 1, 3)
    np.testing.assert_allclose(lp[0], np.asarray(args[0], np.float32),
                               atol=1e-6)
    expect = _rollout_np(out.raw_solution.numpy().reshape(-1, 3), cfg.dt,
                         np.asarray(args[0], np.float32).astype(float))
    np.testing.assert_allclose(lp[1:], expect, atol=1e-5)
    assert not np.allclose(out.raw_solution[:3].numpy(),
                           out.cmd_vel.numpy())
    jscen = mpc.Scenario.create(
        *args, mpc.Footprint.rectangle(0.6, 0.4),
        mpc.Costmap.create(np.zeros((40, 40)), origin=(-1.0, -1.0),
                           resolution=0.05), control_interval=1 / 30)
    for name in ("current_pose", "carrot_pose", "goal_pose", "current_vel",
                 "switch_opt", "control_interval"):
        np.testing.assert_array_equal(getattr(scen, name).numpy(),
                                      np.asarray(getattr(jscen, name)))
    want = jax.jit(lambda st, sc: jsolve_step(
        cfg, st, sc, jnp.float32(1 / 30)))(mpc.init_state(cfg), jscen)
    np.testing.assert_allclose(out.cmd_vel.numpy(), np.asarray(want.cmd_vel),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(lp, np.asarray(want.local_plan), rtol=0,
                               atol=1e-4)
