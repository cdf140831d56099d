"""Per-lane weights and runtime limits in the port, on the CPU (the twins
of tests/test_weights.py and of tests/test_limits.py's value checks).

- `Weights.grid` is JAX's grid, value for value; a weight override equals
  a config with those weights exactly; a grid batches in one solve, with
  the heavier control weight holding the solution at the current
  velocity.
- `Limits.scaled` is JAX's; runtime limits solve as a config with the
  same bounds does (within 2e-6, JAX's tolerance), the scaled bounds bind,
  the controller's speed limit is `Limits.scaled` of its base limits, and
  the server's reconfigured weights and bounds act as a fresh session's.
- JAX values carry over through `interop.weights_from_numpy` /
  `limits_from_numpy`.

tests/test_limits.py also checks that nothing retraces when limits
change: eager PyTorch compiles nothing, so that check has no counterpart
here (the controller's engine is not rebuilt, which is checked).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import neo_mpc_planner2_tpu as mpc
from neo_mpc_planner2_tpu.ops.objective import Limits as JLimits

import neo_mpc_planner2_tpu_torch as tp
from neo_mpc_planner2_tpu_torch import interop
from neo_mpc_planner2_tpu_torch.controller import NeoMpcController
from neo_mpc_planner2_tpu_torch.engine import solve_step
from neo_mpc_planner2_tpu_torch.ops.objective import Limits, Weights
from neo_mpc_planner2_tpu_torch.serving import OptimizerSession
from neo_mpc_planner2_tpu_torch.tree import tree_map

CPU = "cpu"


def _tcfg(jc):
    kw = {f: getattr(jc, f) for f in jc.__dataclass_fields__ if f != "compat"}
    compat = tp.CompatConfig(**dataclasses.asdict(jc.compat))
    return tp.MpcConfig(compat=compat, **kw)


def _empty():
    return tp.Costmap.create(np.zeros((40, 40)), origin=(-1.0, -1.0),
                             resolution=0.05, device=CPU)


def _rect():
    return tp.Footprint.rectangle(0.6, 0.4, device=CPU)


def _lanes(scen, B):
    """A one-lane scenario broadcast to B lanes."""
    return tree_map(lambda t: t.expand((B,) + t.shape).contiguous(), scen)


# ---- tests/test_weights.py ---------------------------------------------------

def test_weights_override_matches_config(cfg):
    """Scenario.weights give exactly what a config with those values
    gives."""
    tcfg = _tcfg(cfg)
    w = Weights.from_config(tcfg, device=CPU).replace(
        w_trans=torch.tensor(0.3), w_control=torch.tensor(0.2))
    assert w.w_orient.shape == ()
    scen = tp.Scenario.create([0, 0, 0], [0.4, 0.1, 0.2], [1, 0.5, 0.3],
                              [0.3, 0, 0], _rect(), _empty(), weights=w)
    u = torch.linspace(-0.3, 0.3, 9)[None]
    override = tp.make_objective(tcfg)(u, _lanes(scen, 1))
    plain = tp.make_objective(tcfg.replace(w_trans=0.3, w_control=0.2))(
        u, _lanes(scen.replace(weights=None), 1))
    assert float(override) == float(plain)


def test_weight_grid_batch_solves(cfg):
    tcfg = _tcfg(cfg)
    grid = Weights.grid(tcfg, device=CPU, w_control=[0.0, 5.0])
    scen = _lanes(tp.Scenario.create([0, 0, 0], [0.6, 0.0, 0.0], [1, 0, 0],
                                     [0.1, 0.0, 0.0], _rect(), _empty()), 2)
    solver = tp.make_sqp_solver_batched(tcfg, tp.make_objective(tcfg),
                                        ftol=1e-8, max_iters=200)
    u = solver(torch.zeros(2, 9), scen.replace(weights=grid)).x
    u = u.numpy().reshape(2, 3, 3)
    assert u[0, 0, 0] > 0.5                   # free to run to the bound
    assert abs(u[1, 0, 0] - 0.1) < 0.05        # held at the velocity


def test_grid_matches_jax():
    cfg = mpc.default_config()
    axes = dict(w_trans=[0.5, 0.82], w_control=[0.01, 0.05, 0.2])
    want = mpc.Weights.grid(cfg, **axes)
    got = Weights.grid(tp.default_config(), device=CPU, **axes)
    assert got.w_trans.shape == got.w_orient.shape == (6,)
    np.testing.assert_allclose(np.unique(got.w_control.numpy()),
                               [0.01, 0.05, 0.2])
    carried = interop.weights_from_numpy(jax.tree.map(np.asarray, want),
                                         device=CPU)
    for name in Weights.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
        assert torch.equal(getattr(carried, name), getattr(got, name))


# ---- tests/test_limits.py ----------------------------------------------------

def _scen(limits=None):
    return tp.Scenario.create([0.0, 0.0, 0.0], [0.6, 0.1, 0.0],
                              [2.0, 0.0, 0.0], [0.2, 0.0, 0.0], _rect(),
                              _empty(), control_interval=1 / 30,
                              limits=limits)


def test_runtime_limits_equal_static(cfg):
    """Limits at half speed solve as a config statically at half speed."""
    tcfg = _tcfg(cfg)
    half = tcfg.replace(max_vel_x=0.35, min_vel_x=-0.35, max_vel_y=0.35,
                        min_vel_y=-0.35, max_vel_trans=0.35)
    static = solve_step(half, tp.init_state(half, device=CPU), _scen(),
                        1 / 30)
    runtime = solve_step(tcfg, tp.init_state(tcfg, device=CPU),
                         _scen(Limits.from_config(half, device=CPU)), 1 / 30)
    for name in ("cmd_vel", "raw_solution"):
        np.testing.assert_allclose(getattr(runtime, name).numpy(),
                                   getattr(static, name).numpy(), atol=2e-6)


def test_scaled_bounds_bind(cfg):
    tcfg = _tcfg(cfg)
    lim = Limits.from_config(tcfg, device=CPU).scaled(0.3)
    out = solve_step(tcfg, tp.init_state(tcfg, device=CPU), _scen(lim),
                     1 / 30)
    raw = out.raw_solution.numpy().reshape(-1, 3)
    # The box is exact (a clip); the cone is ADMM's, to ~1e-3.
    assert np.all(np.abs(raw) <= 0.3 * 0.7 + 1e-6)
    assert np.all(np.linalg.norm(raw[:, :2], axis=1)
                  <= 0.3 * cfg.max_vel_trans + 2e-3)


@pytest.mark.parametrize("batch", [None, 3])
def test_limits_match_jax(cfg, batch):
    """from_config (unbatched as JAX's, or a batch of lanes) and scaled
    equal JAX's; JAX's values carry over through interop."""
    tcfg = _tcfg(cfg)
    want = JLimits.from_config(cfg).scaled(0.4)
    got = Limits.from_config(tcfg, batch, device=CPU).scaled(0.4)
    carried = interop.limits_from_numpy(jax.tree.map(np.asarray, want),
                                        device=CPU)
    lead = () if batch is None else (batch,)
    for name in Limits.__dataclass_fields__:
        w = np.asarray(getattr(want, name))
        g = getattr(got, name)
        assert tuple(g.shape) == lead + w.shape
        np.testing.assert_array_equal(g.numpy(),
                                      np.broadcast_to(w, g.shape))
        assert torch.equal(getattr(carried, name), g[0] if batch else g)
    w1 = Weights.from_config(tcfg, 1, device=CPU)
    assert w1.w_trans.shape == (1,)


def test_speed_limit_is_limits_scaled(cfg):
    """The controller's speed limit: Limits.scaled of its base limits, the
    engine not rebuilt, the halved cone respected over 12 ticks."""
    c = NeoMpcController(device=CPU)
    c.configure(_tcfg(cfg), costmap=_empty(), footprint=_rect())
    c.activate()
    c.set_plan(np.stack([np.linspace(0, 2, 50), np.zeros(50),
                         np.zeros(50)], 1))
    c.compute_velocity_commands([0, 0, 0], [0, 0, 0], 1 / 30)
    engine = c._engine
    c.set_speed_limit(50.0, percentage=True)
    assert c._engine is engine
    want = Limits.from_config(_tcfg(cfg), device=CPU).scaled(0.5)
    for name in Limits.__dataclass_fields__:
        assert torch.equal(getattr(c._limits, name), getattr(want, name))
    vel = np.zeros(3)
    for _ in range(12):
        vel = c.compute_velocity_commands([0.2, 0, 0], vel, 1 / 30)
    assert np.linalg.norm(vel[:2]) <= cfg.max_vel_trans * 0.5 + 1e-4


def _session(cfg):
    s = OptimizerSession(cfg, device=CPU)
    s.handle({"op": "set_costmap", "data": np.zeros((40, 40)).tolist(),
              "origin": [-1, -1], "resolution": 0.05})
    s.handle({"op": "set_footprint", "points": [[0.3, 0.2], [-0.3, 0.2],
                                                [-0.3, -0.2], [0.3, -0.2]]})
    return s


REQ = {"op": "optimizer", "current_pose": [0, 0, 0],
       "carrot_pose": [0.6, 0.1, 0.0], "goal_pose": [2, 0, 0],
       "current_vel": [0.2, 0, 0], "control_interval": 1 / 30,
       "delta_t": 1 / 30}


def test_server_weight_update_takes_effect(cfg):
    tcfg = _tcfg(cfg)
    s = _session(tcfg)
    assert s.handle({"op": "configure", "params": {"w_trans": 0.11}})["ok"]
    assert s.cfg.w_trans == 0.11
    fresh = _session(tcfg.replace(w_trans=0.11))
    np.testing.assert_allclose(s.handle(dict(REQ))["output_vel"],
                               fresh.handle(dict(REQ))["output_vel"],
                               atol=2e-6)


def test_server_bound_update_binds(cfg):
    s = _session(_tcfg(cfg))
    assert s.handle({"op": "configure", "params": {
        "max_vel_trans": 0.3, "max_vel_x": 0.3, "max_vel_y": 0.3}})["ok"]
    v = np.asarray(s.handle(dict(REQ))["output_vel"])
    assert np.linalg.norm(v[:2]) <= 0.3 + 1e-4
