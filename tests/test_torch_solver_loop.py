"""The port's prox-FISTA solver in the closed loop against the JAX
package's, and the cross-solver gate (VERDICT Next #3): the port's two
product-mode solvers, prox-FISTA and SQP, held to the same final objective
on a fixed suite. The closed loop is held at the golden gate (cmds atol
1e-4, goal distance 1e-3).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import neo_mpc_planner2_tpu as mpc
from neo_mpc_planner2_tpu import engine as jengine
from neo_mpc_planner2_tpu import solver as jsolver
from neo_mpc_planner2_tpu import sqp as jsqp
from neo_mpc_planner2_tpu.scenarios import make_scenario_batch as jmake
from neo_mpc_planner2_tpu.simulation import batch_simulate as jsimulate

import neo_mpc_planner2_tpu_torch as tp
from neo_mpc_planner2_tpu_torch import engine as tengine
from neo_mpc_planner2_tpu_torch import solver as tsolver
from neo_mpc_planner2_tpu_torch import sqp as tsqp
from neo_mpc_planner2_tpu_torch.ops import objective as tobj
from neo_mpc_planner2_tpu_torch.simulation import batch_simulate
from test_torch_slice import _from_jax, _product_cfg
from test_torch_sqp import _tcfg


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def test_prox_closed_loop_matches_jax_batch_simulate():
    """The prox slice (chip_smoke.py's: bench.py's product point with
    solver_batch = the prox solver), 4 lanes x 5 ticks, against JAX."""
    cfg = _product_cfg()
    sb = jmake(cfg, 4, seed=0, map_size=48, plan_points=64)
    jsolve = jax.vmap(jsolver.make_solver(
        cfg, mpc.make_objective(cfg, parity=False)))
    want = jax.jit(lambda: jsimulate(cfg, sb, 5, parity=False,
                                     solver_batch=jsolve))()
    tcfg = _tcfg(cfg)
    got = batch_simulate(tcfg, _from_jax(sb), 5, parity=False,
                         solver_batch=tp.make_solver_batched(
                             tcfg, tp.make_objective(tcfg, parity=False)))
    _close(got.cmds, want.cmds, atol=1e-4)
    _close(got.goal_dist, want.goal_dist, atol=1e-3)
    np.testing.assert_array_equal(got.solver_iters.numpy(),
                                  np.asarray(want.solver_iters))
    speed = torch.linalg.vector_norm(got.cmds[..., :2], dim=-1)
    assert float(speed.max()) <= cfg.max_vel_trans + 1e-5


# --- the cross-solver gate -------------------------------------------------

GATE_SUITE = dict(seed=5, map_size=64, plan_points=48,
                  plan_length_range=(0.7, 1.0), clear_corridor_m=0.55,
                  center_on="plan")
GATE_LANES = 32
# The JAX pair on this suite (test_cross_solver_gate_jax_pair below):
# max |F_prox - F_sqp| = 3.312e-4 (0.78 % of F_sqp).
JAX_PAIR_MAX_GAP = 3.312e-4
GATE_ATOL = 5e-4


def _smooth_cfg(cfg):
    """tests/test_product_mode.py's smooth objective on the `cfg` fixture:
    the five reference quirks off."""
    return cfg.replace(compat=dataclasses.replace(
        cfg.compat, buggy_odom_yaw=False, footprint_alias_noop=False,
        lethal_1000x=False, unsquared_control_cost=False,
        no_angle_wrap=False))


def test_cross_solver_gate(cfg):
    """VERDICT Next #3: the port's prox-FISTA and its product SQP land on
    the same final objective, |F_prox - F_sqp| <= 5e-4 on every lane of a
    fixed suite: the first solve of 32 goal-reachable scenarios
    (make_scenario_batch seed 5, map 64, plan lengths 0.7-1.0 m, a 0.55 m
    clear corridor, centred on the plan; tests/test_product_mode.py's
    suite), both from the engine's warm start (the first tick: zero).

    The tolerance comes from the JAX package's own pair on the same suite,
    measured once (test below): max |F_prox - F_sqp| = 3.312e-4, 0.78 % of
    F_sqp (prox above SQP by up to 3.3e-4, below by up to 1.8e-4); 5e-4 is
    1.5 times that. The pre-round-5 prox split (the control term's norm
    prox applied to the squared term) reaches 9.3e-4 on this suite, so the
    gate fails on it."""
    tcfg = _tcfg(_smooth_cfg(cfg))
    sb = tp.make_scenario_batch(tcfg, GATE_LANES, device="cpu", **GATE_SUITE)
    _, scen, st2 = tengine._tick_pre(tcfg, sb.state, sb.plan, sb.robot_pose,
                                     sb.current_vel, sb.costmap, sb.footprint,
                                     None)
    guess, _, _ = tengine._pre_solve(tcfg, st2, scen)
    obj = tobj.make_objective(tcfg, parity=False)
    sqp = tsqp.make_sqp_solver_batched(tcfg, obj)(guess, scen)
    prox = tsolver.make_solver_batched(tcfg, obj)(guess, scen)
    assert bool(prox.converged.all()) and bool(sqp.converged.all())
    gap = (prox.fun - sqp.fun).abs()
    assert float(gap.max()) <= GATE_ATOL, gap.max()


def test_cross_solver_gate_jax_pair(cfg):
    """The measurement behind the gate's tolerance: JAX's prox-FISTA
    against JAX's SQP on the gate's suite."""
    pcfg = _smooth_cfg(cfg)
    sb = jmake(pcfg, GATE_LANES, **GATE_SUITE)
    pre = jax.vmap(lambda st, pl, po, ve, cm, fp: jengine._tick_pre(
        pcfg, st, pl, po, ve, cm, fp, None))
    _, scen, st2 = pre(sb.state, sb.plan, sb.robot_pose, sb.current_vel,
                       sb.costmap, sb.footprint)
    guess, _, _ = jax.vmap(lambda s, sc: jengine._pre_solve(pcfg, s, sc))(
        st2, scen)
    obj = mpc.make_objective(pcfg, parity=False)
    sqp = jsqp.make_sqp_solver_batched(pcfg, obj)(guess, scen)
    prox = jax.vmap(jsolver.make_solver(pcfg, obj))(guess, scen)
    gap = float(np.abs(np.asarray(prox.fun) - np.asarray(sqp.fun)).max())
    assert gap == pytest.approx(JAX_PAIR_MAX_GAP, abs=2e-6)
    assert gap <= GATE_ATOL
