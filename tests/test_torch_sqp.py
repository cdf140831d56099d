"""The port's batched SQP solve against the JAX package's.

The scenario is the one the JAX package's QP-dispatch integration test
solves (tests/test_pallas.py). JAX runs its plain XLA path on the CPU; the
port runs its masked loops with the plain QP. `x` must match at rtol 1e-4 /
atol 1e-5 (the QP and the inverse sum in another order: float32
reassociation noise, amplified by the solve) and the iteration counts must
be equal. Both sequential line-search branches are covered: the fleet
preset's quadratic interpolation and the two-phase backtracking factor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neo_mpc_planner2_tpu as mpc
from neo_mpc_planner2_tpu import sqp as jsqp
from neo_mpc_planner2_tpu.scenarios import make_scenario_batch

import neo_mpc_planner2_tpu_torch as tp
from neo_mpc_planner2_tpu_torch import interop
from neo_mpc_planner2_tpu_torch import sqp as tsqp
from neo_mpc_planner2_tpu_torch.ops import objective as tobj
from neo_mpc_planner2_tpu_torch.tree import tree_map

LINE_SEARCHES = {
    # fleet_config's sequential branch: quadratic-interpolation backtracking.
    "quad_interp": dict(solver_max_backtracks=7, solver_ls_coarse_after=2,
                        solver_ls_coarse_factor=0.0625,
                        solver_ls_quad_interp=True),
    # The two-phase factor branch (the two_phase_ls golden's).
    "two_phase": dict(solver_max_backtracks=7, solver_ls_coarse_after=2,
                      solver_ls_coarse_factor=0.0625,
                      solver_ls_quad_interp=False),
}


def _tcfg(jc):
    kw = {f: getattr(jc, f) for f in jc.__dataclass_fields__ if f != "compat"}
    compat = tp.CompatConfig(**{f: getattr(jc.compat, f)
                                for f in jc.compat.__dataclass_fields__})
    return tp.MpcConfig(compat=compat, **kw)


def _problem(ls, max_iters, qp_iters, B=8):
    cfg = mpc.default_config().replace(
        prediction_horizon=0.8, control_steps=3, opt_tolerance=1e-3,
        footprint_edge_samples=8, max_plan_points=16,
        solver_max_iters=max_iters, qp_iters=qp_iters,
        w_trans=0.82, w_orient=0.5, w_control=0.05, w_terminal=0.05,
        w_costmap=0.05, w_footprint=2000.0, **LINE_SEARCHES[ls])
    sb = make_scenario_batch(cfg, B, seed=2, map_size=32, plan_points=12)
    carrot, goal = sb.robot_pose * 0.5, sb.robot_pose + 1.0
    js = mpc.Scenario.create(sb.robot_pose, carrot, goal, sb.current_vel,
                             sb.footprint, sb.costmap,
                             switch_opt=jnp.zeros(B, bool))
    T = lambda a: torch.as_tensor(np.array(a))
    ts = tobj.Scenario(
        current_pose=T(sb.robot_pose), carrot_pose=T(carrot),
        goal_pose=T(goal), current_vel=T(sb.current_vel),
        footprint=interop.footprint_from_numpy(
            jax.tree.map(np.asarray, sb.footprint)),
        costmap=interop.costmap_from_numpy(
            jax.tree.map(np.asarray, sb.costmap)),
        switch_opt=torch.zeros(B, dtype=torch.bool))
    x0 = np.random.default_rng(0).uniform(-0.3, 0.3, (B, 9)).astype(
        np.float32)
    return cfg, js, ts, x0


@pytest.mark.parametrize("ls", sorted(LINE_SEARCHES))
def test_batched_solve_matches_jax(ls):
    # The fleet preset's iteration caps: 8 SQP iterations, 60 ADMM ones.
    cfg, js, ts, x0 = _problem(ls, 8, 60)
    want = jsqp.make_sqp_solver_batched(cfg, mpc.make_objective(cfg))(
        jnp.asarray(x0), js)
    tcfg = _tcfg(cfg)
    got = tsqp.make_sqp_solver_batched(tcfg, tobj.make_objective(tcfg))(
        torch.as_tensor(x0), ts)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_allclose(got.fun.numpy(), np.asarray(want.fun),
                               rtol=1e-4, atol=1e-6)


def test_lane_results_do_not_depend_on_other_lanes():
    """A lane's solve is the same whether it runs alone or beside lanes
    that finish earlier or later (the masked loops freeze finished lanes)."""
    cfg, _, ts, x0 = _problem("quad_interp", 8, 60)
    tcfg = _tcfg(cfg)
    solve = tsqp.make_sqp_solver_batched(tcfg, tobj.make_objective(tcfg))
    full = solve(torch.as_tensor(x0), ts)
    assert len(set(full.iters.tolist())) > 1     # lanes finish apart
    for b in range(x0.shape[0]):
        one = solve(torch.as_tensor(x0[b:b + 1]),
                    tree_map(lambda t: t[b:b + 1], ts))
        assert int(one.iters[0]) == int(full.iters[b])
        np.testing.assert_allclose(one.x[0].numpy(), full.x[b].numpy(),
                                   rtol=0, atol=1e-6)


def test_unported_solver_options_raise():
    cfg, _, ts, x0 = _problem("two_phase", 3, 8)
    for over in (dict(parallel_line_search=True),
                 dict(solver_ls_wave=4)):
        tcfg = _tcfg(cfg.replace(**over))
        with pytest.raises(NotImplementedError):
            tsqp.make_sqp_solver_batched(tcfg, tobj.make_objective(tcfg))(
                torch.as_tensor(x0), ts)
