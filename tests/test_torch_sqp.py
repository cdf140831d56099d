"""The port's batched SQP solve against the JAX package's.

The scenario is the one the JAX package's QP-dispatch integration test
solves (tests/test_pallas.py). JAX runs its plain XLA path on the CPU; the
port runs its masked loops with the plain QP. `x` must match at rtol 1e-4 /
atol 1e-5 (the QP and the inverse sum in another order: float32
reassociation noise, amplified by the solve) and the iteration counts must
be equal. Both sequential line-search branches are covered: the fleet
preset's quadratic interpolation and the two-phase backtracking factor; and
the product point's candidate wave, on the smooth objective with the patch
sampler."""

import dataclasses

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


def _product(cfg, wave=True):
    """The product point (bench.py's product-SQP flips) on cfg: quirks off,
    the candidate wave, no quadratic interpolation, the patch sampler."""
    from neo_mpc_planner2_tpu.ops.costmap import (
        required_product_patch_halfwidth)

    cfg = cfg.replace(
        parallel_line_search=wave, solver_ls_quad_interp=False,
        solver_patch_exact_picks=False,
        compat=dataclasses.replace(
            cfg.compat, buggy_odom_yaw=False, footprint_alias_noop=False,
            lethal_1000x=False, unsquared_control_cost=False,
            no_angle_wrap=False))
    return cfg.replace(solver_costmap_patch=required_product_patch_halfwidth(
        cfg, 0.05, 0.46))


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
            jax.tree.map(np.asarray, sb.footprint), device="cpu"),
        costmap=interop.costmap_from_numpy(
            jax.tree.map(np.asarray, sb.costmap), device="cpu"),
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
    """The K-wide wave (solver_ls_wave = 4, which overhangs the 3-candidate
    budget) runs and takes sequential backtracking's solves; quadratic
    interpolation with a candidate grid is still refused, as in the JAX
    package, for the fused wave and for the K-wide one."""
    cfg, _, ts, x0 = _problem("two_phase", 3, 8)
    solve = lambda over: tsqp.make_sqp_solver_batched(
        _tcfg(cfg.replace(**over)),
        tobj.make_objective(_tcfg(cfg.replace(**over))))(
            torch.as_tensor(x0), ts)
    wave, seq = solve(dict(solver_ls_wave=4)), solve(dict())
    np.testing.assert_array_equal(wave.x.numpy(), seq.x.numpy())
    np.testing.assert_array_equal(wave.iters.numpy(), seq.iters.numpy())
    for over in (dict(parallel_line_search=True, solver_ls_quad_interp=True),
                 dict(solver_ls_wave=2, solver_ls_quad_interp=True)):
        with pytest.raises(ValueError, match="sequential line search"):
            solve(over)


def _single_lane(scen, footprint, costmap):
    n = lambda tree: jax.tree.map(np.asarray, tree)
    T = lambda a: torch.as_tensor(np.array(a))
    return tobj.Scenario(
        current_pose=T(scen.current_pose), carrot_pose=T(scen.carrot_pose),
        goal_pose=T(scen.goal_pose), current_vel=T(scen.current_vel),
        footprint=interop.footprint_from_numpy(n(footprint), device="cpu"),
        costmap=interop.costmap_from_numpy(n(costmap), device="cpu"),
        switch_opt=torch.tensor(False))


@pytest.mark.parametrize("K", [2, 3])
def test_k_wide_wave_matches_jax(cfg, empty_costmap, footprint, K):
    """solver_ls_wave = K at tests/test_solver.py's two-phase setup (7
    backtracks: K = 2 and 3 overhang the budget), against the JAX package's
    K-wide wave. At the fleet preset's cap of 8 iterations: x within rtol
    1e-5 / atol 1e-6, iterations within 1. Run on to 200 iterations at
    ftol 1e-8 the two stop at different points of a flat valley (the
    sequential branches of the two packages do too: x up to 1.3e-3 apart),
    so there the objective is held, within 1e-6."""
    two = cfg.replace(opt_tolerance=1e-8, solver_ls_coarse_after=2,
                      solver_ls_coarse_factor=0.0625,
                      solver_max_backtracks=7, solver_ls_wave=K)
    scen = mpc.Scenario.create([0, 0, 0], [0.4, 0.1, 0.2], [1.0, 0.5, 0.3],
                               [0.3, 0.1, 0.05], footprint, empty_costmap)
    tcfg = _tcfg(two)
    tscen = _single_lane(scen, footprint, empty_costmap)
    solvers = {iters: (
        jax.jit(mpc.make_sqp_solver(two, mpc.make_objective(two), ftol=1e-8,
                                    max_iters=iters, parallel_ls=False)),
        tsqp.make_sqp_solver(tcfg, tobj.make_objective(tcfg), ftol=1e-8,
                             max_iters=iters, parallel_ls=False))
        for iters in (8, 200)}
    rng = np.random.default_rng(7)
    for _ in range(3):
        x0 = rng.uniform(-0.5, 0.5, 9).astype(np.float32)
        runs = {iters: (want_solve(jnp.asarray(x0), scen),
                        got_solve(torch.as_tensor(x0), tscen))
                for iters, (want_solve, got_solve) in solvers.items()}
        want, got = runs[8]
        np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                                   rtol=1e-5, atol=1e-6)
        assert abs(int(got.iters) - int(want.iters)) <= 1
        want, got = runs[200]
        np.testing.assert_allclose(float(got.fun), float(want.fun), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("K", [2, 3])
def test_k_wide_wave_takes_the_sequential_alpha(K):
    """Iteration by iteration from the same state, the K-wide wave accepts
    the alpha sequential backtracking accepts (read from the warm-alpha
    carry, which stores it), and the whole solves are equal."""
    cfg, _, ts, x0 = _problem("two_phase", 8, 60)
    cfg = cfg.replace(solver_ls_warm_alpha=True)
    tcfg = _tcfg(cfg)
    obj = tobj.make_objective(tcfg)
    fobj = tsqp._batch_fobj(tcfg, obj, ts, tsqp._batch_hoist(tcfg, obj, ts))
    B = x0.shape[0]
    seq = tsqp._make_sqp(fobj, tcfg, B, "cpu", limits=ts.limits)
    wave = tsqp._make_sqp(fobj, tcfg, B, "cpu", ls_wave=K, limits=ts.limits)
    active = torch.ones(B, dtype=torch.bool)
    with torch.no_grad():
        st = seq[0](torch.as_tensor(x0))
        for _ in range(5):
            a, b = seq[2](st, active), wave[2](st, active)
            np.testing.assert_array_equal(a.alpha0.numpy(), b.alpha0.numpy())
            np.testing.assert_array_equal(a.x.numpy(), b.x.numpy())
            st = a
    runs = [tsqp.make_sqp_solver_batched(
        _tcfg(cfg.replace(solver_ls_wave=k)), obj)(torch.as_tensor(x0), ts)
        for k in (1, K)]
    np.testing.assert_array_equal(runs[0].x.numpy(), runs[1].x.numpy())
    np.testing.assert_array_equal(runs[0].iters.numpy(),
                                  runs[1].iters.numpy())


def test_wave_solve_matches_jax():
    """The product point's solve (wave line search, smooth objective, patch
    sampler) against the JAX package's, at the fleet preset's caps."""
    cfg, js, ts, x0 = _problem("two_phase", 8, 60)
    cfg = _product(cfg)
    want = jsqp.make_sqp_solver_batched(
        cfg, mpc.make_objective(cfg, parity=False))(jnp.asarray(x0), js)
    tcfg = _tcfg(cfg)
    got = tsqp.make_sqp_solver_batched(
        tcfg, tobj.make_objective(tcfg, parity=False))(torch.as_tensor(x0),
                                                       ts)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_allclose(got.fun.numpy(), np.asarray(want.fun),
                               rtol=1e-4, atol=1e-6)


def test_wave_takes_the_sequential_alpha():
    """The wave accepts the first candidate of the two-phase schedule that
    sequential backtracking accepts (tests/test_product_mode.py does the
    same for JAX): the same solves to float noise, the same iterations."""
    cfg, _, ts, x0 = _problem("two_phase", 8, 60)
    runs = []
    for wave in (True, False):
        tcfg = _tcfg(_product(cfg, wave=wave))
        runs.append(tsqp.make_sqp_solver_batched(
            tcfg, tobj.make_objective(tcfg, parity=False))(
                torch.as_tensor(x0), ts))
    np.testing.assert_allclose(runs[0].x.numpy(), runs[1].x.numpy(),
                               rtol=0, atol=2e-5)
    np.testing.assert_array_equal(runs[0].iters.numpy(),
                                  runs[1].iters.numpy())


@pytest.mark.parametrize("parallel_ls", [False, True], ids=["sequential",
                                                            "wave"])
def test_warm_alpha_solve_matches_jax(cfg, empty_costmap, footprint,
                                      parallel_ls):
    """solver_ls_warm_alpha (the first trial step min(1, 2·α₀) and the carry
    of α₀) on both line-search branches, at tests/test_solver.py's
    warm-alpha setup: the same three x0 from default_rng(17),
    opt_tolerance 1e-6, 100 iterations; x within the golden gate (1e-4).
    (The K-wide wave: test_k_wide_wave_matches_jax.)"""
    warm = cfg.replace(opt_tolerance=1e-6, solver_ls_warm_alpha=True)
    scen = mpc.Scenario.create([0.1, -0.2, 0.3], [0.5, -0.1, 0.1],
                               [1.0, 0.5, 0.3], [0.2, 0.0, 0.1],
                               footprint, empty_costmap)
    want_solve = jax.jit(mpc.make_sqp_solver(
        warm, mpc.make_objective(warm), max_iters=100,
        parallel_ls=parallel_ls))
    tcfg = _tcfg(warm)
    n = lambda tree: jax.tree.map(np.asarray, tree)
    T = lambda a: torch.as_tensor(np.array(a))
    tscen = tobj.Scenario(
        current_pose=T(scen.current_pose), carrot_pose=T(scen.carrot_pose),
        goal_pose=T(scen.goal_pose), current_vel=T(scen.current_vel),
        footprint=interop.footprint_from_numpy(n(footprint), device="cpu"),
        costmap=interop.costmap_from_numpy(n(empty_costmap), device="cpu"),
        switch_opt=torch.tensor(False))
    got_solve = tsqp.make_sqp_solver(tcfg, tobj.make_objective(tcfg),
                                     max_iters=100, parallel_ls=parallel_ls)
    rng = np.random.default_rng(17)
    for _ in range(3):
        x0 = rng.uniform(-0.5, 0.5, 9).astype(np.float32)
        want = want_solve(jnp.asarray(x0), scen)
        got = got_solve(torch.as_tensor(x0), tscen)
        np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                                   rtol=0, atol=1e-4)
        assert got.x.shape == (9,)
