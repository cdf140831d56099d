"""The port's prox-FISTA solver (`solver.py`) against the JAX package's,
piece by piece (tests/test_torch_solver_loop.py has the closed loop and the
cross-solver gate).

Every piece gets the same numpy inputs on both sides, the JAX one under
`vmap` on the CPU. The projections and the prox are held at atol 1e-6; the
solves at the tolerance of tests/test_torch_sqp.py (x at rtol 1e-4 /
atol 1e-5: float32 sums taken in another order, amplified by the solve)
with equal iteration counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neo_mpc_planner2_tpu as mpc
from neo_mpc_planner2_tpu.ops import objective as jobj
from neo_mpc_planner2_tpu import solver as jsolver

from neo_mpc_planner2_tpu_torch import solver as tsolver
from neo_mpc_planner2_tpu_torch.ops import objective as tobj
from neo_mpc_planner2_tpu_torch.tree import tree_map
from test_torch_sqp import _problem, _product, _tcfg

T = lambda a: torch.as_tensor(np.asarray(a))
F32 = np.float32


def _close(got, want, atol=1e-6, rtol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def _box_disk_inputs(B=64, N=3):
    """Random boxes around the origin, radii and points; lane 0 is the
    round-5 case: lo = (-1, -0.1), hi = (1, 0.1), r = 0.5, xy = (0.9, 0.3),
    where the box bound x = 1 lies outside the disk."""
    rng = np.random.default_rng(4)
    lo = rng.uniform(-1.2, -0.05, (B, 2)).astype(F32)
    hi = rng.uniform(0.05, 1.2, (B, 2)).astype(F32)
    r = rng.uniform(0.2, 1.5, B).astype(F32)
    xy = rng.uniform(-2.0, 2.0, (B, N, 2)).astype(F32)
    lo[0], hi[0], r[0], xy[0] = (-1.0, -0.1), (1.0, 0.1), 0.5, (0.9, 0.3)
    return xy, lo, hi, r


def test_project_box_disk_matches_jax():
    xy, lo, hi, r = _box_disk_inputs()
    want = jax.vmap(jsolver._project_box_disk)(xy, lo, hi, r)
    got = tsolver._project_box_disk(T(xy), T(lo), T(hi), T(r))
    _close(got, want)
    # Round 5: the fabricated (1, 0) is no longer taken; the result lies on
    # both sets.
    speed = torch.linalg.vector_norm(got[0], dim=-1)
    assert float(speed.max()) <= 0.5 + 1e-5
    assert float(got[0, :, 1].abs().max()) <= 0.1 + 1e-6


def _limits(B, rng):
    lo = np.stack([rng.uniform(-1.0, -0.1, B), rng.uniform(-0.8, -0.05, B),
                   rng.uniform(-1.0, -0.2, B)], -1).astype(F32)
    hi = np.stack([rng.uniform(0.1, 1.0, B), rng.uniform(0.05, 0.8, B),
                   rng.uniform(0.2, 1.0, B)], -1).astype(F32)
    trans = rng.uniform(0.2, 1.2, B).astype(F32)
    acc = np.ones((B, 3), F32)
    return (jobj.Limits(vel_lo=jnp.asarray(lo), vel_hi=jnp.asarray(hi),
                       max_vel_trans=jnp.asarray(trans), acc=jnp.asarray(acc)),
            tobj.Limits(vel_lo=T(lo), vel_hi=T(hi), max_vel_trans=T(trans),
                        acc=T(acc)))


@pytest.mark.parametrize("case", ["config", "limits", "round5"])
def test_project_feasible_matches_jax(cfg, case):
    rng = np.random.default_rng(6)
    B = 48
    u = rng.uniform(-2.0, 2.0, (B, 9)).astype(F32)
    if case == "round5":
        cfg = cfg.replace(min_vel_x=-1.0, max_vel_x=1.0, min_vel_y=-0.1,
                          max_vel_y=0.1, max_vel_trans=0.5)
        u[0] = [0.9, 0.3, 0.0] * 3
    if case == "limits":
        jl, tl = _limits(B, rng)
        want = jax.vmap(lambda v, lim: jsolver.project_feasible(v, cfg, lim))(
            u, jl)
        got = tsolver.project_feasible(T(u), _tcfg(cfg), tl)
    else:
        want = jax.vmap(lambda v: jsolver.project_feasible(v, cfg))(u)
        got = tsolver.project_feasible(T(u), _tcfg(cfg))
    _close(got, want)
    if case == "round5":
        xy = got[0].reshape(3, 3)[:, :2]
        assert float(torch.linalg.vector_norm(xy, dim=-1).max()) <= 0.5 + 1e-5


@pytest.mark.parametrize("tau", [0.0, 0.1, 0.5, "per_lane"])
def test_prox_g_matches_jax(cfg, tau):
    rng = np.random.default_rng(7)
    B = 32
    z = rng.uniform(-1.5, 1.5, (B, 9)).astype(F32)
    v = rng.uniform(-0.6, 0.6, (B, 3)).astype(F32)
    taus = (rng.uniform(0.0, 0.5, B) if tau == "per_lane"
            else np.full(B, tau)).astype(F32)
    want = jax.vmap(lambda zz, tt, vv: jsolver.prox_g(zz, tt, vv, cfg))(
        z, taus, v)
    got = tsolver.prox_g(T(z), tau if tau != "per_lane" else T(taus), T(v),
                         _tcfg(cfg))
    _close(got, want)


@pytest.mark.parametrize("limits", [False, True])
def test_prox_at_zero_lambda_is_the_projection(cfg, limits):
    """Where λ = 0 prox_fista projects once instead of running Dykstra's
    cycles: JAX's prox_g at τ = 0 (those cycles) equals the port's
    project_feasible within atol 1e-6."""
    rng = np.random.default_rng(9)
    B = 48
    z = rng.uniform(-1.5, 1.5, (B, 9)).astype(F32)
    v = rng.uniform(-0.6, 0.6, (B, 3)).astype(F32)
    if limits:
        jl, tl = _limits(B, rng)
        want = jax.vmap(lambda zz, vv, lim: jsolver.prox_g(
            zz, 0.0, vv, cfg, lim))(z, v, jl)
        got = tsolver.project_feasible(T(z), _tcfg(cfg), tl)
    else:
        want = jax.vmap(lambda zz, vv: jsolver.prox_g(zz, 0.0, vv, cfg))(z, v)
        got = tsolver.project_feasible(T(z), _tcfg(cfg))
    _close(got, want)


def _fista_pair(cfg, f_np, g_np, lam, v, x0, **kw):
    """JAX's prox_fista on one lane and the port's at batch 1."""
    want = mpc.prox_fista(f_np(jnp), g_np(jnp), jnp.float32(lam),
                          jnp.asarray(v, jnp.float32),
                          jnp.asarray(x0, jnp.float32), cfg, **kw)
    f_t, g_t = f_np(torch), g_np(torch)
    got = tsolver.prox_fista(lambda u: f_t(u[0])[None],
                             lambda u: g_t(u[0])[None], lam,
                             T(np.asarray(v, F32))[None],
                             T(np.asarray(x0, F32))[None], _tcfg(cfg), **kw)
    return got, want


def test_prox_fista_smooth_quadratic_matches_jax(cfg):
    """tests/test_solver.py's smooth quadratic: the target is feasible.

    At L = 2 the first step lands on the target, where f(p) equals the
    backtracking bound f(y) + <g, p - y> + L/2 |p - y|^2 exactly (both are 0
    when evaluated op by op, in JAX and in torch); JAX's compiled loop
    rounds the bound below f(p), backtracks to L = 4, lands halfway and
    takes 11 iterations where the port takes 2. Both land on the target
    within the JAX package's gate (1e-4), so that is what is compared
    here."""
    target = np.asarray([0.2, -0.1, 0.3] * 3, F32)

    def f(xp):
        tgt = xp.asarray(target)
        return lambda u: ((u - tgt) ** 2).sum()

    def g(xp):
        return lambda u: (u * 0.0).sum()

    got, want = _fista_pair(cfg, f, g, 0.0, np.zeros(3), np.zeros(9),
                            ftol=1e-10, max_iters=500)
    assert bool(got.converged[0]) and bool(want.converged)
    _close(got.x[0], want.x, atol=1e-4)
    _close(got.x[0], target, atol=1e-4)


def test_prox_fista_kink_matches_jax(cfg):
    """tests/test_solver.py's dominant control term: the current velocity
    (the kink) is the optimum."""
    v = np.asarray([0.1, 0.05, 0.0], F32)
    lam = 1.0

    def f(xp):
        return lambda u: 1e-3 * (u ** 2).sum()

    def g(xp):
        vv = xp.asarray(v)
        return lambda u: lam * xp.sqrt(
            ((u.reshape(3, 3) - vv) ** 2).sum(-1) + 1e-30).sum()

    got, want = _fista_pair(cfg, f, g, lam, v, np.tile(v, 3), ftol=1e-10,
                            max_iters=200)
    _close(got.x[0], want.x, atol=1e-5, rtol=1e-4)
    assert int(got.iters[0]) == int(want.iters)
    _close(got.x[0].reshape(3, 3), np.tile(v, (3, 1)), atol=1e-3)


def _weights(B):
    rng = np.random.default_rng(8)
    w = [rng.uniform(0.4, 1.0, B), rng.uniform(0.2, 0.6, B),
         rng.uniform(0.01, 0.3, B), rng.uniform(0.02, 0.1, B),
         rng.uniform(0.02, 0.1, B), rng.uniform(500.0, 3000.0, B)]
    w = [a.astype(F32) for a in w]
    return (jobj.Weights(*(jnp.asarray(a) for a in w)),
            tobj.Weights(*(T(a) for a in w)))


@pytest.mark.parametrize("mode", ["parity", "parity_weights", "product"])
def test_solver_batched_matches_jax_vmap(mode):
    """make_solver_batched against jax.vmap(make_solver(...)) on 8 lanes:
    the parity objective with the control norm split into the prox (λ =
    w_control / N, from the config or from per-lane weights), and the
    product objective (no split) with the patch sampler."""
    cfg, js, ts, x0 = _problem("two_phase", 8, 60)
    parity = mode != "product"
    if not parity:
        cfg = _product(cfg)
        assert cfg.solver_costmap_patch > 0
    if mode == "parity_weights":
        jw, tw = _weights(8)
        js, ts = js.replace(weights=jw), ts.replace(weights=tw)
    want = jax.vmap(jsolver.make_solver(
        cfg, mpc.make_objective(cfg, parity=parity)))(jnp.asarray(x0), js)
    tcfg = _tcfg(cfg)
    got = tsolver.make_solver_batched(
        tcfg, tobj.make_objective(tcfg, parity=parity))(T(x0), ts)
    _close(got.x, want.x, atol=1e-5, rtol=1e-4)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    _close(got.fun, want.fun, atol=1e-6, rtol=1e-4)


def test_single_lane_solver_matches_the_batch():
    """make_solver (no batch dims) is the batched solve at batch 1, and a
    lane's result does not depend on the lanes beside it."""
    cfg, _, ts, x0 = _problem("two_phase", 8, 60)
    tcfg = _tcfg(_product(cfg))
    obj = tobj.make_objective(tcfg, parity=False)
    full = tsolver.make_solver_batched(tcfg, obj)(T(x0), ts)
    assert len(set(full.iters.tolist())) > 1      # lanes finish apart
    solve = tsolver.make_solver(tcfg, obj)
    for b in range(x0.shape[0]):
        one = solve(T(x0[b]), tree_map(lambda t: t[b], ts))
        assert one.x.shape == (9,) and int(one.iters) == int(full.iters[b])
        _close(one.x, full.x[b].numpy(), atol=1e-6)
