"""The port's lockstep-tail compaction (sqp.make_sqp_solver_batched), held
as tests/test_compact.py holds the JAX package's.

The batched front end finishes the lanes still alive as a sub-batch of
their own: after `solver_compact_after` full-batch iterations (fixed), or
once at most ceil(B · solver_compact_frac) lanes are alive (adaptive).
Per lane the port's compacted solve must equal its plain path: commands,
raw solutions, iterations, converged flags and state equal, `fun` within
rtol 1e-6 / atol 1e-7 (a 1-ulp tie in f may move a termination). The
closed loop must match the JAX package's compacted `batch_simulate` within
the golden gate (1e-4).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import neo_mpc_planner2_tpu as mpc
from neo_mpc_planner2_tpu.scenarios import make_scenario_batch as jmake
from neo_mpc_planner2_tpu.simulation import batch_simulate as jsimulate

import neo_mpc_planner2_tpu_torch as tp
from neo_mpc_planner2_tpu_torch import interop
from neo_mpc_planner2_tpu_torch import sqp as tsqp
from neo_mpc_planner2_tpu_torch.ops import objective as tobj
from neo_mpc_planner2_tpu_torch.scenarios import make_scenario_batch
from neo_mpc_planner2_tpu_torch.simulation import batch_simulate


def _cfg(**kw):
    """tests/test_compact.py's config, on the port's side, at the fleet
    point's tolerance (1e-3). At the default 1e-5 every lane of these
    batches runs to the cap of 8, so no branch would gather a lane; and
    there the closed loop is not reproducible to 1e-4 at all: a one-ulp
    nudge of the poses moves JAX's own commands by ~9e-3 within 6 ticks,
    the port's stays within twice that
    (test_default_tolerance_envelope_is_the_references_own)."""
    base = dict(solver_max_iters=8, footprint_edge_samples=8,
                max_plan_points=32, solver_compact_min_batch=8,
                opt_tolerance=1e-3)
    base.update(kw)
    return tp.default_config().replace(**base)


def _jcfg(cfg):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if f.name != "compat"}
    compat = mpc.CompatConfig(**dataclasses.asdict(cfg.compat))
    return mpc.MpcConfig(compat=compat, **kw)


def _assert_same(ref, new):
    for name in ("cmd_vel", "raw_solution", "solver_iters",
                 "solver_converged", "collision", "local_plan"):
        np.testing.assert_array_equal(getattr(ref, name).numpy(),
                                      getattr(new, name).numpy(), name)
    np.testing.assert_allclose(ref.fun.numpy(), new.fun.numpy(), rtol=1e-6,
                               atol=1e-7)
    for f in dataclasses.fields(ref.state):
        np.testing.assert_array_equal(
            getattr(ref.state, f.name).numpy(),
            getattr(new.state, f.name).numpy(), f.name)


@pytest.mark.parametrize("frac", [0.5, 0.02])
def test_batch_step_matches_plain(frac):
    """frac 0.5 takes the compact branch on warm ticks; frac 0.02 (one lane)
    falls back to the full batch. A cold tick, then warm ones, with 8
    full-batch iterations of 20."""
    plain = _cfg(solver_max_iters=20)
    cfg = plain.replace(solver_compact_after=8, solver_compact_frac=frac)
    B = 32
    sb = make_scenario_batch(cfg, B, seed=7, map_size=32, plan_points=24,
                             device="cpu")
    ref_eng = tp.MpcEngine(plain, device="cpu")
    eng = tp.MpcEngine(cfg, device="cpu")
    args = (sb.plan, sb.robot_pose, sb.current_vel, sb.costmap, sb.footprint,
            sb.delta_t)
    st_ref = st_new = eng.init_batch_state(B)
    compact_n = int(np.ceil(B * frac))
    branches = []
    for _ in range(3):
        ref = ref_eng.batch_step(st_ref, *args)
        new = eng.batch_step(st_new, *args)
        _assert_same(ref, new)
        alive = int((new.solver_iters > 8).sum())
        branches.append("compact" if 0 < alive <= compact_n
                        else "full" if alive > compact_n else "none")
        st_ref, st_new = ref.state, new.state
    assert branches[0] == "full", branches
    assert set(branches[1:]) == ({"compact"} if frac == 0.5 else {"full"}), \
        branches


def _warm_problem(cfg, B, seed, obstacle):
    rng = np.random.default_rng(seed)
    data = np.zeros((40, 40))
    if obstacle:
        data[10:14, 22:30] = 0.9
    cm = tp.Costmap.create(data, origin=(-1.0, -1.0), resolution=0.05,
                           device="cpu")
    fp = tp.Footprint.rectangle(0.6, 0.4, device="cpu")
    rep = lambda t: t.expand((B,) + t.shape).contiguous()
    draw = lambda lim: torch.as_tensor(rng.uniform(-lim, lim, (B, 3)),
                                       dtype=torch.float32)
    carrots, goals, vels = draw(0.6), draw(1.0), draw(0.3)
    scens = tobj.Scenario(
        current_pose=torch.zeros(B, 3), carrot_pose=carrots,
        goal_pose=goals, current_vel=vels,
        footprint=tp.Footprint(vertices=rep(fp.vertices),
                               n_valid=rep(fp.n_valid)),
        costmap=tp.Costmap(data=rep(cm.data), origin=rep(cm.origin),
                           resolution=rep(cm.resolution)),
        switch_opt=torch.zeros(B, dtype=torch.bool))
    return scens, rng


def _solve_pair(cfg, plain, scens, x0):
    obj = tobj.make_objective(cfg, parity=True)
    ref = tsqp.make_sqp_solver_batched(plain, obj)(x0, scens)
    new = tsqp.make_sqp_solver_batched(cfg, obj)(x0, scens)
    np.testing.assert_array_equal(ref.converged.numpy(),
                                  new.converged.numpy())
    np.testing.assert_array_equal(ref.iters.numpy(), new.iters.numpy())
    np.testing.assert_array_equal(ref.x.numpy(), new.x.numpy())
    np.testing.assert_allclose(ref.fun.numpy(), new.fun.numpy(), rtol=1e-6,
                               atol=1e-7)
    return new


def test_compact_branch_taken_on_warm_batch():
    """Lanes warm-started at their optimum but two perturbed: the fixed
    scheme gathers the two stragglers after 8 iterations and finishes them
    (tests/test_compact.py's warm batch)."""
    cfg = _cfg(solver_compact_after=8, solver_compact_frac=0.5,
               solver_max_iters=20)
    plain = cfg.replace(solver_compact_after=0)
    B = 16
    scens, _ = _warm_problem(cfg, B, 0, obstacle=False)
    obj = tobj.make_objective(cfg, parity=True)
    opt = tsqp.make_sqp_solver_batched(plain, obj)(
        torch.zeros(B, 3 * cfg.control_steps), scens)
    warm = opt.x.clone()
    warm[3] += 0.3
    warm[11] -= 0.3
    new = _solve_pair(cfg, plain, scens, warm)
    n_alive = int((new.iters > cfg.solver_compact_after).sum())
    assert 0 < n_alive <= int(np.ceil(B * cfg.solver_compact_frac))


@pytest.mark.parametrize("max_iters", [8, 20])
def test_adaptive_compaction_matches_plain(max_iters):
    """The adaptive scheme (full-batch trips while more than compact_n lanes
    are alive, then the stragglers alone) equals the plain path per lane,
    from a cold and a random start, at the cap-8 point and at 20."""
    cfg = _cfg(solver_max_iters=max_iters, solver_compact_frac=0.25,
               solver_compact_adaptive=True)
    plain = cfg.replace(solver_compact_adaptive=False)
    B = 16
    scens, rng = _warm_problem(cfg, B, 1, obstacle=True)
    m = 3 * cfg.control_steps
    compact_n = int(np.ceil(B * cfg.solver_compact_frac))
    gathered = []
    for x0 in (torch.zeros(B, m),
               torch.as_tensor(rng.uniform(-0.3, 0.3, (B, m)),
                               dtype=torch.float32)):
        iters = _solve_pair(cfg, plain, scens, x0).iters.numpy()
        # The lanes alive at the first trip that leaves at most compact_n.
        switch = min(t for t in range(max_iters + 1)
                     if (iters > t).sum() <= compact_n)
        gathered.append(int((iters > switch).sum()))
    # At the cap of 8 most lanes run to the cap, so the full batch finishes
    # them; at 20 the stragglers are gathered.
    assert max(gathered) > 0 or max_iters == 8, gathered


@pytest.mark.parametrize("scheme", ["adaptive", "fixed"])
def test_closed_loop_matches_jax(scheme):
    """Six closed-loop ticks with compaction against the JAX package's
    compacted batch_simulate on the same scenario batch: commands within
    1e-4, iterations equal; and against the port's plain path exactly."""
    plain = _cfg(solver_compact_after=0, solver_compact_frac=0.25)
    cfg = (plain.replace(solver_compact_adaptive=True)
           if scheme == "adaptive"
           else plain.replace(solver_compact_after=2))
    jc = _jcfg(cfg)
    sb = jmake(jc, 16, seed=9, map_size=32, plan_points=24)
    want = jax.jit(lambda b: jsimulate(jc, b, 6))(sb)
    tb = interop.scenario_batch_from_numpy(jax.tree.map(np.asarray, sb),
                                           device="cpu")
    got = batch_simulate(cfg, tb, 6)
    np.testing.assert_allclose(got.cmds.numpy(), np.asarray(want.cmds),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.solver_iters.numpy(),
                                  np.asarray(want.solver_iters))
    ref = batch_simulate(plain, tb, 6)
    np.testing.assert_array_equal(got.cmds.numpy(), ref.cmds.numpy())
    np.testing.assert_array_equal(got.solver_iters.numpy(),
                                  ref.solver_iters.numpy())


def test_default_tolerance_envelope_is_the_references_own():
    """At the default opt_tolerance (1e-5) on tests/test_compact.py's batch
    (16 lanes, seed 9, 32² map, 24 plan points, 8 iterations, 6 ticks),
    JAX's jitted batch_simulate against itself with robot_pose nudged by
    one ulp: its commands spread by s (9.03e-3 on the CPU), so the envelope
    is the reference's own and not below 1e-3. The port's plain closed
    loop on the un-nudged batch stays within 2·s of JAX's."""
    cfg = _cfg(opt_tolerance=1e-5)
    jc = _jcfg(cfg)
    sb = jmake(jc, 16, seed=9, map_size=32, plan_points=24)
    run = jax.jit(lambda b: jsimulate(jc, b, 6))
    want = np.asarray(run(sb).cmds)
    pose = np.asarray(sb.robot_pose)
    nudged = sb._replace(robot_pose=jax.numpy.asarray(
        np.nextafter(pose, np.float32(np.inf))))
    spread = float(np.abs(np.asarray(run(nudged).cmds) - want).max())
    assert spread >= 1e-3, spread
    tb = interop.scenario_batch_from_numpy(jax.tree.map(np.asarray, sb),
                                           device="cpu")
    got = batch_simulate(cfg, tb, 6).cmds.numpy()
    assert float(np.abs(got - want).max()) <= 2 * spread
