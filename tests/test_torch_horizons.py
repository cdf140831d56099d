"""The port at other horizons against the JAX package.

The reference hardcodes nothing about control_steps = 3 (a ROS parameter,
mpc_optimization_server.py:75), and neither does the JAX package
(tests/test_horizons.py). Here the port goes through the same horizons on
the CPU, against the JAX package on the same numpy inputs:

- the solver at tests/test_horizons.py's (control_steps, horizon) pairs
  (1, 0.3), (5, 1.0), (8, 1.6), at ftol 1e-8 and 300 iterations: the
  objective within 1e-6 of JAX's jitted solve, and the oracle criterion of
  tests/test_horizons.py:33-34 against the port's scipy oracle (objective
  gap < 1e-4, x within 1e-2 or the gap < 2e-6). The objective and not x:
  at ftol 1e-8 the two stop at different points of a flat valley (ROADMAP
  watch list). control_steps 12 is in test_torch_horizon12*.py;
- one MpcEngine tick at control_steps 1 and 5: cmd_vel within 1e-4 (the
  golden gate), a local plan of steps + 1 poses;
- batch_simulate at control_steps 5, 8 lanes, 5 ticks: commands within
  the goldens' atol 1e-4, goal distance within 1e-3;
- a server session's message script across a configure of control_steps
  5 and back: the same answers as JAX's session (tests/test_torch_serving's
  comparison) and the same slot resets;
- K1's plain version at m = 24 against JAX's plain QP (rtol 2e-4 / atol
  2e-5; m = 3 is in test_torch_kernels.py's parametrization, against the
  Pallas kernel too; at m = 24 the Pallas kernel takes over ten minutes to
  trace and compile in interpret mode);
- the rule that picks each kernel's design, and the wrappers' refusal
  above each cap, with no card.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neo_mpc_planner2_tpu as mpc
from neo_mpc_planner2_tpu import sqp as jsqp
from neo_mpc_planner2_tpu.scenarios import make_scenario_batch as jmake
from neo_mpc_planner2_tpu.serving import OptimizerSession as JaxSession
from neo_mpc_planner2_tpu.simulation import batch_simulate as jsimulate

import neo_mpc_planner2_tpu_torch as tp
from neo_mpc_planner2_tpu_torch import interop
from neo_mpc_planner2_tpu_torch import oracle as toracle
from neo_mpc_planner2_tpu_torch import sqp as tsqp
from neo_mpc_planner2_tpu_torch.kernels import binding
from neo_mpc_planner2_tpu_torch.ops import objective as tobj
from neo_mpc_planner2_tpu_torch.serving import OptimizerSession

N = lambda a: np.asarray(a)


def _tcfg(jc):
    kw = {f: getattr(jc, f) for f in jc.__dataclass_fields__ if f != "compat"}
    compat = tp.CompatConfig(**dataclasses.asdict(jc.compat))
    return tp.MpcConfig(compat=compat, **kw)


def solve_pair(c, footprint, costmap):
    """tests/test_horizons.py's scenario solved by JAX's jitted
    make_sqp_solver and the port's, at ftol 1e-8 and 300 iterations: (JAX's
    solve of x0, the port's)."""
    scen = mpc.Scenario.create([0, 0, 0], [0.4, 0.1, 0.2], [1.0, 0.5, 0.3],
                               [0.3, 0, 0], footprint, costmap)
    want = jax.jit(mpc.make_sqp_solver(c, mpc.make_objective(c), ftol=1e-8,
                                       max_iters=300))
    tc = _tcfg(c)
    T = lambda a: torch.as_tensor(np.array(a))
    n = lambda tree: jax.tree.map(np.asarray, tree)
    tscen = tobj.Scenario(
        current_pose=T(scen.current_pose), carrot_pose=T(scen.carrot_pose),
        goal_pose=T(scen.goal_pose), current_vel=T(scen.current_vel),
        footprint=interop.footprint_from_numpy(n(footprint), device="cpu"),
        costmap=interop.costmap_from_numpy(n(costmap), device="cpu"),
        switch_opt=torch.tensor(False))
    got = tsqp.make_sqp_solver(tc, tobj.make_objective(tc), ftol=1e-8,
                               max_iters=300)
    return (lambda x: want(jnp.asarray(x), scen),
            lambda x: got(torch.as_tensor(x), tscen))


def oracle_solve(c, footprint_np):
    """The port's scipy oracle on tests/test_horizons.py's scenario."""
    npcm = toracle.NpCostmap(np.zeros((40, 40)), np.array([-1.0, -1.0]),
                             0.05)
    nps = toracle.NpScenario(np.zeros(3), np.array([0.4, 0.1, 0.2]),
                             np.array([1.0, 0.5, 0.3]), np.array([0.3, 0, 0]),
                             footprint_np, npcm)
    _, diag = toracle.OracleServer(_tcfg(c)).solve(nps, 0.033)
    return diag


@pytest.mark.parametrize("steps,horizon", [(1, 0.3), (5, 1.0), (8, 1.6)])
def test_solver_matches_jax_and_oracle_other_horizons(
        cfg, empty_costmap, footprint, footprint_np, steps, horizon):
    c = cfg.replace(control_steps=steps, prediction_horizon=horizon,
                    opt_tolerance=1e-8)
    want_solve, got_solve = solve_pair(c, footprint, empty_costmap)
    x0 = np.zeros(3 * steps, np.float32)
    want, got = want_solve(x0), got_solve(x0)
    assert got.x.shape == (3 * steps,)
    assert abs(float(got.fun) - float(want.fun)) <= 1e-6, (
        steps, float(got.fun), float(want.fun))
    diag = oracle_solve(c, footprint_np)
    fgap = float(got.fun) - diag["fun"]
    dx = np.abs(diag["raw"] - got.x.numpy()).max()
    assert fgap < 1e-4, (steps, fgap)
    assert dx < 1e-2 or fgap < 2e-6, (steps, dx, fgap)


def engine_tick_pair(c, costmap, footprint):
    """One MpcEngine tick from a fresh state along a straight 2 m plan at
    0.3 m/s, through JAX's engine and the port's: (JAX's out, the port's)."""
    poses = np.stack([np.linspace(0, 2, 40), np.zeros(40), np.zeros(40)], 1)
    jplan = mpc.Plan.create(poses, max_points=c.max_plan_points)
    jeng, teng = mpc.MpcEngine(c), tp.MpcEngine(_tcfg(c), device="cpu")
    n = lambda tree: jax.tree.map(np.asarray, tree)
    want = jeng.step(jeng.init_state(), jplan, jnp.zeros(3, jnp.float32),
                     jnp.asarray([0.3, 0, 0], jnp.float32), costmap,
                     footprint, 0.033)
    got = teng.step(teng.init_state(),
                    interop.plan_from_numpy(n(jplan), device="cpu"),
                    torch.zeros(3), torch.tensor([0.3, 0.0, 0.0]),
                    interop.costmap_from_numpy(n(costmap), device="cpu"),
                    interop.footprint_from_numpy(n(footprint), device="cpu"),
                    0.033)
    return want, got


@pytest.mark.parametrize("steps", [1, 5])
def test_engine_tick_matches_jax_other_steps(cfg, empty_costmap, footprint,
                                             steps):
    c = cfg.replace(control_steps=steps)
    want, got = engine_tick_pair(c, empty_costmap, footprint)
    assert got.local_plan.shape == (steps + 1, 3)
    assert got.state.initial_guess.shape == (3 * steps,)
    np.testing.assert_allclose(got.cmd_vel.numpy(), N(want.cmd_vel),
                               rtol=0, atol=1e-4)
    assert float(got.cmd_vel[0]) > 0.0


def test_closed_loop_at_control_steps_5_matches_jax(cfg):
    """batch_simulate at control_steps 5 (m = 15), 8 lanes, 5 ticks, on
    the scenario generator's maps with the footprint term on."""
    c = cfg.replace(control_steps=5, prediction_horizon=1.0,
                    w_footprint=2000.0, max_plan_points=32)
    sb = jmake(c, 8, seed=4, map_size=40, plan_points=24)
    want = jsimulate(c, sb, 5)
    tsb = interop.scenario_batch_from_numpy(jax.tree.map(np.asarray, sb),
                                            device="cpu")
    got = tp.batch_simulate(_tcfg(c), tsb, 5)
    assert got.final_state.initial_guess.shape == (8, 15)
    np.testing.assert_allclose(got.cmds.numpy(), N(want.cmds), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got.goal_dist.numpy(), N(want.goal_dist),
                               rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got.lethal.numpy(), N(want.lethal))


FOOTPRINT = [[0.3, 0.2], [-0.3, 0.2], [-0.3, -0.2], [0.3, -0.2]]


def _robot(i):
    return {"op": "optimizer", "current_pose": [0.05 * i - 0.1, -0.02 * i,
                                                0.1 * i],
            "carrot_pose": [0.4, 0.05 * i, 0.1],
            "goal_pose": [0.6, 0.3 + 0.05 * i, 0.2],
            "current_vel": [0.1, 0.0, 0.02 * i], "control_interval": 0.033,
            "delta_t": 0.033}


def test_server_configure_control_steps_5_matches_jax():
    """A session's script across a configure of control_steps 5 and back
    to 3, through the port's and JAX's sessions: equal answers
    (output_vel within 1e-4, the golden gate; iterations within 1; the rest
    as tests/test_torch_serving.py compares them) and equal slot resets
    (every slot's warm start resized to 3 x control_steps)."""
    from test_torch_serving import _close, _map, _params

    from neo_mpc_planner2_tpu import config as jconfig
    from neo_mpc_planner2_tpu_torch import config as tconfig

    p = _params()
    sessions = (JaxSession(jconfig.config_from_ros_params(p)),
                OptimizerSession(tconfig.config_from_ros_params(p),
                                 device="cpu"))
    batch = {"op": "optimizer_batch", "robots": [_robot(i) for i in range(3)],
             "control_interval": 0.033, "delta_t": 0.033}
    script = [
        {"op": "set_costmap", "data": _map(), "origin": [-1.0, -1.0],
         "resolution": 0.05},
        {"op": "set_footprint", "points": FOOTPRINT},
        _robot(0), {**_robot(1), "robot": "a"}, batch,
        {"op": "configure", "params": {"control_steps": 5}},
        _robot(0), _robot(0), batch, batch,
        {"op": "configure", "params": {"control_steps": 3}},
        _robot(0), {**_robot(1), "robot": "a"}, batch]
    for i, msg in enumerate(script):
        want, got = (s.handle(msg) for s in sessions)
        _close((i, msg["op"]), got, want)
        if msg["op"] == "configure":
            m = 3 * msg["params"]["control_steps"]
            for s in sessions:
                assert {k: v["state"].initial_guess.shape[0]
                        for k, v in s._slots.items()} == {"": m, "a": m}
                assert s._fleet_shards is None if hasattr(
                    s, "_fleet_shards") else s._fleet_state is None
        if msg["op"] == "optimizer":
            assert len(got["local_plan"]) == (
                sessions[1].cfg.control_steps + 1)


@pytest.mark.filterwarnings("ignore")
def test_qp_admm_plain_matches_jax_plain_at_m24():
    """K1's plain version at m = 24 (control_steps 8) against JAX's plain
    QP (vmapped, run eagerly), B = 8, 6 iterations."""
    from test_torch_kernels import _qp_inputs

    m = 24
    Bf, g, x, c, J, dxy, lo, hi, carry = _qp_inputs(
        np.random.default_rng(24), 8, m)
    T = lambda a: torch.as_tensor(np.array(a))
    kw = dict(iters=6, rho=1.0, sigma=1e-6)
    got = tsqp.qp_admm_plain(T(Bf), T(g), T(x), T(c), T(J), T(lo), T(hi),
                             *map(T, carry), **kw)
    want = jax.vmap(partial(jsqp._qp_admm_plain, **kw))(
        Bf, g, x, c, J, lo, hi, *carry)
    for gt, w in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), N(w), rtol=2e-4, atol=2e-5)


# --- the dispatch rule, with no card -----------------------------------------

def test_every_k1_width_up_to_its_cap_has_a_design():
    """Every m = 3n up to K1's cap maps to a design: the warp team up to
    m = K1_WARP_TEAM_MAX_M (18), the warp lane up to 63, the block lane above, with enough warps
    for its rows; m = 3 (cap + 1) raises, naming the cap, as do widths that
    are not a multiple of 3."""
    cap = binding.K1_MAX_M
    assert cap == 237 and binding.k1_block_smem_bytes(cap) <= binding.MAX_SMEM
    assert binding.k1_block_smem_bytes(cap + 3) > binding.MAX_SMEM
    for m in range(3, cap + 1, 3):
        want = ("warp_team" if m <= binding.K1_WARP_TEAM_MAX_M else
                "warp_lane" if m <= binding.K1_WARP_LANE_MAX_M else
                "block_lane")
        assert binding.qp_admm_variant(m) == want
        warps = binding.k1_warps_per_lane(m)
        assert warps == {"warp_team": 0, "warp_lane": 1}.get(want, warps)
        if want == "block_lane":
            assert 30 * warps >= m and warps <= 32
    for m in (cap + 3, 3 * 1000):
        with pytest.raises(ValueError, match=f"cap m={cap}"):
            binding.qp_admm_variant(m)
    for m in (0, 4, 10, 31):
        with pytest.raises(ValueError, match="3 x control_steps"):
            binding.qp_admm_variant(m)


def test_every_k2_width_up_to_its_cap_has_a_design():
    """Every m from 1 to K2's cap maps to a design: unrolled at m = 3, 6,
    .., 18, the runtime-m kernel at every other m, at a launch shape whose
    block fits; the width above the cap raises, naming it."""
    cap = binding.K2_MAX_M
    assert cap == 240 and binding.k2_block_smem_bytes(cap) <= binding.MAX_SMEM
    assert binding.k2_block_smem_bytes(cap + 1) > binding.MAX_SMEM
    for m in range(1, cap + 1):
        assert binding.spd_inv_variant(m) == (
            "unrolled" if m in binding.K2_UNROLLED_M else "runtime_m")
        if m not in binding.K2_UNROLLED_M:
            warps, matrices = binding.k2_runtime_shape(m)
            assert 1 <= warps <= 32 and matrices in (1, warps)
            assert (matrices * binding.k2_block_smem_bytes(m)
                    <= binding.MAX_SMEM)
    for m in (0, cap + 1):
        with pytest.raises(ValueError, match=f"1..{cap}"):
            binding.spd_inv_variant(m)


def test_wrappers_refuse_widths_above_the_caps():
    """sqp's checks before a launch (the CUDA path) take every width the
    rule serves and raise above each cap."""
    ok = binding.K1_MAX_M
    rows = binding.qp_rows(ok)
    args = [torch.zeros(2, rows[n]) for n in binding.QP_INPUTS]
    tsqp._check_qp_operands(args, ok)
    big = ok + 3
    rows = binding.qp_rows(big)
    args = [torch.zeros(2, rows[n]) for n in binding.QP_INPUTS]
    with pytest.raises(ValueError, match=f"cap m={ok}"):
        tsqp._check_qp_operands(args, big)
    for m in (1, 4, 36, binding.K2_MAX_M):
        tsqp._check_kernel_inputs([torch.zeros(2, m, m)], m, "chol_inverse",
                                  binding.spd_inv_variant)
    with pytest.raises(ValueError, match=f"1..{binding.K2_MAX_M}"):
        tsqp._check_kernel_inputs([torch.zeros(1, 241, 241)], 241,
                                  "chol_inverse", binding.spd_inv_variant)
