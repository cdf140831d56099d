"""The port's fleet closed-loop slice as a whole, against the JAX package.

- The scenario generator draws the same plans, poses, velocities and
  footprints bit for bit; the maps, synthesized in float32 by the port and
  in float64 by the JAX host path, agree within 1e-6.
- `batch_simulate` on the JAX-built scenario batch, carried over through
  `interop`, reproduces the JAX package's main-path goldens within their
  gates (tests/test_golden.py: cmds atol 1e-4, goal_dist atol 1e-3).
- One direct run against JAX `batch_simulate` at the fleet operating point
  (quadratic-interpolation line search), within the same gates.
- Importing the port never imports JAX.
"""

import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neo_mpc_planner2_tpu as mpc
from neo_mpc_planner2_tpu.scenarios import make_scenario_batch as jmake
from neo_mpc_planner2_tpu.simulation import batch_simulate as jsimulate

import neo_mpc_planner2_tpu_torch as tp
from neo_mpc_planner2_tpu_torch import interop
from neo_mpc_planner2_tpu_torch.scenarios import make_scenario_batch
from neo_mpc_planner2_tpu_torch.simulation import batch_simulate

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

import record_golden  # noqa: E402

GOLDEN_DIR = ROOT / "tests" / "golden"
# The main-path goldens: static map, no compaction, sequential line search.
MAIN_PATH_GOLDENS = ("mpo700_closed_loop", "two_phase_ls", "footprint_live")


def _tcfg(jc):
    kw = {f: getattr(jc, f) for f in jc.__dataclass_fields__ if f != "compat"}
    compat = tp.CompatConfig(**{f: getattr(jc.compat, f)
                                for f in jc.compat.__dataclass_fields__})
    return tp.MpcConfig(compat=compat, **kw)


def _from_jax(sb):
    return interop.scenario_batch_from_numpy(jax.tree.map(np.asarray, sb))


@pytest.mark.parametrize("opts", [
    dict(),
    dict(lethal_threshold=0.85, pose_jitter=0.45),
    dict(clear_corridor_m=0.3, center_on="plan", n_obstacles=4),
], ids=["default", "lethal", "corridor"])
def test_scenario_batch_matches_jax(opts):
    cfg = record_golden.suite_cfg()
    want = jmake(cfg, 16, seed=7, map_size=40, plan_points=32, **opts)
    got = make_scenario_batch(_tcfg(cfg), 16, seed=7, map_size=40,
                              plan_points=32, **opts)
    N = np.asarray
    for name in ("px", "py", "pyaw", "n_valid"):
        np.testing.assert_array_equal(getattr(got.plan, name).numpy(),
                                      N(getattr(want.plan, name)))
    for name in ("robot_pose", "current_vel", "delta_t"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      N(getattr(want, name)))
    np.testing.assert_array_equal(got.footprint.vertices.numpy(),
                                  N(want.footprint.vertices))
    np.testing.assert_array_equal(got.footprint.n_valid.numpy(),
                                  N(want.footprint.n_valid))
    for name in ("origin", "resolution"):
        np.testing.assert_array_equal(getattr(got.costmap, name).numpy(),
                                      N(getattr(want.costmap, name)))
    np.testing.assert_allclose(got.costmap.data.numpy(),
                               N(want.costmap.data), rtol=0, atol=1e-6)
    for name in tp.ControlState.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(got.state, name).numpy(),
                                      N(getattr(want.state, name)))


@pytest.mark.parametrize("variant", MAIN_PATH_GOLDENS)
def test_batch_simulate_reproduces_golden(variant):
    cfg_over, run_over = record_golden.VARIANTS[variant]
    cfg = record_golden.suite_cfg(**cfg_over)
    sb = jmake(cfg, 8, seed=2026, map_size=run_over.get("map_size", 48),
               plan_points=32,
               lethal_threshold=run_over.get("lethal_threshold"),
               pose_jitter=run_over.get("pose_jitter", 0.05))
    res = batch_simulate(_tcfg(cfg), _from_jax(sb), 30)
    with np.load(GOLDEN_DIR / f"{variant}.npz") as z:
        np.testing.assert_allclose(res.cmds.numpy(), z["cmds"], atol=1e-4,
                                   err_msg=f"{variant}: commands differ")
        np.testing.assert_allclose(res.goal_dist.numpy(), z["goal_dist"],
                                   atol=1e-3)
    assert np.isfinite(res.poses.numpy()).all()


def _fleet_cfg():
    """fleet_config() with the fleet benchmark's overrides (bench.py), on
    the JAX side."""
    return mpc.fleet_config().replace(
        prediction_horizon=0.8, control_steps=3, opt_tolerance=1e-3,
        footprint_edge_samples=16, max_plan_points=64,
        solver_compact_adaptive=False,
        min_vel_x=-0.7, min_vel_y=-0.7, min_vel_theta=-0.7,
        max_vel_x=0.7, max_vel_y=0.7, max_vel_trans=0.7, max_vel_theta=0.7,
        w_trans=0.82, w_orient=0.5, w_control=0.05, w_terminal=0.05,
        w_costmap=0.05, w_footprint=2000.0, costmap_sampling="onehot",
        solver_costmap_u8=False,
        lookahead_dist_min=0.4, lookahead_dist_max=0.4,
        lookahead_dist_close_to_goal=0.4)


def test_fleet_slice_matches_jax_batch_simulate():
    cfg = _fleet_cfg()
    sb = jmake(cfg, 16, seed=0, map_size=32, plan_points=64)
    want = jax.jit(lambda: jsimulate(cfg, sb, 5))()
    got = batch_simulate(_tcfg(cfg), _from_jax(sb), 5)
    np.testing.assert_allclose(got.cmds.numpy(), np.asarray(want.cmds),
                               atol=1e-4)
    np.testing.assert_allclose(got.goal_dist.numpy(),
                               np.asarray(want.goal_dist), atol=1e-3)
    np.testing.assert_array_equal(got.lethal.numpy(), np.asarray(want.lethal))
    np.testing.assert_array_equal(got.collisions.numpy(),
                                  np.asarray(want.collisions))
    # The chip smoke's own checks, here on the CPU.
    speed = torch.linalg.vector_norm(got.cmds[..., :2], dim=-1)
    assert float(speed.max()) <= cfg.max_vel_trans + 1e-5


def test_the_fleet_config_matches_the_chip_smoke():
    """chip_smoke.py builds the same operating point as the test above."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    assert (dataclasses.asdict(chip_smoke.fleet_cfg())
            == dataclasses.asdict(_tcfg(_fleet_cfg())))


def test_mpc_engine_matches_jax():
    """MpcEngine.step (one robot, no batch dims) over a few warm-started
    ticks against the JAX engine's, and batch_step against step."""
    cfg = record_golden.suite_cfg(w_footprint=2000.0)
    sb = jmake(cfg, 2, seed=2026, map_size=48, plan_points=32)
    one = jax.tree.map(lambda x: x[0], sb)
    tone = _from_jax(one)
    jeng, teng = mpc.MpcEngine(cfg), tp.MpcEngine(_tcfg(cfg))
    jst, tst = jeng.init_state(), teng.init_state()
    jvel, tvel = one.current_vel, tone.current_vel
    first = None
    for _ in range(3):
        jo = jeng.step(jst, one.plan, one.robot_pose, jvel, one.costmap,
                       one.footprint, 1.0 / 30)
        to = teng.step(tst, tone.plan, tone.robot_pose, tvel, tone.costmap,
                       tone.footprint, 1.0 / 30)
        np.testing.assert_allclose(to.cmd_vel.numpy(), np.asarray(jo.cmd_vel),
                                   atol=1e-4)
        assert to.cmd_vel.shape == (3,)
        first = first or to
        jst, tst, jvel, tvel = jo.state, to.state, jo.cmd_vel, to.cmd_vel
    tb = _from_jax(sb)
    out = teng.batch_step(teng.init_batch_state(2), tb.plan, tb.robot_pose,
                          tb.current_vel, tb.costmap, tb.footprint,
                          tb.delta_t)
    np.testing.assert_allclose(out.cmd_vel[0].numpy(),
                               first.cmd_vel.numpy(), rtol=0, atol=1e-6)


def test_unported_regimes_raise():
    cfg = tp.fleet_config().replace(max_plan_points=16)
    sb = make_scenario_batch(cfg, 2, map_size=32, plan_points=8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        batch_simulate(cfg, sb, 1, window_cells=8)
    with pytest.raises(NotImplementedError):
        tp.make_objective(cfg, parity=False)


def test_importing_the_port_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import neo_mpc_planner2_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k == 'jax' or k.startswith(('jax.', 'jaxlib',\n"
        "                                            'neo_mpc_planner2_tpu.')))\n"
        "print(len(list(pkgutil.walk_packages(p.__path__))), bad)\n"
        "sys.exit(1 if bad or 'neo_mpc_planner2_tpu' in sys.modules else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
