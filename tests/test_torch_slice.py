"""The port's fleet closed-loop slice as a whole, against the JAX package.

- The scenario generator draws the same plans, poses, velocities and
  footprints bit for bit; the maps, synthesized in float32 by the port and
  in float64 by the JAX host path, agree within 1e-6.
- `batch_simulate` on the JAX-built scenario batch, carried over through
  `interop`, reproduces the JAX package's goldens of the paths the port
  runs within their gates (tests/test_golden.py: cmds atol 1e-4, goal_dist
  atol 1e-3): all six, the main path, the uint8 gather source, the rolling
  window and adaptive compaction among them.
- One direct run against JAX `batch_simulate` at the fleet operating point
  (quadratic-interpolation line search), and one at the product point
  (smooth objective, candidate wave, patch sampler), within the same gates.
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
# Every golden: static map, sequential line search; the uint8 gather
# source; the rolling window (a 48-cell view of a 96² world); adaptive
# lockstep-tail compaction.
PORTED_GOLDENS = ("mpo700_closed_loop", "two_phase_ls", "footprint_live",
                  "u8_source", "rolling_window", "adaptive_compact")


def _tcfg(jc):
    kw = {f: getattr(jc, f) for f in jc.__dataclass_fields__ if f != "compat"}
    compat = tp.CompatConfig(**{f: getattr(jc.compat, f)
                                for f in jc.compat.__dataclass_fields__})
    return tp.MpcConfig(compat=compat, **kw)


def _from_jax(sb):
    return interop.scenario_batch_from_numpy(jax.tree.map(np.asarray, sb),
                                             device="cpu")


@pytest.mark.parametrize("opts", [
    dict(),
    dict(lethal_threshold=0.85, pose_jitter=0.45),
    dict(clear_corridor_m=0.3, center_on="plan", n_obstacles=4),
], ids=["default", "lethal", "corridor"])
def test_scenario_batch_matches_jax(opts):
    cfg = record_golden.suite_cfg()
    want = jmake(cfg, 16, seed=7, map_size=40, plan_points=32, **opts)
    got = make_scenario_batch(_tcfg(cfg), 16, seed=7, map_size=40,
                              plan_points=32, device="cpu", **opts)
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


@pytest.mark.parametrize("variant", PORTED_GOLDENS)
def test_batch_simulate_reproduces_golden(variant):
    cfg_over, run_over = record_golden.VARIANTS[variant]
    cfg = record_golden.suite_cfg(**cfg_over)
    sb = jmake(cfg, 8, seed=2026, map_size=run_over.get("map_size", 48),
               plan_points=32,
               lethal_threshold=run_over.get("lethal_threshold"),
               pose_jitter=run_over.get("pose_jitter", 0.05))
    res = batch_simulate(_tcfg(cfg), _from_jax(sb), 30,
                         window_cells=run_over.get("window_cells"))
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


def _product_cfg():
    """bench.py's product-SQP flips on the fleet overrides, on the JAX
    side: quirks off, the candidate wave, the patch sampler (28 cells)."""
    from neo_mpc_planner2_tpu.ops.costmap import (
        required_product_patch_halfwidth)

    cfg = _fleet_cfg()
    cfg = cfg.replace(
        parallel_line_search=True, solver_ls_quad_interp=False,
        solver_patch_exact_picks=False,
        compat=dataclasses.replace(
            cfg.compat, buggy_odom_yaw=False, footprint_alias_noop=False,
            lethal_1000x=False, unsquared_control_cost=False,
            no_angle_wrap=False))
    return cfg.replace(solver_costmap_patch=required_product_patch_halfwidth(
        cfg, 0.05, 0.46))


def test_product_slice_matches_jax_batch_simulate():
    cfg = _product_cfg()
    assert cfg.solver_costmap_patch == 28
    sb = jmake(cfg, 16, seed=0, map_size=48, plan_points=64)
    want = jax.jit(lambda: jsimulate(cfg, sb, 5, parity=False))()
    got = batch_simulate(_tcfg(cfg), _from_jax(sb), 5, parity=False)
    np.testing.assert_allclose(got.cmds.numpy(), np.asarray(want.cmds),
                               atol=1e-4)
    np.testing.assert_allclose(got.goal_dist.numpy(),
                               np.asarray(want.goal_dist), atol=1e-3)
    np.testing.assert_array_equal(got.lethal.numpy(), np.asarray(want.lethal))
    np.testing.assert_array_equal(got.collisions.numpy(),
                                  np.asarray(want.collisions))
    speed = torch.linalg.vector_norm(got.cmds[..., :2], dim=-1)
    assert float(speed.max()) <= cfg.max_vel_trans + 1e-5
    # MpcEngine in product mode: its first batched step is the run's first.
    tb = _from_jax(sb)
    eng = tp.MpcEngine(_tcfg(cfg), parity=False, device="cpu")
    out = eng.batch_step(eng.init_batch_state(16), tb.plan, tb.robot_pose,
                         tb.current_vel, tb.costmap, tb.footprint,
                         tb.delta_t)
    np.testing.assert_array_equal(out.cmd_vel.numpy(), got.cmds[:, 0].numpy())


def test_the_product_config_matches_the_chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    assert (dataclasses.asdict(chip_smoke.product_cfg())
            == dataclasses.asdict(_tcfg(_product_cfg())))


def test_mpc_engine_matches_jax():
    """MpcEngine.step (one robot, no batch dims) over a few warm-started
    ticks against the JAX engine's, and batch_step against step."""
    cfg = record_golden.suite_cfg(w_footprint=2000.0)
    sb = jmake(cfg, 2, seed=2026, map_size=48, plan_points=32)
    one = jax.tree.map(lambda x: x[0], sb)
    tone = _from_jax(one)
    jeng, teng = mpc.MpcEngine(cfg), tp.MpcEngine(_tcfg(cfg), device="cpu")
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
    """The regimes that used to be refused run through batch_simulate and
    give the plain path's commands: fixed and adaptive lockstep-tail
    compaction and the K-wide wave (solver_ls_wave). Quadratic
    interpolation with a wave is still refused, as in the JAX package.
    (The live maps: test_torch_livemap.py; exact footprint mode:
    test_torch_exact.py; compaction in depth: test_torch_compact.py.)"""
    cfg = tp.fleet_config().replace(max_plan_points=16,
                                    solver_ls_quad_interp=False)
    sb = make_scenario_batch(cfg, 4, map_size=32, plan_points=8, device="cpu")
    plain = batch_simulate(cfg, sb, 2).cmds
    for over in (dict(solver_compact_after=2, solver_compact_frac=0.5,
                      solver_compact_min_batch=2),
                 dict(solver_compact_adaptive=True, solver_compact_frac=0.5,
                      solver_compact_min_batch=2),
                 dict(solver_ls_wave=2)):
        np.testing.assert_array_equal(
            batch_simulate(cfg.replace(**over), sb, 2).cmds.numpy(),
            plain.numpy(), err_msg=str(over))
    with pytest.raises(ValueError, match="sequential line search"):
        batch_simulate(cfg.replace(solver_ls_wave=2,
                                   solver_ls_quad_interp=True), sb, 1)


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
        "shells = {p.__name__ + '.' + m for m in ('serving', 'checkpoint',\n"
        "          'controller', 'ros_adapter', 'cli', 'native.host',\n"
        "          'utils.viz', 'utils.se2_np', 'utils.profiling',\n"
        "          'parallel.smoke', 'bench')}\n"
        "sys.exit(1 if bad or 'neo_mpc_planner2_tpu' in sys.modules\n"
        "         or not shells <= set(sys.modules) else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
