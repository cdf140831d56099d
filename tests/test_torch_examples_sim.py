"""The port's closed-loop demos on `simulation` (`rolling_window_demo`,
`dynamic_obstacle_demo`, `product_mode_demo`) against the repository's
`examples/*.py` on the JAX package, on the CPU, as in
tests/test_torch_examples.py (which holds the other four): the JAX side
makes the JAX demo's calls on the port module's numpy scene for the first
TICKS ticks; commands agree within 1e-4 and goal distances within 1e-3.

The product demo's lanes are held up to their first termination tie: a
tick where the two sides' SQP took a different number of iterations (the
convergence test |f_k - f_k-1| < opt_tolerance falls on the other side of
its threshold on one side, from float32 orders of sums), after which the
lane's closed loop follows another trajectory. At most one of the 16 lanes
may tie within the prefix, no earlier than its third tick; every other
lane is held over all TICKS ticks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

import neo_mpc_planner2_tpu as mpc
from neo_mpc_planner2_tpu.scenarios import mpo700_footprint as jmpo700

from test_torch_examples import CMD_ATOL, DIST_ATOL, TICKS, _calls, _close


def test_rolling_window_demo_matches_jax():
    from neo_mpc_planner2_tpu.simulation import simulate_follow_path

    from neo_mpc_planner2_tpu_torch.examples import rolling_window_demo

    sc = rolling_window_demo.scene()
    assert _calls("rolling_window_demo", "config_from_ros_params") == [
        sc["params"]]
    cfg = mpc.config_from_ros_params(sc["params"]).replace(
        max_plan_points=128)
    plan = mpc.Plan.create(sc["plan"], max_points=128)
    world = mpc.Costmap.create(sc["grid"], origin=sc["origin"],
                               resolution=sc["resolution"])
    res = jax.jit(lambda: simulate_follow_path(
        cfg, plan, world, jmpo700(), jnp.zeros(3), jnp.zeros(3), TICKS,
        window_cells=64))()
    got = rolling_window_demo.run(TICKS, device="cpu")
    _close(got["cmds"], res.cmds, CMD_ATOL, "cmds")
    _close(got["goal_dist"], res.goal_dist, DIST_ATOL, "goal_dist")
    assert not got["lethal"].any() and not np.asarray(res.lethal).any()


def test_costmap_create_of_a_transposed_grid_is_contiguous():
    """The rolling demo's world is a transposed numpy grid: Costmap.create
    keeps its values and lays it out contiguously, as K3 reads it (on the
    card a strided map raises there)."""
    from neo_mpc_planner2_tpu_torch.examples import rolling_window_demo
    from neo_mpc_planner2_tpu_torch.ops.costmap import Costmap

    grid = rolling_window_demo.scene()["grid"]
    assert not grid.flags["C_CONTIGUOUS"]
    cm = Costmap.create(grid, origin=(-4.0, -2.0), device="cpu")
    assert cm.data.is_contiguous()
    np.testing.assert_array_equal(cm.data.numpy(), grid)


def test_dynamic_obstacle_demo_matches_jax():
    from neo_mpc_planner2_tpu.engine import init_state
    from neo_mpc_planner2_tpu.scenarios import ScenarioBatch
    from neo_mpc_planner2_tpu.simulation import batch_simulate

    from neo_mpc_planner2_tpu_torch.examples import dynamic_obstacle_demo

    sc = dynamic_obstacle_demo.scene()
    assert _calls("dynamic_obstacle_demo", "config_from_ros_params") == [
        sc["params"]]
    cfg = mpc.config_from_ros_params(sc["params"]).replace(
        max_plan_points=64)
    plan = mpc.Plan.create(sc["plan"], max_points=cfg.max_plan_points)
    B, M = 1, sc["map_cells"]
    lanes = lambda tree: jax.tree.map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), tree)
    sb = ScenarioBatch(
        state=lanes(init_state(cfg)), plan=lanes(plan),
        robot_pose=jnp.zeros((B, 3), jnp.float32),
        current_vel=jnp.zeros((B, 3), jnp.float32),
        costmap=mpc.Costmap(
            data=jnp.zeros((B, M, M), jnp.float32),
            origin=jnp.full((B, 2), sc["origin"], jnp.float32),
            resolution=jnp.full((B,), sc["resolution"], jnp.float32)),
        footprint=lanes(jmpo700()),
        delta_t=jnp.full((B,), 1 / 30, jnp.float32))
    obstacles = tuple(jnp.asarray(sc[k]) for k in ("centers", "amp", "vel"))
    res = jax.jit(lambda b: batch_simulate(
        cfg, b, TICKS, dynamic_obstacles=obstacles,
        obstacle_lethal_threshold=0.5))(sb)
    got = dynamic_obstacle_demo.run(TICKS, device="cpu")
    _close(got["cmds"], res.cmds[0], CMD_ATOL, "cmds")
    _close(got["goal_dist"], res.goal_dist[0], DIST_ATOL, "goal_dist")
    assert list(got["collisions"]) == list(np.asarray(res.collisions[0]))
    assert list(got["lethal"]) == list(np.asarray(res.lethal[0]))


def test_product_mode_demo_matches_jax():
    from neo_mpc_planner2_tpu.ops.costmap import (
        required_product_patch_halfwidth)
    from neo_mpc_planner2_tpu.scenarios import make_scenario_batch
    from neo_mpc_planner2_tpu.simulation import batch_simulate

    from neo_mpc_planner2_tpu_torch.examples import product_mode_demo as pm

    assert _calls("product_mode_demo", "dict") == [pm.SAMPLE]
    assert _calls("product_mode_demo", "make_scenario_batch") == [
        pm.SCENARIO]
    pcfg = mpc.product_config().replace(**pm.SAMPLE)
    pcfg = pcfg.replace(solver_costmap_patch=(
        required_product_patch_halfwidth(pcfg, 0.05, 0.46)))
    parity_cfg = mpc.fleet_config().replace(**pm.SAMPLE)
    tp_p, tp_r = pm.configs()
    assert dataclasses.asdict(tp_p) == dataclasses.asdict(pcfg)
    assert dataclasses.asdict(tp_r) == dataclasses.asdict(parity_cfg)
    sb = make_scenario_batch(pcfg, pm.N, **pm.SCENARIO)
    want = {"product": batch_simulate(pcfg, sb, TICKS, parity=False),
            "parity": batch_simulate(parity_cfg, sb, TICKS)}
    got = pm.run(TICKS, device="cpu")
    run = want["parity"]
    _close(got["parity"]["cmds"], run.cmds, CMD_ATOL, "parity cmds")
    _close(got["parity"]["goal_dist"], run.goal_dist, DIST_ATOL,
           "parity goal_dist")
    run = want["product"]
    tie = got["product"]["solver_iters"] != np.asarray(run.solver_iters)
    held = np.where(tie.any(1), tie.argmax(1), TICKS)
    assert (held < TICKS).sum() <= 1 and held.min() >= 3, held
    for lane, ticks in enumerate(held):
        for key, atol in (("cmds", CMD_ATOL), ("goal_dist", DIST_ATOL)):
            _close(got["product"][key][lane, :ticks],
                   np.asarray(getattr(run, key))[lane, :ticks], atol,
                   f"product {key}, lane {lane}")
