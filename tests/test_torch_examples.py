"""The port's demos (`neo_mpc_planner2_tpu_torch.examples`) against the
repository's `examples/*.py` on the JAX package, on the CPU: here the four
on the controller, the sharded engine and the server, and every demo's
refusal to start without a card; tests/test_torch_examples_sim.py holds
the three on `simulation`.

For each demo the scene is the port module's numpy scene, built once; the
JAX side makes the calls the JAX demo makes (its config, its engine or
controller or session, its loop) on that scene for the first TICKS ticks,
and the port's `run(..., ticks=TICKS, device="cpu")` makes them through
the port. Commands agree within 1e-4 and goal distances within 1e-3 (the
golden gates of tests/test_golden.py). The constants the port copied (the
ROS parameters, the config overrides, the scenario arguments) are read
from the JAX demos' source with `ast` and held equal.

The two demos that serve (`serving_demo`, `live_costmap_demo`) run their
client loops against the JAX package's and the port's `OptimizerSession`
in this process, then once over a socket: `serving_demo`'s own child
server (`cli.server_main --device cpu`) and the port's `serve` in a thread
for `live_costmap_demo`, which must answer as the in-process session did.
"""

import ast
import dataclasses
import pathlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import neo_mpc_planner2_tpu as mpc
from neo_mpc_planner2_tpu.ops.rollout import rollout as jrollout
from neo_mpc_planner2_tpu.scenarios import mpo700_footprint as jmpo700
from neo_mpc_planner2_tpu.utils.se2_np import integrate_cmd_np

from neo_mpc_planner2_tpu_torch import examples
from neo_mpc_planner2_tpu_torch.examples import (
    fleet_demo, follow_path_demo, live_costmap_demo, serving_demo)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TICKS = 20
CMD_ATOL, DIST_ATOL = 1e-4, 1e-3


def _calls(demo: str, name: str) -> list:
    """The calls of `name` (a function or method) in examples/<demo>.py:
    each call's literal first argument or, where that is not a literal,
    its literal keyword arguments as a dict."""
    tree = ast.parse((ROOT / "examples" / f"{demo}.py").read_text())
    out = []
    for node in ast.walk(tree):
        f = getattr(node, "func", None)
        if f is None or (f.attr if isinstance(f, ast.Attribute)
                         else getattr(f, "id", None)) != name:
            continue
        try:
            out.append(ast.literal_eval(node.args[0]))
            continue
        except (IndexError, ValueError):
            pass
        kw = {}
        for k in node.keywords:
            try:
                kw[k.arg] = ast.literal_eval(k.value)
            except ValueError:
                pass
        if kw:
            out.append(kw)
    return out


def _close(got, want, atol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=what)


def test_every_demo_is_a_module_of_the_same_name():
    jax_demos = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))
    assert sorted(examples.NAMES) == jax_demos
    for name in examples.NAMES:
        mod = __import__(f"neo_mpc_planner2_tpu_torch.examples.{name}",
                         fromlist=["run", "main"])
        assert callable(mod.run) and callable(mod.main), name


# ---- follow_path_demo: NeoMpcController (examples/follow_path_demo.py) ----

def test_follow_path_demo_matches_jax():
    sc = follow_path_demo.scene()
    assert _calls("follow_path_demo", "config_from_ros_params") == [
        sc["params"]]
    cfg = mpc.config_from_ros_params(sc["params"])
    ctrl = mpc.NeoMpcController()
    ctrl.configure(cfg, costmap=mpc.Costmap.create(
        sc["grid"], origin=sc["origin"], resolution=sc["resolution"]),
        footprint=jmpo700())
    ctrl.activate()
    ctrl.set_plan(sc["plan"])
    pose, vel, cmds, dists = np.zeros(3), np.zeros(3), [], []
    for _ in range(TICKS):
        cmd = ctrl.compute_velocity_commands(pose, vel, sc["dt"])
        pose = integrate_cmd_np(pose, cmd, sc["dt"])
        vel = cmd
        cmds.append(cmd)
        dists.append(np.linalg.norm(pose[:2] - sc["plan"][-1, :2]))
    got = follow_path_demo.run(TICKS, device="cpu")
    _close(got["cmds"], cmds, CMD_ATOL, "cmds")
    _close(got["goal_dist"], dists, DIST_ATOL, "goal_dist")
    assert got["reached_tick"] == -1


# ---- fleet_demo: ShardedEngine over make_mesh() (examples/fleet_demo.py) --

def test_fleet_demo_matches_jax_sharded_engine():
    from neo_mpc_planner2_tpu.parallel.sharding import (ShardedEngine,
                                                        make_mesh)
    from neo_mpc_planner2_tpu.scenarios import make_scenario_batch

    [overrides] = _calls("fleet_demo", "replace")
    cfg = mpc.default_config().replace(**overrides)
    assert dataclasses.asdict(fleet_demo.config()) == dataclasses.asdict(cfg)
    batch = 8
    eng = ShardedEngine(cfg, make_mesh())
    sb = make_scenario_batch(cfg, batch, seed=7, map_size=64,
                             plan_points=48)
    state, plan = eng.shard(sb.state), eng.shard(sb.plan)
    rest = tuple(eng.shard(x) for x in (sb.robot_pose, sb.current_vel,
                                        sb.costmap, sb.footprint, sb.delta_t))
    poses = rest[0]
    integrate = jax.jit(jax.vmap(lambda p, c: jrollout(
        c[None, :], jnp.float32(cfg.control_interval), p)[0]))
    cmds, speeds = [], []
    for _ in range(TICKS):
        out, metrics = eng.step(state, plan, poses, *rest[1:])
        state = out.state
        poses = integrate(poses, out.cmd_vel)
        cmds.append(np.asarray(out.cmd_vel))
        speeds.append(float(metrics.mean_cmd_speed))
    got = fleet_demo.run(batch, TICKS, device="cpu")
    assert got["mesh_shape"] == (1, 1) and got["world"] == 1
    _close(got["cmds"], cmds, CMD_ATOL, "cmds")
    _close(got["mean_cmd_speed"], speeds, CMD_ATOL, "mean_cmd_speed")


# ---- serving_demo: the server's optimizer / optimizer_batch ops ----------

def test_serving_demo_matches_jax_session_and_its_child_server():
    from neo_mpc_planner2_tpu.serving import OptimizerSession as JSession

    from neo_mpc_planner2_tpu_torch.serving import OptimizerSession

    configure = [m for m in _calls("serving_demo", "call")
                 if isinstance(m, dict) and m.get("op") == "configure"]
    assert configure == [serving_demo.setup_messages()[0]]
    want = serving_demo.run(TICKS, fleet_ticks=TICKS,
                            call=JSession().handle)
    got = serving_demo.run(TICKS, fleet_ticks=TICKS,
                           call=OptimizerSession(device="cpu").handle)
    for key in ("cmds", "fleet_cmds"):
        _close(got[key], want[key], CMD_ATOL, key)
    for key in ("goal_dist", "fleet_goal_dist"):
        _close(got[key], want[key], DIST_ATOL, key)
    # The demo's own deployment: the console script in a child process.
    wire = serving_demo.run(3, device="cpu", fleet_ticks=3)
    assert wire["ping"]["ok"] and wire["ping"]["backend"] == "cpu"
    _close(wire["cmds"], got["cmds"][:3], 1e-6, "wire cmds")
    _close(wire["fleet_cmds"], got["fleet_cmds"][:3], 1e-6, "wire fleet")


# ---- live_costmap_demo: set_costmap_update + tick in a session -----------

def test_live_costmap_demo_matches_jax_session_and_answers_over_a_socket():
    from neo_mpc_planner2_tpu.serving import OptimizerSession as JSession

    from neo_mpc_planner2_tpu_torch.config import config_from_ros_params
    from neo_mpc_planner2_tpu_torch.serving import OptimizerClient, serve
    from neo_mpc_planner2_tpu_torch.utils.entrypoints import free_port

    assert _calls("live_costmap_demo", "config_from_ros_params") == [
        live_costmap_demo.params()]
    jcfg = mpc.config_from_ros_params(
        live_costmap_demo.params()).replace(max_plan_points=64)
    want = live_costmap_demo.run(TICKS, call=JSession(jcfg).handle)
    got = live_costmap_demo.run(TICKS, device="cpu")
    _close(got["cmds"], want["cmds"], CMD_ATOL, "cmds")
    _close(got["goal_dist"], want["goal_dist"], DIST_ATOL, "goal_dist")
    assert list(got["latched"]) == list(want["latched"])
    assert list(got["lethal"]) == list(want["lethal"])

    port, ready = free_port(), threading.Event()
    cfg = config_from_ros_params(
        live_costmap_demo.params()).replace(max_plan_points=64)
    threading.Thread(target=serve, daemon=True, kwargs=dict(
        host="127.0.0.1", port=port, cfg=cfg, ready_event=ready,
        device="cpu")).start()
    assert ready.wait(30)
    client = OptimizerClient(port=port, wait_timeout=30)
    try:
        wire = live_costmap_demo.run(3, call=client.call)
    finally:
        client.close()
    _close(wire["cmds"], got["cmds"][:3], 1e-6, "wire cmds")


@pytest.mark.parametrize("name", examples.NAMES)
def test_demo_refuses_to_start_without_a_card(name, monkeypatch):
    """Without --device cpu, on a machine without a card, each demo raises
    before it runs anything."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = __import__(f"neo_mpc_planner2_tpu_torch.examples.{name}",
                     fromlist=["main"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
