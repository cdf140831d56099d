"""The port's server on the wire and its neighbours, against the JAX package.

- The JAX package's OptimizerClient drives the port's `serve` over TCP on a
  free local port: the same responses as the port's session in-process,
  robot slots and `release`, checkpoints confined to checkpoint_dir.
- Checkpoints cross between the packages in both directions, one lane and
  a fleet, through `checkpoint` and through the servers' save_state /
  load_state ops; a padded JAX fleet checkpoint loads into the port (as
  .npz files; directories: tests/test_torch_checkpoint.py).
- `solve_step` and `controller_step` against JAX's on the same numpy
  inputs, in parity and product mode: commands within 1e-4 (the golden
  gate).
- The port's top-level names against the JAX package's.
- The deliberate divergence of the `optimizer` op: JAX creates a robot's
  slot before it refuses a non-finite delta_t (and may evict another
  robot's state); the port refuses first.
"""

import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neo_mpc_planner2_tpu as mpc
from neo_mpc_planner2_tpu import checkpoint as jckpt
from neo_mpc_planner2_tpu import config as jconfig
from neo_mpc_planner2_tpu.engine import controller_step as jcontroller_step
from neo_mpc_planner2_tpu.engine import solve_step as jsolve_step
from neo_mpc_planner2_tpu.serving import OptimizerClient as JaxClient
from neo_mpc_planner2_tpu.serving import OptimizerSession as JaxSession

import neo_mpc_planner2_tpu_torch as tp
from neo_mpc_planner2_tpu_torch import checkpoint as tckpt
from neo_mpc_planner2_tpu_torch import config as tconfig
from neo_mpc_planner2_tpu_torch import interop
from neo_mpc_planner2_tpu_torch.ops import objective as tobj
from neo_mpc_planner2_tpu_torch.serving import OptimizerSession, serve

from test_torch_serving import (FOOTPRINT, STAGE, _batch, _map, _opt,
                                _params)

# Names of the JAX package that wait for a module still to port.
NOT_YET_PORTED = set()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def wire(tmp_path_factory):
    """The port's server on the CPU in a thread, with a checkpoint
    directory, and the JAX package's client connected to it."""
    ckpt = tmp_path_factory.mktemp("ckpt")
    port = _free_port()
    ready = threading.Event()
    threading.Thread(target=serve, daemon=True, kwargs=dict(
        port=port, cfg=tconfig.config_from_ros_params(_params()),
        ready_event=ready, checkpoint_dir=str(ckpt), max_slots=3,
        device="cpu")).start()
    assert ready.wait(30)
    client = JaxClient(port=port)
    yield client, ckpt
    client.close()


def test_jax_client_drives_the_port_server(wire):
    client, _ = wire
    local = OptimizerSession(tconfig.config_from_ros_params(_params()),
                             device="cpu")
    for msg in STAGE + [_opt(0), _opt(0), _batch(3),
                        {"op": "set_costmap_update", "data": np.ones(
                            (3, 3)), "lo": [10, 10]},
                        _batch(3), {"bad": 1}]:
        # The client encodes numpy arrays (_json_default) as lists.
        got = client.call(msg)
        want = local.handle({**msg, "data": msg["data"].tolist()}
                            if isinstance(msg.get("data"), np.ndarray)
                            else msg)
        assert got == want
    assert client.call({"op": "ping"})["backend"] == "cpu"


def test_slots_and_release_over_the_wire(wire):
    client, _ = wire
    for rid in ("r1", "r2"):
        assert "output_vel" in client.call(_opt(0, robot=rid))
    r = client.call({"op": "release", "robot": "r1"})
    assert r["ok"] and r["released"]
    r = client.call({"op": "release", "robot": "r1"})
    assert r["ok"] and not r["released"]
    # max_slots=3: a fourth robot evicts the least recently used.
    for rid in ("r3", "r4", "r5"):
        client.call(_opt(1, robot=rid))
    assert client.call({"op": "ping"})["slots"] == 3


def test_checkpoint_ops_over_the_wire(wire):
    client, ckpt = wire
    client.call(_opt(0, robot="cp"))
    assert client.call({"op": "save_state", "path": "one.npz",
                        "robot": "cp"}) == {"ok": True, "fleet": False}
    assert (ckpt / "one.npz").is_file()
    assert client.call({"op": "load_state", "path": "one.npz",
                        "robot": "cp2"}) == {"ok": True, "fleet": False}
    client.call(_batch(3))
    r = client.call({"op": "save_state", "path": "fleet.npz", "fleet": True})
    assert r == {"ok": True, "fleet": True, "lanes": 3, "robots": 3}
    r = client.call({"op": "load_state", "path": "fleet.npz", "fleet": True,
                     "robots": 2})
    assert r == {"ok": True, "fleet": True, "lanes": 3, "robots": 2}
    assert "error" in client.call({"op": "save_state", "path": "../x.npz"})
    assert "error" in client.call({"op": "load_state", "path": "nope.npz"})
    # A name without .npz is a torch.distributed.checkpoint directory.
    assert client.call({"op": "save_state", "path": "dir",
                        "robot": "cp"}) == {"ok": True, "fleet": False}
    assert (ckpt / "dir" / ".metadata").is_file()


def _staged_jax(**kw):
    s = JaxSession(jconfig.config_from_ros_params(_params()), **kw)
    for msg in STAGE:
        s.handle(msg)
    return s


def _staged_port(**kw):
    s = OptimizerSession(tconfig.config_from_ros_params(_params()),
                         device="cpu", **kw)
    for msg in STAGE:
        s.handle(msg)
    return s


def test_server_checkpoints_cross_packages(tmp_path):
    """A JAX server's save_state loads into the port's server, and the
    reverse, for a robot slot and for a (padded) fleet: the next solve
    answers as it would have in the saving server."""
    d = str(tmp_path)
    jax_s, port = _staged_jax(checkpoint_dir=d), _staged_port(checkpoint_dir=d)
    for s in (jax_s, port):
        s.handle(_opt(0))
        s.handle(_batch(3))
    jax_s.handle({"op": "save_state", "path": "j1.npz"})
    port.handle({"op": "save_state", "path": "p1.npz"})
    r = jax_s.handle({"op": "save_state", "path": "jf.npz", "fleet": True})
    assert (r["lanes"], r["robots"]) == (8, 3)      # padded to the mesh
    port.handle({"op": "save_state", "path": "pf.npz", "fleet": True})

    fresh_j, fresh_p = (_staged_jax(checkpoint_dir=d),
                        _staged_port(checkpoint_dir=d))
    assert fresh_p.handle({"op": "load_state", "path": "j1.npz"})["ok"]
    assert fresh_j.handle({"op": "load_state", "path": "p1.npz"})["ok"]
    r = fresh_p.handle({"op": "load_state", "path": "jf.npz", "fleet": True,
                        "robots": 3})
    assert r == {"ok": True, "fleet": True, "lanes": 8, "robots": 3}
    assert fresh_j.handle({"op": "load_state", "path": "pf.npz",
                           "fleet": True})["ok"]
    nxt = _opt(0)
    a, b = jax_s.handle(nxt), fresh_p.handle(nxt)
    np.testing.assert_allclose(b["output_vel"], a["output_vel"], atol=1e-4)
    a, b = port.handle(nxt), fresh_j.handle(nxt)
    np.testing.assert_allclose(b["output_vel"], a["output_vel"], atol=1e-4)
    a, b = jax_s.handle(_batch(3)), fresh_p.handle(_batch(3))
    for x, y in zip(a["results"], b["results"]):
        np.testing.assert_allclose(y["output_vel"], x["output_vel"],
                                   atol=1e-4)


@pytest.mark.parametrize("lanes", [None, 5], ids=["one", "fleet"])
def test_npz_checkpoints_cross_packages(tmp_path, lanes):
    """checkpoint.save_state / load_state: an npz the JAX package wrote
    loads into the port with the same arrays, and the reverse."""
    rng = np.random.default_rng(3)
    lead = () if lanes is None else (lanes,)
    arrays = dict(
        initial_guess=rng.normal(size=lead + (9,)).astype(np.float32),
        last_control=rng.normal(size=lead + (3,)).astype(np.float32),
        waiting_time=rng.uniform(0, 3, lead).astype(np.float32),
        collision=rng.random(lead) < 0.5,
        old_goal=rng.normal(size=lead + (3,)).astype(np.float32),
        has_old_goal=rng.random(lead) < 0.5,
        slow_down=rng.random(lead) < 0.5,
        plan_start=rng.integers(0, 9, lead).astype(np.int32))
    jstate = mpc.ControlState(**{k: jnp.asarray(v)
                                 for k, v in arrays.items()})
    jckpt.save_state(str(tmp_path / "j.npz"), jstate)
    got = tckpt.load_state(str(tmp_path / "j.npz"), device="cpu")
    for k, v in arrays.items():
        t = getattr(got, k)
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), v)
        assert t.numpy().dtype == v.dtype
    tckpt.save_state(str(tmp_path / "p.npz"), got)
    back = jckpt.load_state(str(tmp_path / "p.npz"))
    for k, v in arrays.items():
        np.testing.assert_array_equal(np.asarray(getattr(back, k)), v)


def test_load_state_defaults_to_the_card(tmp_path):
    st = tp.init_state(tconfig.default_config(), device="cpu")
    tckpt.save_state(str(tmp_path / "s.npz"), st)
    if torch.cuda.is_available():
        assert tckpt.load_state(str(tmp_path / "s.npz")).initial_guess.is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            tckpt.load_state(str(tmp_path / "s.npz"))


def _lane_inputs(jcfg):
    """One robot's inputs, JAX and port: a 40² map with an obstacle band,
    the MPO-700 footprint, a 12-pose plan; a warm state from one step."""
    data = np.asarray(_map(), np.float32)
    jcm = mpc.Costmap.create(data, origin=(-1.0, -1.0), resolution=0.05)
    jfp = mpc.Footprint.create(np.asarray(FOOTPRINT))
    t = np.linspace(0, 1, 12)
    poses = np.stack([-0.3 + 0.9 * t, 0.4 * t * t, 0.3 * t], -1)
    jplan = mpc.Plan.create(poses, max_points=jcfg.max_plan_points)
    n = lambda tree: jax.tree.map(np.asarray, tree)
    port = dict(costmap=interop.costmap_from_numpy(n(jcm), device="cpu"),
                footprint=interop.footprint_from_numpy(n(jfp), device="cpu"),
                plan=interop.plan_from_numpy(n(jplan), device="cpu"))
    return dict(costmap=jcm, footprint=jfp, plan=jplan), port


@pytest.mark.parametrize("parity", [True, False], ids=["parity", "product"])
def test_solve_and_controller_step_match_jax(parity):
    p = _params()
    if not parity:
        p.update(parallel_line_search=True, solver_ls_quad_interp=False)
    jcfg, tcfg = (jconfig.config_from_ros_params(p),
                  tconfig.config_from_ros_params(p))
    j, t = _lane_inputs(jcfg)
    T = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    pose, vel = [-0.3, 0.02, 0.05], [0.1, 0.0, 0.0]

    # controller_step, three warm-started ticks.
    jst, tst = mpc.init_state(jcfg), tp.init_state(tcfg, device="cpu")
    jstep = jax.jit(lambda st, ps: jcontroller_step(
        jcfg, st, j["plan"], ps, jnp.asarray(vel), j["costmap"],
        j["footprint"], jnp.float32(0.033), parity=parity))
    for k in range(3):
        ps = [pose[0] + 0.02 * k, pose[1], pose[2]]
        jo = jstep(jst, jnp.asarray(ps, jnp.float32))
        to = tp.controller_step(tcfg, tst, t["plan"], T(ps), T(vel),
                                t["costmap"], t["footprint"], 0.033,
                                parity=parity)
        np.testing.assert_allclose(to.cmd_vel.numpy(), np.asarray(jo.cmd_vel),
                                   atol=1e-4)
        assert to.cmd_vel.shape == (3,)
        assert bool(to.lethal) == bool(jo.lethal)
        assert int(to.plan_window_end) == int(jo.plan_window_end)
        jst, tst = jo.state, to.state

    # solve_step on the scenario the tick built, with and without a solver.
    scen_j = mpc.Scenario.create(pose, [0.4, 0.05, 0.1], [0.6, 0.3, 0.2], vel,
                                 j["footprint"], j["costmap"],
                                 control_interval=0.033)
    scen_t = tobj.Scenario(
        current_pose=T(pose), carrot_pose=T([0.4, 0.05, 0.1]),
        goal_pose=T([0.6, 0.3, 0.2]), current_vel=T(vel),
        footprint=t["footprint"], costmap=t["costmap"],
        switch_opt=torch.tensor(False), control_interval=T(0.033))
    jo = jax.jit(lambda st, sc: jsolve_step(jcfg, st, sc, jnp.float32(0.033),
                                            parity=parity))(jst, scen_j)
    solver = tp.make_sqp_solver(tcfg, tp.make_objective(tcfg, parity))
    for kw in ({}, {"solver": solver}):
        to = tp.solve_step(tcfg, tst, scen_t, 0.033, parity=parity, **kw)
        np.testing.assert_allclose(to.cmd_vel.numpy(),
                                   np.asarray(jo.cmd_vel), atol=1e-4)
        np.testing.assert_allclose(to.state.initial_guess.numpy(),
                                   np.asarray(jo.state.initial_guess),
                                   atol=1e-3)
        assert bool(to.collision_footprint) == bool(jo.collision_footprint)


def test_top_level_names_match_jax():
    """Every name the JAX package exports, the port exports, except those
    of modules still to port (ROADMAP.md, Queue 1)."""
    missing = set(mpc.__all__) - set(tp.__all__)
    assert missing == NOT_YET_PORTED
    for name in set(mpc.__all__) - NOT_YET_PORTED:
        assert getattr(tp, name) is not None


def test_rejected_delta_t_divergence():
    """JAX: a non-finite delta_t is refused after the robot's slot is
    created, which LRU-evicts another robot. The port refuses before, so
    both robots' states survive."""
    bad = _opt(0, robot="c", delta_t=float("inf"))
    for s, evicts in ((_staged_jax(max_slots=2), True),
                      (_staged_port(max_slots=2), False)):
        for rid in ("a", "b"):
            s.handle(_opt(0, robot=rid))
        assert s.handle(bad) == {"error": "delta_t is not finite"}
        assert ("a" not in s._slots) == evicts
        assert ("c" in s._slots) == evicts
