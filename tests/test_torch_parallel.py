"""The port's multi-device paths on the CPU.

- `parallel/sharding.py`: two OS processes, one a rank, join a gloo world
  of two and step one sharded fleet twice through
  `neo_mpc_planner2_tpu_torch.parallel.smoke`. Both ranks must print the
  same metrics (one all_reduce each), each rank's lanes must equal the
  one-process `MpcEngine.batch_step` on the same lanes, and the metrics
  must match the JAX package's ShardedEngine on a two-device CPU mesh
  within 1e-5. `make_mesh` refuses a world that does not tile; `shard_batch`
  a batch that does not divide.
- The server's sharded fleet: `OptimizerSession(device=("cpu", "cpu"))`
  splits 5 robots into shards of 3 and 2, one a device, each dispatched
  from its own host thread; `optimizer_batch` and `tick_batch` must answer
  exactly as with `device="cpu"`.
"""

import dataclasses
import os
import re
import socket
import subprocess
import sys
import time
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import neo_mpc_planner2_tpu as mpc
from neo_mpc_planner2_tpu.parallel.sharding import ShardedEngine as JSharded
from neo_mpc_planner2_tpu.parallel.sharding import make_mesh as jmake_mesh
from neo_mpc_planner2_tpu.scenarios import make_scenario_batch as jmake

import neo_mpc_planner2_tpu_torch as tp
from neo_mpc_planner2_tpu_torch.parallel import sharding
from neo_mpc_planner2_tpu_torch.parallel.smoke import smoke_config
from neo_mpc_planner2_tpu_torch.scenarios import make_scenario_batch
from neo_mpc_planner2_tpu_torch.serving import OptimizerSession

REPO = Path(__file__).resolve().parent.parent
METRICS = ("mean_cost", "max_iters", "converged_frac", "collision_frac",
           "lethal_frac", "mean_cmd_speed")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jcfg(cfg):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if f.name != "compat"}
    return mpc.MpcConfig(compat=mpc.CompatConfig(
        **dataclasses.asdict(cfg.compat)), **kw)


def test_two_process_fleet_step(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "neo_mpc_planner2_tpu_torch.parallel.smoke",
         str(r), "2", str(port), str(tmp_path / f"rank{r}.npz"),
         "--device", "cpu", "--batch", "8", "--steps", "2"],
        env=env, cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
        assert f"[rank {r}] OK" in out, out
        assert "mesh=(2, 1)" in out, out
    # The reduced metrics are global: both ranks print the same values.
    lines = [re.findall(r"step\d .*", o) for o in outs]
    assert len(lines[0]) == 2 and lines[0] == lines[1], lines

    # Each rank's lanes against the one-process engine on the same lanes.
    cfg = smoke_config()
    sb = make_scenario_batch(cfg, 8, seed=0, map_size=48, plan_points=24,
                             device="cpu")
    eng = tp.MpcEngine(cfg, device="cpu")
    state = eng.init_batch_state(8)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    # The JAX package's ShardedEngine on a two-device mesh, same config.
    jc = _jcfg(cfg)
    jeng = JSharded(jc, jmake_mesh(jax.devices()[:2], hosts=1),
                    donate_state=False)
    jsb = jmake(jc, 8, seed=0, map_size=48, plan_points=24)
    jstate = jeng.shard(jsb.state)
    jargs = tuple(jeng.shard(x) for x in (
        jsb.plan, jsb.robot_pose, jsb.current_vel, jsb.costmap,
        jsb.footprint, jsb.delta_t))
    for s in range(2):
        out = eng.batch_step(state, sb.plan, sb.robot_pose, sb.current_vel,
                             sb.costmap, sb.footprint, sb.delta_t)
        state = out.state
        for r, got in enumerate(ranks):
            lanes = slice(4 * r, 4 * r + 4)
            np.testing.assert_array_equal(got[f"cmd_vel{s}"],
                                          out.cmd_vel[lanes].numpy())
            np.testing.assert_array_equal(got[f"iters{s}"],
                                          out.solver_iters[lanes].numpy())
        local = sharding.fleet_metrics(out, distributed=False)
        np.testing.assert_array_equal(
            ranks[0][f"metrics{s}"],
            np.array([float(getattr(local, k)) for k in METRICS]))
        jout, jm = jeng.step(jstate, *jargs)
        jstate = jout.state
        np.testing.assert_allclose(
            ranks[0][f"metrics{s}"],
            np.array([float(getattr(jm, k)) for k in METRICS]),
            rtol=0, atol=1e-5)


def test_make_mesh_rejects_bad_topology():
    with pytest.raises(ValueError, match="do not tile"):
        sharding.make_mesh(["cpu"] * 8, hosts=3)
    with pytest.raises(ValueError, match="do not tile"):
        sharding.make_mesh(["cpu"] * 2, hosts=0)
    # A world that tiles still needs a process group.
    with pytest.raises(RuntimeError, match="process group"):
        sharding.make_mesh(["cpu"] * 8, hosts=2)


def test_shard_batch_takes_this_ranks_slice():
    mesh = types.SimpleNamespace(size=lambda: 4, get_rank=lambda: 2,
                                 device_type="cpu")
    tree = {"a": torch.arange(16.0).reshape(8, 2), "b": (torch.arange(8),)}
    got = sharding.shard_batch(tree, mesh)
    np.testing.assert_array_equal(got["a"].numpy(), [[8, 9], [10, 11]])
    np.testing.assert_array_equal(got["b"][0].numpy(), [4, 5])
    with pytest.raises(ValueError, match="does not divide"):
        sharding.shard_batch(torch.zeros(6), mesh)


def _staged(device, fleet_chunk=0):
    """A session on `device` with the generator's first map and MPO-700
    staged, and 5 robots' requests and plans from the same batch."""
    cfg = smoke_config()
    sb = make_scenario_batch(cfg, 5, seed=4, map_size=48, plan_points=24,
                             device="cpu")
    sess = OptimizerSession(cfg, device=device, fleet_chunk=fleet_chunk)
    sess.handle({"op": "set_costmap", "data": sb.costmap.data[0].tolist(),
                 "origin": sb.costmap.origin[0].tolist(),
                 "resolution": float(sb.costmap.resolution[0])})
    nv = int(sb.footprint.n_valid[0])
    sess.handle({"op": "set_footprint",
                 "points": sb.footprint.vertices[0, :nv].tolist()})
    return sess, sb


def _fleet_script(sess, sb):
    n = sb.robot_pose.shape[0]
    poses = [sb.plan.poses[i, :int(sb.plan.n_valid[i])].tolist()
             for i in range(n)]
    robots = [{"current_pose": sb.robot_pose[i].tolist(),
               "carrot_pose": [0.4, 0.05, 0.1],
               "goal_pose": poses[i][-1],
               "current_vel": sb.current_vel[i].tolist()}
              for i in range(n)]
    replies = []
    # Two ticks, a shrink to 3 robots (one shard of 2, one of 1) and a
    # regrow: the surviving lanes keep their state across the re-split.
    for group in (robots, robots, robots[:3], robots):
        replies.append(sess.handle({"op": "optimizer_batch",
                                    "robots": group, "delta_t": 0.05}))
    replies.append(sess.handle({"op": "set_plans", "plans": poses}))
    for _ in range(2):
        replies.append(sess.handle({"op": "tick_batch", "delta_t": 0.05,
                                    "robots": [{"pose": r["current_pose"],
                                                "vel": r["current_vel"]}
                                               for r in robots]}))
    return replies


@pytest.mark.parametrize("fleet_chunk", [0, 2])
def test_server_shards_fleet_lanes_like_one_device(fleet_chunk):
    """5 robots over two devices (shards of 3 and 2; with fleet_chunk=2 the
    shard of 3 runs as chunks of 2 and 1) answer as on one device."""
    one, sb = _staged("cpu")
    two, _ = _staged(("cpu", "cpu"), fleet_chunk)
    assert len(two.devices) == 2 and len(one.devices) == 1
    want, got = _fleet_script(one, sb), _fleet_script(two, sb)
    for w, g in zip(want, got):
        assert "error" not in g, g
        assert g == w
    np.testing.assert_array_equal(two._fleet_state.initial_guess.numpy(),
                                  one._fleet_state.initial_guess.numpy())


def test_lane_cache_builds_once_under_shard_threads(monkeypatch):
    """Eight shards of two lanes on eight "devices" (all the CPU) ask for
    the same lane batch from eight threads at once, with a short switch
    interval: the locked cache builds it once."""
    sess, sb = _staged(("cpu",) * 8)
    builds = []
    build = sess._build_lanes

    def slow_build(lanes, dev):
        # A wide window between the cache lookup and its fill.
        builds.append((lanes, dev))
        time.sleep(0.05)
        return build(lanes, dev)

    monkeypatch.setattr(sess, "_build_lanes", slow_build)
    robots = [{"current_pose": [0.0, 0.0, 0.0], "carrot_pose": [0.4, 0, 0],
               "goal_pose": [1.0, 0.0, 0.0], "current_vel": [0.0, 0, 0]}
              for _ in range(16)]
    interval = sys.getswitchinterval()
    try:
        sys.setswitchinterval(1e-6)
        reply = sess.handle({"op": "optimizer_batch", "robots": robots,
                             "delta_t": 0.05})
    finally:
        sys.setswitchinterval(interval)
    assert "error" not in reply and len(reply["results"]) == 16
    assert builds == [(2, torch.device("cpu"))]
