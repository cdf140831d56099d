"""The port's directory checkpoints (`checkpoint.py`): a ControlState as a
`torch.distributed.checkpoint` directory, where the JAX package writes an
orbax one.

- One writer: a batched and a single-lane state round-trip bit for bit,
  dtypes kept, with and without a template; a template that does not match
  raises; a save replaces what the directory held.
- An orbax directory written by the JAX package is refused with a message
  that names .npz, the format the packages share.
- The port's server under the JAX package's OptimizerClient: fleet and
  per-robot save_state / load_state with directory names answer as the
  .npz route does, and the solve after either load is the one the saved
  state gave.
- Two gloo ranks: the rank script's --checkpoint run saves its shards at
  world 2 over a (2, 1) mesh, and its step resumed from the loaded shard
  equals the uninterrupted one; the directory loads whole, with no process
  group, bit-equal to the ranks' states; a save at world 1 loads into the
  shards of a (1, 2) mesh of two ranks equal to shard_batch's, and their
  collective save loads whole equal to the state.
"""

import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neo_mpc_planner2_tpu as mpc
from neo_mpc_planner2_tpu import checkpoint as jckpt
from neo_mpc_planner2_tpu.serving import OptimizerClient as JaxClient

import neo_mpc_planner2_tpu_torch as tp
from neo_mpc_planner2_tpu_torch import checkpoint as tckpt
from neo_mpc_planner2_tpu_torch import config as tconfig
from neo_mpc_planner2_tpu_torch.serving import serve

from test_torch_serving import STAGE, _batch, _opt, _params

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _arrays(lanes, seed=3, m=9):
    """A ControlState's fields as numpy arrays with random values of every
    field's dtype (float32, bool, int32); lanes None is one lane."""
    rng = np.random.default_rng(seed)
    lead = () if lanes is None else (lanes,)
    return dict(
        initial_guess=rng.normal(size=lead + (m,)).astype(np.float32),
        last_control=rng.normal(size=lead + (3,)).astype(np.float32),
        waiting_time=rng.uniform(0, 3, lead).astype(np.float32),
        collision=rng.random(lead) < 0.5,
        old_goal=rng.normal(size=lead + (3,)).astype(np.float32),
        has_old_goal=rng.random(lead) < 0.5,
        slow_down=rng.random(lead) < 0.5,
        plan_start=rng.integers(0, 9, lead).astype(np.int32))


def _state(arrays):
    return tp.ControlState(**{k: torch.as_tensor(v)
                              for k, v in arrays.items()})


def _assert_state_equals(state, arrays):
    for k, v in arrays.items():
        t = getattr(state, k)
        assert t.device.type == "cpu", k
        assert t.numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(t.numpy(), v, k)


@pytest.mark.parametrize("with_template", [False, True],
                         ids=["metadata", "template"])
@pytest.mark.parametrize("lanes", [None, 6], ids=["one", "fleet"])
def test_directory_round_trip_is_bit_equal(tmp_path, lanes, with_template):
    arrays = _arrays(lanes)
    state = _state(arrays)
    path = str(tmp_path / "state")
    tckpt.save_state(path, state)
    assert os.path.isfile(os.path.join(path, ".metadata"))
    back = tckpt.load_state(path, template=state if with_template else None,
                            device="cpu")
    _assert_state_equals(back, arrays)


def test_template_must_match(tmp_path):
    path = str(tmp_path / "fleet")
    tckpt.save_state(path, _state(_arrays(6)))
    with pytest.raises(ValueError, match="initial_guess"):
        tckpt.load_state(path, template=_state(_arrays(5)), device="cpu")
    with pytest.raises(ValueError, match="plan_start"):
        tckpt.load_state(path, template=_state(_arrays(6)).replace(
            plan_start=torch.zeros(6, dtype=torch.int64)), device="cpu")
    with pytest.raises(FileNotFoundError):
        tckpt.load_state(str(tmp_path / "nothing"), device="cpu")
    with pytest.raises(ValueError, match="directory"):
        tckpt.save_state(str(tmp_path / "f.npz"), _state(_arrays(6)),
                         mesh=object())


def test_save_replaces_the_directory(tmp_path):
    path = tmp_path / "state"
    tckpt.save_state(str(path), _state(_arrays(6)))
    (path / "__7_0.distcp").write_bytes(b"a larger world's shard")
    arrays = _arrays(None, seed=5)
    tckpt.save_state(str(path), _state(arrays))
    assert sorted(os.listdir(path)) == [".metadata", "__0_0.distcp"]
    assert not (tmp_path / "state.partial").exists()
    _assert_state_equals(tckpt.load_state(str(path), device="cpu"), arrays)


@pytest.mark.parametrize("lanes", [None, 4], ids=["one", "fleet"])
def test_jax_orbax_directory_is_refused(tmp_path, lanes):
    arrays = _arrays(lanes)
    path = str(tmp_path / "orbax")
    jckpt.save_state(path, mpc.ControlState(
        **{k: jnp.asarray(v) for k, v in arrays.items()}))
    assert os.path.isdir(path)
    with pytest.raises(ValueError, match=r"\.npz"):
        tckpt.load_state(path, device="cpu")
    # The shared format carries the same state across.
    jckpt.save_state(str(tmp_path / "j.npz"), jckpt.load_state(path))
    _assert_state_equals(tckpt.load_state(str(tmp_path / "j.npz"),
                                          device="cpu"), arrays)


@pytest.fixture
def wire(tmp_path):
    """The port's server on the CPU in a thread with a checkpoint directory,
    the JAX package's client connected, the map and footprint staged."""
    port = _free_port()
    ready = threading.Event()
    threading.Thread(target=serve, daemon=True, kwargs=dict(
        port=port, cfg=tconfig.config_from_ros_params(_params()),
        ready_event=ready, checkpoint_dir=str(tmp_path),
        device="cpu")).start()
    assert ready.wait(30)
    client = JaxClient(port=port)
    for msg in STAGE:
        client.call(msg)
    yield client, tmp_path
    client.close()


def test_server_fleet_directory_checkpoint_matches_npz(wire):
    client, ckpt = wire
    client.call(_batch(3))
    client.call(_batch(3))
    saved = {name: client.call({"op": "save_state", "path": name,
                                "fleet": True})
             for name in ("fleet.npz", "fleet_dir")}
    assert saved["fleet_dir"] == saved["fleet.npz"] == {
        "ok": True, "fleet": True, "lanes": 3, "robots": 3}
    assert (ckpt / "fleet_dir" / ".metadata").is_file()
    # The next solve from the saved state; each load rewinds to it.
    answers = {"saved": client.call(_batch(3))}
    for name in ("fleet_dir", "fleet.npz"):
        loaded = client.call({"op": "load_state", "path": name,
                              "fleet": True})
        assert loaded == saved[name]
        answers[name] = client.call(_batch(3))
    assert "error" not in answers["saved"]
    assert answers["fleet_dir"] == answers["fleet.npz"] == answers["saved"]
    assert client.call(_batch(3)) != answers["saved"]


def test_server_robot_directory_checkpoint_matches_npz(wire):
    client, ckpt = wire
    client.call(_opt(0, robot="a"))
    client.call(_opt(1, robot="a"))
    for name in ("a.npz", "a_dir"):
        assert client.call({"op": "save_state", "path": name,
                            "robot": "a"}) == {"ok": True, "fleet": False}
    answers = {"saved": client.call(_opt(1, robot="a"))}
    for name, rid in (("a_dir", "b"), ("a.npz", "c")):
        assert client.call({"op": "load_state", "path": name,
                            "robot": rid}) == {"ok": True, "fleet": False}
        answers[name] = client.call(_opt(1, robot=rid))
    assert "error" not in answers["saved"]
    assert answers["a_dir"] == answers["a.npz"] == answers["saved"]
    # A fresh slot answers otherwise: the loads carried the warm state.
    assert client.call(_opt(1, robot="fresh")) != answers["saved"]
    # The directory save's target is an entry inside checkpoint_dir.
    for name in (".", "", "sub/.."):
        assert "error" in client.call({"op": "save_state", "path": name,
                                       "robot": "a"})
    assert "error" in client.call({"op": "load_state", "path": "no_dir",
                                   "robot": "a"})
    assert (ckpt / "a.npz").is_file()


def _run_ranks(argv_of, tmp_path, world=2):
    """`world` processes, argv_of(rank) each, their output and rcs."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    procs = [subprocess.Popen(argv_of(r), env=env, cwd=tmp_path,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
        assert f"[rank {r}] OK" in out, out
    return outs


def test_two_ranks_save_resume_and_load_whole(tmp_path):
    port, ckpt = _free_port(), tmp_path / "ckpt"
    _run_ranks(lambda r: [
        sys.executable, "-m", "neo_mpc_planner2_tpu_torch.parallel.smoke",
        str(r), "2", str(port), str(tmp_path / f"rank{r}.npz"),
        "--device", "cpu", "--batch", "8", "--steps", "2",
        "--checkpoint", str(ckpt)], tmp_path)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    assert sorted(os.listdir(ckpt)) == [".metadata", "__0_0.distcp",
                                        "__1_0.distcp"]
    for r in ranks:
        # The step taken from the loaded shard is the uninterrupted one.
        np.testing.assert_array_equal(r["resumed_cmd_vel1"], r["cmd_vel1"])
    # No process group here: the directory loads whole, bit-equal to the
    # ranks' states in rank order.
    want = {f: np.concatenate([r[f"ckpt_{f}"] for r in ranks])
            for f in tckpt._FIELDS}
    assert want["initial_guess"].shape[0] == 8
    whole = tckpt.load_state(str(ckpt), device="cpu")
    _assert_state_equals(whole, want)
    # A one-writer save into the same directory leaves no shard of world 2.
    tckpt.save_state(str(ckpt), whole)
    assert sorted(os.listdir(ckpt)) == [".metadata", "__0_0.distcp"]
    _assert_state_equals(tckpt.load_state(str(ckpt), device="cpu"), want)


# One rank of a world of two over a (1, 2) mesh: loads the world-1 save
# `whole` into its shard, held against shard_batch of the whole state (which
# it loads with no collective inside the world), then saves its shard
# collectively into `shards`.
RANK_SCRIPT = """
import datetime, sys
import torch
from neo_mpc_planner2_tpu_torch import checkpoint
from neo_mpc_planner2_tpu_torch.parallel import sharding
rank, port, whole, shards = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
    sys.argv[4]
sharding.initialize_distributed(
    device="cpu", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
    rank=rank, timeout=datetime.timedelta(seconds=60))
mesh = sharding.make_mesh(hosts=1)
assert tuple(mesh.shape) == (1, 2), mesh.shape
state = checkpoint.load_state(whole, device="cpu")
shard = checkpoint.load_state(whole, mesh=mesh)
want = sharding.shard_batch(state, mesh)
for f in checkpoint._FIELDS:
    a, b = getattr(shard, f), getattr(want, f)
    assert a.dtype == b.dtype and torch.equal(a, b), f
checkpoint.save_state(shards, shard, mesh=mesh)
torch.distributed.destroy_process_group()
print(f"[rank {rank}] OK", flush=True)
"""


def test_world_one_save_loads_into_two_rank_shards(tmp_path):
    arrays = _arrays(8, seed=11)
    whole, shards = str(tmp_path / "whole"), str(tmp_path / "shards")
    tckpt.save_state(whole, _state(arrays))
    port = _free_port()
    _run_ranks(lambda r: [sys.executable, "-c", RANK_SCRIPT, str(r),
                          str(port), whole, shards], tmp_path)
    assert sorted(os.listdir(shards)) == [".metadata", "__0_0.distcp",
                                          "__1_0.distcp"]
    _assert_state_equals(tckpt.load_state(shards, device="cpu"), arrays)
