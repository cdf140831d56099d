"""The C++ nav2 controller plugin against the port's server, end to end
without ROS: tests/test_nav2_plugin.py with the port's `serve` on the CPU
in place of the JAX package's.

The plugin's real (nav2) branch is compiled against the stub ROS headers
(`neo_mpc_planner2_tpu/native/ros/stubs`) into a harness binary, with the
g++ line of scripts/check_nav2_plugin.sh but into this test's temporary
directory, and driven through configure → activate → setPlan → a
closed loop of computeVelocityCommands over TCP. The harness asserts the
empty-plan throw, finite and cone-bounded commands, progress to the plan
goal, a working dynamic-parameter callback and the lethal exception text
("MPC detected collision!")."""

import dataclasses
import re
import shutil
import socket
import subprocess
import threading
from pathlib import Path

import numpy as np
import pytest

import neo_mpc_planner2_tpu_torch as tp
from neo_mpc_planner2_tpu_torch.serving import OptimizerClient, serve

REPO = Path(__file__).resolve().parent.parent
ROS = REPO / "neo_mpc_planner2_tpu/native/ros"
SRC = REPO / "neo_mpc_planner2_tpu/native/src"


@pytest.fixture(scope="module")
def harness_bin(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    out = tmp_path_factory.mktemp("nav2") / "stubs_harness"
    build = subprocess.run(
        ["g++", "-std=c++17", "-Wall", "-Wextra", "-O1", "-g",
         "-I", str(ROS / "stubs"), "-I", str(SRC), "-o", str(out),
         str(ROS / "stubs_main.cpp"), str(SRC / "neo_mpc_host.cpp")],
        capture_output=True, text=True, timeout=300)
    assert build.returncode == 0, build.stderr
    return out


def _tcfg(jc):
    kw = {f: getattr(jc, f) for f in jc.__dataclass_fields__ if f != "compat"}
    compat = tp.CompatConfig(**dataclasses.asdict(jc.compat))
    return tp.MpcConfig(compat=compat, **kw)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_nav2_plugin_closed_loop_against_the_port(cfg, harness_bin):
    port = _free_port()
    ready = threading.Event()
    threading.Thread(target=serve, daemon=True, kwargs=dict(
        host="127.0.0.1", port=port, cfg=_tcfg(cfg), ready_event=ready,
        device="cpu")).start()
    assert ready.wait(30)
    cl = OptimizerClient(port=port, wait_timeout=15)
    # Stage the solve-side map + footprint (in deployment: ros_adapter's
    # subscriptions or navigation.yaml; the plugin's own gates run on the
    # nav2 rolling costmap it snapshots in-process).
    assert cl.call({"op": "ping"})["backend"] == "cpu"
    cl.call({"op": "set_costmap", "data": np.zeros((80, 80)).tolist(),
             "origin": [-2.0, -2.0], "resolution": 0.05})
    cl.call({"op": "set_footprint",
             "points": [[0.25, 0.18], [-0.25, 0.18],
                        [-0.25, -0.18], [0.25, -0.18]]})
    run = subprocess.run([str(harness_bin), str(port)],
                         capture_output=True, text=True, timeout=600)
    cl.close()
    assert run.returncode == 0, run.stdout + run.stderr
    assert "nav2 plugin harness OK" in run.stdout
    # The closed loop got near the 1.2 m plan goal (stderr carries the pose).
    m = re.search(r"advanced to x=([-\d.]+)", run.stderr)
    assert m is not None, run.stderr
    assert float(m.group(1)) > 1.0, run.stderr
