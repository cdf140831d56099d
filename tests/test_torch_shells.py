"""The port's shells against the JAX package's, on the CPU: the ROS 2
adapter (`ros_adapter`), the server CLI (`cli`) and the numpy helpers
(`utils.viz`, `utils.se2_np`, `utils.profiling`).

- The pure message translators give JAX's results on the same messages.
- `costmap_refresh_op` sends the exact dirty bounding box where JAX pads it
  to powers of two (a deliberate divergence: the port's session writes a
  block of any shape); applied to the previous grid, both give the new
  grid.
- `RosOptimizerServer` of each package under tests/fake_rclpy.py, driven by
  the same message sequence (footprint, full grids, the dirty diff,
  update-topic merges, the dropped-baseline path, dynamic parameters, the
  optimizer service): the same ops in the same order, the staged maps equal
  cell for cell after every message, the service's commands within 1e-4.
- `cli._load_params_file` on the navigation.yaml layout and on a flat dict;
  `cli.server_main` on a free port with --device cpu answers an
  `optimizer` request as an in-process session does.
- `RateTracker` stats (the port has no `Timer`: its spans time its
  phases), the viz messages and the se2 helpers equal to JAX's; the trace
  readers of `utils.profiling`.
"""

import json
import math
import socket
import threading
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

from neo_mpc_planner2_tpu import cli as jcli
from neo_mpc_planner2_tpu import ros_adapter as jra
from neo_mpc_planner2_tpu.serving import OptimizerSession as JaxSession
from neo_mpc_planner2_tpu.utils import profiling as jprof
from neo_mpc_planner2_tpu.utils import se2_np as jse2
from neo_mpc_planner2_tpu.utils import viz as jviz

import neo_mpc_planner2_tpu_torch as tp
from neo_mpc_planner2_tpu_torch import cli as tcli
from neo_mpc_planner2_tpu_torch import ros_adapter as tra
from neo_mpc_planner2_tpu_torch.serving import OptimizerClient
from neo_mpc_planner2_tpu_torch.serving import OptimizerSession
from neo_mpc_planner2_tpu_torch.utils import profiling as tprof
from neo_mpc_planner2_tpu_torch.utils import se2_np as tse2
from neo_mpc_planner2_tpu_torch.utils import viz as tviz

import fake_rclpy
from test_ros_adapter import _request, _response
from test_ros_server_shell import _footprint_msg, _grid_msg

ATOL = 1e-4
FOOTPRINT = [[0.3, 0.2], [-0.3, 0.2], [-0.3, -0.2], [0.3, -0.2]]


def _tcfg(jc):
    import dataclasses

    kw = {f: getattr(jc, f) for f in jc.__dataclass_fields__ if f != "compat"}
    compat = tp.CompatConfig(**dataclasses.asdict(jc.compat))
    return tp.MpcConfig(compat=compat, **kw)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---- pure translators -----------------------------------------------------

def test_translators_match_jax():
    for yaw in (-3.0, -1.2, 0.0, 0.7, 2.9):
        q = jra.quaternion_from_yaw(yaw)
        assert tra.quaternion_from_yaw(yaw) == q
        assert (tra.euler_yaw_from_quaternion(q[1], q[2], q[3], q[0])
                == jra.euler_yaw_from_quaternion(q[1], q[2], q[3], q[0]))
    req = _request(pose=(0.1, -0.2, 0.3), carrot=(0.4, 0.1, -2.0),
                   goal=(1.0, 0.5, 3.0), vel=(0.2, -0.1, 0.05))
    for dt in (None, 0.033):
        assert tra.request_to_msg(req, dt) == jra.request_to_msg(req, dt)
    assert (tra.pose_to_xyyaw(req.current_pose.pose)
            == jra.pose_to_xyyaw(req.current_pose.pose))
    assert tra.twist_to_vec(req.current_vel) == jra.twist_to_vec(
        req.current_vel)
    result = {"output_vel": [0.1, -0.2, 0.3]}
    got = tra.fill_response(_response(), result).output_vel.twist
    want = jra.fill_response(_response(), result).output_vel.twist
    assert (got.linear.x, got.linear.y, got.angular.z) == (
        want.linear.x, want.linear.y, want.angular.z)
    fp = _footprint_msg()
    assert tra.footprint_msg_to_points(fp) == jra.footprint_msg_to_points(fp)
    rng = np.random.default_rng(3)
    data = rng.integers(-1, 101, 6 * 7).astype(np.int8)
    np.testing.assert_array_equal(tra.occupancy_values_to_cost(data, 6, 7),
                                  jra.occupancy_values_to_cost(data, 6, 7))
    grid = NS(info=NS(width=7, height=6, resolution=0.1,
                      origin=NS(position=NS(x=-0.5, y=-0.4, z=0.0))),
              data=data)
    upd = NS(x=2, y=3, width=7, height=6, data=data)
    for fn in ("occupancy_grid_to_costmap_msg",
               "occupancy_grid_update_to_msg"):
        got, want = getattr(tra, fn)(grid if "update" not in fn else upd), \
            getattr(jra, fn)(grid if "update" not in fn else upd)
        assert got.keys() == want.keys()
        np.testing.assert_array_equal(got.pop("data"), want.pop("data"))
        assert got == want
    assert set(tra.__all__) == set(jra.__all__)


def _apply(grid, op):
    out = grid.copy()
    x, y = op["lo"]
    h, w = op["data"].shape
    out[y:y + h, x:x + w] = op["data"]
    return out


def test_costmap_refresh_op_sends_the_exact_dirty_box():
    meta = ((-1.0, -1.0), 0.05)
    g0 = np.zeros((32, 32), np.float32)
    for pkg in (tra, jra):
        assert pkg.costmap_refresh_op(None, None, g0, meta)["op"] == \
            "set_costmap"
        assert pkg.costmap_refresh_op(g0, meta, g0.copy(), meta) is None
        assert pkg.costmap_refresh_op(
            g0, meta, g0, ((-0.9, -1.0), 0.05))["op"] == "set_costmap"
    g1 = g0.copy()
    g1[10, 4] = 0.7
    g1[12, 9] = 1.0
    g2 = g1.copy()
    g2[31, 31] = 0.9
    g2[29, 30] = 0.8
    for prev, new, lo, shape in ((g0, g1, [4, 10], (3, 6)),
                                 (g1, g2, [30, 29], (3, 2))):
        got = tra.costmap_refresh_op(prev, meta, new, meta)
        want = jra.costmap_refresh_op(prev, meta, new, meta)
        assert got["op"] == want["op"] == "set_costmap_update"
        assert got["lo"] == lo and got["data"].shape == shape
        np.testing.assert_array_equal(_apply(prev, got), new)
        np.testing.assert_array_equal(_apply(prev, got), _apply(prev, want))


# ---- the service callback core -------------------------------------------

def _staged(pkg_session, cfg, **kw):
    s = pkg_session(cfg, **kw)
    s.handle({"op": "set_costmap", "data": np.zeros((40, 40)).tolist(),
              "origin": [-1, -1], "resolution": 0.05})
    s.handle({"op": "set_footprint", "points": FOOTPRINT})
    return s


def test_callback_core_matches_jax(cfg):
    js = _staged(JaxSession, cfg)
    ts = _staged(OptimizerSession, _tcfg(cfg), device="cpu")
    for req in (_request(), _request(pose=(0.1, 0.0, -0.2),
                                     vel=(0.3, 0.05, 0.0))):
        got = tra.optimizer_callback_core(ts, req, _response(), 0.033)
        want = jra.optimizer_callback_core(js, req, _response(), 0.033)
        g, w = got.output_vel.twist, want.output_vel.twist
        np.testing.assert_allclose(
            [g.linear.x, g.linear.y, g.angular.z],
            [w.linear.x, w.linear.y, w.angular.z], atol=ATOL)
        assert abs(g.linear.x) > 1e-3
    bare = OptimizerSession(_tcfg(cfg), device="cpu")
    with pytest.raises(RuntimeError, match="costmap"):
        tra.optimizer_callback_core(bare, _request(), _response(), 0.033)


# ---- RosOptimizerServer under the fake rclpy -------------------------------

@pytest.fixture()
def servers(cfg, monkeypatch):
    """A RosOptimizerServer of each package on the same config (the port's
    on the CPU), each session's handle() spied on: (jax, port, ops), ops
    {"jax": [...], "port": [...]}."""
    fake_rclpy.install(monkeypatch)
    monkeypatch.setattr(tra, "HAVE_RCLPY", True)
    srv_type = type("Optimizer", (), {})
    pair = {"jax": jra.RosOptimizerServer(srv_type, cfg=cfg),
            "port": tra.RosOptimizerServer(srv_type, cfg=_tcfg(cfg),
                                           device="cpu")}
    ops = {k: [] for k in pair}
    for k, srv in pair.items():
        real = srv.session.handle

        def spy(msg, real=real, log=ops[k]):
            log.append(msg)
            return real(msg)

        monkeypatch.setattr(srv.session, "handle", spy)
    return pair["jax"], pair["port"], ops


def _same_staging(jsrv, tsrv, ops):
    assert [o["op"] for o in ops["port"]] == [o["op"] for o in ops["jax"]]
    assert tsrv._baseline_dropped == jsrv._baseline_dropped
    assert (tsrv._last_grid is None) == (jsrv._last_grid is None)
    if jsrv._last_grid is not None:
        np.testing.assert_array_equal(tsrv._last_grid, jsrv._last_grid)
        assert tsrv._last_meta == jsrv._last_meta
    if jsrv.session.costmap is None:
        assert tsrv.session.costmap is None
    else:
        np.testing.assert_array_equal(tsrv.session.costmap.data.numpy(),
                                      np.asarray(jsrv.session.costmap.data))


def _twist(resp):
    tw = resp.output_vel.twist
    return [tw.linear.x, tw.linear.y, tw.angular.z]


def test_ros_server_wiring_matches_jax(servers):
    jsrv, tsrv, _ = servers
    assert tsrv.node.node_name == jsrv.node.node_name
    assert tsrv.node.services.keys() == jsrv.node.services.keys()
    assert tsrv.node.subscriptions.keys() == jsrv.node.subscriptions.keys()
    assert tsrv.node.params == jsrv.node.params
    assert tsrv.session.device.type == "cpu"


def test_ros_server_message_sequence_matches_jax(servers):
    jsrv, tsrv, ops = servers
    pair = (jsrv, tsrv)

    def both(topic, msg):
        for srv in pair:
            srv.node.publish(topic, msg)
        _same_staging(jsrv, tsrv, ops)

    def serve(req):
        got, want = (_twist(s.node.call_service("optimizer", req,
                                                _response()))
                     for s in (tsrv, jsrv))
        np.testing.assert_allclose(got, want, atol=ATOL)
        return got

    # The service before anything is staged: a zero command and a warning.
    assert serve(_request()) == [0.0, 0.0, 0.0]
    assert tsrv.node.get_logger().warnings
    both("/local_costmap/published_footprint", _footprint_msg())
    base = np.zeros((32, 32), np.float32)
    both("/local_costmap/costmap", _grid_msg(base))
    both("/local_costmap/costmap", _grid_msg(base))          # unchanged
    changed = base.copy()
    changed[10:13, 20:22] = 0.5
    changed[30, 31] = 0.25
    both("/local_costmap/costmap", _grid_msg(changed))        # dirty box
    assert ops["port"][-1]["data"].shape == (21, 12)
    assert ops["jax"][-1]["data"].shape == (32, 16)
    both("/local_costmap/costmap_updates",
         NS(x=5, y=7, width=3, height=2, data=np.full(6, 50, np.int8)))
    assert abs(serve(_request(vel=(0.1, 0.0, 0.0)))[0]) > 1e-3
    # An update larger than the grid drops the baseline; an update racing
    # ahead of the next full grid is discarded; the next full grid restages
    # (the same content), and updates flow again.
    both("/local_costmap/costmap_updates",
         NS(x=10, y=10, width=30, height=30, data=np.zeros(900, np.int8)))
    assert tsrv._last_grid is None and tsrv._baseline_dropped
    small = NS(x=0, y=0, width=2, height=2, data=np.full(4, 100, np.int8))
    both("/local_costmap/costmap_updates", small)
    both("/local_costmap/costmap", _grid_msg(changed))
    assert ops["port"][-1]["op"] == "set_costmap"
    both("/local_costmap/costmap_updates", small)
    assert ops["port"][-1]["op"] == "set_costmap_update"
    # Dynamic parameters reach the session's config.
    for srv in pair:
        assert all(r.successful for r in srv.node.set_parameters(
            {"lookahead_dist_min": 0.55, "w_control": 0.1}))
    assert tsrv.session.cfg.lookahead_dist_min == pytest.approx(0.55)
    assert tsrv.session.cfg.w_control == jsrv.session.cfg.w_control
    serve(_request(pose=(0.05, 0.02, 0.1)))


def test_ros_server_rejected_stage_drops_baseline(servers, monkeypatch):
    jsrv, tsrv, _ = servers
    for srv in (jsrv, tsrv):
        monkeypatch.setattr(srv.session, "handle",
                            lambda msg: {"error": "injected"})
        srv.node.publish("/local_costmap/costmap",
                         _grid_msg(np.zeros((16, 16), np.float32)))
        assert srv._last_grid is None and srv._baseline_dropped
        assert srv.node.get_logger().warnings


def test_ros_server_without_rclpy_raises():
    assert not tra.HAVE_RCLPY
    with pytest.raises(ImportError, match="rclpy"):
        tra.RosOptimizerServer(srv_type=object, device="cpu")


def test_ros_server_needs_a_card_unless_asked_for_the_cpu(cfg, monkeypatch):
    fake_rclpy.install(monkeypatch)
    monkeypatch.setattr(tra, "HAVE_RCLPY", True)
    srv_type = type("Optimizer", (), {})
    if torch.cuda.is_available():
        srv = tra.RosOptimizerServer(srv_type, cfg=_tcfg(cfg))
        assert srv.session.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tra.RosOptimizerServer(srv_type, cfg=_tcfg(cfg))


# ---- the CLI ----------------------------------------------------------------

NAVIGATION_YAML = """
controller_server:
  ros__parameters:
    controller_frequency: 25.0
    FollowPath:
      plugin: "neo_mpc_planner::NeoMpcPlanner"
      lookahead_dist_min: 0.4
      lookahead_dist_max: 0.6
mpc_optimization_server:
  ros__parameters:
    acc_x_limit: 0.5
    max_vel_trans: 0.6
    w_trans: 0.82
    control_steps: 3
"""


def test_load_params_file_matches_jax(tmp_path):
    nav = tmp_path / "navigation.yaml"
    nav.write_text(NAVIGATION_YAML)
    flat = tmp_path / "flat.json"
    flat.write_text(json.dumps({"max_vel_trans": 0.5, "control_steps": 4}))
    for path in (nav, flat):
        assert tcli._load_params_file(str(path)) == jcli._load_params_file(
            str(path))
    params = tcli._load_params_file(str(nav))
    assert params["controller_frequency"] == 25.0
    assert params["lookahead_dist_max"] == 0.6 and params["w_trans"] == 0.82
    bad = tmp_path / "list.json"
    bad.write_text("[1, 2]")
    with pytest.raises(SystemExit):
        tcli._load_params_file(str(bad))


def test_server_main_help_names_its_defaults(capsys):
    with pytest.raises(SystemExit) as e:
        tcli.server_main(["--help"])
    assert e.value.code == 0
    out = " ".join(capsys.readouterr().out.split())
    assert "neo-mpc-server-torch" in out and "--device" in out
    assert "0 (default) = always one dispatch" in out
    assert "NVIDIA H100 80GB HBM3 at a 700 W power limit" in out


def test_server_main_answers_an_optimizer_request(tmp_path):
    params = tmp_path / "navigation.yaml"
    params.write_text(NAVIGATION_YAML)
    port = _free_port()
    threading.Thread(target=tcli.server_main, daemon=True, args=(
        ["--port", str(port), "--device", "cpu", "--params-file",
         str(params)],)).start()
    client = OptimizerClient(port=port, wait_timeout=60)
    local = OptimizerSession(tp.config_from_ros_params(
        tcli._load_params_file(str(params))), device="cpu")
    stage = [{"op": "set_costmap", "data": np.zeros((40, 40)).tolist(),
              "origin": [-1, -1], "resolution": 0.05},
             {"op": "set_footprint", "points": FOOTPRINT}]
    req = {"op": "optimizer", "current_pose": [0.0, 0.0, 0.3],
           "carrot_pose": [0.4, 0.1, 0.2], "goal_pose": [1.0, 0.5, 0.3],
           "current_vel": [0.2, 0.0, 0.0], "switch_opt": False,
           "control_interval": 1 / 30, "delta_t": 1 / 30}
    try:
        assert client.call({"op": "ping"})["backend"] == "cpu"
        for msg in stage:
            assert "error" not in client.call(msg)
            local.handle(msg)
        got = client.call(req)
        want = local.handle(req)
    finally:
        client.close()
    assert got["output_vel"] == pytest.approx(want["output_vel"], abs=1e-7)
    assert abs(got["output_vel"][0]) > 1e-3


# ---- numpy helpers and profiling ---------------------------------------------

def test_timer_and_rate_tracker_match_jax():
    samples = np.random.default_rng(1).uniform(0.01, 0.2, 700)
    trackers = [tprof.RateTracker(window=512), jprof.RateTracker(window=512)]
    assert trackers[0].stats() == trackers[1].stats() == {"count": 0}
    for s in samples:
        for t in trackers:
            t.record(float(s))
    assert trackers[0].stats() == trackers[1].stats()
    assert trackers[0].stats()["count"] == 512
    # The port has no Timer (no caller): spans time its phases.
    assert not hasattr(tprof, "Timer") and hasattr(jprof, "Timer")
    with trackers[0].measure():
        pass
    assert trackers[0].samples[-1] >= 0.0


def test_viz_and_se2_match_jax():
    rng = np.random.default_rng(2)
    local_plan = rng.normal(size=(4, 3))
    carrot = rng.normal(size=3)
    verts = rng.normal(size=(5, 2))
    for name, args in (("local_plan_msg", (local_plan,)),
                       ("carrot_msg", (carrot,)),
                       ("plan_msg", (local_plan, 3)),
                       ("predicted_footprint_msg", (verts, local_plan[-1]))):
        assert getattr(tviz, name)(*args) == getattr(jviz, name)(*args), name
    for yaw in (-2.5, 0.0, 1.1):
        q = tse2.quat_from_yaw_np(yaw)
        assert q == jse2.quat_from_yaw_np(yaw)
        assert tse2.yaw_from_quat_np(*q) == jse2.yaw_from_quat_np(*q)
        assert math.isclose(tse2.yaw_from_quat_np(*q), yaw, abs_tol=1e-12)
    pose, cmd = rng.normal(size=3), rng.normal(size=3)
    np.testing.assert_array_equal(tse2.integrate_cmd_np(pose, cmd, 0.033),
                                  jse2.integrate_cmd_np(pose, cmd, 0.033))


def test_device_trace_on_the_cpu_has_no_device_lane(tmp_path):
    with tprof.device_trace(str(tmp_path)):
        torch.ones(8).cumsum(0)
    assert len(list(tmp_path.glob("trace_*.json"))) == 1
    assert tprof.device_module_durations_ms(str(tmp_path)) == {}
    assert tprof.host_call_counts(str(tmp_path)) == {}
    assert tprof.device_module_durations_ms(str(tmp_path / "none")) == {}


def test_trace_readers_parse_the_newest_chrome_trace(tmp_path):
    """Kernels are read from the device lane in time order; the host's CUDA
    runtime calls are counted by name; an older trace is ignored."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "qp_admm_kernel", "ts": 30.0,
         "dur": 4.0},
        {"ph": "X", "cat": "kernel", "name": "qp_admm_kernel", "ts": 10.0,
         "dur": 2.0},
        {"ph": "X", "cat": "kernel", "name": "footprint_cost_kernel",
         "ts": 20.0, "dur": 1.5},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 9.0, "dur": 3.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 19.0, "dur": 3.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 40.0, "dur": 3.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1.0,
         "dur": 1.0},
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "GPU 0"}},
    ]
    (tmp_path / "trace_1.json").write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "old", "ts": 0, "dur": 1}]}))
    (tmp_path / "trace_2.json").write_text(json.dumps(
        {"traceEvents": events}))
    assert tprof.device_module_durations_ms(str(tmp_path)) == {
        "qp_admm_kernel": [0.002, 0.004], "footprint_cost_kernel": [0.0015]}
    assert tprof.host_call_counts(str(tmp_path)) == {
        "cudaLaunchKernel": 2, "cudaStreamSynchronize": 1}
