"""The port's single-robot controller (`NeoMpcController`) and its native
host library, against the JAX package, on the CPU.

- The lifecycle and its exceptions (tests/test_controller.py): a tick
  before activate, without a plan, with a zero-length plan, on a lethal
  map ("MPC detected collision!"); configure from the ROS parameter dict.
- The closed loop against JAX's controller on both routes (fused, and the
  C++ host's geometry with the solve on the device): the robot follows the
  JAX controller's commands, both controllers are fed the same pose and
  velocity every tick and each carries its own state, and every command of
  the port is within 1e-4 of JAX's (the golden gate, tests/test_golden.py)
  for 25 ticks. A free-running pair would integrate 1e-6 differences of
  float rounding into poses that then differ, which the loop amplifies.
- set_speed_limit as a percentage, absolute, repeated without compounding,
  with the footprint_edge_samples bump kept; debug_msgs() and
  transformed_plan() equal to JAX's.
- The native library built from the port's own copy of the C++ sources
  (the JAX package's code), its tick equal to JAX's NativeHost on the
  same inputs; a failed or impossible build raises.
"""

import dataclasses
import pathlib
import subprocess

import numpy as np
import pytest
import torch

import neo_mpc_planner2_tpu as mpc
from neo_mpc_planner2_tpu import controller as jcontroller
from neo_mpc_planner2_tpu.native import host as jhost
from neo_mpc_planner2_tpu.utils.se2_np import integrate_cmd_np

import neo_mpc_planner2_tpu_torch as tp
from neo_mpc_planner2_tpu_torch import controller as tcontroller
from neo_mpc_planner2_tpu_torch.native import host as thost
from neo_mpc_planner2_tpu_torch.scenarios import make_scenario_batch

ROOT = pathlib.Path(__file__).resolve().parent.parent
ATOL = 1e-4
TICKS = 25


def _tcfg(jc):
    kw = {f: getattr(jc, f) for f in jc.__dataclass_fields__ if f != "compat"}
    compat = tp.CompatConfig(**dataclasses.asdict(jc.compat))
    return tp.MpcConfig(compat=compat, **kw)


def _fleet_jcfg():
    """fleet_config() with the fleet benchmark's overrides (bench.py), as
    chip_smoke.fleet_cfg() sets them."""
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


@pytest.fixture(scope="module")
def jax_native_lib(tmp_path_factory):
    """The JAX package's host library built from its own source into a
    temporary directory (the flags of scripts/build_native.sh), so that this
    file never writes into the JAX package while its tests build there."""
    out = tmp_path_factory.mktemp("jax_native") / "libneo_mpc_host.so"
    subprocess.run(
        ["g++", "-std=c++17", "-shared", "-fPIC", "-O3", "-DNDEBUG", "-o",
         str(out), str(ROOT / "neo_mpc_planner2_tpu/native/src/"
                       "neo_mpc_host.cpp")], check=True, timeout=300)
    return out


@pytest.fixture()
def jax_native(jax_native_lib, monkeypatch):
    """Point the JAX package's NativeHost at that library."""
    monkeypatch.setattr(jhost, "_LIB_PATH", str(jax_native_lib))
    monkeypatch.setattr(jhost, "_lib", None)
    return jhost


@pytest.fixture(scope="module")
def scene():
    """One robot from the scenario generator at the fleet point (seed 0,
    64² map, MPO-700 footprint, 64 plan points), as numpy arrays."""
    sb = make_scenario_batch(_tcfg(_fleet_jcfg()), 1, seed=0, map_size=64,
                             plan_points=64, device="cpu")
    nv = int(sb.footprint.n_valid[0])
    return dict(grid=sb.costmap.data[0].numpy(),
                origin=tuple(sb.costmap.origin[0].tolist()),
                res=float(sb.costmap.resolution[0]),
                plan=sb.plan.poses[0].numpy(),
                pose=sb.robot_pose[0].numpy().astype(float),
                vel=sb.current_vel[0].numpy().astype(float),
                fp=sb.footprint.vertices[0, :nv].numpy())


def _pair(jcfg, grid, origin, res, fp, native=False):
    """A configured, activated controller of each package on the same
    inputs: (jax, port)."""
    jc = jcontroller.NeoMpcController()
    jc.configure(jcfg, costmap=mpc.Costmap.create(grid, origin=origin,
                                                  resolution=res),
                 footprint=mpc.Footprint.create(fp), native_geometry=native)
    tc = tcontroller.NeoMpcController(device="cpu")
    tc.configure(_tcfg(jcfg) if not isinstance(jcfg, dict) else jcfg,
                 costmap=tp.Costmap.create(grid, origin=origin,
                                           resolution=res, device="cpu"),
                 footprint=tp.Footprint.create(fp, device="cpu"),
                 native_geometry=native)
    for c in (jc, tc):
        c.activate()
    return jc, tc


def _line_plan(n=50, length=2.0):
    return np.stack([np.linspace(0, length, n), np.zeros(n), np.zeros(n)], 1)


EMPTY = dict(grid=np.zeros((40, 40), np.float32), origin=(-1.0, -1.0),
             res=0.05, fp=np.array([[0.3, 0.2], [-0.3, 0.2], [-0.3, -0.2],
                                    [0.3, -0.2]]))


def _shadow_loop(jc, tc, pose, vel, ticks, check=None):
    """The robot follows jc's commands; both controllers get the same pose
    and velocity each tick. Returns (jax cmds, port cmds), (ticks, 3)."""
    pose, vel = np.array(pose, float), np.array(vel, float)
    got_j, got_t = [], []
    for _ in range(ticks):
        a = jc.compute_velocity_commands(pose, vel, 1 / 30)
        b = tc.compute_velocity_commands(pose, vel, 1 / 30)
        got_j.append(a)
        got_t.append(b)
        if check is not None:
            check(jc, tc)
        pose = integrate_cmd_np(pose, a, 1 / 30)
        vel = a
    return np.array(got_j), np.array(got_t)


# ---- lifecycle and exceptions -------------------------------------------

def test_tick_before_activate_raises(cfg):
    for pkg, kw in ((jcontroller, {}), (tcontroller, {"device": "cpu"})):
        c = pkg.NeoMpcController(**kw)
        c.configure(cfg if pkg is jcontroller else _tcfg(cfg))
        with pytest.raises(pkg.ControllerException,
                           match="controller not activated"):
            c.compute_velocity_commands([0, 0, 0], [0, 0, 0], 0.033)
    c = tcontroller.NeoMpcController(device="cpu")
    with pytest.raises(tcontroller.ControllerException):
        c.activate()          # before configure, as JAX's


def test_tick_without_plan_raises(cfg):
    for c in _pair(cfg, **EMPTY):
        with pytest.raises(Exception, match="zero length") as e:
            c.compute_velocity_commands([0, 0, 0], [0, 0, 0], 0.033)
        assert type(e.value).__name__ == "ControllerException"


@pytest.mark.parametrize("native", [False, True])
def test_zero_length_plan_raises_as_jax(cfg, native, jax_native):
    """An empty pose array is refused by Plan.create (ValueError) in both
    packages; a Plan with no valid pose by the controller (cpp:70)."""
    jc, tc = _pair(cfg, native=native, **EMPTY)
    for c in (jc, tc):
        with pytest.raises(ValueError, match="plan has zero length"):
            c.set_plan(np.zeros((0, 3)))
    empty = {jc: mpc.Plan.from_poses(np.zeros((8, 3), np.float32), 0),
             tc: tp.Plan.from_poses(np.zeros((8, 3)), 0, device="cpu")}
    for c, plan in empty.items():
        with pytest.raises(Exception,
                           match="Received plan with zero length") as e:
            c.set_plan(plan)
        assert type(e.value).__name__ == "ControllerException"


@pytest.mark.parametrize("native", [False, True])
def test_lethal_map_raises_as_jax(cfg, native, jax_native):
    lethal = dict(EMPTY, grid=np.ones((40, 40), np.float32))
    for c in _pair(cfg, native=native, **lethal):
        c.set_plan(_line_plan())
        with pytest.raises(Exception, match="MPC detected collision!") as e:
            c.compute_velocity_commands([0, 0, 0], [0, 0, 0], 0.033)
        assert type(e.value).__name__ == "ControllerException"


def test_configure_from_ros_param_dict():
    params = {"prediction_horizon": 0.8, "control_steps": 3,
              "max_vel_trans": 0.6}
    jc, tc = _pair(params, **EMPTY)
    assert tc.cfg.max_vel_trans == 0.6
    assert tc.cfg.dt == pytest.approx(0.8 / 3)
    assert dataclasses.asdict(tc.cfg) == dataclasses.asdict(jc.cfg)


# ---- the closed loop ------------------------------------------------------

@pytest.mark.parametrize("native", [False, True])
def test_closed_loop_matches_jax(scene, native, jax_native):
    jc, tc = _pair(_fleet_jcfg(), scene["grid"], scene["origin"],
                   scene["res"], scene["fp"], native=native)
    for c in (jc, tc):
        c.set_plan(scene["plan"])

    def same_window(jc, tc):
        np.testing.assert_array_equal(
            np.asarray(jc._last_window, int),
            np.asarray([int(v) for v in tc._last_window]))

    got_j, got_t = _shadow_loop(jc, tc, scene["pose"], scene["vel"], TICKS,
                                same_window)
    assert np.isfinite(got_t).all()
    # The robot moves: the comparison is not of zero commands.
    assert np.abs(got_j[:, 0]).max() > 0.1
    np.testing.assert_allclose(got_t, got_j, rtol=0, atol=ATOL)


def test_debug_msgs_and_transformed_plan_match_jax(cfg):
    jc, tc = _pair(cfg, **EMPTY)
    assert tc.debug_msgs() == {} and tc.transformed_plan().shape == (0, 3)
    for c in (jc, tc):
        c.set_plan(_line_plan())

    def same_msgs(jc, tc):
        np.testing.assert_allclose(tc.transformed_plan(),
                                   jc.transformed_plan(), atol=1e-6)
        want, got = jc.debug_msgs(), tc.debug_msgs()
        assert set(got) == set(want) == {
            "lookahead_point", "local_plan", "received_global_plan",
            "predicted_footprint"}
        flat_got, flat_want = _flatten(got), _flatten(want)
        assert flat_got.keys() == flat_want.keys()
        for k, v in flat_want.items():
            if isinstance(v, str):
                assert flat_got[k] == v, k
            else:
                assert abs(flat_got[k] - v) <= ATOL, k

    _shadow_loop(jc, tc, [0.6, 0.1, 0.2], [0.1, 0, 0], 3, same_msgs)


def _flatten(msg, prefix=""):
    """The leaves of a message dict (floats, and frame ids as strings), by
    path."""
    out = {}
    items = msg.items() if isinstance(msg, dict) else enumerate(msg)
    for k, v in items:
        key = f"{prefix}/{k}"
        if isinstance(v, (dict, list)):
            out.update(_flatten(v, key))
        elif isinstance(v, str):
            out[key] = v
        else:
            out[key] = float(v)
    return out


# ---- speed limits and the footprint sampling bump ------------------------

def test_speed_limit_matches_jax(cfg):
    jc, tc = _pair(cfg, **EMPTY)
    base = tc.cfg.max_vel_trans
    for c in (jc, tc):
        c.set_plan(_line_plan())
        c.set_speed_limit(50.0, percentage=True)
    assert tc.cfg.max_vel_trans == pytest.approx(base * 0.5)
    assert dataclasses.asdict(tc.cfg) == dataclasses.asdict(jc.cfg)
    got_j, got_t = _shadow_loop(jc, tc, np.zeros(3), np.zeros(3), 12)
    np.testing.assert_allclose(got_t, got_j, rtol=0, atol=ATOL)
    assert np.hypot(got_t[:, 0], got_t[:, 1]).max() <= base * 0.5 + 1e-4
    assert np.hypot(got_t[:, 0], got_t[:, 1]).max() > base * 0.25


def test_speed_limit_absolute_and_repeated_do_not_compound(cfg):
    jc, tc = _pair(cfg, **EMPTY)
    base = tc.cfg.max_vel_trans
    for c in (jc, tc):
        c.set_speed_limit(0.35, percentage=False)
    assert tc.cfg.max_vel_trans == pytest.approx(0.35)
    for c in (jc, tc):
        c.set_speed_limit(50.0, percentage=True)
        c.set_speed_limit(50.0, percentage=True)
    # "percentage from maximum robot speed" — not of the current limit.
    assert tc.cfg.max_vel_trans == pytest.approx(base * 0.5)
    assert dataclasses.asdict(tc.cfg) == dataclasses.asdict(jc.cfg)
    for c in (jc, tc):
        c.set_speed_limit(100.0, percentage=True)
    assert tc.cfg.max_vel_trans == pytest.approx(base)
    limits = tc._limits
    assert limits.vel_hi.shape == (3,) and limits.max_vel_trans.shape == ()


def test_footprint_edge_samples_bump_survives_speed_limit(cfg):
    """A 0.02 m map needs about 0.6 / 0.02 + 2 samples an edge on the 0.6 m
    footprint: configure raises the count as JAX's does, and a later speed
    limit keeps it."""
    fine = dict(EMPTY, res=0.02)
    jc, tc = _pair(cfg.replace(footprint_edge_samples=8), **fine)
    bumped = jc.cfg.footprint_edge_samples
    assert tc.cfg.footprint_edge_samples == bumped >= 32
    for c in (jc, tc):
        c.set_speed_limit(40.0, percentage=True)
    assert tc.cfg.footprint_edge_samples == bumped
    assert dataclasses.asdict(tc.cfg) == dataclasses.asdict(jc.cfg)
    # set_costmap with a coarser map leaves the count; a finer one raises
    # it again, on both.
    for c, pkg in ((jc, mpc), (tc, tp)):
        kw = {} if pkg is mpc else {"device": "cpu"}
        c.set_costmap(pkg.Costmap.create(np.zeros((40, 40)), (-0.4, -0.4),
                                         0.01, **kw))
    assert tc.cfg.footprint_edge_samples == jc.cfg.footprint_edge_samples
    assert tc.cfg.footprint_edge_samples >= 62


def test_controller_refuses_a_map_on_another_device(cfg):
    c = tcontroller.NeoMpcController(device="cpu")
    meta = tp.Costmap(data=torch.zeros((8, 8), device="meta"),
                      origin=torch.zeros(2), resolution=torch.tensor(0.05))
    with pytest.raises(ValueError, match="costmap is on meta"):
        c.configure(_tcfg(cfg), costmap=meta)
    c.configure(_tcfg(cfg))
    with pytest.raises(ValueError, match="footprint is on meta"):
        c.set_footprint(tp.Footprint(
            vertices=torch.zeros((4, 2), device="meta"),
            n_valid=torch.tensor(4)))


# ---- the native host library ---------------------------------------------

def _code(path):
    """A C++ source's lines without their // comments."""
    return [line.split("//")[0].rstrip()
            for line in path.read_text().splitlines()]


def test_native_sources_are_the_jax_packages():
    """The port's copy of the host library is the JAX package's code (the
    implementation byte for byte; the header up to its comments)."""
    jax_src = ROOT / "neo_mpc_planner2_tpu/native/src"
    assert ((thost.SRC / "neo_mpc_host.cpp").read_bytes()
            == (jax_src / "neo_mpc_host.cpp").read_bytes())
    assert (_code(thost.SRC / "neo_mpc_host.h")
            == _code(jax_src / "neo_mpc_host.h"))


def test_native_library_builds_from_the_port_copy(tmp_path):
    lib = thost.build_library(build_dir=tmp_path)
    assert lib.parent == tmp_path and lib.exists()
    assert lib == thost.library_path(build_dir=tmp_path)
    assert lib.name.startswith("libneo_mpc_host_") and len(lib.stem) == 32
    # Built once: a second call finds it.
    mtime = lib.stat().st_mtime_ns
    assert thost.build_library(build_dir=tmp_path) == lib
    assert lib.stat().st_mtime_ns == mtime
    # The package's default lives under build/native/ of the checkout.
    assert thost.library_path().parent == ROOT / "build" / "native"


def test_native_tick_matches_jax(jax_native):
    rng = np.random.default_rng(5)
    data = rng.uniform(0, 0.7, (40, 40)).astype(np.float32)
    plan = np.stack([np.linspace(0, 1.5, 30), 0.2 * np.sin(np.linspace(
        0, 2, 30)), np.linspace(0, 0.4, 30)], 1)
    kw = dict(lookahead_dist_min=0.3, lookahead_dist_max=0.5,
              lookahead_dist_close_to_goal=0.4, controller_frequency=30.0)
    hosts = [jax_native.NativeHost(**kw), thost.NativeHost(**kw)]
    for h in hosts:
        assert h.set_plan(plan) == 0
    for pose in ([0.0, 0.0, 0.0], [0.3, 0.05, 0.1], [0.8, 0.2, 0.3],
                 [1.45, 0.18, 0.4]):
        (sj, rj), (st, rt) = [h.tick(pose, [0.2, 0.0, 0.05], data,
                                     (-1.0, -1.0), 0.05, EMPTY["fp"])
                              for h in hosts]
        assert sj == st
        assert vars(rt).keys() == vars(rj).keys()
        for k, v in vars(rj).items():
            np.testing.assert_array_equal(getattr(rt, k), v, err_msg=k)
        assert (hosts[1].footprint_cost(data, (-1.0, -1.0), 0.05,
                                        EMPTY["fp"], pose)
                == hosts[0].footprint_cost(data, (-1.0, -1.0), 0.05,
                                           EMPTY["fp"], pose))
    assert thost.NMP_ERR_LETHAL == jax_native.NMP_ERR_LETHAL == 3


def test_native_build_failures_raise(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    (src / "neo_mpc_host.h").write_text("")
    (src / "neo_mpc_host.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        thost.build_library(src=src, build_dir=tmp_path / "out")
    monkeypatch.setattr(thost.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        thost.build_library(build_dir=tmp_path / "none")
