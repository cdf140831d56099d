"""The port's OptimizerSession against the JAX package's, message for
message.

One fixed script of requests goes through a session of each package on the
same config: configure (a runtime weight and a rebuild), set_costmap,
set_footprint, optimizer (two robot slots), optimizer_batch (the fleet
growing, then shrinking), set_plan/tick, set_plans/tick_batch,
set_costmap_update, pipelined mode and exact footprint mode; and a shorter
one in product mode (parity=False). Every response has the same keys and
value types. The values: output_vel within 1e-4 (the golden gate),
iterations within ±1 (a 1-ulp tie in f may move a termination by one
iteration), flags, error strings and integers equal, other floats within
1e-3 (the local plan and the cost follow the solve's iterate); a fleet's
"lanes" is the robots, where JAX reports its padded lane count.
"""

import numpy as np
import pytest
import torch

from neo_mpc_planner2_tpu import config as jconfig
from neo_mpc_planner2_tpu.serving import OptimizerSession as JaxSession

from neo_mpc_planner2_tpu_torch import config as tconfig
from neo_mpc_planner2_tpu_torch.serving import OptimizerSession

FOOTPRINT = [[0.3, 0.2], [-0.3, 0.2], [-0.3, -0.2], [0.3, -0.2]]


def _params():
    """The session config as ROS parameters (the tests' conftest point)."""
    return dict(
        prediction_horizon=0.8, control_steps=3, opt_tolerance=1e-3,
        footprint_edge_samples=8, max_plan_points=32, acc_x_limit=2.5,
        acc_y_limit=2.5, acc_theta_limit=3.0, min_vel_x=-0.7,
        min_vel_y=-0.7, min_vel_theta=-0.7, max_vel_x=0.7, max_vel_y=0.7,
        max_vel_trans=0.7, max_vel_theta=0.7, w_trans=0.82, w_orient=0.5,
        w_control=0.05, w_terminal=0.05, w_costmap=0.05, w_footprint=2000.0,
        lookahead_dist_min=0.4, lookahead_dist_max=0.4,
        lookahead_dist_close_to_goal=0.4, solver_max_iters=8)


def _sessions(**kw):
    p = _params()
    jax_s = JaxSession(jconfig.config_from_ros_params(p), **kw)
    port = OptimizerSession(tconfig.config_from_ros_params(p), device="cpu",
                            **kw)
    return jax_s, port


def _map(seed=0, size=40):
    rng = np.random.default_rng(seed)
    data = rng.uniform(0.0, 0.3, (size, size))
    data[26:30, 4:16] = 1.0
    data[8:11, 22:24] = 0.995
    return data.round(4).tolist()


def _robot(i, **kw):
    r = {"current_pose": [0.05 * i - 0.1, -0.02 * i, 0.1 * i],
         "carrot_pose": [0.4, 0.05 * i, 0.1],
         "goal_pose": [0.6, 0.3 + 0.05 * i, 0.2],
         "current_vel": [0.1, 0.0, 0.02 * i]}
    r.update(kw)
    return r


def _plan(i, n=12):
    t = np.linspace(0.0, 1.0, n)
    return np.stack([-0.3 + 0.9 * t + 0.02 * i, 0.1 * i + 0.4 * t * t,
                     0.3 * t], -1).round(4).tolist()


def _opt(i=0, **kw):
    return {"op": "optimizer", **_robot(i), "control_interval": 0.033,
            "delta_t": 0.033, **kw}


def _batch(n, **kw):
    return {"op": "optimizer_batch", "robots": [_robot(i) for i in range(n)],
            "control_interval": 0.033, "delta_t": 0.033, **kw}


def _tick_batch(n):
    return {"op": "tick_batch", "delta_t": 0.033,
            "robots": [{"pose": [-0.3 + 0.02 * i, 0.1 * i, 0.0],
                        "vel": [0.1, 0.0, 0.0]} for i in range(n)]}


STAGE = [
    {"op": "optimizer", **_robot(0)},                     # no costmap yet
    {"op": "set_costmap", "data": _map(), "origin": [-1.0, -1.0],
     "resolution": 0.05},
    _opt(0),                                              # no footprint yet
    {"op": "set_footprint", "points": FOOTPRINT},
    {"op": "ping"},
]

PARITY_SCRIPT = STAGE + [
    _opt(0), _opt(0), _opt(1, robot="a"), _opt(0),
    {"op": "configure", "params": {"w_trans": 0.9}},      # runtime weight
    _opt(0),
    _batch(3), _batch(4), _batch(4), _batch(2),
    {"op": "set_plan", "poses": _plan(0)},
    {"op": "tick", "pose": [-0.3, 0.0, 0.0], "vel": [0.0, 0.0, 0.0],
     "delta_t": 0.033},
    {"op": "tick", "pose": [-0.28, 0.0, 0.01], "vel": [0.1, 0.0, 0.0],
     "delta_t": 0.033},
    {"op": "set_plans", "plans": [_plan(i) for i in range(3)]},
    _tick_batch(3), _tick_batch(3), _tick_batch(2),
    {"op": "set_costmap_update", "data": np.ones((4, 6)).tolist(),
     "lo": [18, 19]},
    _opt(0),
    {"op": "tick", "pose": [-0.1, 0.0, 0.0], "vel": [0.1, 0.0, 0.0],
     "delta_t": 0.033},
    {"op": "set_costmap_update", "data": [[0.0]], "lo": [60, 0]},
    {"op": "configure", "params": {}, "pipelined": True},
    _opt(0), _opt(0), _batch(2), _batch(3), _batch(3),
    {"op": "configure", "params": {"footprint_exact": True},
     "pipelined": False},
    _opt(0), _opt(1, robot="a"),
    {"op": "release", "robot": "a"}, {"op": "release", "robot": "zz"},
    {"op": "reset"}, {"op": "tick", "pose": [0, 0, 0], "vel": [0, 0, 0]},
    {"op": "nope"},
]

PRODUCT_PARAMS = {"parallel_line_search": True,
                  "solver_ls_quad_interp": False}

PRODUCT_SCRIPT = STAGE + [
    {"op": "configure", "params": PRODUCT_PARAMS},
    _opt(0), _opt(0), _batch(3), _batch(3),
    {"op": "set_plan", "poses": _plan(1)},
    {"op": "tick", "pose": [-0.3, 0.1, 0.0], "vel": [0.0, 0.0, 0.0],
     "delta_t": 0.033},
    {"op": "tick", "pose": [-0.28, 0.1, 0.0], "vel": [0.1, 0.0, 0.0],
     "delta_t": 0.033},
]


def _close(path, got, want):
    key = path[-1] if path else None
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _close(path + (k,), got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        if key == "output_vel":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4,
                                       err_msg=str(path))
        elif key in ("local_plan", "carrot_pose"):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-3,
                                       err_msg=str(path))
        else:
            for i, (g, w) in enumerate(zip(got, want)):
                _close(path + (i,), g, w)
    elif key == "iterations":
        assert type(got) is int and abs(got - want) <= 1, (path, got, want)
    elif key == "backend":
        assert got == want == "cpu"
    elif key == "lanes":
        # The port holds the robots; JAX pads to a power of two (ROADMAP.md,
        # Queue 3, deliberate divergences).
        assert type(got) is int and 0 < got <= want, (path, got, want)
    elif isinstance(want, float):
        assert type(got) is float, path
        assert abs(got - want) <= 1e-3 * max(1.0, abs(want)), (path, got,
                                                               want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


@pytest.mark.parametrize("script,parity", [(PARITY_SCRIPT, True),
                                           (PRODUCT_SCRIPT, False)],
                         ids=["parity", "product"])
def test_session_script_matches_jax(script, parity):
    jax_s, port = _sessions(parity=parity)
    for i, msg in enumerate(script):
        want = jax_s.handle(msg)
        got = port.handle(msg)
        _close((i, msg["op"]), got, want)
    assert port.cfg == tconfig.config_from_ros_params(
        {f: getattr(jax_s.cfg, f) for f in jax_s.cfg.__dataclass_fields__
         if f != "compat"})


def test_fleet_lanes_follow_the_robots():
    """No lane padding: the fleet state holds the robots; a grown fleet's
    new lanes start from init_state (they answer as a fresh session's
    lanes do) while the surviving lanes keep their warm starts, and a
    shrink drops the tail."""
    def staged():
        s = _sessions()[1]
        for msg in STAGE:
            s.handle(msg)
        return s

    port = staged()
    port.handle(_batch(3))
    assert port._fleet_state.initial_guess.shape[0] == 3
    got = port.handle(_batch(5))["results"]
    fresh = staged().handle(_batch(5))["results"]
    assert port._fleet_state.initial_guess.shape[0] == 5
    assert got[3:] == fresh[3:] and got[:3] != fresh[:3]
    port.handle(_batch(2))
    assert port._fleet_state.initial_guess.shape[0] == 2
    regrown = port.handle(_batch(3))["results"]
    assert regrown[2] == staged().handle(_batch(3))["results"][2]


def test_rejected_delta_t_creates_no_slot():
    """A non-finite delta_t is refused before the robot's slot exists, so
    it evicts no other robot (the JAX package creates the slot first)."""
    _, port = _sessions(max_slots=2)
    for msg in STAGE:
        port.handle(msg)
    assert "output_vel" in port.handle(_opt(0, robot="a"))
    assert "output_vel" in port.handle(_opt(1, robot="b"))
    r = port.handle(_opt(0, robot="c", delta_t=float("nan")))
    assert r == {"error": "delta_t is not finite"}
    assert set(port._slots) == {"a", "b"}
    r = port.handle(_opt(0, robot="c", current_pose=[float("inf"), 0, 0]))
    assert "non-finite" in r["error"] and set(port._slots) == {"a", "b"}


def test_chunked_dispatch_matches_one_dispatch():
    """fleet_chunk splits the lanes into chunks (the last one shorter);
    the responses are the single dispatch's."""
    _, one = _sessions()
    _, chunked = _sessions(fleet_chunk=2)
    for msg in STAGE + [_batch(5), _batch(5)]:
        a, b = one.handle(msg), chunked.handle(msg)
    assert a == b
    for msg in ({"op": "set_plans", "plans": [_plan(i) for i in range(5)]},
                _tick_batch(5)):
        a, b = one.handle(msg), chunked.handle(msg)
    assert a == b


def test_session_defaults_to_the_card():
    """Without device= the session is on the card: here, with no card, it
    raises."""
    if torch.cuda.is_available():
        assert OptimizerSession(
            tconfig.config_from_ros_params(_params())).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            OptimizerSession(tconfig.config_from_ros_params(_params()))
