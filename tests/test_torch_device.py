"""The port's public entry points build their tensors on the card unless the
caller asks for the CPU.

Called with no `device`, each one either returns CUDA tensors (where a card
exists) or raises (on a machine without one): it never carries on on the
CPU. With device="cpu" it returns CPU tensors, and the constructors that
call another constructor hand their device on. Whether a card exists is
decided inside each test, never at import, so every worker collects the
same tests. Imports no JAX.
"""

import numpy as np
import pytest
import torch

import neo_mpc_planner2_tpu_torch as tp
from neo_mpc_planner2_tpu_torch import interop, scenarios
from neo_mpc_planner2_tpu_torch.ops import footprint as tfp
from neo_mpc_planner2_tpu_torch.ops import objective as tobj
from neo_mpc_planner2_tpu_torch.tree import tree_map


def _cfg():
    return tp.fleet_config().replace(max_plan_points=16)


def _leaves(tree):
    out = []
    tree_map(lambda t: out.append(t), tree)
    return out


def _numpy_batch():
    """A scenario batch as nested dicts of numpy arrays, the form the JAX
    package's containers take after `jax.tree.map(np.asarray, ...)`."""
    sb = tp.make_scenario_batch(_cfg(), 2, map_size=32, plan_points=8,
                                device="cpu")
    fields = lambda obj, names: {n: getattr(obj, n).numpy() for n in names}
    return {
        "state": fields(sb.state, tp.ControlState.__dataclass_fields__),
        "plan": fields(sb.plan, ("px", "py", "pyaw", "n_valid")),
        "robot_pose": sb.robot_pose.numpy(),
        "current_vel": sb.current_vel.numpy(),
        "costmap": fields(sb.costmap, ("data", "origin", "resolution")),
        "footprint": fields(sb.footprint, ("vertices", "n_valid")),
        "delta_t": sb.delta_t.numpy(),
    }


POSES = np.stack([np.linspace(0, 1, 5), np.zeros(5), np.zeros(5)], -1)

# name -> fn(**device_kw): each public entry point that builds tensors from
# host values.
ENTRY_POINTS = {
    "make_scenario_batch": lambda **kw: tp.make_scenario_batch(
        _cfg(), 2, map_size=32, plan_points=8, **kw),
    "init_state": lambda **kw: tp.init_state(_cfg(), **kw),
    "MpcEngine.init_state": lambda **kw: tp.MpcEngine(_cfg(),
                                                      **kw).init_state(),
    "MpcEngine.init_batch_state": lambda **kw: tp.MpcEngine(
        _cfg(), **kw).init_batch_state(3),
    "scenario_batch_from_numpy": lambda **kw:
        interop.scenario_batch_from_numpy(_numpy_batch(), **kw),
    "costmap_from_numpy": lambda **kw: interop.costmap_from_numpy(
        _numpy_batch()["costmap"], **kw),
    "plan_from_numpy": lambda **kw: interop.plan_from_numpy(
        _numpy_batch()["plan"], **kw),
    "footprint_from_numpy": lambda **kw: interop.footprint_from_numpy(
        _numpy_batch()["footprint"], **kw),
    "control_state_from_numpy": lambda **kw:
        interop.control_state_from_numpy(_numpy_batch()["state"], **kw),
    "mpo700_footprint": lambda **kw: scenarios.mpo700_footprint(**kw),
    "mpo500_footprint": lambda **kw: scenarios.mpo500_footprint(**kw),
    "Plan.from_poses": lambda **kw: tp.Plan.from_poses(POSES, 5, **kw),
    "Plan.create": lambda **kw: tp.Plan.create(POSES, 16, **kw),
    "Footprint.create": lambda **kw: tp.Footprint.create(
        [[0.2, 0.1], [-0.2, 0.1], [0.0, -0.2]], **kw),
    "Footprint.rectangle": lambda **kw: tp.Footprint.rectangle(0.6, 0.4,
                                                               **kw),
    "Costmap.create": lambda **kw: tp.Costmap.create(np.zeros((8, 8)), **kw),
    "Weights.from_config": lambda **kw: tobj.Weights.from_config(_cfg(), 3,
                                                                 **kw),
    "Limits.from_config": lambda **kw: tobj.Limits.from_config(_cfg(), 3,
                                                               **kw),
    "edge_parameters": lambda **kw: tfp.edge_parameters(16, **kw),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    build = ENTRY_POINTS[name]
    if torch.cuda.is_available():
        leaves = _leaves(build())
        assert leaves and all(t.is_cuda for t in leaves), name
    else:
        # torch raises on a CUDA device it was not built for or cannot
        # find; nothing falls back to the CPU.
        with pytest.raises((AssertionError, RuntimeError)):
            build()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_stays_on_the_cpu_when_asked(name):
    leaves = _leaves(ENTRY_POINTS[name](device="cpu"))
    assert leaves and all(t.device.type == "cpu" for t in leaves), name


def test_batch_simulate_follows_its_inputs_device():
    """simulation and the engine take their device from the tensors they
    are given: a CPU scenario runs on the CPU with no kernel launched."""
    from neo_mpc_planner2_tpu_torch import sqp

    sb = tp.make_scenario_batch(_cfg(), 2, map_size=32, plan_points=8,
                                device="cpu")
    before = sqp.qp_admm.launches
    res = tp.batch_simulate(_cfg(), sb, 1)
    assert all(t.device.type == "cpu" for t in _leaves(res))
    assert sqp.qp_admm.launches == before


def test_prox_solver_follows_its_inputs_device():
    """The prox path takes its device from the tensors it is given, like
    the SQP: a CPU scenario runs prox-FISTA on the CPU, with K3's plain
    version and no kernel launched."""
    from neo_mpc_planner2_tpu_torch.ops import footprint as fpm

    cfg = _cfg()
    sb = tp.make_scenario_batch(cfg, 2, map_size=32, plan_points=8,
                                device="cpu")
    before = fpm.footprint_cost_batch.launches
    res = tp.batch_simulate(cfg, sb, 1, parity=False,
                            solver_batch=tp.make_solver_batched(
                                cfg, tp.make_objective(cfg, parity=False)))
    assert all(t.device.type == "cpu" for t in _leaves(res))
    assert fpm.footprint_cost_batch.launches == before


def test_controller_runs_on_the_card_unless_asked_for_the_cpu():
    """NeoMpcController() is for the card: its configure raises without
    one; device="cpu" keeps its state on the CPU."""
    cfg = _cfg()
    ctrl = tp.NeoMpcController()
    if torch.cuda.is_available():
        ctrl.configure(cfg)
        assert all(t.is_cuda for t in _leaves(ctrl._state))
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ctrl.configure(cfg)
    cpu = tp.NeoMpcController(device="cpu")
    cpu.configure(cfg)
    assert all(t.device.type == "cpu" for t in _leaves(cpu._state))


def test_server_main_runs_on_the_card_unless_asked_for_the_cpu():
    """The console script's default --device is the card: without one it
    refuses to start (the session raises before the socket listens); with
    one it serves from the card."""
    import socket
    import threading

    from neo_mpc_planner2_tpu_torch import cli
    from neo_mpc_planner2_tpu_torch.serving import OptimizerClient

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.server_main(["--port", str(port)])
        return
    threading.Thread(target=cli.server_main, args=(["--port", str(port)],),
                     daemon=True).start()
    client = OptimizerClient(port=port, wait_timeout=60)
    try:
        assert client.call({"op": "ping"})["backend"] == "gpu"
    finally:
        client.close()
