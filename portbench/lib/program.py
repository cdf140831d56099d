"""The program under test, reached through its public entry points:
neo_mpc_planner2_tpu_torch's configuration, scene types, closed-loop
simulation and optimization server. Only this module and the entry
loops (lib/fleet.py, lib/serve.py) import it; the reference never
does."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import scenes


def port_config(c: dict):
    """The deployment's numbers as the port's MpcConfig."""
    from neo_mpc_planner2_tpu_torch.config import CompatConfig, MpcConfig

    names = {f.name for f in dataclasses.fields(MpcConfig)}
    kw = {k: v for k, v in {**c["ros_params"], **c["engine"]}.items()
          if k in names}
    missing = set(c["ros_params"]) | set(c["engine"])
    missing -= names
    if missing:
        raise KeyError(f"not fields of MpcConfig: {sorted(missing)}")
    return MpcConfig(**kw, compat=CompatConfig(**c["compat"]))


def scenario_batch(cfg, c: dict, sc: dict):
    """A scene batch (lib.scenes) as the port's ScenarioBatch."""
    from neo_mpc_planner2_tpu_torch.ops.costmap import Costmap
    from neo_mpc_planner2_tpu_torch.ops.footprint import Footprint
    from neo_mpc_planner2_tpu_torch.ops.pursuit import Plan
    from neo_mpc_planner2_tpu_torch.scenarios import ScenarioBatch

    dev = sc["data"].device
    B = sc["data"].shape[0]
    plan = Plan(px=sc["plan"][..., 0].contiguous(),
                py=sc["plan"][..., 1].contiguous(),
                pyaw=sc["plan"][..., 2].contiguous(), n_valid=sc["n_valid"])
    fp1 = Footprint.create(scenes.footprint(c), cfg.max_footprint_vertices,
                           device=dev)
    fp = Footprint(vertices=fp1.vertices.expand(B, -1, -1).contiguous(),
                   n_valid=fp1.n_valid.expand(B).contiguous())
    cm = Costmap(data=sc["data"], origin=sc["origin"], resolution=sc["res"])
    return ScenarioBatch(state=None, plan=plan, robot_pose=sc["pose"],
                         current_vel=sc["vel"], costmap=cm, footprint=fp,
                         delta_t=None)


def simulate(cfg, parity: bool, sb, ticks: int, init=None, obstacles=None):
    from neo_mpc_planner2_tpu_torch.simulation import batch_simulate

    return batch_simulate(cfg, sb, ticks, parity=parity, init=init,
                          dynamic_obstacles=obstacles)


def elapsed(t: int, dt: float) -> float:
    """f32(t) · f32(dt): the time of tick t as the program's clock has it."""
    return float(np.float32(t) * np.float32(dt))


def start_server(cfg, parity: bool, device: str):
    """The port's optimization server (serving.serve) in a daemon thread of
    this process, on a free loopback port. -> port.

    On a card the kernel library is built (first run in a checkout) or
    loaded here, in set-up: the server would otherwise build it inside the
    first request, longer than the client waits for a reply."""
    import socket
    import threading

    from neo_mpc_planner2_tpu_torch.serving import serve

    if torch.device(device).type == "cuda":
        from neo_mpc_planner2_tpu_torch.kernels.build import load_library

        load_library()

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    ready = threading.Event()
    threading.Thread(target=serve, daemon=True, kwargs=dict(
        host="127.0.0.1", port=port, cfg=cfg, ready_event=ready,
        parity=parity, device=device)).start()
    if not ready.wait(60):
        raise TimeoutError("the optimization server did not come up")
    return port


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
