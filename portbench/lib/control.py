"""The lower-precision control: the plain reference put in the program's
place, computed in bfloat16 (the configuration states float32; bfloat16 is
the step a later change would be tempted by). It offers the entry loops what
lib/program.py offers (a closed loop over a scene batch, and an
optimization server over loopback TCP), so the control runs through the
same window, the same judge and the same limits as the program. Its
readings are the upper ends the limits of checks/<cell>.json are set
below. The batched QP inverse runs in float32 and is rounded back: torch
has no bfloat16 matrix inverse.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
from types import SimpleNamespace

import numpy as np
import torch

from . import cells, judge, scenes
from .program import elapsed, sync  # noqa: F401

DTYPE = torch.bfloat16


def port_config(c: dict) -> dict:
    return c


def scenario_batch(cfg, c: dict, sc: dict) -> dict:
    return {"c": c, "sc": sc}


def simulate(cfg, parity: bool, sb, ticks: int, init=None, obstacles=None):
    """The closed loop of the scene batch, in bfloat16: -> an object with
    the fields of the program's SimResult that the entry loops read."""
    c, sc = sb["c"], sb["sc"]
    ref = cells.reference(c["reference"])
    P = ref.params_from_config(c)
    dev = sc["data"].device
    B = sc["data"].shape[0]
    fp = torch.as_tensor(scenes.footprint(c)).to(dev, DTYPE).expand(B, -1, -1)
    if init is None:
        state = ref.init_state(P, B, DTYPE, dev)
        pose, vel = sc["pose"].to(DTYPE), sc["vel"].to(DTYPE)
    else:
        state, pose, vel = init
        pose, vel = pose.to(DTYPE), vel.to(DTYPE)
    plan, nv = sc["plan"].to(DTYPE), sc["n_valid"].long()
    origin, res = sc["origin"].to(DTYPE), sc["res"].to(DTYPE)
    dt = 1.0 / P.controller_frequency
    poses, cmds = [], []
    for t in range(ticks):
        if obstacles is not None:
            e = elapsed(t, dt)
            data = ref.blob_map(obstacles[0] + e * obstacles[2], obstacles[1],
                                sc["origin"], sc["data"].shape[-1],
                                float(sc["res"][0]))
        else:
            data = sc["data"]
        grid = ref.Grid(data.to(DTYPE), origin, res)
        cmd, state, _ = ref.tick(P, state, plan, nv, pose, vel, grid, fp,
                                 fp.shape[1], DTYPE)
        pose = ref.plant(P, pose, cmd)
        vel = cmd
        poses.append(pose)
        cmds.append(cmd)
    return SimpleNamespace(
        poses=torch.stack(poses, 1).float(), cmds=torch.stack(cmds, 1).float(),
        solver_iters=torch.zeros(B, ticks, dtype=torch.int32, device=dev),
        final_state=state)


class _Session:
    """One robot's server state, answered by the reference in bfloat16."""

    def __init__(self, c: dict, device):
        self.c, self.dev = c, device
        self.ref = cells.reference(c["reference"])
        self.P = self.ref.params_from_config(c)
        self.P.p["footprint_edge_samples"] = judge.served_edge_samples(c)
        self.state = self.ref.init_state(self.P, 1, DTYPE, device)
        self.grid = self.fp = None

    def handle(self, msg: dict) -> dict:
        ref, P, dev = self.ref, self.P, self.dev
        t = lambda a: torch.as_tensor(np.float32(a), device=dev).to(DTYPE)
        if msg["op"] == "set_costmap":
            data = torch.as_tensor(np.asarray(msg["data"], np.float32),
                                   device=dev)[None]
            self.grid = ref.Grid(data.to(DTYPE), t(msg["origin"])[None],
                                 t([msg["resolution"]]))
            return {"ok": True}
        if msg["op"] == "set_footprint":
            self.fp = t(msg["points"])[None]
            return {"ok": True}
        pose = t(msg["current_pose"])[None]
        fpc = ref.footprint_cost(self.grid, ref.place(pose[:, None, :],
                                                      self.fp),
                                 self.fp.shape[1], P.footprint_edge_samples)
        cmd, self.state, x, conv = ref.serve_request(
            P, self.state, self.grid, self.fp, self.fp.shape[1], pose,
            t(msg["carrot_pose"])[None], t(msg["goal_pose"])[None],
            t(msg["current_vel"])[None], None,
            t([msg["control_interval"]]), t([msg["delta_t"]]), fpc, DTYPE)
        lp = torch.cat([pose[:, None], ref.rollout(
            x.reshape(1, P.n, 3), P.dt, pose)], 1)[0]
        return {"output_vel": cmd[0].float().tolist(),
                "success": bool(conv[0]), "iterations": 0, "cost": 0.0,
                "collision": bool(self.state["collision"][0]),
                "collision_footprint": bool(fpc[0] == 1.0),
                "local_plan": lp.float().tolist()}


def start_server(cfg, parity: bool, device: str) -> int:
    """A loopback server whose `optimizer` op is the bfloat16 reference."""
    session = _Session(cfg, device)

    class Handler(socketserver.StreamRequestHandler):
        def handle(self) -> None:
            for line in self.rfile:
                resp = session.handle(json.loads(line))
                self.wfile.write(json.dumps(resp).encode() + b"\n")
                self.wfile.flush()

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    srv = socketserver.ThreadingTCPServer(("127.0.0.1", port), Handler)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return port
