"""Standalone optimization server (port of `serving.py`): the deployment twin
of the reference's `mpc_optimization_server` node
(mpc_optimization_server.py:441-447).

The wire protocol is the JAX package's, byte for byte: newline-delimited
JSON over TCP, the same ops, request fields, response keys and error
strings, so the C++ Nav2 plugin and either package's `OptimizerClient` talk
to this server unchanged:

    {"op": "configure", "params": {<ROS parameter names>}}
    {"op": "set_costmap", "data": [[...]], "origin": [x, y], "resolution": r}
    {"op": "set_costmap_update", "data": [[...]], "lo": [c, r], "win_lo": ..}
    {"op": "set_footprint", "points": [[x, y], ...]}
    {"op": "optimizer", "current_pose": [x,y,yaw], "carrot_pose": [x,y,yaw],
     "goal_pose": [x,y,yaw], "current_vel": [vx,vy,wz],
     "switch_opt": false, "control_interval": 0.033}
    {"op": "optimizer_batch", "robots": [{<optimizer fields>}, ...]}
    {"op": "set_plan", "poses": [[x, y, yaw], ...]}   # full-tick mode
    {"op": "tick", "pose": [x,y,yaw], "vel": [vx,vy,wz]}
    {"op": "set_plans", "plans": [<poses>, ...]}      # batched full tick
    {"op": "tick_batch", "robots": [{"pose": …, "vel": …}, ...]}
    {"op": "save_state"/"load_state", "path": "name[.npz]"[, "fleet": true]}
    {"op": "release", "robot": id}
    {"op": "reset"}
    {"op": "ping"}

See the JAX package's module for each op's semantics: robot slots (an
optional "robot" id, an LRU cap and a TTL), positional fleet lanes,
pipelined (advanced-step) mode, product mode (parity=False), runtime
parameters that need no rebuild (RUNTIME_PARAMS), checkpoints confined to
`checkpoint_dir` (a name ending in .npz is one file either package reads;
any other is a directory, here a `torch.distributed.checkpoint` one where
the JAX package writes orbax's). What differs here, each a deliberate
divergence (ROADMAP.md, Queue 3):

- The fleet ops (`optimizer_batch`, `tick_batch`) split their lanes into
  contiguous shards, one a device of `device`, as the JAX package shards
  them over every visible device: each shard's state and its copy of the
  staged map stay on its device, each shard is dispatched from its own
  host thread, and the results are gathered back in lane order.
  `device="cuda"` (no index) is every visible card, `"cuda:k"` that card,
  `"cpu"` the CPU; a tuple names the devices. Shards may differ by one
  lane (the JAX package pads the fleet to a multiple of the device count).
  The single-robot ops run on the first device.
- No lane padding. The JAX package pads a fleet to a power of two so that
  fleet-size churn reuses one compiled executable; eager PyTorch compiles
  nothing, so the fleet state holds exactly the robots. What a client sees
  is kept: new lanes start from init_state, a shrink drops the tail. A
  fleet checkpoint's "lanes" is the lanes its state holds (the robots,
  unless a padded JAX checkpoint was loaded).
- A checkpoint directory is PyTorch's own (`checkpoint.py`): the JAX
  package's orbax directories do not load here, nor the port's there; the
  packages cross through .npz names. A fleet save joins the shards and
  writes the whole state from this process; a fleet load re-splits it over
  the session's devices. A name that resolves to checkpoint_dir itself is
  refused (a directory save replaces its target).
- `fleet_chunk` defaults to 0: one batch a call (the JAX default of 4096
  is a TPU measurement). A positive value splits each shard's lanes into
  chunks of at most that many, the last one shorter.
- Pipelined mode keeps the semantics (a response carries the previous
  tick's result; the first is the warm-up response), but it hides no time:
  eager PyTorch launches the whole solve from the host, whose masked loops
  wait on the device, before the response is built.
- An `optimizer` request is validated, its delta_t included, before a slot
  is created: a rejected request creates no slot and evicts no robot (the
  JAX package checks delta_t after creating the slot).
- The staged map is copied once per fleet size into a contiguous per-lane
  batch for the kernels (K3 reads a lane's map at lane × H × W), where the
  JAX package reads one map in place for every lane.

Per response, one packed vector (a fleet: one (lanes, width) array a
shard) crosses from the device to the host; each request's floats cross the
other way as one array a shard.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import socketserver
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from .checkpoint import load_state, save_state
from .config import MpcConfig, config_from_ros_params, default_config
from .engine import (_solve_lanes, batch_state, init_state,
                     make_batched_controller_step)
from .ops.costmap import Costmap, u8_source_enabled
from .ops.footprint import Footprint, required_edge_samples
from .ops.objective import Limits, Scenario, Weights, make_objective
from .ops.pursuit import Plan
from .sqp import make_sqp_solver_batched
from .tree import tree_map
from .utils.profiling import span

# Parameters the reference's cb_params updates in place (py:405-439): weights
# and velocity/acceleration bounds. They reach the solve as per-lane
# Weights/Limits, so reconfiguring them rebuilds nothing.
RUNTIME_PARAMS = frozenset({
    "w_trans", "w_orient", "w_control", "w_terminal", "w_costmap",
    "w_footprint",
    "min_vel_x", "min_vel_y", "min_vel_theta", "min_vel_trans",
    "max_vel_x", "max_vel_y", "max_vel_trans", "max_vel_theta",
    "acc_x_limit", "acc_y_limit", "acc_theta_limit",
})

__all__ = ["OptimizerSession", "serve", "OptimizerClient"]


def _resolve_devices(device) -> tuple:
    """The fleet's devices: every visible card for "cuda" without an index,
    that card for "cuda:k", the CPU for "cpu", or each of a tuple/list."""
    devs = ([torch.device(d) for d in device]
            if isinstance(device, (tuple, list)) else [torch.device(device)])
    if not devs:
        raise ValueError("no device given")
    if any(d.type == "cuda" for d in devs) and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the server runs on the card "
                           "unless it is asked for the CPU (device='cpu')")
    if len(devs) == 1 and devs[0].type == "cuda" and devs[0].index is None:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return tuple(devs)


class OptimizerSession:
    """Transport-independent request handler (used directly in-process and
    behind `serve`). The single-robot ops run on the first of its devices
    (`device`); the fleet ops shard their lanes over all of them
    (`devices`)."""

    def __init__(self, cfg: Optional[MpcConfig] = None, pipelined: bool = False,
                 checkpoint_dir: Optional[str] = None, max_slots: int = 1024,
                 slot_ttl: Optional[float] = None, parity: bool = True,
                 fleet_chunk: int = 0, device="cuda"):
        self.devices = _resolve_devices(device)
        self.device = self.devices[0]
        self.cfg = cfg or default_config()
        self.fleet_chunk = int(fleet_chunk)
        self.parity = parity
        # Slot lifecycle: an LRU cap enforced when a new slot is created, and
        # an optional idle TTL (seconds) applied at the same point.
        self.max_slots = max(1, int(max_slots))
        self.slot_ttl = slot_ttl
        self._slot_clock = time.monotonic
        # save_state/load_state resolve names inside this directory only;
        # None disables them (the path arrives over an unauthenticated
        # socket).
        self.checkpoint_dir = checkpoint_dir
        self.costmap: Optional[Costmap] = None
        self.footprint: Optional[Footprint] = None
        self._slots: dict = {}
        self._fleet_last_time = 0.0
        self.pipelined = pipelined
        # optimizer_batch lanes: a batched ControlState of _fleet_n robots
        # (or of a loaded checkpoint's lanes) as a list of shards (_split;
        # `_fleet_state` joins them), and the pipelined pending (packed, n).
        self._fleet_shards = None
        self._fleet_pending = None
        self._fleet_n = 0
        # set_plans/tick_batch lanes, the state and plans as shards.
        self._ftick_shards = None
        self._ftick_plan_shards = None
        self._ftick_goals = None
        self._ftick_n = 0
        self._ftick_last_time = 0.0
        self._tick_step = None
        # Per lane count and device: the staged map and footprint as
        # contiguous lane batches, and the Weights/Limits of the config.
        self._lane_cache: dict = {}
        self._lane_lock = threading.Lock()   # shard threads fill the cache
        self._rebuild()

    # ---- slots ----
    def _slot(self, msg: dict) -> dict:
        rid = str(msg.get("robot", ""))
        slot = self._slots.get(rid)
        if slot is None:
            # Creation is the only growth path: expire TTL-idle slots, then
            # enforce the LRU cap, leaving room for the new slot.
            now = self._slot_clock()
            if self.slot_ttl is not None:
                dead = [r for r, s in self._slots.items()
                        if now - s["last_used"] > self.slot_ttl]
                for r in dead:
                    del self._slots[r]
            while len(self._slots) >= self.max_slots:
                lru = min(self._slots,
                          key=lambda r: self._slots[r]["last_used"])
                del self._slots[lru]
            slot = self._slots[rid] = {
                "state": init_state(self.cfg, self.device), "last_time": 0.0,
                "plan": None, "pending": None, "last_used": now}
        else:
            slot["last_used"] = self._slot_clock()
        return slot

    def op_release(self, msg: dict) -> dict:
        """Drop a robot's session slot. {"op": "release", "robot": id}."""
        rid = str(msg.get("robot", ""))
        released = self._slots.pop(rid, None) is not None
        return {"ok": True, "released": released, "slots": len(self._slots)}

    # Default-slot views: the single-robot state of the reference's server.
    @property
    def state(self):
        return self._slot({})["state"]

    @state.setter
    def state(self, v) -> None:
        self._slot({})["state"] = v

    @property
    def last_time(self) -> float:
        return self._slot({})["last_time"]

    @last_time.setter
    def last_time(self, v: float) -> None:
        self._slot({})["last_time"] = v

    @property
    def _pending(self):
        return self._slot({})["pending"]

    @_pending.setter
    def _pending(self, v) -> None:
        self._slot({})["pending"] = v

    @property
    def _plan(self):
        return self._slot({})["plan"]

    @_plan.setter
    def _plan(self, v) -> None:
        self._slot({})["plan"] = v

    def _clear_pendings(self) -> None:
        for slot in self._slots.values():
            slot["pending"] = None
        self._fleet_pending = None

    # ---- lanes ----
    def _fresh(self, lanes: int):
        return batch_state(init_state(self.cfg, self.device), lanes)

    def _lanes(self, lanes: int, device) -> dict:
        """The staged map, footprint, weights and limits as `lanes`-lane
        batches on `device`, built once per lane count, device and
        staging."""
        with self._lane_lock:
            got = self._lane_cache.get((lanes, device))
            if got is None:
                got = self._lane_cache[(lanes, device)] = self._build_lanes(
                    lanes, device)
        return got

    def _build_lanes(self, lanes: int, device) -> dict:
        cm, fp = self.costmap, self.footprint
        rep = lambda t: t.to(device).expand((lanes,) + t.shape).contiguous()
        h, w = cm.data.shape
        lane_cm = Costmap(data=rep(cm.data), origin=rep(cm.origin),
                          resolution=rep(cm.resolution),
                          win_lo=None if cm.win_lo is None else rep(cm.win_lo),
                          win_cells=cm.win_cells).with_flat(
            u8=u8_source_enabled(self.cfg.solver_costmap_u8, h * w))
        return {"costmap": lane_cm,
                "footprint": Footprint(vertices=rep(fp.vertices),
                                       n_valid=rep(fp.n_valid)),
                "weights": Weights.from_config(self.cfg, lanes, device),
                "limits": Limits.from_config(self.cfg, lanes, device)}

    # ---- fleet shards ----
    def _bounds(self, lanes: int) -> list:
        """The fleet's contiguous shards, one a device while there are lanes
        for it: [(device, lo, hi)], the first lanes % shards one longer."""
        shards = max(1, min(len(self.devices), lanes))
        base, extra = divmod(lanes, shards)
        out, lo = [], 0
        for i in range(shards):
            hi = lo + base + (i < extra)
            out.append((self.devices[i], lo, hi))
            lo = hi
        return out

    def _split(self, tree, lanes: int) -> list:
        """A lane-batched tree as the fleet's shards, each on its device."""
        return [tree_map(lambda x: x[lo:hi].to(dev), tree)
                for dev, lo, hi in self._bounds(lanes)]

    def _join(self, shards: list):
        """The shards as one lane-batched tree on the first device."""
        if len(shards) == 1:
            return shards[0]
        return tree_map(lambda *xs: torch.cat([x.to(self.device)
                                               for x in xs]), *shards)

    @property
    def _fleet_state(self):
        """The optimizer_batch state as one lane batch on the first device
        (None before the first fleet request)."""
        return (None if self._fleet_shards is None
                else self._join(self._fleet_shards))

    @_fleet_state.setter
    def _fleet_state(self, st) -> None:
        self._fleet_shards = (None if st is None
                              else self._split(st, st.initial_guess.shape[0]))

    @staticmethod
    def _shard_lanes(shards: list) -> int:
        return sum(int(s.initial_guess.shape[0]) for s in shards)

    def _chunked(self, fn, lane_args, lanes: int):
        """fn(*lane_args) -> (packed, state) over `lanes` lanes of one
        shard, in chunks of at most fleet_chunk lanes when it is positive
        (lanes are independent, so the results are the single call's)."""
        chunk = self.fleet_chunk
        if chunk <= 0 or lanes <= chunk:
            return fn(*lane_args)
        packs, states = [], []
        for i in range(0, lanes, chunk):
            part = tree_map(lambda x: x[i:i + chunk], lane_args)
            p, s = fn(*part)
            packs.append(p)
            states.append(s)
        return (torch.cat(packs), tree_map(lambda *xs: torch.cat(xs),
                                           *states))

    def _dispatch(self, fn, shard_args: list, reqs: np.ndarray):
        """fn over every shard: shard_args[i] are shard i's lane arguments
        on its device, reqs the fleet's (lanes, width) requests, split the
        same way. Each shard runs from its own host thread on its device.
        -> (packed (lanes, width) on the host, the new state's shards)."""
        def run(i, dev, lo, hi):
            args = (*shard_args[i], torch.as_tensor(reqs[lo:hi], device=dev))
            if dev.type != "cuda":
                return self._chunked(fn, args, hi - lo)
            with torch.cuda.device(dev):
                return self._chunked(fn, args, hi - lo)

        bounds = self._bounds(reqs.shape[0])
        if len(bounds) == 1:
            outs = [run(0, *bounds[0])]
        else:
            with ThreadPoolExecutor(len(bounds)) as pool:
                outs = list(pool.map(lambda ib: run(ib[0], *ib[1]),
                                     enumerate(bounds)))
        packed = np.concatenate([p.cpu().numpy() for p, _ in outs])
        return packed, [st for _, st in outs]

    # Request vector: [pose(3), carrot(3), goal(3), vel(3), switch_opt,
    # control_interval, delta_t] = 15 floats. Response vector: the
    # _pack_common prefix [cmd(3), converged, iters, fun, collision,
    # collision_footprint], the full tick's extras, then the local plan.
    _REQ_W = 15

    @staticmethod
    def _pack_common(o) -> list:
        """The shared response prefix, 8 columns a lane; _resp_from_vec is
        its decoder."""
        col = lambda x: x.to(torch.float32)[:, None]
        return [o.cmd_vel, col(o.solver_converged), col(o.solver_iters),
                col(o.fun), col(o.collision), col(o.collision_footprint)]

    @staticmethod
    def _pack_tick_extras(o) -> list:
        """The full tick's extras after the prefix: [lethal(8),
        plan_empty(9), carrot(10:13), window begin/end(13:15)];
        _tick_extras_from_vec is their decoder."""
        col = lambda x: x.to(torch.float32)[:, None]
        return [col(o.lethal), col(o.plan_empty), o.carrot_pose,
                col(o.plan_window_begin), col(o.plan_window_end)]

    @staticmethod
    def _tick_extras_from_vec(vec: np.ndarray) -> dict:
        return {
            "lethal": bool(vec[8] > 0.5),
            "plan_empty": bool(vec[9] > 0.5),
            "carrot_pose": vec[10:13].tolist(),
            "plan_window": [int(round(float(vec[13]))),
                            int(round(float(vec[14])))],
        }

    def _solve_requests(self, state, reqs):
        """The optimizer ops on len(reqs) lanes: reqs (B, 15) on the device,
        state (B, ...). -> (packed (B, 8 + 3(N + 1)), new state)."""
        B = reqs.shape[0]
        lanes = self._lanes(B, reqs.device)
        scen = Scenario(
            current_pose=reqs[:, 0:3], carrot_pose=reqs[:, 3:6],
            goal_pose=reqs[:, 6:9], current_vel=reqs[:, 9:12],
            footprint=lanes["footprint"], costmap=lanes["costmap"],
            switch_opt=reqs[:, 12] != 0, control_interval=reqs[:, 13],
            weights=lanes["weights"], limits=lanes["limits"])
        out = _solve_lanes(self.cfg, state, scen, reqs[:, 14], self._solve)
        packed = torch.cat(self._pack_common(out)
                           + [out.local_plan.reshape(B, -1)], dim=-1)
        return packed, out.state

    def _tick_lanes(self, state, plans, reqs):
        """The full tick on len(reqs) lanes: reqs (B, 7) = [pose(3),
        vel(3), delta_t]. -> (packed (B, 15 + 3(N + 1)), new state)."""
        B = reqs.shape[0]
        lanes = self._lanes(B, reqs.device)
        o = self._tick_fn()(state, plans, reqs[:, 0:3], reqs[:, 3:6],
                            lanes["costmap"], lanes["footprint"],
                            reqs[:, 6])
        packed = torch.cat(self._pack_common(o) + self._pack_tick_extras(o)
                           + [o.local_plan.reshape(B, -1)], dim=-1)
        return packed, o.state

    def _tick_fn(self):
        """The batched full tick of the current config, built at first
        use."""
        if self._tick_step is None:
            self._tick_step = make_batched_controller_step(
                self.cfg, parity=self.parity)
        return self._tick_step

    def _rebuild(self) -> None:
        cfg = self.cfg
        self._solve = make_sqp_solver_batched(
            cfg, make_objective(cfg, parity=self.parity))
        self._tick_step = None
        self._lane_cache = {}
        # A reconfigure keeps mission state where shapes allow (cb_params,
        # py:405-439); only a control_steps change resets it.
        m = 3 * cfg.control_steps
        for slot in self._slots.values():
            if slot["state"] is None or slot["state"].initial_guess.shape[0] != m:
                slot["state"] = init_state(cfg, self.device)
                slot["pending"] = None
        if (self._fleet_shards is not None
                and self._fleet_shards[0].initial_guess.shape[-1] != m):
            self._fleet_shards = None
            self._fleet_pending = None
        if (self._ftick_shards is not None
                and self._ftick_shards[0].initial_guess.shape[-1] != m):
            self._ftick_shards = None
            self._ftick_plan_shards = None
            self._ftick_goals = None
            self._ftick_n = 0

    # ---- ops ----
    def op_configure(self, msg: dict) -> dict:
        # A partial reconfigure merges over the current config (cb_params).
        old_cfg = self.cfg
        params = msg.get("params", {})
        self.cfg = config_from_ros_params(params, base=self.cfg)
        if "pipelined" in msg:
            was = self.pipelined
            self.pipelined = bool(msg["pipelined"])
            if was != self.pipelined:
                # A toggle drops any in-flight result.
                self._clear_pendings()
        changed = {f.name for f in dataclasses.fields(MpcConfig)
                   if f.name != "compat"
                   and getattr(self.cfg, f.name) != getattr(old_cfg, f.name)}
        if changed <= RUNTIME_PARAMS:
            # Weights and bounds only: new per-lane Weights/Limits, the same
            # solver; the full tick reads them from cfg, so it is rebuilt.
            self._lane_cache = {}
            self._tick_step = None
            return {"ok": True, "pipelined": self.pipelined, "retraced": False}
        self._clear_pendings()
        self._rebuild()
        if self.costmap is not None:
            # Re-derive the staged gather caches under the new cfg (the u8
            # companion is decided at staging time).
            h, w = self.costmap.data.shape[-2], self.costmap.data.shape[-1]
            self.costmap = self.costmap.with_flat(
                u8=u8_source_enabled(self.cfg.solver_costmap_u8, h * w))
        return {"ok": True, "pipelined": self.pipelined, "retraced": True}

    def op_set_costmap(self, msg: dict) -> dict:
        """Stage the full grid; "win_cells": N (and "win_lo": [col, row])
        makes the solver see the N×N rolling-window view of it."""
        data = np.asarray(msg["data"], np.float32)
        if data.ndim != 2 or data.size == 0:
            return {"error": "costmap data must be a non-empty 2-D grid"}
        if not np.isfinite(data).all():
            return {"error": "costmap data contains non-finite values"}
        cm = Costmap.create(data, origin=tuple(msg.get("origin", (0.0, 0.0))),
                            resolution=float(msg.get("resolution", 0.05)),
                            device=self.device)
        h, w = cm.data.shape
        if "win_cells" in msg:
            wc = int(msg["win_cells"])
            lo = np.asarray(msg.get("win_lo", (0, 0)), np.int32)
            if not (0 < wc <= min(h, w)):
                return {"error": f"win_cells must be in [1, {min(h, w)}]"}
            if (lo.shape != (2,) or lo.min() < 0 or lo[0] + wc > w
                    or lo[1] + wc > h):
                return {"error": "win_lo puts the window outside the map"}
            cm = cm.replace(win_lo=torch.as_tensor(lo, device=self.device),
                            win_cells=wc)
        self.costmap = cm.with_flat(
            u8=u8_source_enabled(self.cfg.solver_costmap_u8, h * w))
        self._lane_cache = {}
        self._ensure_footprint_sampling()
        return {"ok": True, "shape": [h, w]}

    def op_set_costmap_update(self, msg: dict) -> dict:
        """Write a dirty block of cells at "lo" [col, row] and/or move the
        rolling window ("win_lo") without re-sending the grid."""
        if self.costmap is None:
            return {"error": "no costmap set"}
        cm = self.costmap
        h, w = cm.data.shape
        if "data" in msg:
            cells = np.asarray(msg["data"], np.float32)
            lo = np.asarray(msg.get("lo", (0, 0)), np.int32)
            if cells.ndim != 2 or cells.size == 0:
                return {"error": "update data must be a non-empty 2-D block"}
            if not np.isfinite(cells).all():
                return {"error": "update data contains non-finite values"}
            if (lo.shape != (2,) or lo.min() < 0 or lo[0] + cells.shape[1] > w
                    or lo[1] + cells.shape[0] > h):
                return {"error": "update window outside the map"}
            cm = cm.update_window(torch.as_tensor(cells, device=self.device),
                                  torch.as_tensor(lo, device=self.device))
        if "win_lo" in msg:
            if cm.win_cells is None:
                return {"error": "no rolling window configured "
                                 "(set_costmap with win_cells first)"}
            lo = np.asarray(msg["win_lo"], np.int32)
            wc = cm.win_cells
            if (lo.shape != (2,) or lo.min() < 0 or lo[0] + wc > w
                    or lo[1] + wc > h):
                return {"error": "win_lo puts the window outside the map"}
            cm = cm.replace(win_lo=torch.as_tensor(lo, device=self.device))
        self.costmap = cm
        self._lane_cache = {}
        return {"ok": True}

    def op_set_footprint(self, msg: dict) -> dict:
        pts = np.asarray(msg["points"], np.float32)
        if pts.ndim != 2 or pts.shape[0] < 1 or pts.shape[1] != 2:
            return {"error": "footprint points must be a non-empty (V, 2) list"}
        if not np.isfinite(pts).all():
            return {"error": "footprint contains non-finite values"}
        self.footprint = Footprint.create(
            pts, max_vertices=self.cfg.max_footprint_vertices,
            device=self.device)
        self._lane_cache = {}
        self._ensure_footprint_sampling()
        return {"ok": True}

    def _ensure_footprint_sampling(self) -> None:
        """Raise footprint_edge_samples so that uniform sampling skips no
        cell (ceil(max_edge/resolution) + 2). No-op in exact mode."""
        if (self.cfg.footprint_exact or self.costmap is None
                or self.footprint is None):
            return
        nv = int(self.footprint.n_valid)
        need = required_edge_samples(
            self.footprint.vertices[:nv].cpu().numpy(),
            float(self.costmap.resolution))
        if need > self.cfg.footprint_edge_samples:
            self.cfg = self.cfg.replace(footprint_edge_samples=need)
            self._rebuild()

    def op_reset(self, msg: dict) -> dict:
        """New-mission reset: every slot (state, clock, plan, pending) and
        both fleets."""
        self._slots = {}
        self._fleet_shards = None
        self._fleet_pending = None
        self._fleet_n = 0
        self._fleet_last_time = 0.0
        self._ftick_shards = None
        self._ftick_plan_shards = None
        self._ftick_goals = None
        self._ftick_n = 0
        self._ftick_last_time = 0.0
        return {"ok": True}

    def op_ping(self, msg: dict) -> dict:
        backend = "gpu" if self.device.type == "cuda" else self.device.type
        return {"ok": True, "backend": backend, "slots": len(self._slots)}

    def _checkpoint_path(self, msg: dict) -> str:
        """A request's checkpoint name inside checkpoint_dir: relative, no
        '..', not checkpoint_dir itself; the ops are off unless the
        server has a directory."""
        if self.checkpoint_dir is None:
            raise ValueError(
                "checkpoint ops disabled: configure the session/server "
                "with a checkpoint_dir")
        name = str(msg["path"])
        if os.path.isabs(name) or ".." in name.replace("\\", "/").split("/"):
            raise ValueError("checkpoint path must be relative without '..'")
        if os.path.normpath(name) == ".":
            raise ValueError("checkpoint path must name an entry inside "
                             "checkpoint_dir")
        return os.path.join(self.checkpoint_dir, name)

    def op_save_state(self, msg: dict) -> dict:
        """{"op": "save_state", "path": p[, "fleet": true]}: p a name under
        checkpoint_dir, an .npz file or a directory (checkpoint.py). The
        fleet's shards are joined and written whole by this process."""
        path = self._checkpoint_path(msg)
        if msg.get("fleet"):
            if self._fleet_shards is None:
                return {"error": "no fleet state to save"}
            save_state(path, self._fleet_state)
            return {"ok": True, "fleet": True,
                    "lanes": self._shard_lanes(self._fleet_shards),
                    "robots": self._fleet_n}
        # Looked up without _slot(): saving creates no slot.
        rid = str(msg.get("robot", ""))
        slot = self._slots.get(rid)
        if slot is None:
            return {"error": f"no session state for robot {rid!r} "
                             "(nothing solved yet?)"}
        slot["last_used"] = self._slot_clock()
        save_state(path, slot["state"])
        return {"ok": True, "fleet": False}

    def op_load_state(self, msg: dict) -> dict:
        """Restore a save_state checkpoint. A fleet restore takes the
        checkpoint's lanes, split over the session's devices; {"robots": n}
        sets the live robot count (default: every lane), clamped to
        [0, lanes]."""
        path = self._checkpoint_path(msg)
        st = load_state(path, device=self.device)
        if int(st.initial_guess.shape[-1]) != 3 * self.cfg.control_steps:
            return {"error": "checkpoint control_steps mismatch"}
        if msg.get("fleet"):
            lanes = int(st.initial_guess.shape[0])
            self._fleet_state = st
            self._fleet_n = max(0, min(int(msg.get("robots", lanes)), lanes))
            self._fleet_pending = None
            return {"ok": True, "fleet": True, "lanes": lanes,
                    "robots": self._fleet_n}
        slot = self._slot(msg)
        slot["state"] = st
        slot["pending"] = None
        return {"ok": True, "fleet": False}

    def _pack_req(self, msg: dict, delta_t: float) -> np.ndarray:
        req = np.zeros(self._REQ_W, np.float32)
        req[0:3] = np.asarray(msg["current_pose"], np.float32)
        req[3:6] = np.asarray(msg["carrot_pose"], np.float32)
        req[6:9] = np.asarray(msg["goal_pose"], np.float32)
        req[9:12] = np.asarray(msg["current_vel"], np.float32)
        req[12] = 1.0 if msg.get("switch_opt", False) else 0.0
        req[13] = float(msg.get("control_interval",
                                self.cfg.control_interval))
        req[14] = float(delta_t)
        if not np.isfinite(req).all():
            # Reject rather than let a bad pose poison the warm start.
            raise ValueError("request contains non-finite values")
        return req

    def _resp_from_vec(self, vec: np.ndarray, lp_off: int = 8) -> dict:
        """Decode the _pack_common prefix and the local plan at lp_off (8
        for the optimizer ops; the full tick's extras sit in between)."""
        n = self.cfg.control_steps
        return {
            "output_vel": vec[:3].tolist(),
            "success": bool(vec[3] > 0.5),
            "iterations": int(round(float(vec[4]))),
            "cost": float(vec[5]),
            "collision": bool(vec[6] > 0.5),
            "collision_footprint": bool(vec[7] > 0.5),
            "local_plan": vec[lp_off:lp_off + 3 * (n + 1)]
                          .reshape(n + 1, 3).tolist(),
        }

    def _warmup_resp(self) -> dict:
        return {"output_vel": [0.0, 0.0, 0.0], "success": True,
                "iterations": 0, "cost": 0.0, "collision": False,
                "collision_footprint": False, "pipelined_warmup": True,
                "local_plan": np.zeros(
                    (self.cfg.control_steps + 1, 3)).tolist()}

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def op_optimizer(self, msg: dict) -> dict:
        if self.costmap is None:
            return {"error": "no costmap set"}
        if self.footprint is None:
            return {"error": "no footprint set"}
        with span("serve.pack"):
            # Validate the whole request, delta_t included, before the slot
            # is looked up: a rejected request neither moves the slot's
            # clock nor creates a slot (which could LRU-evict another
            # robot).
            req = self._pack_req(msg, 0.0)
            if "delta_t" in msg:
                delta_t = float(msg["delta_t"])
                if not np.isfinite(delta_t):
                    return {"error": "delta_t is not finite"}
            slot = self._slot(msg)
            if "delta_t" not in msg:
                now = time.time()
                delta_t = now - slot["last_time"]
                slot["last_time"] = now
            req[14] = delta_t
            reqs = self._to_device(req[None])
        # The solve span ends with the device-to-host copy of the answer.
        with span("serve.solve"):
            packed, st = self._solve_requests(
                tree_map(lambda x: x[None], slot["state"]), reqs)
            slot["state"] = tree_map(lambda x: x[0], st)
            packed = packed[0]
            if self.pipelined:
                prev, slot["pending"] = slot["pending"], packed
                if prev is None:
                    return self._warmup_resp()
                packed = prev
            vec = packed.cpu().numpy()
        with span("serve.unpack"):
            return self._resp_from_vec(vec)

    # ---- full-tick mode ----
    def op_set_plan(self, msg: dict) -> dict:
        """Stage the global plan for op_tick (setPlan, cpp:274-281): the
        consumed prefix resets; slow-down latches only on a goal change."""
        poses = np.asarray(msg["poses"], np.float32)
        if poses.ndim != 2 or poses.shape[0] < 1 or poses.shape[1] != 3:
            return {"error": "poses must be a non-empty (N, 3) list"}
        if poses.shape[0] > self.cfg.max_plan_points:
            return {"error": f"plan has {poses.shape[0]} poses > "
                             f"max_plan_points={self.cfg.max_plan_points}"}
        slot = self._slot(msg)
        new_plan = Plan.create(poses, max_points=self.cfg.max_plan_points,
                               device=self.device)
        old = slot["plan"]
        goal_changed = (old is None
                        or not torch.equal(old.goal(), new_plan.goal()))
        slot["plan"] = new_plan
        st = slot["state"]
        slot["state"] = st.replace(
            plan_start=torch.zeros_like(st.plan_start),
            slow_down=st.slow_down | goal_changed)
        return {"ok": True, "n_poses": int(poses.shape[0])}

    def op_tick(self, msg: dict) -> dict:
        """One full controller tick: pursuit + solve + post-processing. The
        plugin gates come back as the `lethal`/`plan_empty` flags."""
        if self.costmap is None:
            return {"error": "no costmap set"}
        if self.footprint is None:
            return {"error": "no footprint set"}
        slot = self._slot(msg)
        if slot["plan"] is None:
            return {"error": "no plan set (op set_plan first)"}
        pose = np.asarray(msg["pose"], np.float32)
        vel = np.asarray(msg["vel"], np.float32)
        if pose.shape != (3,) or vel.shape != (3,):
            return {"error": "pose and vel must be [x, y, yaw]/[vx, vy, wz]"}
        if "delta_t" in msg:
            delta_t = float(msg["delta_t"])
        else:
            now = time.time()
            delta_t = now - slot["last_time"]
            slot["last_time"] = now
        req = np.concatenate([pose, vel, [delta_t]]).astype(np.float32)
        one = lambda x: x[None]
        packed, st = self._tick_lanes(tree_map(one, slot["state"]),
                                      tree_map(one, slot["plan"]),
                                      self._to_device(req[None]))
        slot["state"] = tree_map(lambda x: x[0], st)
        vec = packed[0].cpu().numpy()
        resp = self._resp_from_vec(vec, lp_off=15)
        resp.update(self._tick_extras_from_vec(vec))
        return resp

    def op_set_plans(self, msg: dict) -> dict:
        """Stage positional per-lane plans for op_tick_batch. Lanes whose
        goal changed, and new lanes, get the setPlan latch (prefix reset +
        slow-down); surviving same-goal lanes keep their state."""
        raw = msg.get("plans", [])
        if not raw:
            return {"error": "empty plans list"}
        built = []
        for p in raw:
            poses = np.asarray(p, np.float32)
            if poses.ndim != 2 or poses.shape[0] < 1 or poses.shape[1] != 3:
                return {"error": "each plan must be a non-empty (N, 3) list"}
            if poses.shape[0] > self.cfg.max_plan_points:
                return {"error": f"a plan has {poses.shape[0]} poses > "
                                 f"max_plan_points={self.cfg.max_plan_points}"}
            built.append(poses)
        n = len(built)
        P = self.cfg.max_plan_points
        padded = np.stack([np.concatenate([b, np.repeat(b[-1:], P - len(b),
                                                        0)]) for b in built])
        plans = Plan.from_poses(self._to_device(padded),
                                [len(b) for b in built], self.device)
        new_goals = np.stack([b[-1] for b in built])
        st = self._fresh(n)
        old = (None if self._ftick_shards is None
               else self._join(self._ftick_shards))
        keep = (min(self._ftick_n, n, int(old.initial_guess.shape[0]))
                if old is not None else 0)
        if keep:
            st = tree_map(lambda f, o: torch.cat([o[:keep], f[keep:]]),
                          st, old)
        changed = np.ones((n,), bool)
        if self._ftick_goals is not None:
            k = min(keep, len(self._ftick_goals), n)
            changed[:k] = np.any(self._ftick_goals[:k] != new_goals[:k],
                                 axis=-1)
        st = st.replace(plan_start=torch.zeros_like(st.plan_start),
                        slow_down=st.slow_down | self._to_device(changed))
        self._ftick_shards = self._split(st, n)
        self._ftick_plan_shards = self._split(plans, n)
        self._ftick_goals = new_goals
        self._ftick_n = n
        return {"ok": True, "n_plans": n, "lanes": n}

    def op_tick_batch(self, msg: dict) -> dict:
        """The batched full tick: {"op": "tick_batch", "robots": [{"pose":
        …, "vel": …}, …]}, as many robots as staged plans; blocking."""
        if self.costmap is None:
            return {"error": "no costmap set"}
        if self.footprint is None:
            return {"error": "no footprint set"}
        if self._ftick_plan_shards is None:
            return {"error": "no plans staged (op set_plans first)"}
        robots = msg.get("robots", [])
        if len(robots) != self._ftick_n:
            return {"error": f"{len(robots)} robots != {self._ftick_n} "
                             f"staged plans (re-stage with set_plans)"}
        n = self._ftick_n
        if "delta_t" in msg:
            delta_t = float(msg["delta_t"])
        else:
            now = time.time()
            delta_t = now - self._ftick_last_time
            self._ftick_last_time = now
        reqs = np.zeros((n, 7), np.float32)
        reqs[:, 6] = delta_t
        for i, r in enumerate(robots):
            pose = np.asarray(r["pose"], np.float32)
            vel = np.asarray(r["vel"], np.float32)
            if pose.shape != (3,) or vel.shape != (3,):
                return {"error": "pose and vel must be "
                                 "[x, y, yaw]/[vx, vy, wz]"}
            reqs[i, 0:3] = pose
            reqs[i, 3:6] = vel
        self._tick_fn()     # built here, not in the shards' threads
        vecs, self._ftick_shards = self._dispatch(
            self._tick_lanes,
            list(zip(self._ftick_shards, self._ftick_plan_shards)), reqs)
        results = []
        for vec in vecs:
            resp = self._resp_from_vec(vec, lp_off=15)
            resp.update(self._tick_extras_from_vec(vec))
            results.append(resp)
        return {"results": results}

    def op_optimizer_batch(self, msg: dict) -> dict:
        """Fleet tick: n robots on the staged map and footprint, one batch a
        shard (or fleet_chunk-sized chunks of it) a call. Robots are
        positional; new lanes start from init_state, a shrink drops the
        tail."""
        if self.costmap is None:
            return {"error": "no costmap set"}
        if self.footprint is None:
            return {"error": "no footprint set"}
        robots = msg.get("robots", [])
        n = len(robots)
        if n == 0:
            return {"error": "empty robots list"}
        # Validate every request before any state changes.
        default_ci = msg.get("control_interval", self.cfg.control_interval)
        reqs = np.zeros((n, self._REQ_W), np.float32)
        for i, r in enumerate(robots):
            reqs[i] = self._pack_req(
                {**r, "control_interval": r.get("control_interval",
                                                default_ci)}, 0.0)
        if "delta_t" in msg:
            delta_t = float(msg["delta_t"])
            if not np.isfinite(delta_t):
                return {"error": "delta_t is not finite"}
        else:
            now = time.time()
            delta_t = now - self._fleet_last_time
            self._fleet_last_time = now
        reqs[:, 14] = delta_t

        old = self._fleet_shards
        if old is None or self._shard_lanes(old) != n or n > self._fleet_n:
            st = self._fresh(n)
            if old is not None:
                old = self._join(old)
                keep = min(self._fleet_n, n, int(old.initial_guess.shape[0]))
                if keep:
                    st = tree_map(
                        lambda f, o: torch.cat([o[:keep], f[keep:]]), st, old)
            self._fleet_state = st
        packed, self._fleet_shards = self._dispatch(
            self._solve_requests, [(s,) for s in self._fleet_shards], reqs)
        self._fleet_n = n

        n_out = n
        if self.pipelined:
            prev, self._fleet_pending = self._fleet_pending, (packed, n)
            if prev is None:
                return {"results": [self._warmup_resp() for _ in range(n)]}
            # Surviving lanes get the previous tick's results; new lanes a
            # warm-up entry.
            packed, prev_n = prev
            n_out = min(prev_n, n)
        results = [self._resp_from_vec(v) for v in packed[:n_out]]
        results += [self._warmup_resp() for _ in range(n - n_out)]
        return {"results": results}

    def handle(self, msg: dict) -> dict:
        op = msg.get("op")
        fn = getattr(self, f"op_{op}", None)
        if fn is None:
            return {"error": f"unknown op: {op!r}"}
        try:
            return fn(msg)
        except Exception as e:  # noqa: BLE001 — the error net is the contract
            # Every failure comes back as {"error": ...} on the same
            # connection; KeyboardInterrupt/SystemExit still propagate.
            return {"error": f"{type(e).__name__}: {e}"}


def serve(host: str = "127.0.0.1", port: int = 7180,
          cfg: Optional[MpcConfig] = None, ready_event=None,
          pipelined: bool = False,
          checkpoint_dir: Optional[str] = None, max_slots: int = 1024,
          slot_ttl: Optional[float] = None, parity: bool = True,
          fleet_chunk: int = 0, device="cuda") -> None:
    """Blocking server loop. Connections are threaded; requests serialize on
    one lock, the discipline of the reference's single-threaded executor
    (py:441-444). checkpoint_dir enables save_state/load_state inside it.
    The session lives on `device` (every visible card for "cuda"), the card
    unless the caller asks for the CPU."""
    session = OptimizerSession(cfg, pipelined=pipelined,
                               checkpoint_dir=checkpoint_dir,
                               max_slots=max_slots, slot_ttl=slot_ttl,
                               parity=parity, fleet_chunk=fleet_chunk,
                               device=device)
    lock = threading.Lock()

    class Handler(socketserver.StreamRequestHandler):
        def handle(self) -> None:
            seq = 0  # the request's number on this connection
            for line in self.rfile:
                line = line.strip()
                if not line:
                    continue
                with span("serve.request", trace=seq) as request:
                    with span("serve.decode"):
                        try:
                            msg, resp = json.loads(line), None
                        except json.JSONDecodeError as e:
                            resp = {"error": f"bad json: {e}"}
                    if resp is None:
                        request.set(op=msg.get("op")
                                    if isinstance(msg, dict) else None)
                        with span("serve.lock_wait"):
                            lock.acquire()
                        try:
                            with span("serve.handle"):
                                resp = session.handle(msg)
                        finally:
                            lock.release()
                    with span("serve.encode"):
                        self.wfile.write(json.dumps(resp).encode() + b"\n")
                        self.wfile.flush()
                seq += 1

    class Server(socketserver.ThreadingMixIn, socketserver.TCPServer):
        allow_reuse_address = True  # must be set before bind
        daemon_threads = True

    with Server((host, port), Handler) as srv:
        if ready_event is not None:
            ready_event.set()
        srv.serve_forever()


def _json_default(o):
    """json.dumps fallback: numpy arrays (and tensors) as nested lists;
    anything else raises the standard TypeError naming its type."""
    if hasattr(o, "tolist"):
        return o.tolist()
    raise TypeError(f"Object of type {type(o).__name__} "
                    "is not JSON serializable")


class OptimizerClient:
    """Minimal blocking client: the stand-in for the plugin's service client
    (NeoMpcPlanner.cpp:308, :248-250), with its wait-for-service loop
    (cpp:325-330)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 7180,
                 wait_timeout: float = 10.0):
        deadline = time.time() + wait_timeout
        while True:
            try:
                self.sock = socket.create_connection((host, port), timeout=1.0)
                self.sock.settimeout(None)
                break
            except OSError:
                if time.time() > deadline:
                    raise TimeoutError("optimizer service not available")
                time.sleep(0.2)
        self.f = self.sock.makefile("rwb")

    def call(self, msg: dict) -> dict:
        self.f.write(json.dumps(msg, default=_json_default).encode() + b"\n")
        self.f.flush()
        line = self.f.readline()
        if not line:
            raise ConnectionError("server closed connection")
        return json.loads(line)

    def close(self) -> None:
        self.f.close()
        self.sock.close()
