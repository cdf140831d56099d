"""Scenario-batch sharding over the cards of a world (port of
`parallel/sharding.py`).

The JAX package shards one global batch over a ('host', 'chip') device
mesh under `shard_map`. Here the PyTorch idiom: one process per card,
joined by `torch.distributed`. Every rank holds a contiguous slice of the
scenario batch on its own card (rank r of W holds lanes [r·B/W, (r+1)·B/W))
and steps it with the port's batched controller step. MPC lanes are
independent, so the only collective is the fleet-metric reduction: one
all_reduce(SUM) of the packed local sums and one all_reduce(MAX) of the
iteration count a step. The backend is NCCL for the card, gloo for the CPU.

    >>> initialize_distributed(init_method="tcp://localhost:29500",
    ...                        world_size=W, rank=r)      # on every rank
    >>> eng = ShardedEngine(cfg, make_mesh())
    >>> state = eng.init_state(4096)                       # this rank's lanes
    >>> out, metrics = eng.step(state, *eng.shard((plans, poses, vels,
    ...                                            costmaps, fps, dts)))
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple, Sequence

import torch
import torch.distributed as dist

from ..config import MpcConfig
from ..engine import (ControlState, batch_state, init_state,
                      make_batched_controller_step)
from ..tree import tree_map

__all__ = ["make_mesh", "shard_batch", "FleetMetrics", "ShardedEngine",
           "initialize_distributed", "fleet_metrics"]


def initialize_distributed(device="cuda", **kw: Any) -> None:
    """Join the world: torch.distributed.init_process_group(**kw) with NCCL
    when `device` is the card (this rank's card, LOCAL_RANK or the rank
    modulo the visible cards, becomes the current device) and gloo when it
    is the CPU. kw: init_method ("tcp://localhost:<port>"), world_size,
    rank, timeout, as init_process_group takes them. A no-op when a group
    already exists."""
    if dist.is_initialized():
        return
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' for gloo")
        rank = kw.get("rank", int(os.environ.get("RANK", 0)))
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    kw.setdefault("backend", "nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(**kw)


def _rank_device(mesh) -> torch.device:
    """This rank's device on the mesh: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(devices: Sequence | None = None, hosts: int | None = None):
    """The ('host', 'chip') DeviceMesh over the world, one device a rank in
    rank order (rank r sits at host r // chips, chip r % chips).

    devices: the world's devices (their count must be the world size; by
    default one a rank: each rank's card under NCCL, the CPU under gloo).
    hosts: the mesh's host rows; by default the world over the launcher's
    LOCAL_WORLD_SIZE, else 1. A world that does not tile over `hosts`
    raises ValueError."""
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        n = len(devices)
    else:
        n = dist.get_world_size() if dist.is_initialized() else 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    h = hosts if hosts is not None else (n // local if n % local == 0 else 1)
    if h <= 0 or n % h != 0:
        raise ValueError(
            f"{n} devices do not tile over {h} hosts; pass an explicit "
            f"`hosts` that divides the device count")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "initialize_distributed on every rank first")
    if n != dist.get_world_size():
        raise ValueError(f"{n} devices for a world of "
                         f"{dist.get_world_size()} ranks: one device a rank")
    from torch.distributed.device_mesh import init_device_mesh

    kind = (devices[0].type if devices is not None
            else "cuda" if dist.get_backend() == "nccl" else "cpu")
    return init_device_mesh(kind, (h, n // h),
                            mesh_dim_names=("host", "chip"))


def shard_batch(tree: Any, mesh) -> Any:
    """This rank's contiguous slice of the leading (scenario) axis of every
    tensor leaf, on this rank's device. A batch that does not divide over
    the world raises ValueError."""
    world, rank = mesh.size(), mesh.get_rank()
    dev = _rank_device(mesh)

    def put(x):
        b = x.shape[0]
        if b % world:
            raise ValueError(f"a batch of {b} lanes does not divide over "
                             f"{world} ranks")
        n = b // world
        return x[rank * n:(rank + 1) * n].to(dev)

    return tree_map(put, tree)


class FleetMetrics(NamedTuple):
    """Cross-fleet aggregates, the one place collectives appear: per-solve
    cost, solver iterations, convergence and safety-stop rates."""

    mean_cost: torch.Tensor
    max_iters: torch.Tensor
    converged_frac: torch.Tensor
    collision_frac: torch.Tensor
    lethal_frac: torch.Tensor
    mean_cmd_speed: torch.Tensor


def fleet_metrics(out, distributed: bool = True) -> FleetMetrics:
    """FleetMetrics of a step's output. The local sums (and the lane count)
    are packed into one float64 tensor; with `distributed` they are summed
    over the world by one all_reduce and the iteration count by one
    all_reduce(MAX), so each mean is over the global lanes. Without it, the
    same reductions over the lanes at hand."""
    f64 = lambda t: t.to(torch.float64).sum()
    speed = torch.linalg.vector_norm(out.cmd_vel[..., :2], dim=-1)
    sums = torch.stack([f64(out.fun), f64(out.solver_converged),
                        f64(out.collision), f64(out.lethal), f64(speed),
                        out.fun.new_tensor(out.fun.shape[0],
                                           dtype=torch.float64)])
    mx = out.solver_iters.max()
    if distributed:
        dist.all_reduce(sums, op=dist.ReduceOp.SUM)
        dist.all_reduce(mx, op=dist.ReduceOp.MAX)
    means = (sums[:5] / sums[5]).to(torch.float32)
    return FleetMetrics(mean_cost=means[0], max_iters=mx,
                        converged_frac=means[1], collision_frac=means[2],
                        lethal_frac=means[3], mean_cmd_speed=means[4])


class ShardedEngine:
    """Fleet-scale engine: every rank steps its shard of B scenarios on its
    own card with the port's batched controller step (lockstep-tail
    compaction, where the config asks for it, gathers stragglers within
    the shard), and the fleet metrics are reduced over the world.

    >>> eng = ShardedEngine(cfg, make_mesh())
    >>> state = eng.init_state(4096)
    >>> out, metrics = eng.step(state, plans, poses, vels, costmaps, fps, dts)

    Every argument of `step` is this rank's shard (`shard`). donate_state
    is accepted for the JAX package's signature and has no meaning here:
    eager PyTorch neither donates nor invalidates the input state, so an
    old state may be stepped again.
    """

    def __init__(self, cfg: MpcConfig, mesh=None, parity: bool = True,
                 donate_state: bool = True,
                 window_cells: int | None = None):
        """window_cells: nav2 rolling-local-costmap fleets: `costmaps` then
        carry each lane's WORLD map and each step re-centres a view of
        (window_cells)² cells on its lane's robot (simulation.rolling_view)
        before the step; per-lane metadata only."""
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        self.parity = parity
        self.window_cells = window_cells
        self.device = _rank_device(self.mesh)
        self._step = make_batched_controller_step(cfg, parity)

    def init_state(self, batch: int) -> ControlState:
        """This rank's shard of a `batch`-lane initial state."""
        world = self.mesh.size()
        if batch % world:
            raise ValueError(f"a batch of {batch} lanes does not divide "
                             f"over {world} ranks")
        return batch_state(init_state(self.cfg, self.device), batch // world)

    def shard(self, tree):
        return shard_batch(tree, self.mesh)

    def step(self, state, plans, poses, vels, costmaps, footprints, dts):
        if self.window_cells is not None:
            from ..simulation import rolling_view

            costmaps = rolling_view(costmaps, poses, self.window_cells)
        out = self._step(state, plans, poses, vels, costmaps, footprints,
                         dts)
        return out, fleet_metrics(out)
