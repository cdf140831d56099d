"""Scaling benchmark: closed-loop solves/s at increasing card counts.

BASELINE.json asks for >= 80 % linear solves/s scaling from one chip up.
This script measures sustained closed-loop throughput on worlds of 1, 2,
4, ... cards (up to --max-devices and the visible cards, the last world
being all of them), with the batch a card held fixed (weak scaling — the
deployment regime: more cards, more robots). One process a card, joined by
`torch.distributed` (NCCL; `parallel.sharding`): every rank steps its
shard of the batch with `simulation.batch_simulate`, and a world's time is
its slowest rank's. Prints one JSON line a world.

Protocol (the JAX script's): every efficiency is normalized inside one
world. Its rank 0 also measures a 1-card baseline — the batch of one card
on its own card while the other ranks wait — and efficiency =
t_baseline / t_sharded, <= 1 up to noise. Steady state = the least wall
over --repeats runs after a warm-up run. On one card the script prints the
1-card point; that is not an error.

    python -m neo_mpc_planner2_tpu_torch.scripts.scaling_bench

--pinned, the JAX script's CPU virtual-mesh protocol (one taskset child a
mesh size, one core a virtual device), has no counterpart here and is
refused.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import time

from ..utils.entrypoints import add_device_arg, free_port, resolve_device, sync

__all__ = ["config", "world_sizes", "measure", "main"]

PINNED_REFUSAL = ("--pinned is the JAX script's CPU virtual-mesh protocol "
                  "(a taskset child a mesh size); the port scales over "
                  "cards, one process a card, and has no counterpart")


def config():
    """default_config() at the sample weights, 40 SQP iterations, the
    one-hot sampler."""
    from ..config import default_config

    return default_config().replace(
        prediction_horizon=0.8, opt_tolerance=1e-3, footprint_edge_samples=16,
        max_plan_points=64, solver_max_iters=40, costmap_sampling="onehot",
        min_vel_x=-0.7, min_vel_y=-0.7, min_vel_theta=-0.7,
        max_vel_x=0.7, max_vel_y=0.7, max_vel_trans=0.7, max_vel_theta=0.7,
        w_trans=0.82, w_orient=0.5, w_control=0.05, w_terminal=0.05,
        w_costmap=0.05, w_footprint=0.0,
        lookahead_dist_min=0.4, lookahead_dist_max=0.4,
        lookahead_dist_close_to_goal=0.4,
    )


def world_sizes(cards: int, max_devices: int) -> list:
    """1, 2, 4, ... up to min(cards, max_devices), and that count last."""
    top = max(1, min(cards, max_devices))
    sizes, n = [], 1
    while n <= top:
        sizes.append(n)
        n *= 2
    if sizes[-1] != top:
        sizes.append(top)
    return sizes


def _steady_time(fn, repeats: int) -> float:
    """The least wall of `repeats` calls of fn (each ending in a sync),
    after one warm-up call."""
    fn()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def measure(world: int, rank: int, args, device) -> dict | None:
    """One world's record on this rank (None on ranks other than 0). With
    world > 1 a process group must exist."""
    import torch
    import torch.distributed as dist

    from ..scenarios import make_scenario_batch
    from ..simulation import batch_simulate

    cfg = config()
    tpd = args.ticks_per_dispatch or args.ticks
    bpd = args.batch_per_device
    B = bpd * world

    def run_once(sb):
        batch_simulate(cfg, sb, tpd)
        sync(device)

    sb = make_scenario_batch(cfg, B, seed=0, map_size=args.map_size,
                             plan_points=24, device=device)
    if world > 1:
        from ..parallel.sharding import make_mesh, shard_batch

        sb = shard_batch(sb, make_mesh())
        dist.barrier()
    t_shard = _steady_time(lambda: run_once(sb), args.repeats)
    if world > 1:
        slowest = torch.tensor([t_shard], dtype=torch.float64, device=device)
        dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
        t_shard = float(slowest)
    # The 1-card baseline: the batch of one card on rank 0's card, the
    # other ranks waiting.
    t_base = None
    if rank == 0:
        sb1 = make_scenario_batch(cfg, bpd, seed=0, map_size=args.map_size,
                                  plan_points=24, device=device)
        t_base = _steady_time(lambda: run_once(sb1), args.repeats)
    if world > 1:
        dist.barrier()
    if rank:
        return None
    return {"devices": world, "batch": B, "ticks_per_dispatch": tpd,
            "solves_per_sec": round(B * tpd / t_shard, 1),
            "baseline_1dev_solves_per_sec": round(bpd * tpd / t_base, 1),
            "steady_tick_ms": round(t_shard / tpd * 1e3, 2),
            "efficiency": round(t_base / t_shard, 3)}


def _rank_main(args) -> None:
    """A child: rank `args.rank` of a world of `args.world` on its card
    (or, given --device cpu, on the CPU under gloo)."""
    import torch
    import torch.distributed as dist

    from ..parallel.sharding import initialize_distributed

    initialize_distributed(device=args.device,
                           init_method=f"tcp://127.0.0.1:{args.port}",
                           world_size=args.world, rank=args.rank,
                           timeout=datetime.timedelta(seconds=300))
    try:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if torch.device(args.device).type == "cuda"
               else torch.device("cpu"))
        rec = measure(args.world, args.rank, args, dev)
        if rec is not None:
            print(json.dumps(rec), flush=True)
    finally:
        dist.destroy_process_group()


def _world(args, world: int) -> dict:
    """One world of `world` child processes, one a card; rank 0's line."""
    import torch

    port = free_port()
    flags = [f"--{k.replace('_', '-')}={v}" for k, v in (
        ("batch_per_device", args.batch_per_device), ("ticks", args.ticks),
        ("map_size", args.map_size), ("repeats", args.repeats),
        ("ticks_per_dispatch", args.ticks_per_dispatch),
        ("device", torch.device(args.device).type))]
    procs = [subprocess.Popen(
        [sys.executable, "-m", __spec__.name, *flags, "--world", str(world),
         "--rank", str(r), "--port", str(port)],
        stdout=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))) for r in range(world)]
    outs = [p.communicate()[0] for p in procs]
    bad = [r for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(f"world {world}: ranks {bad} failed")
    return json.loads([ln for ln in outs[0].splitlines()
                       if ln.startswith("{")][-1])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch-per-device", type=int, default=256)
    ap.add_argument("--ticks", type=int, default=10)
    ap.add_argument("--map-size", type=int, default=48)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--max-devices", type=int, default=8)
    ap.add_argument("--pinned", action="store_true",
                    help="refused: the JAX script's CPU virtual mesh")
    # K ticks a dispatch, one sync a K; 0 = --ticks.
    ap.add_argument("--ticks-per-dispatch", type=int, default=0)
    # A world's children (set by the parent, one a rank).
    ap.add_argument("--world", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.pinned:
        raise SystemExit(PINNED_REFUSAL)
    if args.world:
        _rank_main(args)
        return
    device = resolve_device(args.device)
    import torch

    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    for world in world_sizes(cards, args.max_devices):
        rec = (measure(1, 0, args, device) if world == 1
               else _world(args, world))
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
