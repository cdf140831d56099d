"""Dynamic-regime decomposition: where does the dynamic-obstacle pass's
overhead go, a map size?

Times three closed-loop programs at the bench's shapes (batch, ticks) and
one synthesis-only program:

  static          : fixed map (the headline regime)
  dynamic         : the map re-synthesized every tick from six moving blobs
                    a lane (the bench's dynamic row: O(B·O·H·W))
  updates         : one 16x16 dirty-window write a lane a tick
                    (Costmap.update_window's pattern: O(B·U²))
  synthesis-only  : `simulation.dynamic_obstacle_map` alone, a Python loop
                    over the ticks (attribution for the dynamic row)

Prints one JSON line a program with the JAX script's keys (ms/tick as the
least wall of --reps runs after a warm-up run), and beside them the CUDA
launches and host syncs a tick, read by torch.profiler over a further
--launch-ticks ticks of the same program, and the closed loops' mean SQP
iterations: the port is launch-bound, and the live maps' extra launches a
tick are the question.

    python -m neo_mpc_planner2_tpu_torch.scripts.dyn_decompose
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np
import torch

from ..utils.entrypoints import add_device_arg, resolve_device, sync

__all__ = ["config", "draws", "launches", "run", "main"]


def config():
    """fleet_config() at the sample weights with the live footprint
    weight."""
    from ..config import fleet_config

    return fleet_config().replace(
        max_plan_points=64,
        min_vel_x=-0.7, min_vel_y=-0.7, min_vel_theta=-0.7,
        max_vel_x=0.7, max_vel_y=0.7, max_vel_trans=0.7, max_vel_theta=0.7,
        w_trans=0.82, w_orient=0.5, w_control=0.05, w_terminal=0.05,
        w_costmap=0.05, w_footprint=2000.0,
        lookahead_dist_min=0.4, lookahead_dist_max=0.4,
        lookahead_dist_close_to_goal=0.4)


def draws(batch: int, map_size: int, device):
    """The JAX script's obstacles, in its order from one generator (seed
    3): six blobs a lane (centres (B, 6, 2), amplitudes (B, 6), velocities
    (B, 6, 2)) and then one update a lane ((B, 2), (B,), (B, 2)),
    float32."""
    rng = np.random.default_rng(3)
    half = map_size * 0.05 / 2
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    dyn = (f32(rng.uniform(-half + 0.8, half - 0.3, (batch, 6, 2))),
           f32(rng.uniform(0.3, 0.95, (batch, 6))),
           f32(rng.uniform(-0.25, 0.25, (batch, 6, 2))))
    upd = (f32(rng.uniform(-half + 0.8, half - 0.3, (batch, 2))),
           f32(rng.uniform(0.3, 0.95, (batch,))),
           f32(rng.uniform(-0.25, 0.25, (batch, 2))))
    return dyn, upd


def launches(fn, device) -> dict:
    """The CUDA launch and sync calls of one call of fn() under
    torch.profiler ({} of each on the CPU: no CUDA activity)."""
    from ..utils.profiling import (LAUNCH_CALLS, SYNC_CALLS, device_trace,
                                   host_call_counts)

    with tempfile.TemporaryDirectory() as td:
        with device_trace(td):
            fn()
            sync(device)
        calls = host_call_counts(td)
    return {"launches": sum(calls.get(k, 0) for k in LAUNCH_CALLS),
            "syncs": sum(calls.get(k, 0) for k in SYNC_CALLS)}


def run(batch: int = 4096, ticks: int = 20, map_size: int = 64,
        reps: int = 2, launch_ticks: int = 2, device="cuda",
        emit=print) -> list:
    """Each program's record (see the module docstring), each passed to
    `emit` as one JSON line when it is measured."""
    from ..scenarios import make_scenario_batch
    from ..simulation import batch_simulate, dynamic_obstacle_map

    device = resolve_device(device)
    cfg = config()
    B, T, M = batch, ticks, map_size
    sb = make_scenario_batch(cfg, B, seed=0, map_size=M, plan_points=64,
                             maps_on_device=True, device=device)
    dyn, upd = draws(B, M, device)
    records = []

    def timed(name, fn):
        """fn(t) runs t ticks of the program and returns its SimResult
        (or None)."""
        fn(T)  # warm-up
        sync(device)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn(T)
            sync(device)
            best = min(best, time.perf_counter() - t0)
        rec = {"program": name, "map_size": M, "batch": B, "ticks": T,
               "ms_per_tick": round(best / T * 1e3, 3),
               "solves_per_sec": round(B * T / best, 1)}
        counted = launches(lambda: fn(launch_ticks), device)
        rec.update({"launch_ticks": launch_ticks,
                    "launches_per_tick": counted["launches"] / launch_ticks,
                    "syncs_per_tick": counted["syncs"] / launch_ticks,
                    "mean_iters": None if out is None else round(float(
                        out.solver_iters.float().mean()), 3)})
        records.append(rec)
        emit(json.dumps(rec))
        return best

    timed("static", lambda t: batch_simulate(cfg, sb, t))
    timed("dynamic_resynth", lambda t: batch_simulate(
        cfg, sb, t, dynamic_obstacles=dyn))
    timed("dynamic_updates", lambda t: batch_simulate(
        cfg, sb, t, costmap_updates=upd, update_cells=16))

    # Synthesis-only: the per-tick blob field and its flat view, a loop
    # like the sim's (attribution: dynamic_resynth - static - this ~=
    # the engine's cost of consuming a fresh map).
    dt = cfg.control_interval

    def synth_only(t_count):
        acc = torch.zeros(B, device=device)
        for t in range(t_count):
            acc = acc + dynamic_obstacle_map(sb.costmap, dyn, t,
                                             dt).flat[:, 0]
        return None

    timed("synthesis_only", synth_only)
    return records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--map-size", type=int, default=64)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--launch-ticks", type=int, default=2,
                    help="ticks of the profiled run that counts launches")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    run(args.batch, args.ticks, args.map_size, args.reps, args.launch_ticks,
        args.device, emit=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
