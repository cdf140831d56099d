"""Device-op breakdown of the headline closed-loop tick.

Runs a few ticks of the bench's headline program (`batch_simulate` at the
headline operating point) under torch.profiler and prints the top kernels
by their summed device time, then the host's kernel launches by the torch
op that made them and the host's launch and sync calls: the port is eager,
its ticks are bound by the host's launches, and these lines say which ops
make them. The first run is the warm-up; the traced run follows. Reading
the trace takes longer than the ticks: keep --ticks small.

    python -m neo_mpc_planner2_tpu_torch.scripts.trace_headline --ticks 4
    python -m neo_mpc_planner2_tpu_torch.scripts.trace_headline --step-mode --quad-interp

--step-mode traces one `MpcEngine.batch_step` a step (the program behind
the bench's device p99: the state threaded, a sync a step) and prints
each step's device time (the kernels launched inside its range).
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from ..utils.entrypoints import add_device_arg, resolve_device, sync

__all__ = ["config", "top_device_ops", "top_host_ops", "run", "main"]


def config(max_iters: int = 8, quad_interp: bool = False):
    """The bench's headline operating point (a two-phase Armijo schedule)
    on default_config()."""
    from ..config import default_config

    return default_config().replace(
        prediction_horizon=0.8, control_steps=3, opt_tolerance=1e-3,
        footprint_edge_samples=16, max_plan_points=64,
        solver_max_iters=max_iters,
        solver_max_backtracks=7, solver_ls_coarse_after=2,
        solver_ls_coarse_factor=0.0625,
        solver_ls_quad_interp=quad_interp,
        min_vel_x=-0.7, min_vel_y=-0.7, min_vel_theta=-0.7,
        max_vel_x=0.7, max_vel_y=0.7, max_vel_trans=0.7, max_vel_theta=0.7,
        w_trans=0.82, w_orient=0.5, w_control=0.05, w_terminal=0.05,
        w_costmap=0.05, w_footprint=2000.0,
        costmap_sampling="onehot",
        lookahead_dist_min=0.4, lookahead_dist_max=0.4,
        lookahead_dist_close_to_goal=0.4,
    )


def top_device_ops(logdir: str, n: int = 40):
    """The kernels of the newest trace in `logdir` by summed device time:
    [(name, (count, total ms)), ...], the n largest."""
    from ..utils.profiling import device_module_durations_ms

    agg = {name: (len(d), sum(d))
           for name, d in device_module_durations_ms(logdir).items()}
    return sorted(agg.items(), key=lambda kv: -kv[1][1])[:n]


def top_host_ops(logdir: str, n: int = 40):
    """The host ops of the newest trace by the kernels they launched:
    [(op, launches), ...], the n largest."""
    from ..utils.profiling import host_launches_by_op

    return sorted(host_launches_by_op(logdir).items(),
                  key=lambda kv: -kv[1])[:n]


def run(batch: int = 4096, ticks: int = 4, map_size: int = 64,
        max_iters: int = 8, top: int = 40, step_mode: bool = False,
        quad_interp: bool = False, reps: int = 8, device="cuda") -> dict:
    """The traced run's top device ops, top host ops, host calls by name
    (launches and syncs among them) and, in step mode, each traced step's
    device time in ms."""
    from ..engine import MpcEngine
    from ..scenarios import make_scenario_batch
    from ..simulation import batch_simulate
    from ..utils.profiling import (device_step_durations_ms, device_trace,
                                   host_call_counts)

    device = resolve_device(device)
    cfg = config(max_iters, quad_interp)
    sb = make_scenario_batch(cfg, batch, seed=0, map_size=map_size,
                             plan_points=64, maps_on_device=True,
                             device=device)
    steps = []
    with tempfile.TemporaryDirectory() as td:
        if step_mode:
            eng = MpcEngine(cfg, device=device)
            st = eng.init_batch_state(batch)
            a = (sb.plan, sb.robot_pose, sb.current_vel, sb.costmap,
                 sb.footprint, sb.delta_t)
            st = eng.batch_step(st, *a).state  # warm-up
            sync(device)
            with device_trace(td):
                for i in range(reps):
                    with torch.profiler.record_function(f"headline_step_{i}"):
                        st = eng.batch_step(st, *a).state
                        sync(device)
            steps = device_step_durations_ms(td, "headline_step_")
        else:
            batch_simulate(cfg, sb, ticks)  # warm-up
            sync(device)
            with device_trace(td):
                batch_simulate(cfg, sb, ticks)
                sync(device)
        return {"device_ops": top_device_ops(td, top),
                "host_ops": top_host_ops(td, top),
                "host_calls": host_call_counts(td), "step_ms": steps}


def main(argv=None) -> None:
    from ..utils.profiling import LAUNCH_CALLS, SYNC_CALLS

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--ticks", type=int, default=4)
    ap.add_argument("--map-size", type=int, default=64)
    ap.add_argument("--max-iters", type=int, default=8)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--step-mode", action="store_true",
                    help="trace a MpcEngine.batch_step a step instead of "
                         "the closed loop")
    ap.add_argument("--quad-interp", action="store_true",
                    help="solver_ls_quad_interp=True (the fleet_config knob)")
    ap.add_argument("--reps", type=int, default=8,
                    help="step-mode: traced step count")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    out = run(args.batch, args.ticks, args.map_size, args.max_iters,
              args.top, args.step_mode, args.quad_interp, args.reps,
              args.device)
    # Each step's device time; all 0.0 without a device lane (the CPU).
    if args.step_mode and any(out["step_ms"][1:]):
        d = np.array(out["step_ms"][1:])
        print(f"step: n={d.size} p50={np.percentile(d, 50):.3f}"
              f" p99={np.percentile(d, 99):.3f} max={d.max():.3f} ms")
    what = (f"{args.reps} steps" if args.step_mode
            else f"{args.ticks} ticks")
    rows = out["device_ops"]
    total = sum(t for _, (_, t) in rows)
    print(f"top {len(rows)} device ops, {what} @ batch "
          f"{args.batch} quad={args.quad_interp} (sum {total:.1f} ms):")
    for name, (cnt, t) in rows:
        print(f"  {t:8.2f} ms  x{cnt:<5d} {name[:110]}")
    calls = out["host_calls"]
    launches = sum(calls.get(k, 0) for k in LAUNCH_CALLS)
    syncs = sum(calls.get(k, 0) for k in SYNC_CALLS)
    print(f"top {len(out['host_ops'])} host ops by kernel launches, {what} "
          f"({launches} launches, {syncs} syncs):")
    for name, n in out["host_ops"]:
        print(f"  x{n:<6d} {name[:110]}")


if __name__ == "__main__":
    main()
