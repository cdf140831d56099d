"""Benchmark of the port (port of the repository's `bench.py`, which the
JAX package's `neo-mpc-bench` runs): closed-loop MPC solves/s on one card,
and every later pass of that file on the same card.

    python -m neo_mpc_planner2_tpu_torch.bench [--device cuda|cuda:k|cpu]
    neo-mpc-bench-torch [...]

The flags, their defaults, the passes, their seeds, sizes, repetitions and
budget rules are bench.py's; so is the output: ONE JSON line on stdout with
bench.py's keys in bench.py's order, progress on stderr. The headline is
mandatory; every later pass catches its own error, prints it on stderr and
leaves its fields null. A watchdog prints the line at --deadline with what
has been measured, or exits 3 if the headline has not finished.

The headline: `--batch` robots run the whole FollowPath loop (pursuit, SQP
solve, post-processing, plant) for `--ticks` control periods through
`simulation.batch_simulate` at the fleet preset, the least wall of 3 timed
runs after a warm-up; value = solves/s on the one card, vs_baseline =
value / 50 (the reference's ~50 Hz for one robot).

Where it differs from bench.py:
- `--device` (default "cuda", the current card; "cuda:k" a card; "cpu"
  only when asked): without a card and without --device cpu it raises
  before the headline and prints no line.
- `devices` is 1 and no rate is divided by the visible cards: the port's
  batch_simulate runs on one card.
- The port is eager: each pass's first call is its warm-up, and its masked
  loops wait on the device, so a timed wall holds the host's launches.
- A step's device time (`device_p99_ms`, `device_p99_default_ms`) is the
  summed device time of the kernels that the step launched, read from one
  torch.profiler session with a range a step (null on the CPU: there is no
  device lane).
- The serving pass binds a free port; its answers are checked for errors.
- A sync is torch.cuda.synchronize (nothing on the CPU).
- At the end, stderr carries the launches of each hand-written kernel in
  the run ("[bench] kernel launches {...}").
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from .utils.entrypoints import free_port, resolve_device

__all__ = ["main", "fleet_cfg", "default_cfg", "product_cfg", "prox_solver",
           "obstacles", "QUALITY_SCENARIO", "chain", "quality",
           "kernel_wrappers", "kernel_launches"]

# The goal-reachable fleet of the quality passes: 0.7-1.1 m plans inside a
# static window centred on the plan, with the plan's corridor kept passable.
QUALITY_SCENARIO = dict(seed=1, plan_points=64, plan_length_range=(0.7, 1.1),
                        clear_corridor_m=0.55, center_on="plan")


def fleet_cfg(control_steps: int = 3, compact_adaptive: bool = False,
              costmap_u8=False):
    """fleet_config() with the benchmark's overrides: bench.py's shape
    (0.8 s horizon, 16 samples an edge, 64 plan points), its symmetric
    0.7 bounds and weights, the live footprint weight (2000) and the
    one-hot point sampler."""
    from .config import fleet_config

    return fleet_config().replace(
        prediction_horizon=0.8, control_steps=control_steps,
        opt_tolerance=1e-3,
        footprint_edge_samples=16, max_plan_points=64,
        solver_compact_adaptive=compact_adaptive,
        min_vel_x=-0.7, min_vel_y=-0.7, min_vel_theta=-0.7,
        max_vel_x=0.7, max_vel_y=0.7, max_vel_trans=0.7, max_vel_theta=0.7,
        w_trans=0.82, w_orient=0.5, w_control=0.05, w_terminal=0.05,
        w_costmap=0.05, w_footprint=2000.0,
        costmap_sampling="onehot",
        solver_costmap_u8=costmap_u8,
        lookahead_dist_min=0.4, lookahead_dist_max=0.4,
        lookahead_dist_close_to_goal=0.4)


def default_cfg(cfg):
    """The library-default solver program on `cfg`'s weights (bench.py's
    cfg40): cap 40, single-phase Armijo of 16 backtracks, no quadratic
    interpolation, no compaction."""
    return cfg.replace(solver_max_iters=40, solver_max_backtracks=16,
                       solver_ls_coarse_after=0,
                       solver_ls_quad_interp=False,
                       solver_compact_adaptive=False)


def product_cfg(cfg):
    """The product point on `cfg` (bench.py's pcfg): quirks off, the
    candidate-wave line search without quadratic interpolation, and the
    patch sampler sized for the MPO-700 footprint (0.46 m circumradius) at
    0.05 m."""
    from .ops.costmap import required_product_patch_halfwidth

    pcfg = cfg.replace(
        parallel_line_search=True, solver_ls_quad_interp=False,
        solver_patch_exact_picks=False,
        compat=dataclasses.replace(
            cfg.compat, buggy_odom_yaw=False, footprint_alias_noop=False,
            lethal_1000x=False, unsquared_control_cost=False,
            no_angle_wrap=False))
    return pcfg.replace(solver_costmap_patch=(
        required_product_patch_halfwidth(pcfg, 0.05, 0.46)))


def prox_solver(pcfg):
    """The prox-FISTA cross-check's batched solver on `pcfg`'s smooth
    objective (bench.py's vmapped make_solver)."""
    from .ops.objective import make_objective
    from .solver import make_solver_batched

    return make_solver_batched(pcfg, make_objective(pcfg, parity=False))


def obstacles(kind: str, batch: int, map_size: int, device):
    """The live maps' moving obstacles, drawn as bench.py draws them:
    centres U(-half + 0.8, half - 0.3), amplitudes U(0.3, 0.95), velocities
    U(-0.25, 0.25) m/s, float32, half = map_size * 0.05 / 2.
    kind "dynamic": six obstacles a lane, (B, 6, 2), (B, 6), (B, 6, 2),
    from seed 3; "updates": one a lane, (B, 2), (B,), (B, 2), from seed 4."""
    if kind not in ("dynamic", "updates"):
        raise ValueError(f"kind must be 'dynamic' or 'updates': {kind!r}")
    rng = np.random.default_rng(3 if kind == "dynamic" else 4)
    per = (6,) if kind == "dynamic" else ()
    half = map_size * 0.05 / 2
    draws = (rng.uniform(-half + 0.8, half - 0.3, (batch,) + per + (2,)),
             rng.uniform(0.3, 0.95, (batch,) + per),
             rng.uniform(-0.25, 0.25, (batch,) + per + (2,)))
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in draws)


def chain(sim, scen, carry, seg_ticks: int, total_ticks: int,
          keep_going=lambda: True):
    """Closed-loop segments of seg_ticks, `sim(scen, carry, seg_ticks)`,
    each started from the (state, pose, vel) carry of the one before, until
    total_ticks have run or keep_going() turns false after a segment. The
    last segment's result and the ticks run."""
    done = 0
    while True:
        run = sim(scen, carry, seg_ticks)
        carry = (run.final_state, run.poses[:, -1], run.cmds[:, -1])
        done += seg_ticks
        if done >= total_ticks or not keep_going():
            return run, done


def quality(run) -> tuple:
    """bench.py's reductions of a quality run's last tick: the share of
    lanes within 0.10 m of their goal, the median goal distance (linear
    interpolation, as numpy's percentile) and, of the lanes that did not
    reach, the share stopped by a safety latch (predicted collision or
    lethal footprint)."""
    dist = run.goal_dist[:, -1]
    reached = dist < 0.10
    blocked = run.collisions[:, -1] | run.lethal[:, -1]
    n_unreached = float((~reached).sum())
    return (float(reached.float().mean()),
            float(torch.quantile(dist.float(), 0.5)),
            float((blocked & ~reached).sum()) / max(n_unreached, 1.0))


def kernel_wrappers() -> dict:
    """Each wrapper that counts its kernel's launches, by name: qp_admm
    (K1), spd_inv (K2), footprint_cost (K3) and footprint_walk (K3's walk
    mode)."""
    from . import sqp
    from .ops import footprint

    return {"qp_admm": sqp.qp_admm, "spd_inv": sqp.chol_inverse,
            "footprint_cost": footprint.footprint_cost_batch,
            "footprint_walk": footprint.footprint_walk_batch}


def kernel_launches() -> dict:
    """Each wrapper's launches in this process by its name, and K3's by
    launch plan as "footprint_cost:<plan>" / "footprint_walk:<plan>"."""
    wrappers = kernel_wrappers()
    out = {name: fn.launches for name, fn in wrappers.items()}
    for name, fn in wrappers.items():
        out.update({f"{name}:{plan}": n
                    for plan, n in getattr(fn, "plans", {}).items()})
    return out


class _Line:
    """The one JSON line, filled as passes finish, and its watchdog."""

    def __init__(self):
        self.results: dict = {}
        self.done = threading.Event()
        self._emitted = False
        self._lock = threading.Lock()

    def emit(self) -> None:
        # The watchdog and the main thread can race here at the deadline;
        # exactly one line prints, and only once the headline is in.
        with self._lock:
            if self.results.get("value") is None or self._emitted:
                return
            self._emitted = True
            print(json.dumps(self.results), flush=True)

    def watchdog(self, deadline_s: float, t_start: float) -> None:
        if self.done.wait(max(0.0, deadline_s
                              - (time.monotonic() - t_start))):
            return
        if self.results.get("value") is not None:
            print("[bench] watchdog: deadline hit, emitting partial results",
                  file=sys.stderr, flush=True)
            self.emit()
            os._exit(0)
        print("[bench] watchdog: deadline hit before the headline finished",
              file=sys.stderr, flush=True)
        os._exit(3)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="neo-mpc-bench-torch")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--latency-reps", type=int, default=50)
    # Steps of each profiled device-p99 pass.
    ap.add_argument("--trace-reps", type=int, default=12)
    # 64 cells at 0.05 m: a 3.2 m local window.
    ap.add_argument("--map-size", type=int, default=64)
    # The quality passes' closed-loop horizon, run in --ticks segments.
    ap.add_argument("--quality-ticks", type=int, default=160)
    # cfg.solver_costmap_u8: the f32 map (false), its uint8 companion
    # (true), or u8 from 128^2 cells on (auto).
    ap.add_argument("--costmap-u8", default="false",
                    choices=["false", "true", "auto"])
    ap.add_argument("--compact-adaptive", default="false",
                    choices=["true", "false"])
    ap.add_argument("--control-steps", type=int, default=3)
    # The watchdog prints what has been measured this many seconds in;
    # later passes are skipped when the budget left cannot fit them.
    ap.add_argument("--deadline", type=float,
                    default=float(os.environ.get("BENCH_DEADLINE_S", "560")))
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default: cuda, the "
                         "current card; cuda:k for card k; without a card "
                         "the bench refuses to start unless given "
                         "--device cpu)")
    return ap


def main(argv=None) -> None:
    """Run the benchmark and print its one JSON line (see the module
    docstring); argv defaults to sys.argv[1:]."""
    args = _parser().parse_args(argv)
    line = _Line()
    try:
        _main(args, line)
    finally:
        # An error after the headline still prints the measured line.
        line.done.set()
        line.emit()


def _main(args, line: _Line) -> None:
    results = line.results
    costmap_u8 = {"false": False, "true": True, "auto": "auto"}[args.costmap_u8]
    device = resolve_device(args.device)

    t_start = time.monotonic()
    threading.Thread(target=line.watchdog, args=(args.deadline, t_start),
                     daemon=True).start()

    def remaining() -> float:
        return args.deadline - (time.monotonic() - t_start)

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def best(fn, reps: int):
        """fn() once as the warm-up, then `reps` timed calls that each end
        in a sync: the last result and the least wall in seconds."""
        out = fn()
        sync()
        secs = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            sync()
            secs = min(secs, time.perf_counter() - t0)
        return out, secs

    from .engine import MpcEngine
    from .scenarios import make_scenario_batch
    from .simulation import batch_simulate
    from .tree import tree_map

    B, T, M = args.batch, args.ticks, args.map_size
    # The port's batch_simulate runs on one card.
    n_dev = 1
    cfg = fleet_cfg(args.control_steps, args.compact_adaptive == "true",
                    costmap_u8)
    cfg40 = default_cfg(cfg)

    # ---- headline: sustained closed-loop throughput, from a cold carry;
    # the quality pass chains the same program.
    sb = make_scenario_batch(cfg, B, seed=0, map_size=M, plan_points=64,
                             maps_on_device=True, device=device)

    def sim(scen, carry, ticks):
        return batch_simulate(cfg, scen, ticks, init=carry)

    eng0 = MpcEngine(cfg, device=device)
    cold = (eng0.init_batch_state(B), sb.robot_pose, sb.current_vel)
    run, sim_s = best(lambda: sim(sb, cold, T), 3)
    print(f"[bench] headline done in {sim_s:.2f}s", file=sys.stderr)
    solves_per_sec = B * T / sim_s / n_dev

    # The headline is in: publish it with every later field null, so that
    # the watchdog or a failed pass still prints the whole schema.
    results.update({
        "metric": "MPC solves/sec/chip (horizon 0.8s, closed loop)",
        "control_steps": args.control_steps,
        "value": round(solves_per_sec, 1),
        "unit": "solves/s/chip",
        "vs_baseline": round(solves_per_sec / 50.0, 2),
        "batch": B,
        "ticks": T,
        "map_size": M,
        "costmap_u8": args.costmap_u8,
        "compact_adaptive": args.compact_adaptive,
        "devices": n_dev,
        "cold_batch_step_ms": None,
        "single_robot_tick_ms": None,
        "blocking_rtt_p99_ms": None,
        "device_p99_ms": None,
        "quality_ticks": None,
        "goal_reached_frac": None,
        "final_goal_dist_p50_m": None,
        "unreached_blocked_frac": None,
        "unconverged_frac": None,
        "default_fidelity_solves_per_sec": None,
        "default_fidelity_unconverged_frac": None,
        "rolling_solves_per_sec": None,
        "rolling_window_cells": None,
        "dynamic_solves_per_sec": None,
        "dynamic_updates_solves_per_sec": None,
        "product_sqp_solves_per_sec": None,
        "product_sqp_mean_iters": None,
        "product_sqp_goal_reached_frac": None,
        "product_sqp_final_dist_p50_m": None,
        "product_sqp_unreached_blocked_frac": None,
        "product_sqp_quality_ticks": None,
        "product_solves_per_sec": None,
        "product_mean_iters": None,
        "product_goal_reached_frac": None,
        "product_final_dist_p50_m": None,
        "product_unreached_blocked_frac": None,
        "product_quality_ticks": None,
        "single_robot_tick_default_ms": None,
        "device_p99_default_ms": None,
        "serving_tick_ms": None,
        "serving_tick_p99_ms": None,
        "serving_fleet64_per_robot_ms": None,
    })

    # Share of (lane, tick) solves stopped by the iteration cap.
    try:
        results["unconverged_frac"] = round(
            1.0 - float(run.converged.float().mean()), 4)
    except Exception as e:
        print(f"[bench] unconverged fetch failed: {e!r}", file=sys.stderr)

    # ---- the live maps, at the headline's batch and ticks.
    # Rolling: world maps twice the headline's side, the controller on a
    # (map_size)² view re-centred on its robot every tick.
    try:
        if remaining() < 150:
            raise TimeoutError("skipped: <150 s of budget left")
        wsb = make_scenario_batch(cfg, B, seed=2, map_size=M * 2,
                                  plan_points=64, maps_on_device=True,
                                  device=device)
        _, sw = best(lambda: batch_simulate(cfg, wsb, T, window_cells=M), 2)
        results["rolling_solves_per_sec"] = round(B * T / sw / n_dev, 1)
        results["rolling_window_cells"] = M
        print(f"[bench] rolling-window pass done in {sw:.2f}s",
              file=sys.stderr)
    except Exception as e:
        print(f"[bench] rolling-window pass failed: {e!r}", file=sys.stderr)

    # Dynamic obstacles: every lane's map re-synthesized every tick with
    # six linearly moving blobs.
    try:
        if remaining() < 150:
            raise TimeoutError("skipped: <150 s of budget left")
        dyn = obstacles("dynamic", B, M, device)
        _, sd = best(lambda: batch_simulate(cfg, sb, T,
                                            dynamic_obstacles=dyn), 2)
        results["dynamic_solves_per_sec"] = round(B * T / sd / n_dev, 1)
        print(f"[bench] dynamic-obstacle pass done in {sd:.2f}s",
              file=sys.stderr)
    except Exception as e:
        print(f"[bench] dynamic-obstacle pass failed: {e!r}", file=sys.stderr)

    # Incremental updates: one 16² block repainted a lane a tick around one
    # moving obstacle.
    try:
        if remaining() < 150:
            raise TimeoutError("skipped: <150 s of budget left")
        upd = obstacles("updates", B, M, device)
        _, su = best(lambda: batch_simulate(cfg, sb, T, costmap_updates=upd,
                                            update_cells=16), 2)
        results["dynamic_updates_solves_per_sec"] = round(
            B * T / su / n_dev, 1)
        print(f"[bench] dynamic-updates pass done in {su:.2f}s",
              file=sys.stderr)
    except Exception as e:
        print(f"[bench] dynamic-updates pass failed: {e!r}", file=sys.stderr)

    # ---- trajectory quality: a goal-reachable fleet driven to its goals
    # by chaining the headline's program, until --quality-ticks or the
    # budget runs out (quality_ticks reports the horizon run).
    try:
        qsb = make_scenario_batch(cfg, B, map_size=M, maps_on_device=True,
                                  device=device, **QUALITY_SCENARIO)
        carry = (eng0.init_batch_state(B), qsb.robot_pose, qsb.current_vel)
        q_run, quality_ticks = chain(
            sim, qsb, carry, T, args.quality_ticks,
            lambda: remaining() >= 3 * sim_s + 60)
        if quality_ticks < args.quality_ticks:
            print("[bench] quality pass truncated by deadline",
                  file=sys.stderr)
        reached, dist_p50, blocked = quality(q_run)
        results.update({
            "quality_ticks": quality_ticks,
            "goal_reached_frac": round(reached, 4),
            "final_goal_dist_p50_m": round(dist_p50, 3),
            "unreached_blocked_frac": round(blocked, 4),
        })
        print(f"[bench] quality pass done ({quality_ticks} ticks)",
              file=sys.stderr)
    except Exception as e:
        print(f"[bench] quality pass failed: {e!r}", file=sys.stderr)

    # ---- product mode through the SQP (the smooth objective, parity
    # False): throughput on the headline's scenarios, quality on the
    # quality suite.
    pcfg = product_cfg(cfg)
    try:
        if remaining() < 420:
            raise TimeoutError("skipped: <420 s of budget left "
                               "(reserved for the established passes)")

        def simsq(scen, carry, ticks):
            return batch_simulate(pcfg, scen, ticks, parity=False,
                                  init=carry)

        st0 = eng0.init_batch_state(B)
        runsq, ssq = best(
            lambda: simsq(sb, (st0, sb.robot_pose, sb.current_vel), T), 2)
        results["product_sqp_solves_per_sec"] = round(B * T / ssq / n_dev, 1)
        results["product_sqp_mean_iters"] = round(
            float(runsq.solver_iters.float().mean()), 1)
        sq = make_scenario_batch(pcfg, B, map_size=M, maps_on_device=True,
                                 device=device, **QUALITY_SCENARIO)
        carry = (eng0.init_batch_state(B), sq.robot_pose, sq.current_vel)
        sr_run, sticks = chain(simsq, sq, carry, T, args.quality_ticks,
                               lambda: remaining() >= 2 * ssq + 330)
        reached, dist_p50, blocked = quality(sr_run)
        results["product_sqp_goal_reached_frac"] = round(reached, 4)
        results["product_sqp_final_dist_p50_m"] = round(dist_p50, 3)
        results["product_sqp_unreached_blocked_frac"] = round(blocked, 4)
        results["product_sqp_quality_ticks"] = sticks
        print(f"[bench] product-SQP pass done ({ssq:.1f}s solve, "
              f"{sticks} quality ticks)", file=sys.stderr)
    except Exception as e:
        print(f"[bench] product-SQP pass failed: {e!r}", file=sys.stderr)

    # ---- product mode through prox-FISTA: the cross-check of the SQP.
    try:
        if remaining() < 390:
            raise TimeoutError("skipped: <390 s of budget left "
                               "(reserved for the established passes)")
        psolver = prox_solver(pcfg)

        def simp(scen, carry, ticks):
            return batch_simulate(pcfg, scen, ticks, parity=False,
                                  init=carry, solver_batch=psolver)

        st0 = eng0.init_batch_state(B)
        runp, sp = best(
            lambda: simp(sb, (st0, sb.robot_pose, sb.current_vel), T), 2)
        results["product_solves_per_sec"] = round(B * T / sp / n_dev, 1)
        results["product_mean_iters"] = round(
            float(runp.solver_iters.float().mean()), 1)
        pq = make_scenario_batch(pcfg, B, map_size=M, maps_on_device=True,
                                 device=device, **QUALITY_SCENARIO)
        carry = (eng0.init_batch_state(B), pq.robot_pose, pq.current_vel)
        pr_run, pticks = chain(simp, pq, carry, T, args.quality_ticks,
                               lambda: remaining() >= 2 * sp + 300)
        reached, dist_p50, blocked = quality(pr_run)
        results["product_goal_reached_frac"] = round(reached, 4)
        results["product_final_dist_p50_m"] = round(dist_p50, 3)
        results["product_unreached_blocked_frac"] = round(blocked, 4)
        results["product_quality_ticks"] = pticks
        print(f"[bench] product-mode pass done ({sp:.1f}s solve, "
              f"{pticks} quality ticks)", file=sys.stderr)
    except Exception as e:
        print(f"[bench] product-mode pass failed: {e!r}", file=sys.stderr)

    # ---- default fidelity: the library-default solver program (cap 40)
    # on the headline's scenarios.
    try:
        if remaining() < 120:
            raise TimeoutError("skipped: <120 s of budget left")
        run40, s40 = best(lambda: batch_simulate(cfg40, sb, T), 2)
        default_sps = B * T / s40 / n_dev
        results.update({
            "default_fidelity_solves_per_sec": round(default_sps, 1),
            "default_fidelity_unconverged_frac": round(
                1.0 - float(run40.converged.float().mean()), 4),
        })
        print(f"[bench] default-fidelity (max_iters=40) done in {s40:.1f}s",
              file=sys.stderr)
    except Exception as e:
        print(f"[bench] default-fidelity pass failed: {e!r}", file=sys.stderr)

    # ---- the serving layer end to end: the port's TCP server in a thread
    # of this process on the run's card, driven over a real socket.
    # serving_tick_ms: median blocking single-robot request;
    # serving_fleet64_per_robot_ms: a 64-robot batched request / 64.
    try:
        if remaining() < 150:
            raise TimeoutError("skipped: <150 s of budget left")
        from .serving import OptimizerClient, serve

        port = free_port()
        ready = threading.Event()
        threading.Thread(target=serve, daemon=True, kwargs=dict(
            host="127.0.0.1", port=port, cfg=cfg, ready_event=ready,
            device=str(device))).start()
        ready.wait(10)
        cl = OptimizerClient(port=port, wait_timeout=10)

        def call(msg: dict) -> None:
            resp = cl.call(msg)
            if "error" in resp:
                raise RuntimeError(f"{msg['op']}: {resp['error']}")

        fp = [[0.365, 0.275], [-0.365, 0.275], [-0.365, -0.275],
              [0.365, -0.275]]
        half = M * 0.05 / 2
        call({"op": "set_costmap", "data": np.zeros((M, M)).tolist(),
              "origin": [-half, -half], "resolution": 0.05})
        call({"op": "set_footprint", "points": fp})
        req = {"op": "optimizer", "current_pose": [0, 0, 0],
               "carrot_pose": [0.4, 0.05, 0.1], "goal_pose": [1.5, 0.3, 0.2],
               "current_vel": [0.2, 0, 0], "control_interval": 1 / 30,
               "delta_t": 1 / 30}
        call(req)  # warm-up
        lat = []
        for _ in range(args.latency_reps):
            t0 = time.perf_counter()
            call(req)
            lat.append(time.perf_counter() - t0)
        lat_ms = np.array(lat) * 1e3
        results["serving_tick_ms"] = round(float(np.median(lat_ms)), 3)
        results["serving_tick_p99_ms"] = round(
            float(np.percentile(lat_ms, 99)), 2)
        print(f"[bench] serving single-robot done "
              f"(p50 {np.median(lat_ms):.2f} ms)", file=sys.stderr)
        if remaining() > 90:
            robots = [{"current_pose": [0.02 * i, 0, 0],
                       "carrot_pose": [0.4, 0.05 - 0.01 * i, 0.1],
                       "goal_pose": [1.5, 0.3, 0.2],
                       "current_vel": [0.2, 0, 0],
                       "control_interval": 1 / 30} for i in range(64)]
            breq = {"op": "optimizer_batch", "robots": robots,
                    "delta_t": 1 / 30}
            call(breq)  # warm-up
            blat = []
            for _ in range(20):
                t0 = time.perf_counter()
                call(breq)
                blat.append(time.perf_counter() - t0)
            results["serving_fleet64_per_robot_ms"] = round(
                float(np.median(blat)) * 1e3 / 64, 3)
            print(f"[bench] serving fleet-64 done "
                  f"({np.median(blat)*1e3:.1f} ms/tick)", file=sys.stderr)
        cl.close()
    except Exception as e:
        print(f"[bench] serving pass failed: {e!r}", file=sys.stderr)

    # ---- cold-start batched step: zero warm starts, every lane solved.
    eng = eng0
    try:
        if remaining() < 90:
            raise TimeoutError("skipped: <90 s of budget left")
        cold_args = (sb.state, sb.plan, sb.robot_pose, sb.current_vel,
                     sb.costmap, sb.footprint, sb.delta_t)
        eng.batch_step(*cold_args)
        sync()
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            eng.batch_step(*cold_args)
            sync()
        cold_ms = (time.perf_counter() - t0) / reps * 1e3
        results["cold_batch_step_ms"] = round(cold_ms, 2)
        print(f"[bench] cold done ({cold_ms:.1f} ms/step)", file=sys.stderr)
    except Exception as e:
        print(f"[bench] cold pass failed: {e!r}", file=sys.stderr)

    def take1(tree):
        return tree_map(lambda x: x[:1], tree)

    a1 = (take1(sb.plan), sb.robot_pose[:1], sb.current_vel[:1],
          take1(sb.costmap), take1(sb.footprint), sb.delta_t[:1])

    def pipelined_ms(engine, st):
        """The least per-tick wall of 3 segments of --latency-reps steps,
        the state threaded, one sync a segment; and the state after."""
        best_ms = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(args.latency_reps):
                st = engine.batch_step(st, *a1).state
            sync()
            best_ms = min(best_ms, (time.perf_counter() - t0)
                          / args.latency_reps * 1e3)
        return best_ms, st

    # ---- one robot (lane 0 of the headline's scenarios) at the fleet
    # preset: the pipelined tick and the blocking step's p99.
    single_ok = False
    try:
        if remaining() < 90:
            raise TimeoutError("skipped: <90 s of budget left")
        o = eng.batch_step(eng.init_batch_state(1), *a1)
        sync()
        pipe_ms, st = pipelined_ms(eng, o.state)
        results["single_robot_tick_ms"] = round(pipe_ms, 3)
        lats = []
        for _ in range(args.latency_reps):
            t0 = time.perf_counter()
            eng.batch_step(st, *a1)
            sync()
            lats.append(time.perf_counter() - t0)
        results["blocking_rtt_p99_ms"] = round(
            float(np.percentile(np.array(lats) * 1e3, 99)), 2)
        single_ok = True
    except Exception as e:
        print(f"[bench] single-robot latency pass failed: {e!r}",
              file=sys.stderr)

    # ---- one robot at the default preset (cfg40): the pipelined tick.
    single_def_ok = False
    try:
        if remaining() < 80:
            raise TimeoutError("skipped: <80 s of budget left")
        eng_def = MpcEngine(cfg40, device=device)
        od = eng_def.batch_step(eng_def.init_batch_state(1), *a1)
        sync()
        pd_ms, std = pipelined_ms(eng_def, od.state)
        results["single_robot_tick_default_ms"] = round(pd_ms, 3)
        single_def_ok = True
        print(f"[bench] single-robot default-preset done ({pd_ms:.3f} ms)",
              file=sys.stderr)
    except Exception as e:
        print(f"[bench] single-robot default-preset pass failed: {e!r}",
              file=sys.stderr)

    # ---- the device time of those single-robot steps: p99 over
    # --trace-reps steps after the first.
    def device_p99_ms(engine, st):
        from .utils.profiling import device_step_durations_ms, device_trace

        if device.type != "cuda":
            raise RuntimeError("skipped: no device lane on the CPU")
        with tempfile.TemporaryDirectory() as td:
            with device_trace(td):
                for i in range(args.trace_reps):
                    with torch.profiler.record_function(f"bench_step_{i}"):
                        engine.batch_step(st, *a1)
                        sync()
            print("[bench] parsing trace...", file=sys.stderr)
            durs = device_step_durations_ms(td, "bench_step_")
        if len(durs) != args.trace_reps or min(durs, default=0.0) <= 0.0:
            raise RuntimeError(f"the trace lost device records: step device "
                               f"ms {durs} for {args.trace_reps} steps")
        return (round(float(np.percentile(np.array(durs[1:]), 99)), 3)
                if durs[1:] else None)

    try:
        if not single_ok:
            raise TimeoutError("skipped: single-robot pass did not complete")
        if remaining() < 60:
            raise TimeoutError("skipped: <60 s of budget left")
        print("[bench] tracing device step times...", file=sys.stderr)
        results["device_p99_ms"] = device_p99_ms(eng, st)
    except Exception as e:
        print(f"[bench] device trace failed: {e!r}", file=sys.stderr)

    try:
        if not single_def_ok:
            raise TimeoutError("skipped: default-preset pass did not "
                               "complete")
        if remaining() < 50:
            raise TimeoutError("skipped: <50 s of budget left")
        print("[bench] tracing default-preset device step...",
              file=sys.stderr)
        results["device_p99_default_ms"] = device_p99_ms(eng_def, std)
    except Exception as e:
        print(f"[bench] default-preset device trace failed: {e!r}",
              file=sys.stderr)

    print(f"[bench] kernel launches {json.dumps(kernel_launches())}",
          file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
