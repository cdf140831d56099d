"""Attribute the product-mode (prox-FISTA + smooth objective) quality at
map-128 against map-64.

Candidate causes, isolated one a pass (the bench's quality-suite recipe:
seed 1, 0.7-1.1 m plans, cleared corridor, plan-centred window):

  A. map64          — the reference point.
  B. map128         — the drop to attribute.
  C. embed_lethal   — the map-64 WORLD CONTENT embedded in a 128x128 grid
                      with a LETHAL (1.0) ring. Out-of-window reads are
                      lethal by nav2 convention, and boundary bilinear
                      interpolation sees the same 1.0 neighbours, so the
                      sampling is IDENTICAL to pass A cell for cell while
                      the solver runs on the 128x128 grid. B against C
                      isolates grid size from content; C against A should
                      be ~0.
  D. map128_cap16   — pass B with the prox iteration budget doubled
                      (cap 8 -> 16): recovers quality iff the cap binds.

Every pass also classifies the non-reachers by the safety latch
(collision | lethal at the final tick). Each pass chains --ticks-tick
segments of `simulation.batch_simulate` with the prox solver
(`solver.make_solver_batched`) up to --quality-ticks and prints one JSON
line with the JAX script's keys.

    python -m neo_mpc_planner2_tpu_torch.scripts.product_decompose
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from ..utils.entrypoints import add_device_arg, resolve_device, sync

__all__ = ["config", "suite", "embed", "run_pass", "main"]

PASSES = "map64,map128,embed_lethal,map128_cap16"


def config():
    """The bench's product-pass config: the fleet preset at the sample
    weights with the live footprint weight, quirks off."""
    from ..config import fleet_config

    cfg = fleet_config().replace(
        prediction_horizon=0.8, control_steps=3, opt_tolerance=1e-3,
        footprint_edge_samples=16, max_plan_points=64,
        min_vel_x=-0.7, min_vel_y=-0.7, min_vel_theta=-0.7,
        max_vel_x=0.7, max_vel_y=0.7, max_vel_trans=0.7, max_vel_theta=0.7,
        w_trans=0.82, w_orient=0.5, w_control=0.05, w_terminal=0.05,
        w_costmap=0.05, w_footprint=2000.0,
        costmap_sampling="onehot",
        lookahead_dist_min=0.4, lookahead_dist_max=0.4,
        lookahead_dist_close_to_goal=0.4,
    )
    return cfg.replace(compat=dataclasses.replace(
        cfg.compat, buggy_odom_yaw=False, footprint_alias_noop=False,
        lethal_1000x=False, unsquared_control_cost=False,
        no_angle_wrap=False))


def suite(pcfg, batch: int, map_size: int, device):
    """The quality suite at `map_size` cells."""
    from ..scenarios import make_scenario_batch

    return make_scenario_batch(pcfg, batch, seed=1, map_size=map_size,
                               plan_points=64, plan_length_range=(0.7, 1.1),
                               clear_corridor_m=0.55, center_on="plan",
                               maps_on_device=True, device=device)


def embed(sb, big: int = 128, fill: float = 1.0):
    """Each lane's map at the centre of a (big)² grid filled with `fill`,
    the origins shifted so that the WORLD content is unchanged."""
    data = sb.costmap.data
    small = data.shape[-1]
    pad = (big - small) // 2
    out = torch.full(data.shape[:-2] + (big, big), fill, dtype=data.dtype,
                     device=data.device)
    out[..., pad:pad + small, pad:pad + small] = data
    res = sb.costmap.resolution
    origin = sb.costmap.origin - (pad * res)[..., None]
    return sb._replace(costmap=sb.costmap.replace(
        data=out, origin=origin, flat=None, flat_u8=None))


def run_pass(name: str, sb, pcfg, args, device, solver_cap=None) -> dict:
    """One pass: the chained closed loop and its record."""
    from ..engine import MpcEngine
    from ..ops.objective import make_objective
    from ..simulation import batch_simulate
    from ..solver import make_solver_batched

    psolver = make_solver_batched(pcfg, make_objective(pcfg, parity=False),
                                  max_iters=solver_cap)
    eng = MpcEngine(pcfg, device=device)
    carry = (eng.init_batch_state(args.batch), sb.robot_pose, sb.current_vel)
    t0 = time.time()
    ticks = 0
    while ticks < args.quality_ticks:
        run = batch_simulate(pcfg, sb, args.ticks, parity=False, init=carry,
                             solver_batch=psolver)
        carry = (run.final_state, run.poses[:, -1], run.cmds[:, -1])
        ticks += args.ticks
    dist = run.goal_dist[:, -1]
    sync(device)
    reached = dist < 0.10
    blocked = run.collisions[:, -1] | run.lethal[:, -1]
    n_un = float((~reached).sum())
    rec = {
        "pass": name,
        "map_cells": int(sb.costmap.data.shape[-1]),
        "solver_cap": int(solver_cap or pcfg.solver_max_iters),
        "quality_ticks": ticks,
        "goal_reached_frac": round(float(reached.float().mean()), 4),
        "final_dist_p50_m": round(float(torch.quantile(dist.float(), 0.5)),
                                  4),
        "unreached_blocked_frac": round(
            float((blocked & ~reached).sum()) / max(n_un, 1.0), 4),
        "mean_iters": round(float(run.solver_iters.float().mean()), 2),
        "wall_s": round(time.time() - t0, 1),
    }
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--quality-ticks", type=int, default=160)
    ap.add_argument("--passes", default=PASSES)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    pcfg = config()
    passes = args.passes.split(",")
    recs = []
    sb64 = (suite(pcfg, args.batch, 64, device)
            if {"map64", "embed_lethal"} & set(passes) else None)
    if "map64" in passes:
        recs.append(run_pass("map64", sb64, pcfg, args, device))
    if "map128" in passes or "map128_cap16" in passes:
        sb128 = suite(pcfg, args.batch, 128, device)
        if "map128" in passes:
            recs.append(run_pass("map128", sb128, pcfg, args, device))
        if "map128_cap16" in passes:
            recs.append(run_pass("map128_cap16", sb128, pcfg, args, device,
                                 solver_cap=2 * pcfg.solver_max_iters))
    if "embed_lethal" in passes:
        recs.append(run_pass("embed_lethal", embed(sb64, fill=1.0), pcfg,
                             args, device))
    return recs


if __name__ == "__main__":
    main()
