"""Demo: the stuck-wait maneuver against a crossing dynamic obstacle.

This is the scenario class the reference's 3 s stuck-wait exists for
(mpc_optimization_server.py:374-382): an obstacle crosses the robot's
corridor, the command is zeroed while it blocks, and — once the obstacle
has passed — the robot resumes and reaches its goal. The JAX demo asserts
that the predicted-collision latch is what stops it; in both packages the
plugin's lethal gate (the obstacle's lethal cells under the footprint:
`SimResult.lethal`) holds the robot first, the latch never fires, and
both demos end on that assertion after reaching the goal.

Runs on the device: the costmap is re-synthesized every tick with the
obstacle's centre advanced along its velocity (`simulation.batch_simulate`
with `dynamic_obstacles`, 260 ticks at batch 1), the batched equivalent of
the fresh costmap the reference's server receives with every call.

    python -m neo_mpc_planner2_tpu_torch.examples.dynamic_obstacle_demo
    python -m neo_mpc_planner2_tpu_torch.examples.dynamic_obstacle_demo --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

from ..utils.entrypoints import SAMPLE_PARAMS, add_device_arg, resolve_device

__all__ = ["TICKS", "scene", "run", "main"]

TICKS = 260


def scene() -> dict:
    """The straight 2 m plan along +x (50 poses), the 96x96 grid at 0.05 m
    it is re-synthesized on (origin -2.4 m), and one lethal obstacle
    starting 1.1 m beside the path at x = 1.0 and crossing at 0.45 m/s
    (in the corridor from ~tick 55 to ~tick 105): centres (1, 1, 2),
    amplitudes (1, 1), velocities (1, 1, 2), in numpy."""
    n = 50
    return {"params": dict(SAMPLE_PARAMS),
            "plan": np.stack([np.linspace(0, 2.0, n), np.zeros(n),
                              np.zeros(n)], 1),
            "map_cells": 96, "origin": -2.4, "resolution": 0.05,
            "centers": np.array([[[1.0, -1.1]]], np.float32),
            "amp": np.array([[1.0]], np.float32),
            "vel": np.array([[[0.0, 0.45]]], np.float32)}


def run(ticks: int | None = None, device="cuda") -> dict:
    """`ticks` closed-loop ticks (default 260) at batch 1. Returns lane
    0's goal distances (T,), collision latches and lethal-gate flags (T,)
    and commands (T, 3), the first and last tick of each (-1: none) and
    the first tick within 8 cm of the goal (-1: none)."""
    import torch

    from ..config import config_from_ros_params
    from ..engine import init_state
    from ..ops.costmap import Costmap
    from ..ops.pursuit import Plan
    from ..scenarios import ScenarioBatch, mpo700_footprint
    from ..simulation import batch_simulate
    from ..tree import tree_map

    device = resolve_device(device)
    sc = scene()
    cfg = config_from_ros_params(sc["params"]).replace(max_plan_points=64)
    plan = Plan.create(sc["plan"], max_points=cfg.max_plan_points,
                       device=device)
    B, M = 1, sc["map_cells"]
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    costmap = Costmap(  # the geometry carrier; re-synthesized every tick
        data=torch.zeros((B, M, M), device=device),
        origin=torch.full((B, 2), sc["origin"], device=device),
        resolution=torch.full((B,), sc["resolution"], device=device))
    lanes = lambda tree: tree_map(
        lambda x: x.expand((B,) + tuple(x.shape)).contiguous(), tree)
    sb = ScenarioBatch(
        state=lanes(init_state(cfg, device)), plan=lanes(plan),
        robot_pose=torch.zeros((B, 3), device=device),
        current_vel=torch.zeros((B, 3), device=device),
        costmap=costmap, footprint=lanes(mpo700_footprint(device=device)),
        delta_t=torch.full((B,), 1 / 30, device=device))
    res = batch_simulate(
        cfg, sb, TICKS if ticks is None else ticks,
        dynamic_obstacles=(f32(sc["centers"]), f32(sc["amp"]),
                           f32(sc["vel"])),
        obstacle_lethal_threshold=0.5)
    gd = res.goal_dist[0].cpu().numpy()
    coll = res.collisions[0].cpu().numpy()
    lethal = res.lethal[0].cpu().numpy()
    stops, held = np.nonzero(coll)[0], np.nonzero(lethal)[0]
    reached = np.nonzero(gd < 0.08)[0]
    ends = lambda ticks, i: int(ticks[i]) if len(ticks) else -1
    return {"goal_dist": gd, "collisions": coll, "lethal": lethal,
            "cmds": res.cmds[0].cpu().numpy(),
            "latch_first": ends(stops, 0), "latch_last": ends(stops, -1),
            "lethal_first": ends(held, 0), "lethal_last": ends(held, -1),
            "reached_tick": ends(reached, 0)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arg(ap)
    out = run(device=ap.parse_args(argv).device)
    gd, coll, cmds = out["goal_dist"], out["collisions"], out["cmds"]
    for i in range(0, len(gd), 26):
        print(f"tick {i:>3}  goal dist {gd[i]:5.2f} m  "
              f"collision latch {'ON ' if coll[i] else 'off'}  "
              f"|cmd| {np.hypot(cmds[i, 0], cmds[i, 1]):.2f} m/s")
    first, last, reached = (out["latch_first"], out["latch_last"],
                            out["reached_tick"])
    assert first >= 0, "the crossing obstacle never latched the stop"
    assert reached >= 0, f"goal not reached (final dist {gd[-1]:.3f})"
    print(f"\nlatched (stopped) ticks {first}..{last} "
          f"({(last - first) / 30:.1f} s incl. the 3 s stuck-wait), "
          f"then resumed and reached the goal at tick {reached}")


if __name__ == "__main__":
    main()
