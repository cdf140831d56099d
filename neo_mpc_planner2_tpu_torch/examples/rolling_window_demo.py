"""Demo: a long plan traversed with a nav2-style ROLLING local costmap.

The reference plugin sizes its plan window from the nav2 local costmap,
which re-centres on the robot every tick (Costmap2DROS rolling_window;
NeoMpcPlanner.cpp:80-82). A STATIC window cannot follow a plan longer than
its extent — the robot hits the lethal out-of-window band and latches the
safety stop. This demo drives a 4.8 m plan through a 9.6 m world with a
3.2 m rolling window for 420 ticks (`simulation.simulate_follow_path` with
window_cells=64), through the view (`simulation.rolling_view`): the window
is bounds metadata on the world map, nothing is copied a tick.

    python -m neo_mpc_planner2_tpu_torch.examples.rolling_window_demo
    python -m neo_mpc_planner2_tpu_torch.examples.rolling_window_demo --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

from ..utils.entrypoints import SAMPLE_PARAMS, add_device_arg, resolve_device

__all__ = ["TICKS", "scene", "run", "main"]

TICKS = 420


def scene() -> dict:
    """The 4.8 m gently curved plan (120 poses) and the 192x192 world map
    (9.6 m at 0.05 m) with eight blobs of clutter away from the path
    corridor (seed 4), in numpy."""
    n = 120
    t = np.linspace(0.0, 1.0, n)
    xs = 4.8 * t
    ys = 0.6 * np.sin(np.pi * t)
    yaw = np.arctan2(np.gradient(ys), np.gradient(xs))
    rng = np.random.default_rng(4)
    yy, xx = np.meshgrid(np.arange(192) * 0.05 - 2.0,
                         np.arange(192) * 0.05 - 4.0, indexing="ij")
    grid = np.zeros((192, 192), np.float32)
    for _ in range(8):
        cx, cy = rng.uniform(0.2, 4.4), rng.uniform(-3.0, 5.0)
        if abs(cy - 0.6 * np.sin(np.pi * cx / 4.8)) < 0.7:
            cy += 1.4
        grid = np.maximum(grid, 0.9 * np.exp(
            -(((xx - cy) ** 2) + (yy - cx) ** 2) / 0.03)).astype(np.float32)
    # xx spans world y here (the meshgrid order); the world is its transpose.
    return {"params": dict(SAMPLE_PARAMS), "plan": np.stack([xs, ys, yaw], 1),
            "grid": grid.T, "origin": (-4.0, -2.0), "resolution": 0.05}


def run(ticks: int | None = None, device="cuda") -> dict:
    """`ticks` closed-loop ticks (default 420) of one robot on the scene.
    Returns the poses and commands (T, 3), the goal distances, the lethal
    flags (T,) and the first tick within 5 cm of the goal (-1: none)."""
    from ..config import config_from_ros_params
    from ..ops.costmap import Costmap
    from ..ops.pursuit import Plan
    from ..scenarios import mpo700_footprint
    from ..simulation import simulate_follow_path

    device = resolve_device(device)
    sc = scene()
    cfg = config_from_ros_params(sc["params"]).replace(max_plan_points=128)
    plan = Plan.create(sc["plan"], max_points=128, device=device)
    world = Costmap.create(sc["grid"], origin=sc["origin"],
                           resolution=sc["resolution"], device=device)
    zeros = np.zeros(3, np.float32)
    res = simulate_follow_path(cfg, plan, world,
                               mpo700_footprint(device=device), zeros, zeros,
                               TICKS if ticks is None else ticks,
                               window_cells=64)
    gd = res.goal_dist.cpu().numpy()
    reached = np.nonzero(gd < 0.05)[0]
    return {"poses": res.poses.cpu().numpy(), "cmds": res.cmds.cpu().numpy(),
            "goal_dist": gd, "lethal": res.lethal.cpu().numpy(),
            "reached_tick": int(reached[0]) if len(reached) else -1}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arg(ap)
    out = run(device=ap.parse_args(argv).device)
    gd, poses = out["goal_dist"], out["poses"]
    for i in range(0, len(poses), 60):
        print(f"tick {i:>3}  x {poses[i, 0]:6.2f}  y {poses[i, 1]:6.2f}  "
              f"goal dist {gd[i]:5.2f} m")
    r = out["reached_tick"]
    if r >= 0:
        print(f"reached goal at tick {r} (dist {gd[r]:.3f} m) — 4.8 m plan "
              f"through a 3.2 m rolling window")
    else:
        print(f"final goal dist {gd[-1]:.3f} m after {len(gd)} ticks")
    assert not out["lethal"].any(), "lethal latch fired"


if __name__ == "__main__":
    main()
