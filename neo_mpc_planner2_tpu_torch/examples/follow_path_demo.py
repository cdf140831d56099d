"""Demo: an MPO-700 follows a curved plan through a cluttered map.

Runs the full controller (`NeoMpcController`: pursuit → SQP solve → safety
post-processing) in a closed loop for up to 400 ticks on a 120x120 map and
prints the trajectory every 30 ticks, then the tick it reached the goal.

    python -m neo_mpc_planner2_tpu_torch.examples.follow_path_demo
    python -m neo_mpc_planner2_tpu_torch.examples.follow_path_demo --device cpu

One robot's tick is bound by the host: a few thousand kernel launches and
a few tens of syncs a tick, 70-130 ms a tick on an H100 (PERF.md §5), so
the ~130 ticks to the goal take 10-20 s on the card and the whole 400, if
it never settled, 30-50 s.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..utils.entrypoints import SAMPLE_PARAMS, add_device_arg, resolve_device

__all__ = ["TICKS", "scene", "run", "main"]

TICKS = 400


def scene() -> dict:
    """The demo's plan (80 poses to (2.0, 1.0)) and its 120x120 map at
    0.05 m with a soft obstacle beside the path, in numpy."""
    t = np.linspace(0, 1, 80)
    plan_xy = np.stack([2.0 * t, t**2, np.arctan2(np.gradient(t**2),
                                                  np.gradient(2.0 * t))], 1)
    yy, xx = np.meshgrid(np.arange(120) * 0.05 - 1.0,
                         np.arange(120) * 0.05 - 1.0, indexing="ij")
    grid = 0.9 * np.exp(-(((xx - 1.0) ** 2) + (yy - 0.15) ** 2) / 0.02)
    return {"params": dict(SAMPLE_PARAMS), "plan": plan_xy, "grid": grid,
            "origin": (-1.0, -1.0), "resolution": 0.05, "dt": 1.0 / 30.0}


def run(ticks: int | None = None, device="cuda") -> dict:
    """The closed loop for `ticks` ticks (default 400), stopping at the
    goal (within 5 cm and slower than 5 cm/s). Returns the poses after
    each tick and the commands (T, 3), the goal distances (T,), the tick
    the goal was reached (-1: not reached) and the last lookahead point."""
    from ..config import config_from_ros_params
    from ..controller import NeoMpcController
    from ..ops.costmap import Costmap
    from ..scenarios import mpo700_footprint
    from ..utils.se2_np import integrate_cmd_np

    device = resolve_device(device)
    sc = scene()
    cfg = config_from_ros_params(sc["params"])
    costmap = Costmap.create(sc["grid"], origin=sc["origin"],
                             resolution=sc["resolution"], device=device)
    ctrl = NeoMpcController(device=device)
    ctrl.configure(cfg, costmap=costmap,
                   footprint=mpo700_footprint(device=device))
    ctrl.activate()
    ctrl.set_plan(sc["plan"])

    goal = sc["plan"][-1, :2]
    pose, vel, dt = np.zeros(3), np.zeros(3), sc["dt"]
    poses, cmds, dists, reached = [], [], [], -1
    for i in range(TICKS if ticks is None else ticks):
        cmd = ctrl.compute_velocity_commands(pose, vel, dt)
        pose = integrate_cmd_np(pose, cmd, dt)
        vel = cmd
        poses.append(pose)
        cmds.append(cmd)
        dists.append(np.linalg.norm(pose[:2] - goal))
        if dists[-1] < 0.05 and np.hypot(cmd[0], cmd[1]) < 0.05:
            reached = i
            break
    return {"poses": np.array(poses), "cmds": np.array(cmds),
            "goal_dist": np.array(dists), "reached_tick": reached,
            "lookahead_point": ctrl.debug_msgs()["lookahead_point"]["point"]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arg(ap)
    out = run(device=ap.parse_args(argv).device)
    print(f"{'tick':>4} {'x':>7} {'y':>7} {'yaw':>7}   "
          f"{'vx':>6} {'vy':>6} {'wz':>6}")
    for i in range(0, len(out["poses"]), 30):
        pose, cmd = out["poses"][i], out["cmds"][i]
        print(f"{i:4d} {pose[0]:7.3f} {pose[1]:7.3f} {pose[2]:7.3f}   "
              f"{cmd[0]:6.3f} {cmd[1]:6.3f} {cmd[2]:6.3f}")
    if out["reached_tick"] >= 0:
        print(f"\nreached goal at tick {out['reached_tick']} "
              f"(dist {out['goal_dist'][-1]:.3f} m)")
    else:
        print(f"\ndid not settle within {TICKS} ticks")
    print("last lookahead point:", out["lookahead_point"])


if __name__ == "__main__":
    main()
