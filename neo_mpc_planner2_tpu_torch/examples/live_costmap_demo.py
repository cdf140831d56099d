"""Demo: the live-costmap serving flow through the server's ops.

The reference's server solves against a costmap that its ROS subscriptions
keep current (mpc_optimization_server.py:118); the port's session offers
that as explicit ops. The demo drives a full-tick session (`serving.
OptimizerSession`, in this process, on the card unless it is given
--device cpu) the way a deployment's sensor pipeline would:

  1. `set_costmap` stages the 96x96 world grid ONCE, with a 64-cell
     rolling window view,
  2. each tick, `set_costmap_update` writes only the 16x16 dirty cells
     around a moving obstacle and re-centres the window on the robot,
  3. `tick` runs the whole controller tick in the session.

The obstacle crosses the robot's corridor and the robot reaches the goal
within 360 ticks. The JAX demo also asserts that the predicted-collision
latch fires while the obstacle blocks; in both packages the robot is held
by the plugin's lethal gate instead (the obstacle's lethal disc under its
footprint: the tick's `lethal` flag) until the obstacle has passed, the
latch never fires, and both demos end on that assertion.

    python -m neo_mpc_planner2_tpu_torch.examples.live_costmap_demo
    python -m neo_mpc_planner2_tpu_torch.examples.live_costmap_demo --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

from ..utils.entrypoints import SAMPLE_PARAMS, add_device_arg, resolve_device

__all__ = ["TICKS", "W", "RES", "params", "obstacle_patch",
           "setup_messages", "run", "main"]

TICKS = 360
W = 96          # world grid (4.8 m at 5 cm)
RES = 0.05


def params() -> dict:
    """The session's ROS parameters: the sample values with the live
    footprint weight (2000), a 3 s stuck-wait and a 0.8 low-pass gain."""
    p = dict(SAMPLE_PARAMS, w_footprint=2000.0, waiting_time=3.0,
             low_pass_gain=0.8)
    p.pop("controller_frequency")
    return p


def obstacle_patch(base, cx_cell, cy_cell, size, world_cells):
    """The sensor pipeline's belief for the dirty window: the static base
    plus a lethal disc (radius 3 cells) at the obstacle's cell."""
    lo = [int(np.clip(cx_cell - size // 2, 0, world_cells - size)),
          int(np.clip(cy_cell - size // 2, 0, world_cells - size))]
    win = base[lo[1]:lo[1] + size, lo[0]:lo[0] + size].copy()
    yy, xx = np.mgrid[0:size, 0:size]
    d2 = (xx + lo[0] - cx_cell) ** 2 + (yy + lo[1] - cy_cell) ** 2
    win[d2 <= 9] = 1.0
    return win, lo


def setup_messages(base) -> list:
    """Stage once: the world grid with a 64-cell window centred on the
    start, the footprint and a 1.6 m straight plan of 48 poses."""
    return [{"op": "set_costmap", "data": base.tolist(),
             "origin": [-2.4, -2.4], "resolution": RES,
             "win_cells": 64, "win_lo": [16, 16]},
            {"op": "set_footprint",
             "points": [[0.365, 0.275], [-0.365, 0.275],
                        [-0.365, -0.275], [0.365, -0.275]]},
            {"op": "set_plan",
             "poses": [[x, 0.0, 0.0] for x in np.linspace(0.0, 1.6, 48)]}]


def run(ticks: int | None = None, device="cuda", call=None) -> dict:
    """The demo's session for up to `ticks` ticks (default 360), stopping
    within 8 cm of the goal. call: a message -> response function to drive
    (a client's `call` over a socket); by default an in-process
    `OptimizerSession` on `device`. Returns the commands and poses (T, 3),
    the goal distances (T,), the latch flags and the lethal-gate flags
    (T,), the tick the goal was reached (-1: not reached), whether the
    collision latch fired and the obstacle's y after each tick."""
    if call is None:
        from ..config import config_from_ros_params
        from ..serving import OptimizerSession

        cfg = config_from_ros_params(params()).replace(max_plan_points=64)
        call = OptimizerSession(cfg, device=resolve_device(device)).handle
    base = np.zeros((W, W), np.float32)
    for msg in setup_messages(base):
        r = call(msg)
        if not r.get("ok"):
            raise RuntimeError(f"{msg['op']}: {r}")

    # The obstacle crosses the corridor at x = 0.8 m, moving in -y.
    obs, obs_v = np.array([0.8, 0.9]), np.array([0.0, -0.45])
    pose, vel, dt = np.zeros(3), np.zeros(3), 1.0 / 30.0
    cmds, poses, dists, latches, lethal, obs_y = [], [], [], [], [], []
    reached = -1
    for t in range(TICKS if ticks is None else ticks):
        # 1. sensor update: the dirty window around the obstacle.
        cx = int((obs[0] + 2.4) / RES)
        cy = int((obs[1] + 2.4) / RES)
        win, lo = obstacle_patch(base, cx, cy, 16, W)
        # 2. the window follows the robot.
        rx = int(np.clip((pose[0] + 2.4) / RES - 32, 0, W - 64))
        ry = int(np.clip((pose[1] + 2.4) / RES - 32, 0, W - 64))
        r = call({"op": "set_costmap_update", "data": win.tolist(),
                  "lo": lo, "win_lo": [rx, ry]})
        if not r.get("ok"):
            raise RuntimeError(f"set_costmap_update: {r}")
        # 3. one full controller tick.
        r = call({"op": "tick", "pose": pose.tolist(), "vel": vel.tolist(),
                  "delta_t": dt})
        if "output_vel" not in r:
            raise RuntimeError(f"tick: {r}")
        cmd = np.asarray(r["output_vel"])
        latches.append(bool(r["collision"] or r["collision_footprint"]))
        lethal.append(bool(r["lethal"]))
        # The plant: yaw first, as the controller assumes.
        pose[2] += cmd[2] * dt
        pose[0] += (cmd[0] * np.cos(pose[2]) - cmd[1] * np.sin(pose[2])) * dt
        pose[1] += (cmd[0] * np.sin(pose[2]) + cmd[1] * np.cos(pose[2])) * dt
        vel = cmd
        obs = obs + obs_v * dt
        obs_y.append(obs[1])
        cmds.append(cmd)
        poses.append(pose.copy())
        dists.append(np.linalg.norm(pose[:2] - [1.6, 0.0]))
        if dists[-1] < 0.08:
            reached = t
            break
    return {"cmds": np.array(cmds), "poses": np.array(poses),
            "goal_dist": np.array(dists), "latched": np.array(latches),
            "lethal": np.array(lethal),
            "reached_tick": reached, "latched_en_route": any(latches),
            "obstacle_y": np.array(obs_y)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arg(ap)
    out = run(device=ap.parse_args(argv).device)
    for t in range(0, len(out["cmds"]), 30):
        p = out["poses"][t]
        print(f"t={t:3d} pose=({p[0]:+.2f},{p[1]:+.2f}) "
              f"obs_y={out['obstacle_y'][t]:+.2f} "
              f"gd={out['goal_dist'][t]:.3f} latched={out['latched'][t]}")
    if out["reached_tick"] >= 0:
        print(f"reached goal at tick {out['reached_tick']} "
              f"(dist {out['goal_dist'][-1]:.3f} m); "
              f"collision latched en route: {out['latched_en_route']}")
    assert out["reached_tick"] >= 0, "robot failed to reach the goal"
    assert out["latched_en_route"], \
        "the crossing obstacle never latched the collision stop"


if __name__ == "__main__":
    main()
