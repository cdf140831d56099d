"""Two-process deployment demo: the optimization server + a plugin-side
client.

Mirrors the reference deployment shape — the C++ plugin blocking on the
`optimizer` ROS service a tick (NeoMpcPlanner.cpp:248-250) with the Python
server solving (mpc_optimization_server.py:349-403) — over the port's
newline-JSON TCP transport. The server is the port's console script
(`cli.server_main`) in a child process on a free port, on the card unless
the demo is given --device cpu; the "robot" is the omni kinematic model
the controller assumes, and the client integrates the returned command.
One robot drives to its goal (up to 200 ticks), then three robots share
one `optimizer_batch` request a tick (up to 120 ticks).

    python -m neo_mpc_planner2_tpu_torch.examples.serving_demo
    python -m neo_mpc_planner2_tpu_torch.examples.serving_demo --device cpu
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys

import numpy as np

from ..utils.entrypoints import add_device_arg, free_port, resolve_device

__all__ = ["PARAMS", "FOOTPRINT", "TICKS", "FLEET_TICKS", "setup_messages",
           "run", "main"]

TICKS, FLEET_TICKS = 200, 120

PARAMS = {
    "max_vel_x": 0.5, "min_vel_x": -0.5, "max_vel_trans": 0.5,
    # The reference's SAMPLE weights (README.md:27-86). The raw declared
    # defaults are degenerate: with current_vel = 0 the unsquared
    # w_control*||u|| kink outweighs the translation gradient and
    # standing still is a true local optimum.
    "w_trans": 0.82, "w_orient": 0.5, "w_control": 0.05,
    "w_terminal": 0.05, "w_costmap": 0.05,
    "prediction_horizon": 0.8, "control_steps": 3,
    # The demo drives the server RAW (carrot = goal, no plugin layer
    # shrinking the lookahead near the goal), so the accel clamp gets
    # enough authority to decelerate in time.
    "acc_x_limit": 2.0, "acc_y_limit": 2.0, "acc_theta_limit": 2.0,
    "opt_tolerance": 1e-3}
FOOTPRINT = [[0.365, 0.275], [-0.365, 0.275], [-0.365, -0.275],
             [0.365, -0.275]]


def setup_messages() -> list:
    """The session's set-up: configure, an empty 64x64 map (3.2 m) and the
    MPO-700-ish footprint."""
    return [{"op": "configure", "params": PARAMS},
            {"op": "set_costmap", "data": np.zeros((64, 64)).tolist(),
             "origin": [-1.6, -1.6], "resolution": 0.05},
            {"op": "set_footprint", "points": FOOTPRINT}]


def _step(p, v, dt):
    """One step of the omni model (yaw after the position, as the JAX
    demo's client integrates)."""
    return [p[0] + dt * (v[0] * math.cos(p[2]) - v[1] * math.sin(p[2])),
            p[1] + dt * (v[0] * math.sin(p[2]) + v[1] * math.cos(p[2])),
            p[2] + dt * v[2]]


def _carrot(goal, pose):
    """The goal in the robot's base frame."""
    d = [goal[0] - pose[0], goal[1] - pose[1], goal[2] - pose[2]]
    c, s = math.cos(-pose[2]), math.sin(-pose[2])
    return [d[0] * c - d[1] * s, d[0] * s + d[1] * c, d[2]]


def _loops(call, ticks: int, fleet_ticks: int) -> dict:
    """The demo's two client loops over `call` (a message -> response
    function)."""
    for msg in setup_messages():
        resp = call(msg)
        if "error" in resp:
            raise RuntimeError(f"{msg['op']}: {resp['error']}")
    # Drive toward a goal well inside the static 3.2 m map window (a 0.8 s
    # rollout from near the edge would read out-of-window cells as lethal).
    goal = [0.8, 0.3, 0.0]
    pose, vel, dt = [0.0, 0.0, 0.0], [0.0, 0.0, 0.0], 1.0 / 30.0
    cmds, dists, reached = [], [], -1
    for tick in range(ticks):
        rsp = call({"op": "optimizer", "current_pose": pose,
                    "carrot_pose": _carrot(goal, pose), "goal_pose": goal,
                    "current_vel": vel, "control_interval": dt,
                    "delta_t": dt})
        vel = rsp["output_vel"]
        pose = _step(pose, vel, dt)
        cmds.append(vel)
        dists.append(math.hypot(goal[0] - pose[0], goal[1] - pose[1]))
        if dists[-1] < 0.08:
            reached = tick
            break

    # Fleet serving: the same server drives N robots a request as one
    # batched device dispatch (optimizer_batch), each robot keeping its
    # own warm-start lane.
    fleet = [{"pose": [0.0, 0.1 * i, 0.0], "vel": [0.0, 0.0, 0.0],
              "goal": [0.8, 0.3 - 0.2 * i, 0.0]} for i in range(3)]
    fcmds, fdists, freached = [], [], -1
    for tick in range(fleet_ticks):
        robots = [{"current_pose": r["pose"],
                   "carrot_pose": _carrot(r["goal"], r["pose"]),
                   "goal_pose": r["goal"], "current_vel": r["vel"],
                   "control_interval": dt} for r in fleet]
        rsp = call({"op": "optimizer_batch", "robots": robots,
                    "delta_t": dt})
        for r, res in zip(fleet, rsp["results"]):
            r["vel"] = res["output_vel"]
            r["pose"] = _step(r["pose"], r["vel"], dt)
        fcmds.append([r["vel"] for r in fleet])
        fdists.append([math.hypot(r["goal"][0] - r["pose"][0],
                                  r["goal"][1] - r["pose"][1])
                       for r in fleet])
        if max(fdists[-1]) < 0.08:
            freached = tick
            break
    return {"cmds": np.array(cmds), "goal_dist": np.array(dists),
            "reached_tick": reached, "fleet_cmds": np.array(fcmds),
            "fleet_goal_dist": np.array(fdists),
            "fleet_reached_tick": freached}


def run(ticks: int | None = None, device="cuda", call=None,
        fleet_ticks: int | None = None) -> dict:
    """The demo's loops (`ticks` single-robot ticks, default 200, and
    `fleet_ticks` three-robot ticks, default 120; each loop stops when its
    robots are within 8 cm of their goals). call: a message -> response
    function to drive (an in-process `OptimizerSession.handle`, or a
    client's `call`); by default the port's server is started in a child
    process on a free port, on `device`, and stopped at return. Returns
    the commands (T, 3) and goal distances (T,) of the one robot, those of
    the three (T, 3, 3) and (T, 3), and the ticks each loop reached its
    goals at (-1: not reached); with the child server also its `ping`
    answer."""
    ticks = TICKS if ticks is None else ticks
    fleet_ticks = FLEET_TICKS if fleet_ticks is None else fleet_ticks
    if call is not None:
        return _loops(call, ticks, fleet_ticks)
    from ..serving import OptimizerClient

    dev = resolve_device(device)
    port = free_port()
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    server = subprocess.Popen(
        [sys.executable, "-c",
         "from neo_mpc_planner2_tpu_torch.cli import server_main; "
         f"server_main(['--port', '{port}', '--device', '{dev}'])"],
        env=env)
    try:
        cli = OptimizerClient(port=port, wait_timeout=120.0)
        try:
            ping = cli.call({"op": "ping"})
            out = _loops(cli.call, ticks, fleet_ticks)
        finally:
            cli.close()
        return dict(out, ping=ping)
    finally:
        server.terminate()
        server.wait(timeout=10)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arg(ap)
    out = run(device=ap.parse_args(argv).device)
    print("connected:", out["ping"])
    for tick in range(0, len(out["cmds"]), 20):
        v = out["cmds"][tick]
        print(f"tick {tick:3d}  dist {out['goal_dist'][tick]:.3f} m  "
              f"cmd [{v[0]:+.3f} {v[1]:+.3f} {v[2]:+.3f}]")
    if out["reached_tick"] >= 0:
        print(f"reached goal at tick {out['reached_tick']} "
              f"(dist {out['goal_dist'][-1]:.3f} m)")
    print("\nfleet serving (3 robots, one request per tick):")
    for tick in range(0, len(out["fleet_cmds"]), 20):
        print(f"tick {tick:3d}  dists " + " ".join(
            f"{d:.3f}" for d in out["fleet_goal_dist"][tick]))
    if out["fleet_reached_tick"] >= 0:
        print(f"all 3 robots reached their goals at tick "
              f"{out['fleet_reached_tick']}")


if __name__ == "__main__":
    main()
