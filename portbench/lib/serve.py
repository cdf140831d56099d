"""The serving cells' entry loop: the port's optimization server
(serving.serve) in a thread of this process, and one robot's Nav2 plugin
stood in by a client over loopback TCP.

The client keeps one connection and a closed loop: it sends the next
`optimizer` request once the reply is in and 1/rate s has passed since the
last send (back to back while requests take longer). Between requests it
moves the robot by the returned command over the control interval and
picks the carrot as the plugin does (pursuit.carrot). An episode is a plan
and its local costmap drawn from the seed; it ends within `goal_tol_m` of
the goal or after `episode_ticks` requests, and the next episode's map goes
out with set_costmap between requests, outside the timed ones.

Latency is the client's: from writing a request to reading its reply, for
every request sent in the window.
"""

from __future__ import annotations

import json
import socket
import time

import numpy as np
import torch

from . import judge, pursuit, scenes, stats, trace


class Client:
    """Newline-delimited JSON over one TCP connection."""

    def __init__(self, port: int):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=60)
        self.f = self.sock.makefile("rwb")

    def call(self, msg: dict) -> dict:
        self.f.write(json.dumps(msg).encode() + b"\n")
        self.f.flush()
        line = self.f.readline()
        if not line:
            raise ConnectionError("the server closed the connection")
        return json.loads(line)

    def close(self) -> None:
        self.f.close()
        self.sock.close()


def f32(a) -> list:
    return [float(v) for v in np.asarray(a, np.float32).reshape(-1)]


class Robot:
    """The plugin's stand-in: episodes, carrot, plant, requests."""

    def __init__(self, run, c, tr, client):
        self.run, self.c, self.tr, self.cl = run, c, tr, client
        self.ci = float(np.float32(1.0 / c["ros_params"]["controller_frequency"]))
        self.la = c["ros_params"]["lookahead_dist_close_to_goal"]
        self.episode = -1
        self.grids = []
        self.reqs, self.resps, self.lat = [], [], []

    def new_episode(self) -> None:
        c, tr = self.c, self.tr
        self.episode += 1
        m = c["map"]
        sc = scenes.fleet_scenes(
            scenes.rng(self.run.seed, 200 + self.episode), 1, m["cells"],
            m["resolution_m"], tr["plan_points"], tr["plan_points"],
            tr["plan_length_m"], tr["obstacles"], tr["pose_jitter_m"],
            tr["center_on"], "cpu")
        self.plan = sc["plan"][0].numpy().astype(np.float64)
        self.goal = self.plan[-1]
        self.half = m["cells"] * m["resolution_m"] / 2.0
        self.pose = sc["pose"][0].numpy().astype(np.float64)
        self.vel = sc["vel"][0].numpy().astype(np.float64)
        self.start = 0
        self.ticks = 0
        self.grids.append((sc["data"][0], sc["origin"][0], sc["res"][0]))
        r = self.cl.call({"op": "set_costmap",
                          "data": sc["data"][0].numpy().tolist(),
                          "origin": f32(sc["origin"][0]),
                          "resolution": float(sc["res"][0])})
        if "error" in r:
            raise RuntimeError(f"set_costmap: {r['error']}")

    def request(self) -> dict:
        carrot, self.start, closer = pursuit.carrot(
            self.plan, self.start, self.pose, self.half, self.la)
        return {"op": "optimizer", "current_pose": f32(self.pose),
                "carrot_pose": f32(carrot), "goal_pose": f32(self.goal),
                "current_vel": f32(self.vel), "switch_opt": bool(closer),
                "control_interval": self.ci, "delta_t": self.ci}

    def step(self) -> float:
        """One request and its reply; the robot moves. -> latency s."""
        req = self.request()
        t0 = time.perf_counter()
        try:
            resp = self.cl.call(req)
        except (OSError, ValueError) as e:
            resp = {"error": repr(e)}
        lat = time.perf_counter() - t0
        req["episode"] = self.episode
        self.reqs.append(req)
        ok = "error" not in resp
        self.resps.append(resp if ok else None)
        u = np.asarray(resp["output_vel"] if ok else [0.0, 0.0, 0.0],
                       np.float64)
        self.pose = pursuit.plant(self.pose, u, self.ci)
        self.vel = u
        self.ticks += 1
        d = np.hypot(*(self.pose[:2] - self.goal[:2]))
        if d < self.tr["goal_tol_m"] or self.ticks >= self.tr["episode_ticks"]:
            self.new_episode()
        return lat


def run(run) -> dict:
    c, tr = run.config, run.traffic
    program = run.program
    cfg = program.port_config(c)
    port = program.start_server(cfg, c["mode"] == "parity", run.device)
    cl = Client(port)
    r = cl.call({"op": "set_footprint",
                 "points": [f32(p) for p in scenes.footprint(c)]})
    if "error" in r:
        raise RuntimeError(f"set_footprint: {r['error']}")
    bot = Robot(run, c, tr, cl)
    bot.new_episode()
    run.log("warm requests")
    for _ in range(int(tr["warmup_requests"])):
        bot.step()
    if None in bot.resps:
        raise RuntimeError("a warm-up request got no reply")
    setup_s = time.perf_counter() - run.t_start

    run.log("window")
    first = len(bot.reqs)
    period = 1.0 / tr["rate_hz"]
    t0 = time.perf_counter()
    due = t0
    while True:
        now = time.perf_counter()
        if now < due:
            time.sleep(due - now)
        sent = time.perf_counter()
        bot.lat.append(bot.step())
        due = sent + period
        if time.perf_counter() - t0 >= run.seconds:
            break
    n = len(bot.lat)
    failed = sum(1 for r in bot.resps[first:] if r is None)
    out = {"e2e": {**stats.latency_ms(bot.lat), "setup_s": setup_s},
           "attempted": n, "failed": failed}
    run.log(f"window: {n} requests, {time.perf_counter() - t0:.3f} s")
    cuda = torch.device(run.device).type == "cuda"
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
    ctx = {"kind": "serve", "events": None}
    if run.trace and cuda:
        k = int(tr["trace_requests"])

        def requests():
            for _ in range(k):
                bot.step()

        ev, wall = trace.profile(requests)
        ctx.update(events=ev, requests=k, window_s=wall)
    cl.close()
    out["layer_ctx"] = ctx
    run.log("judge")
    end = first + n
    out["numbers"] = judge.serve(c, tr, bot.reqs[:end], bot.resps[:end],
                                 bot.grids, range(first, end))
    return out
