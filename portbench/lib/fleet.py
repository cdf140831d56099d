"""The fleet cells' entry loop: the port's closed loop
(simulation.batch_simulate) over a card's worth of robots.

Set-up makes `scene_batches` scene batches from the seed, on the device,
and runs one whole warm segment. The window then runs segments of
`segment_ticks` ticks, each from a cold controller state on the next batch
in turn, until the first segment that ends after `--seconds`; the rate is
every lane-tick of the window over the window's time. A traced run then
profiles `trace_ticks` consecutive ticks: a segment's last ticks, continued
from its carry. After everything, the judge re-derives a sample of lanes
of every segment with the reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import judge, scenes, stats, trace


def _scenes(run, c, tr, k: int, lanes: int):
    m = c["map"]
    sc = scenes.fleet_scenes(
        scenes.rng(run.seed, k), lanes, m["cells"], m["resolution_m"],
        tr["plan_points"], c["engine"]["max_plan_points"],
        tr["plan_length_m"], tr["obstacles"], tr["pose_jitter_m"],
        tr["center_on"], run.device)
    mo = tr.get("moving_obstacles")
    if mo:
        sc["moving"] = scenes.moving_obstacles(
            scenes.rng(run.seed, 100 + k), lanes, mo["per_lane"], m["cells"],
            m["resolution_m"], mo["speed_mps"], run.device)
    return sc


def run(run) -> dict:
    c, tr = run.config, run.traffic
    lanes = run.lanes or c["lanes_per_card"]
    ticks = run.ticks or tr["segment_ticks"]
    parity = c["mode"] == "parity"
    program = run.program
    cfg = program.port_config(c)
    dt = 1.0 / c["ros_params"]["controller_frequency"]
    batches = [_scenes(run, c, tr, k, lanes)
               for k in range(tr["scene_batches"])]
    sbs = [program.scenario_batch(cfg, c, sc) for sc in batches]

    def segment(k, n, init=None, t0=0):
        obs = batches[k].get("moving")
        if obs is not None and t0:
            e = program.elapsed(t0, dt)
            obs = (obs[0] + e * obs[2], obs[1], obs[2])
        res = program.simulate(cfg, parity, sbs[k], n, init=init,
                               obstacles=obs)
        program.sync(run.device)
        return res

    run.log("warm segment")
    segment(0, ticks)
    setup_s = time.perf_counter() - run.t_start

    run.log("window")
    kept, iters = [], []
    t0 = time.perf_counter()
    i = 0
    while True:
        k = i % len(batches)
        res = segment(k, ticks)
        kept.append((k, res.poses, res.cmds))
        iters.append(res.solver_iters.sum())
        i += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    window = time.perf_counter() - t0
    solves = lanes * ticks * i
    out = {"e2e": {"solves_per_s": stats.solves_per_s(lanes, ticks, i,
                                                      window),
                   "setup_s": setup_s},
           "attempted": solves}
    run.log(f"window: {i} segments, {window:.3f} s")
    memory = (torch.cuda.max_memory_allocated()
              if torch.device(run.device).type == "cuda" else 0)

    ctx = {"kind": "fleet", "lanes": lanes,
           "m": 3 * c["ros_params"]["control_steps"],
           "qp_iters": c["engine"]["qp_iters"],
           "mean_iters": float(torch.stack(iters).sum()) / solves,
           "events": None}
    if run.trace:
        n = min(int(tr["trace_ticks"]), ticks)
        head = segment(0, ticks - n) if ticks > n else None
        init = (None if head is None else
                (head.final_state, head.poses[:, -1], head.cmds[:, -1]))
        if torch.device(run.device).type == "cuda":
            ev, wall = trace.profile(
                lambda: segment(0, n, init, ticks - n))
            ctx.update(events=ev, ticks=n, window_s=wall)

    # The program's answers at the judged lanes, then its state is freed.
    pick = np.sort(scenes.rng(run.seed, 999).choice(
        lanes, min(lanes, int(tr["judge_lanes"])), replace=False))
    idx = torch.as_tensor(pick, device=run.device)
    segs = [(k, p[idx].cpu(), u[idx].cpu()) for k, p, u in kept]
    ins = [{key: (v[idx].cpu() if torch.is_tensor(v) else
                  tuple(a[idx].cpu() for a in v))
            for key, v in b.items()} for b in batches]
    failed = sum(int((~torch.isfinite(u).all(-1)).sum()) for _, _, u in kept)
    del kept, sbs, batches
    out.update(failed=failed, memory_peak_bytes=memory, layer_ctx=ctx)
    run.log("judge")
    out["numbers"] = judge.fleet(c, tr, ins, segs, ticks)
    return out
