"""The comparison that decides `correct`: the program's answers against
the plain reference (reference/<config's reference>.py), re-derived from
the same inputs that the benchmark made.

Fleet cells: the answers are every tick's command and pose of a sample of
lanes (drawn from the seed) of every segment of the window. The reference
runs each sampled lane's whole segment from the same cold start and scene,
led at every tick by the program's own pose (where the program's robot
stands), so that one tick's disagreement does not carry into the next
through the plant. Its controller state (warm start, last command, the
velocity it reports, latches, plan index) is its own: the controller
feeds its own command back as the robot's velocity, and the reference's
unsquared control cost is only smooth where that feedback is exact.

Serve cell: the answers are the server's replies to every request of the
window. The reference keeps its own server state from the run's first
request on (warm start, last command, latch, stuck-wait clock), reading
each request's pose, carrot, goal and intervals, which the client made by
moving the robot by the program's commands, and taking as the robot's
velocity its own last command, as the fleet judge does.

Numbers compared (each with its limit in checks/<cell>.json):
- cmd_mismatch_share: the share of judged commands further than `cmd_tol`
  (m/s, rad/s, largest component) from the reference's, or not finite;
- plant_gap: the largest distance between a pose the program reported and
  the reference's plant applied to the program's previous pose and
  command (fleet cells).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import cells, scenes

DEV = "cpu"


def verdict(numbers: dict, failed: int, limits: dict):
    """The rule of `correct`, for every run and every reading: each number
    of the cell's limits, and the failed answers, at or under its limit.
    -> (correct, {name: {"value", "limit"}})."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    checks["failed"] = {"value": int(failed), "limit": 0}
    ok = all(not math.isnan(float(v["value"]))
             and float(v["value"]) <= float(v["limit"])
             for v in checks.values())
    return ok, checks


def _mismatch(got, want, tol: float):
    gap = (got - want).abs().amax(-1)
    return ~(gap <= tol)


def fleet(c, tr, ins, segs, ticks: int, dtype=torch.float32) -> dict:
    """ins: per scene batch, the judged lanes' inputs (CPU tensors); segs:
    (batch, poses (L, T, 3), cmds (L, T, 3)) of each segment."""
    ref = cells.reference(c["reference"])
    P = ref.params_from_config(c)
    cat = lambda key: torch.cat([ins[k][key] for k, _, _ in segs]).to(DEV)
    plan, nv = cat("plan").to(dtype), cat("n_valid").long()
    data, origin, res = cat("data"), cat("origin"), cat("res")
    pose0, vel0 = cat("pose"), cat("vel")
    moving = None
    if "moving" in ins[0]:
        moving = [torch.cat([ins[k]["moving"][j] for k, _, _ in segs]).to(DEV)
                  for j in range(3)]
    prog_p = torch.cat([p for _, p, _ in segs]).to(DEV)
    prog_u = torch.cat([u for _, _, u in segs]).to(DEV)
    B = prog_p.shape[0]
    pts = scenes.footprint(c)
    fp = torch.as_tensor(pts).to(dtype).expand(B, -1, -1)
    cells_ = c["map"]["cells"]
    state = ref.init_state(P, B, dtype, DEV)
    vel = vel0.to(dtype)
    bad = 0
    plant_gap = 0.0
    dt = 1.0 / P.controller_frequency
    for t in range(ticks):
        pose = (pose0 if t == 0 else prog_p[:, t - 1]).to(dtype)
        if moving is not None:
            e = float(np.float32(t) * np.float32(dt))
            d = ref.blob_map(moving[0] + e * moving[2], moving[1], origin,
                             cells_, float(res[0]))
        else:
            d = data
        grid = ref.Grid(d.to(dtype), origin.to(dtype), res.to(dtype))
        cmd, state, _ = ref.tick(P, state, plan, nv, pose, vel, grid, fp,
                                 len(pts), dtype)
        vel = cmd
        bad += int(_mismatch(prog_u[:, t].double(), cmd.double(),
                             tr["cmd_tol"]).sum())
        nxt = ref.plant(P, pose.float(), prog_u[:, t].float())
        gap = (prog_p[:, t].double() - nxt.double()).abs().amax()
        plant_gap = max(plant_gap, float(gap)) if torch.isfinite(gap) \
            else float("inf")
    return {"cmd_mismatch_share": bad / (B * ticks),
            "plant_gap": plant_gap}


def served_edge_samples(c) -> int:
    """The server raises the edge samples so that uniform sampling skips
    no cell: ceil(longest edge / resolution) + 2, at least 8."""
    pts = scenes.footprint(c).astype(float)
    edge = float(np.max(np.linalg.norm(np.roll(pts, -1, 0) - pts, axis=-1)))
    need = max(8, int(np.ceil(edge / c["map"]["resolution_m"])) + 2)
    return max(need, int(c["engine"]["footprint_edge_samples"]))


def chains(reqs) -> list:
    """The requests in runs of one goal: [(first, stop)]. The server's
    state (warm start, last command, stuck-wait clock) carries along a run
    and starts again where the goal changes; only its collision latch
    carries from one run into the next."""
    cut = [0] + [i for i in range(1, len(reqs))
                 if reqs[i]["goal_pose"] != reqs[i - 1]["goal_pose"]]
    return list(zip(cut, cut[1:] + [len(reqs)]))


def _serve_chains(ref, P, c, reqs, grids, runs, latch, dtype):
    """The reference's own closed loop of server states along each run of
    requests, the runs side by side as lanes: -> its command for every
    request (K, 3) and each run's latch at its end (L,)."""
    L, T = len(runs), max(b - a for a, b in runs)
    K = len(reqs)
    # Request index at (lane, step); a run that has ended repeats its last.
    at = [[min(a + t, b - 1) for t in range(T)] for a, b in runs]
    live = torch.tensor([[a + t < b for t in range(T)] for a, b in runs])
    f = lambda key: torch.as_tensor(np.array(
        [[reqs[i][key] for i in row] for row in at], np.float32)).to(dtype)
    pose, carrot, goal = f("current_pose"), f("carrot_pose"), f("goal_pose")
    vel0, ci, dtq = f("current_vel"), f("control_interval"), f("delta_t")
    ep = [reqs[a]["episode"] for a, _ in runs]
    grid = ref.Grid(torch.stack([grids[e][0] for e in ep]).to(dtype),
                    torch.stack([grids[e][1] for e in ep]).to(dtype),
                    torch.stack([grids[e][2] for e in ep]).to(dtype))
    pts = scenes.footprint(c)
    fp = torch.as_tensor(pts).to(dtype).expand(L, -1, -1)
    state = ref.init_state(P, L, dtype, DEV)
    state["collision"] = latch.clone()
    out = []
    vel = vel0[:, 0]
    for t in range(T):
        fpc = ref.footprint_cost(grid, ref.place(pose[:, t, None, :], fp),
                                 len(pts), P.footprint_edge_samples)
        cmd, new, _, _ = ref.serve_request(
            P, state, grid, fp, len(pts), pose[:, t], carrot[:, t],
            goal[:, t], vel, None, ci[:, t], dtq[:, t], fpc, dtype)
        on = live[:, t]
        state = {k: torch.where(on.reshape((L,) + (1,) * (v.dim() - 1)),
                                new[k], v) for k, v in state.items()}
        # The robot reports the command it was given: the reference's own.
        vel = torch.where(on[:, None], cmd, vel)
        out.append(cmd)
    cmds = torch.zeros(K, 3, dtype=torch.float64)
    cmds[torch.as_tensor(at)[live]] = torch.stack(out, 1)[live].double()
    return cmds, state["collision"]


def serve(c, tr, reqs, resps, grids, judged, dtype=torch.float32) -> dict:
    """reqs / resps: every request of the run in order from the first
    (each reply a dict, or None where none came); grids[e]: episode e's
    map (data, origin, res); judged: the indices whose replies are
    compared (the window's).

    The reference keeps its own server state along the requests, as the
    server does from the first request on: it reads each request's pose,
    carrot, goal and intervals (the client's, led by the program's
    commands), and in place of the robot's reported velocity its own last
    command (the first request of a goal reports the robot's start). The
    runs of one goal go side by side; a run that starts with a latch its
    predecessor left set is run again until every latch agrees."""
    ref = cells.reference(c["reference"])
    P = ref.params_from_config(c)
    P.p["footprint_edge_samples"] = served_edge_samples(c)
    runs = chains(reqs)
    latch = torch.zeros(len(runs), dtype=torch.bool)
    for _ in range(len(runs)):
        cmds, end = _serve_chains(ref, P, c, reqs, grids, runs, latch, dtype)
        want = torch.cat([torch.zeros(1, dtype=torch.bool), end[:-1]])
        if torch.equal(want, latch):
            break
        latch = want
    judged = list(judged)
    bad = sum(1 for i in judged if resps[i] is None)
    ok = [i for i in judged if resps[i] is not None]
    if ok:
        got = torch.as_tensor(np.array([resps[i]["output_vel"] for i in ok],
                                       np.float64))
        bad += int(_mismatch(got, cmds[ok], tr["cmd_tol"]).sum())
    return {"cmd_mismatch_share": bad / max(1, len(judged))}
