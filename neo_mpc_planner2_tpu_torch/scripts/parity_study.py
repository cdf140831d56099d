"""Large-scale oracle-parity study (the BASELINE.md north-star gate).

Runs N scenarios of the canonical MPO-700/MPO-500 suites through BOTH
sides:

  device: pursuit -> ONE batched solve on the card (ftol 1e-8, 300
          iterations; `parity.device_solves`)
  oracle: the scipy SLSQP server (`oracle.OracleServer`) on a
          multiprocessing pool

and reports the command-diff distribution, the matched fraction at the
1e-2 m/s tolerance of the committed gate, and a breakdown of every
unmatched command (which side reached the better objective, scipy's
success flag). It also measures scipy's OWN self-agreement ceiling: each
oracle solve is re-run from +/-1e-6-perturbed warm starts; the fraction
of scenarios where scipy disagrees with itself beyond the same tolerance
bounds what any cross-solver gate can demand. The sequence suite runs T
stateful ticks a scenario, both sides fed the same inputs each tick.

    python -m neo_mpc_planner2_tpu_torch.scripts.parity_study --n 300

The report goes to --out (default build/parity_study/PARITY_REPORT.json);
the repository's PARITY_REPORT.json is the JAX package's record and is
never written.

Reference anchor: mpc_optimization_server.py:363-364 (the scipy call this
study replicates on the oracle side).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import pathlib
import pickle
import time

import numpy as np
import torch

from ..utils.entrypoints import add_device_arg, resolve_device

__all__ = ["CMD_TOL", "OBJ_TIE_TOL", "PERTURB", "DEFAULT_OUT", "suite_cfg",
           "run_suite", "run_sequence_suite", "main"]

CMD_TOL = 1e-2          # the committed gate's command tolerance (m/s)
OBJ_TIE_TOL = 1e-4      # objective-gap tolerance for "distinct minimum"
PERTURB = 1e-6          # warm-start perturbation of the self-agreement probe

_ROOT = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_OUT = str(_ROOT / "build" / "parity_study" / "PARITY_REPORT.json")
_REFERENCE_REPORT = _ROOT / "PARITY_REPORT.json"


def suite_cfg(chassis: str):
    """The suite's config (`parity.suite_config`), the MPO-500's with its
    0.8 m/s bounds."""
    from ..parity import suite_config

    cfg = suite_config()
    if chassis == "mpo500":
        cfg = cfg.replace(min_vel_x=-0.8, max_vel_x=0.8,
                          min_vel_y=-0.8, max_vel_y=0.8, max_vel_trans=0.8)
    return cfg


def _chassis(chassis: str):
    from ..scenarios import (MPO500_LENGTH, MPO500_WIDTH, MPO700_LENGTH,
                             MPO700_WIDTH)

    return ((MPO500_LENGTH, MPO500_WIDTH) if chassis == "mpo500"
            else (MPO700_LENGTH, MPO700_WIDTH))


def _rectangle(L: float, W: float) -> np.ndarray:
    hl, hw = L / 2, W / 2
    return np.array([[hl, hw], [-hl, hw], [-hl, -hw], [hl, -hw]])


def _host(t) -> np.ndarray:
    return t.double().cpu().numpy()


# ---------------------------------------------------------------------------
# Oracle side (pool workers; numpy/scipy only)
# ---------------------------------------------------------------------------

_WORKER = {}


def _init_worker(cfg_bytes):
    _WORKER["cfg"] = pickle.loads(cfg_bytes)


def _oracle_one(task):
    """One scenario through the scipy oracle, plus K re-solves from
    perturbed warm starts for the self-agreement probe."""
    from ..oracle import NpCostmap, NpScenario, OracleServer

    (idx, pose, carrot, goal, vel, fp_np, cm_data, cm_origin, cm_res,
     switch_opt, n_perturb, seed) = task
    cfg = _WORKER["cfg"]
    nps = NpScenario(pose, carrot, goal, vel, fp_np,
                     NpCostmap(cm_data, cm_origin, cm_res),
                     switch_opt=switch_opt, control_interval=1 / 30)
    cmd, diag = OracleServer(cfg).solve(nps, 1 / 30)
    # Self-agreement: fresh servers, the warm start perturbed by +/-PERTURB
    # (old_goal pre-seeded so that the new-goal reset keeps it).
    rng = np.random.default_rng(seed)
    self_diff = 0.0
    for _ in range(n_perturb):
        srv_p = OracleServer(cfg)
        srv_p.old_goal = goal.copy()
        srv_p.initial_guess = (np.zeros(cfg.control_steps * 3)
                               + rng.choice([-PERTURB, PERTURB],
                                            cfg.control_steps * 3))
        cmd_p, _ = srv_p.solve(nps, 1 / 30)
        self_diff = max(self_diff, float(np.abs(cmd_p - cmd).max()))
    return {"idx": int(idx), "cmd": [float(v) for v in cmd],
            "fun": diag["fun"], "success": diag["success"],
            "nit": diag["nit"], "collision": bool(diag["collision"]),
            "collision_footprint": bool(diag["collision_footprint"]),
            "self_diff": self_diff}


def _oracle_sequence(task):
    from ..oracle import NpCostmap, NpScenario, OracleServer

    idx, inputs, fp_np, cm_data, cm_origin, cm_res = task
    npcm = NpCostmap(cm_data, cm_origin, cm_res)
    srv = OracleServer(_WORKER["cfg"])
    cmds, funs, succ = [], [], []
    for pose, carrot, goal, vel, sw in inputs:
        nps = NpScenario(pose, carrot, goal, vel, fp_np, npcm,
                         switch_opt=bool(sw), control_interval=1 / 30)
        cmd, diag = srv.solve(nps, 1 / 30)
        cmds.append([float(v) for v in cmd])
        funs.append(float(diag["fun"]))
        succ.append(bool(diag["success"]))
    return {"idx": int(idx), "cmds": cmds, "funs": funs, "success": succ}


def _pool_map(fn, tasks, cfg, workers: int, chunksize: int):
    with mp.get_context("spawn").Pool(workers, _init_worker,
                                      (pickle.dumps(cfg),)) as pool:
        return pool.map(fn, tasks, chunksize=chunksize)


# ---------------------------------------------------------------------------
# The suites
# ---------------------------------------------------------------------------

def run_suite(name, chassis, n, seed, workers, n_perturb, device,
              lethal_threshold=None, pose_jitter=0.05, control_steps=None):
    """One single-tick suite: its summary dict (the JAX study's keys)."""
    from ..ops.footprint import Footprint
    from ..parity import device_solves
    from ..scenarios import make_scenario_batch

    cfg = suite_cfg(chassis)
    if control_steps is not None:
        cfg = cfg.replace(control_steps=control_steps)
    L, W = _chassis(chassis)
    fp_dev = Footprint.rectangle(L, W, cfg.max_footprint_vertices,
                                 device=device)
    sb = make_scenario_batch(cfg, n, seed=seed, map_size=48, plan_points=48,
                             lethal_threshold=lethal_threshold,
                             pose_jitter=pose_jitter, footprint=fp_dev,
                             device=device)
    t0 = time.time()
    pr, out, goal = device_solves(cfg, sb, device)
    cmd_dev, fun_dev = _host(out.cmd_vel), _host(out.fun)
    conv_dev = out.solver_converged.cpu().numpy()
    plan_empty, lethal = (pr.plan_empty.cpu().numpy(),
                          pr.lethal.cpu().numpy())
    carrot, closer = _host(pr.carrot_pose), pr.closer_to_goal.cpu().numpy()
    print(f"[{name}] device: {n} solves in one dispatch, "
          f"{time.time() - t0:.1f}s", flush=True)

    fp_np = _rectangle(L, W)
    goal = _host(goal)
    pose, vel = _host(sb.robot_pose), _host(sb.current_vel)
    data, origin, res = (_host(sb.costmap.data), _host(sb.costmap.origin),
                         _host(sb.costmap.resolution))
    tasks = [(i, pose[i], carrot[i], goal[i], vel[i], fp_np, data[i],
              origin[i], float(res[i]), bool(closer[i]), n_perturb,
              seed * 100003 + i)
             for i in range(n) if not (plan_empty[i] or lethal[i])]
    t0 = time.time()
    oracle_rows = _pool_map(_oracle_one, tasks, cfg, workers, 4)
    print(f"[{name}] oracle: {len(tasks)} solves x {1 + n_perturb} "
          f"starts on {workers} workers, {time.time() - t0:.1f}s", flush=True)

    rows = []
    for o in oracle_rows:
        i = o["idx"]
        diff = float(np.abs(cmd_dev[i] - np.asarray(o["cmd"])).max())
        rows.append({
            "idx": i, "cmd_diff": diff,
            "obj_gap": float(fun_dev[i] - o["fun"]),  # device - oracle
            "matched": diff < CMD_TOL, "scipy_success": o["success"],
            "scipy_nit": o["nit"], "scipy_self_diff": o["self_diff"],
            "device_converged": bool(conv_dev[i]),
            "collision": o["collision"] or o["collision_footprint"]})
    checked = len(rows)
    matched = sum(r["matched"] for r in rows)
    diffs = np.array([r["cmd_diff"] for r in rows])
    self_diffs = np.array([r["scipy_self_diff"] for r in rows])
    unmatched = [r for r in rows if not r["matched"]]
    dev_better = [r for r in unmatched if r["obj_gap"] < -OBJ_TIE_TOL]
    ora_better = [r for r in unmatched if r["obj_gap"] > OBJ_TIE_TOL]
    tie = [r for r in unmatched
           if -OBJ_TIE_TOL <= r["obj_gap"] <= OBJ_TIE_TOL]
    self_flaky = [r for r in unmatched if r["scipy_self_diff"] >= CMD_TOL]
    pct = lambda q: float(np.percentile(diffs, q)) if checked else None
    summary = {
        "suite": name,
        "n_scenarios": n,
        "checked": checked,
        "matched": matched,
        "matched_frac": matched / max(checked, 1),
        "cmd_diff_p50": pct(50),
        "cmd_diff_p90": pct(90),
        "cmd_diff_p99": pct(99),
        "cmd_diff_max": float(diffs.max()) if checked else None,
        "scipy_self_agree_frac": float((self_diffs < CMD_TOL).mean())
        if checked else None,
        "scipy_self_diff_max": float(self_diffs.max()) if checked else None,
        "unmatched": {
            "count": len(unmatched),
            "device_better_objective": len(dev_better),
            "oracle_better_objective": len(ora_better),
            "objective_tie": len(tie),
            "scipy_self_disagrees_too": len(self_flaky),
            "scipy_failed": sum(not r["scipy_success"] for r in unmatched),
            "worst_oracle_better_gap": float(max(
                (r["obj_gap"] for r in ora_better), default=0.0)),
        },
        "rows_unmatched": sorted(
            ({k: r[k] for k in ("idx", "cmd_diff", "obj_gap", "scipy_success",
                                "scipy_nit", "scipy_self_diff",
                                "device_converged", "collision")}
             for r in unmatched),
            key=lambda r: -r["cmd_diff"]),
    }
    print(f"[{name}] matched {matched}/{checked} "
          f"(frac={summary['matched_frac']:.3f}), "
          f"p99 diff {summary['cmd_diff_p99']}, "
          f"scipy self-agree {summary['scipy_self_agree_frac']}, "
          f"unmatched: dev-better {len(dev_better)} / ora-better "
          f"{len(ora_better)} / tie {len(tie)}", flush=True)
    return summary


def run_sequence_suite(name, chassis, n, ticks, seed, workers, device):
    """T stateful ticks a scenario, both sides fed IDENTICAL inputs each
    tick (pose, carrot and velocity from one pursuit stream driven by the
    device's commands), each side evolving its own warm start, last
    control and stuck state: its summary dict (the JAX study's keys)."""
    from ..engine import batch_state, init_state
    from ..ops.footprint import Footprint
    from ..ops.objective import make_objective
    from ..ops.rollout import rollout
    from ..parity import device_solves
    from ..scenarios import make_scenario_batch
    from ..sqp import make_sqp_solver_batched

    cfg = suite_cfg(chassis)
    L, W = _chassis(chassis)
    fp_dev = Footprint.rectangle(L, W, cfg.max_footprint_vertices,
                                 device=device)
    sb = make_scenario_batch(cfg, n, seed=seed, map_size=48, plan_points=48,
                             plan_length_range=(0.7, 1.1),
                             clear_corridor_m=0.55, center_on="plan",
                             footprint=fp_dev, device=device)
    solve = make_sqp_solver_batched(cfg, make_objective(cfg), ftol=1e-8,
                                    max_iters=300)
    goal_np = _host(sb.plan.goal())
    state = batch_state(init_state(cfg, device), n)
    pose, vel = sb.robot_pose, sb.current_vel
    start = torch.zeros(n, dtype=torch.int32, device=device)
    slow = torch.zeros(n, dtype=torch.bool, device=device)

    t0 = time.time()
    dev_cmds = np.zeros((ticks, n, 3))
    dev_funs = np.zeros((ticks, n))
    goal_dist = np.zeros((ticks, n))  # robot -> goal entering tick t
    gated = np.zeros((n,), bool)      # a tick hit a plugin gate: excluded
    seq_inputs = [[] for _ in range(n)]
    for t in range(ticks):
        pr, out, _ = device_solves(cfg, sb, device, state=state, start=start,
                                   slow=slow, pose=pose, vel=vel,
                                   solve=solve)
        state = out.state
        gated |= pr.plan_empty.cpu().numpy() | pr.lethal.cpu().numpy()
        dev_cmds[t] = _host(out.cmd_vel)
        dev_funs[t] = _host(out.fun)
        pose_np = _host(pose)
        goal_dist[t] = np.hypot(pose_np[:, 0] - goal_np[:, 0],
                                pose_np[:, 1] - goal_np[:, 1])
        carrot_np = _host(pr.carrot_pose)
        closer_np = pr.closer_to_goal.cpu().numpy()
        vel_np = _host(vel)
        for i in range(n):
            seq_inputs[i].append((pose_np[i], carrot_np[i], goal_np[i],
                                  vel_np[i], bool(closer_np[i])))
        # The plant integrates the DEVICE command; both sides see its pose.
        with torch.no_grad():
            pose = rollout(out.cmd_vel[:, None, :], 1 / 30, pose)[:, 0]
        vel = out.cmd_vel
        start = pr.new_start
        slow = torch.where(pr.plan_empty, slow, pr.slow_down)
    print(f"[{name}] device: {n} lanes x {ticks} stateful ticks, "
          f"{time.time() - t0:.1f}s", flush=True)

    fp_np = _rectangle(L, W)
    data, origin, res = (_host(sb.costmap.data), _host(sb.costmap.origin),
                         _host(sb.costmap.resolution))
    tasks = [(i, seq_inputs[i], fp_np, data[i], origin[i], float(res[i]))
             for i in range(n) if not gated[i]]
    t0 = time.time()
    rows = _pool_map(_oracle_sequence, tasks, cfg, workers, 2)
    print(f"[{name}] oracle: {len(tasks)} sequences on {workers} workers, "
          f"{time.time() - t0:.1f}s", flush=True)

    diffs, per_tick, per_tick_n = [], np.zeros((ticks,)), 0
    # Unmatched ticks by the achieved-objective gap: both sides minimize
    # the SAME objective each tick (only warm start and filter state
    # differ), so the gap says whether an unmatched command is a near-tie
    # arg-min or a solver loss.
    un_gap, un_dist, un_fail, all_dist = [], [], 0, []
    for o in rows:
        i = o["idx"]
        d = np.abs(dev_cmds[:, i, :] - np.asarray(o["cmds"])).max(axis=-1)
        diffs.extend(d.tolist())
        per_tick += (d < CMD_TOL)
        per_tick_n += 1
        all_dist.extend(goal_dist[:, i].tolist())
        ora_funs = np.asarray(o["funs"])
        for t in np.nonzero(d >= CMD_TOL)[0]:
            un_gap.append(float(dev_funs[t, i] - ora_funs[t]))
            un_dist.append(float(goal_dist[t, i]))
            un_fail += int(not o["success"][t])
    un_gap, un_dist_a, diffs = (np.asarray(un_gap), np.asarray(un_dist),
                                np.asarray(diffs))
    summary = {
        "suite": name,
        "mode": "sequence",
        "n_sequences": per_tick_n,
        "ticks": ticks,
        "checked": int(diffs.size),
        "matched": int((diffs < CMD_TOL).sum()),
        "matched_frac": float((diffs < CMD_TOL).mean()),
        "cmd_diff_p50": float(np.percentile(diffs, 50)),
        "cmd_diff_p99": float(np.percentile(diffs, 99)),
        "cmd_diff_max": float(diffs.max()),
        "matched_frac_per_tick": [round(float(v / max(per_tick_n, 1)), 4)
                                  for v in per_tick],
        "goal_dist_p50_all_m": float(np.percentile(all_dist, 50)),
        "unmatched": {
            "count": int(un_gap.size),
            "device_better_objective": int((un_gap < -OBJ_TIE_TOL).sum()),
            "oracle_better_objective": int((un_gap > OBJ_TIE_TOL).sum()),
            "objective_tie": int((np.abs(un_gap) <= OBJ_TIE_TOL).sum()),
            "worst_oracle_better_gap": float(
                un_gap[un_gap > OBJ_TIE_TOL].max()) if
            (un_gap > OBJ_TIE_TOL).any() else 0.0,
            "scipy_failed": int(un_fail),
            "goal_dist_p50_m": float(np.percentile(un_dist_a, 50))
            if un_dist_a.size else None,
            "goal_dist_p90_m": float(np.percentile(un_dist_a, 90))
            if un_dist_a.size else None,
        },
    }
    u = summary["unmatched"]
    print(f"[{name}] sequence parity: {summary['matched']}/"
          f"{summary['checked']} (frac={summary['matched_frac']:.3f}), "
          f"p99 {summary['cmd_diff_p99']:.2e}, last-tick frac "
          f"{summary['matched_frac_per_tick'][-1]:.3f}; unmatched: "
          f"dev-better {u['device_better_objective']} / ora-better "
          f"{u['oracle_better_objective']} / tie {u['objective_tie']}, "
          f"goal-dist p50 {u['goal_dist_p50_m']}", flush=True)
    return summary


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=300)
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--workers", type=int,
                    default=max(2, (os.cpu_count() or 2) - 1))
    ap.add_argument("--perturb-reps", type=int, default=3)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--suites", default="mpo700,mpo500,footprint,cs5,sequence")
    ap.add_argument("--sequence-n", type=int, default=50)
    ap.add_argument("--sequence-ticks", type=int, default=10)
    # Merge this run's suites into an existing report at --out: a suite
    # with the same (suite, mode, ticks) key is replaced, others kept.
    ap.add_argument("--append", action="store_true")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    out_path = pathlib.Path(args.out).resolve()
    if out_path == _REFERENCE_REPORT.resolve():
        raise SystemExit(f"{_REFERENCE_REPORT.name} is the JAX package's "
                         "record and is never written: pass another --out")
    device = resolve_device(args.device)

    suites, results = args.suites.split(","), []
    single = (args.workers, args.perturb_reps, device)
    if "mpo700" in suites:
        results.append(run_suite("mpo700", "mpo700", args.n, args.seed,
                                 *single))
    if "mpo500" in suites:
        results.append(run_suite("mpo500", "mpo500", args.n, args.seed + 99,
                                 *single))
    if "footprint" in suites:
        # The lethal-adjacent regime (footprint branch + x1000
        # discontinuities): distinct minima are expected near the cliffs,
        # so this row contextualizes rather than gates.
        results.append(run_suite("lethal_adjacent", "mpo700", args.n,
                                 args.seed + 198, *single,
                                 lethal_threshold=0.5, pose_jitter=0.7))
    if "cs5" in suites:
        # control_steps=5 over the same 0.8 s horizon (m = 15).
        results.append(run_suite("mpo700_cs5", "mpo700", args.n,
                                 args.seed + 555, *single, control_steps=5))
    if "sequence" in suites:
        results.append(run_sequence_suite(
            "mpo700_sequence", "mpo700", args.sequence_n,
            args.sequence_ticks, args.seed + 297, args.workers, device))

    report = {"cmd_tol": CMD_TOL, "obj_tie_tol": OBJ_TIE_TOL,
              "perturb": PERTURB, "perturb_reps": args.perturb_reps,
              "device": str(device), "suites": results}
    if args.append and out_path.exists():
        prev = json.loads(out_path.read_text())

        def key(s):
            return (s.get("suite"), s.get("mode"), s.get("ticks"))

        fresh = {key(s) for s in results}
        report["suites"] = ([s for s in prev.get("suites", [])
                             if key(s) not in fresh] + results)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(report, indent=1))
    print(f"wrote {out_path}")
    return report


if __name__ == "__main__":
    main()
