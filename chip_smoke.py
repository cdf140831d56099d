"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from `neo_mpc_planner2_tpu_torch/csrc/`, checks each
against its plain PyTorch version on the card, drives the fleet closed loop
(4096 lanes, 64x64 maps, control_steps=3, 20 ticks) through
`batch_simulate`, and compares one controller step on the card with the same
step on the CPU. Every phase prints a line; any failure exits non-zero. The
second-to-last line is the card's name and power limit, the last line
`{"ok": true, "device": {...}}`. Needs a CUDA device: without one it exits
non-zero and prints no result. Imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _ptxas_report(log: str) -> dict:
    """Registers, stack and spill bytes per kernel instance from nvcc's
    `-Xptxas -v` output, keyed like "qp_admm_m15"."""
    import re

    report, name = {}, None
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '\w*?(qp_admm|spd_inv)"
                        r"_kernelILi(\d+)E", line)
        if hit:
            name = f"{hit.group(1)}_m{hit.group(2)}"
            report[name] = {}
        elif name and "spill stores" in line:
            nums = [int(v) for v in re.findall(r"(\d+) bytes", line)]
            report[name].update(stack=nums[0], spill_stores=nums[1],
                                spill_loads=nums[2])
        elif name and "registers" in line:
            report[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return report


def _time_ms(fn, reps: int = 20) -> float:
    """Median of `reps` CUDA-event timings of fn(), after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _excess(got, want, rtol, atol) -> float:
    """max(|got - want| - (atol + rtol |want|)); <= 0 means within."""
    return float(((got - want).abs() - (atol + rtol * want.abs())).max())


def _qp_inputs(rng, B, m, device):
    """Random SPD QP instances with warm carries (as the JAX package's
    kernel tests make them)."""
    import numpy as np
    import torch

    n = m // 3
    A = rng.normal(size=(B, m, m)).astype(np.float32) * 0.3
    Bmat = A @ np.swapaxes(A, -1, -2) + np.eye(m, dtype=np.float32)
    g = rng.normal(size=(B, m)).astype(np.float32)
    x = rng.uniform(-0.5, 0.5, (B, m)).astype(np.float32)
    xy = x.reshape(B, n, 3)[:, :, :2]
    nrm = np.maximum(np.linalg.norm(xy, axis=-1), 1e-12)
    c = (0.7 - nrm).astype(np.float32)
    dxy = (-xy / nrm[..., None]).reshape(B, 2 * n).astype(np.float32)
    lo = np.full((B, m), -0.7, np.float32)
    hi = np.full((B, m), 0.7, np.float32)
    carry = [rng.normal(size=(B, r)).astype(np.float32) * 0.1
             for r in (m, m, n, m, n)]
    t = lambda a: torch.as_tensor(a, device=device).contiguous()
    return [t(Bmat.reshape(B, m * m)), t(g), t(x), t(c), t(dxy), t(lo),
            t(hi), *(t(a) for a in carry)]


def phase_kernels(device):
    import numpy as np
    import torch

    from neo_mpc_planner2_tpu_torch import sqp

    rng = np.random.default_rng(0)
    rtol, atol = 2e-4, 2e-5
    report = {}
    worst = 0.0
    for m in (9, 15):
        for B in (1, 131, 4096):
            for iters in (6, 60):
                args = _qp_inputs(rng, B, m, device)
                J = sqp._cone_jacobian(args[4], m)
                plain_args = args[:4] + [J] + args[5:]
                kw = dict(iters=iters, rho=1.0, sigma=1e-6)
                got = sqp.qp_admm(*args, **kw)
                want = sqp.qp_admm_plain(*plain_args, **kw)
                torch.cuda.synchronize()
                for gt, w in zip(got, want):
                    if not bool(torch.isfinite(gt).all()):
                        raise AssertionError(f"K1 m={m} B={B}: non-finite")
                    ex = _excess(gt, w, rtol, atol)
                    if ex > 0:
                        raise AssertionError(
                            f"K1 m={m} B={B} iters={iters}: off its plain "
                            f"version by {ex:.3g} past rtol/atol")
                    worst = max(worst, float((gt - w).abs().max()))
                if B == 4096 and iters == 60:
                    report[f"qp_admm_m{m}_ms"] = _time_ms(
                        lambda: sqp.qp_admm(*args, **kw))
                    report[f"qp_admm_plain_m{m}_ms"] = _time_ms(
                        lambda: sqp.qp_admm_plain(*plain_args, **kw))
    report["qp_admm_max_abs_err"] = worst
    print(json.dumps({"phase": "K1 qp_admm vs plain", "rtol": rtol,
                      "atol": atol, **report}), flush=True)

    inv = {}
    worst_inv, worst_res = 0.0, 0.0
    for m in (6, 9, 15):
        for B in (1, 131, 4096):
            A = rng.normal(size=(B, m, m)).astype(np.float32) * 0.3
            M = torch.as_tensor(A @ np.swapaxes(A, -1, -2)
                                + np.eye(m, dtype=np.float32), device=device)
            got = sqp.chol_inverse(M)
            want = sqp.chol_inverse_plain(M)
            torch.cuda.synchronize()
            ex = _excess(got, want, rtol, atol)
            if ex > 0 or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"K2 m={m} B={B}: off its plain "
                                     f"version by {ex:.3g} past rtol/atol")
            res = float((M @ got - torch.eye(m, device=device)).abs().max())
            if res > 1e-3:
                raise AssertionError(f"K2 m={m} B={B}: |MX - I| = {res:.3g}")
            worst_inv = max(worst_inv, float((got - want).abs().max()))
            worst_res = max(worst_res, res)
            if B == 4096:
                inv[f"spd_inv_m{m}_ms"] = _time_ms(
                    lambda: sqp.chol_inverse(M))
                inv[f"spd_inv_plain_m{m}_ms"] = _time_ms(
                    lambda: sqp.chol_inverse_plain(M))
    inv["spd_inv_max_abs_err"] = worst_inv
    inv["spd_inv_max_residual"] = worst_res
    print(json.dumps({"phase": "K2 spd_inv vs plain", "rtol": rtol,
                      "atol": atol, "launches": sqp.chol_inverse.launches,
                      **inv}), flush=True)
    return report, inv


def fleet_cfg():
    """fleet_config() with the fleet benchmark's overrides (bench.py)."""
    import neo_mpc_planner2_tpu_torch as tp

    return tp.fleet_config().replace(
        prediction_horizon=0.8, control_steps=3, opt_tolerance=1e-3,
        footprint_edge_samples=16, max_plan_points=64,
        solver_compact_adaptive=False,
        min_vel_x=-0.7, min_vel_y=-0.7, min_vel_theta=-0.7,
        max_vel_x=0.7, max_vel_y=0.7, max_vel_trans=0.7, max_vel_theta=0.7,
        w_trans=0.82, w_orient=0.5, w_control=0.05, w_terminal=0.05,
        w_costmap=0.05, w_footprint=2000.0, costmap_sampling="onehot",
        solver_costmap_u8=False,
        lookahead_dist_min=0.4, lookahead_dist_max=0.4,
        lookahead_dist_close_to_goal=0.4)


def phase_slice(device, smi: str, batch: int = 4096, ticks: int = 20):
    import torch

    from neo_mpc_planner2_tpu_torch import sqp
    from neo_mpc_planner2_tpu_torch.scenarios import make_scenario_batch
    from neo_mpc_planner2_tpu_torch.simulation import batch_simulate

    cfg = fleet_cfg()
    sb = make_scenario_batch(cfg, batch, seed=0, map_size=64,
                             plan_points=64, device=device)
    batch_simulate(cfg, sb, ticks)             # warm-up
    torch.cuda.synchronize()
    sqp.qp_admm.launches = 0
    sqp.chol_inverse.launches = 0
    t0 = time.perf_counter()
    res = batch_simulate(cfg, sb, ticks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"qp_admm": sqp.qp_admm.launches,
                "spd_inv": sqp.chol_inverse.launches}

    cmds = res.cmds
    if not bool(torch.isfinite(cmds).all()):
        raise AssertionError("slice: non-finite commands")
    speed = torch.linalg.vector_norm(cmds[..., :2], dim=-1)
    if float(speed.max()) > cfg.max_vel_trans + 1e-5:
        raise AssertionError(f"slice: |cmd_xy| {float(speed.max())} above "
                             f"max_vel_trans {cfg.max_vel_trans}")
    if launches["qp_admm"] <= 0:
        raise AssertionError("slice: the QP kernel was never launched")
    out = {"phase": "fleet slice", "batch": batch, "ticks": ticks,
           "map": 64, "control_steps": cfg.control_steps,
           "wall_s": wall, "solves_per_s": batch * ticks / wall,
           "launches": launches,
           "goal_reached_frac": float((res.goal_dist[:, -1] < 0.10)
                                      .float().mean()),
           "final_dist_p50": float(res.goal_dist[:, -1].median()),
           "converged_frac": float(res.converged.float().mean()),
           "mean_sqp_iters": float(res.solver_iters.float().mean()),
           "card": smi}
    print(json.dumps(out), flush=True)
    return out


def phase_card_vs_cpu(device):
    import torch

    from neo_mpc_planner2_tpu_torch.engine import make_batched_controller_step
    from neo_mpc_planner2_tpu_torch.scenarios import make_scenario_batch
    from neo_mpc_planner2_tpu_torch.tree import tree_map

    cfg = fleet_cfg()
    sb = make_scenario_batch(cfg, 256, seed=1, map_size=64, plan_points=64)
    step = make_batched_controller_step(cfg)
    args = (sb.state, sb.plan, sb.robot_pose, sb.current_vel, sb.costmap,
            sb.footprint, sb.delta_t)
    cpu = step(*args).cmd_vel
    gpu = step(*tree_map(lambda t: t.to(device), args)).cmd_vel.cpu()
    diff = (gpu - cpu).abs().amax(-1)
    frac = float((diff <= 1e-3).float().mean())
    out = {"phase": "card vs cpu, one step", "lanes": 256,
           "max_cmd_diff": float(diff.max()), "frac_within_1e-3": frac}
    print(json.dumps(out), flush=True)
    if frac < 0.99:
        raise AssertionError(f"card vs CPU: only {frac:.4f} of lanes within "
                             "1e-3")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing runs on the CPU",
              file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(json.dumps({"phase": "device", "name": name, "nvidia_smi": smi,
                      "torch": torch.__version__, "cuda": torch.version.cuda}),
          flush=True)

    from neo_mpc_planner2_tpu_torch.kernels import build

    build.build_library()
    print(json.dumps({"phase": "build", "built": build.last_build["built"],
                      "seconds": build.last_build["seconds"],
                      "ptxas": _ptxas_report(build.last_build["log"])}),
          flush=True)

    k1, _ = phase_kernels(device)
    sl = phase_slice(device, smi)
    phase_card_vs_cpu(device)

    kernels = [{
        "name": "qp_admm", "route": "cuda",
        "source": "neo_mpc_planner2_tpu_torch/csrc/qp_admm.cu",
        "replaces": "neo_mpc_planner2_tpu/sqp.py:318",
        "launches": sl["launches"]["qp_admm"],
        "max_abs_err": k1["qp_admm_max_abs_err"],
        "ms": k1["qp_admm_m9_ms"], "plain_ms": k1["qp_admm_plain_m9_ms"]}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(_nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
