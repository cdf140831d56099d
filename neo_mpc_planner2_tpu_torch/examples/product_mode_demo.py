"""Demo: the PRODUCT operating point — the smooth bilinear objective and
the true predicted footprint through the batched SQP (`product_config()`),
with the fused line-search wave and the patch sampler sized for the
MPO-700 (`required_product_patch_halfwidth`). A fleet of 16 drives around
a graded obstacle field to its goals for 150 ticks; parity mode
(`fleet_config()`, reference-quirk-faithful) runs the same scenarios for
comparison.

    python -m neo_mpc_planner2_tpu_torch.examples.product_mode_demo
    python -m neo_mpc_planner2_tpu_torch.examples.product_mode_demo --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

from ..utils.entrypoints import add_device_arg, resolve_device

__all__ = ["TICKS", "N", "SAMPLE", "SCENARIO", "configs", "run", "main"]

TICKS, N = 150, 16
SAMPLE = dict(
    prediction_horizon=0.8, control_steps=3, opt_tolerance=1e-3,
    footprint_edge_samples=16, max_plan_points=64,
    acc_x_limit=2.5, acc_y_limit=2.5, acc_theta_limit=3.0,
    min_vel_x=-0.7, min_vel_y=-0.7, min_vel_theta=-0.7,
    max_vel_x=0.7, max_vel_y=0.7, max_vel_trans=0.7, max_vel_theta=0.7,
    w_trans=0.82, w_orient=0.5, w_control=0.05, w_terminal=0.05,
    w_costmap=0.05, w_footprint=2000.0,
    lookahead_dist_min=0.4, lookahead_dist_max=0.4,
    lookahead_dist_close_to_goal=0.4,
)
# make_scenario_batch's arguments for the 16 scenarios.
SCENARIO = dict(seed=11, map_size=64, plan_points=48,
                plan_length_range=(0.8, 1.1), clear_corridor_m=0.55,
                center_on="plan")


def configs():
    """(product, parity): product_config() and fleet_config() at SAMPLE,
    the product's patch sized from the 0.05 m map and the MPO-700's
    0.46 m circumradius."""
    from ..config import fleet_config, product_config
    from ..ops.costmap import required_product_patch_halfwidth

    pcfg = product_config().replace(**SAMPLE)
    pcfg = pcfg.replace(solver_costmap_patch=(
        required_product_patch_halfwidth(pcfg, 0.05, 0.46)))
    return pcfg, fleet_config().replace(**SAMPLE)


def run(ticks: int | None = None, device="cuda") -> dict:
    """Both modes on the same N scenarios for `ticks` ticks (default
    150). Returns, under "product" and "parity", each run's commands
    (N, T, 3), goal distances (N, T) and solver iterations (N, T), and
    the product config's max_vel_trans."""
    from ..scenarios import make_scenario_batch
    from ..simulation import batch_simulate

    device = resolve_device(device)
    ticks = TICKS if ticks is None else ticks
    pcfg, parity_cfg = configs()
    sb = make_scenario_batch(pcfg, N, device=device, **SCENARIO)
    runs = {"product": batch_simulate(pcfg, sb, ticks, parity=False),
            "parity": batch_simulate(parity_cfg, sb, ticks)}
    host = lambda t: t.cpu().numpy()
    return {**{name: {"cmds": host(r.cmds), "goal_dist": host(r.goal_dist),
                      "solver_iters": host(r.solver_iters)}
               for name, r in runs.items()},
            "max_vel_trans": pcfg.max_vel_trans}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arg(ap)
    out = run(device=ap.parse_args(argv).device)
    for name, key in (("product", "product"), ("parity ", "parity")):
        d = out[key]["goal_dist"][:, -1]
        it = float(np.mean(out[key]["solver_iters"].astype(np.float32)))
        print(f"{name}: {int((d < 0.10).sum())}/{len(d)} goals within "
              f"10 cm, median final dist {np.median(d)*100:.1f} cm, "
              f"mean solver iters {it:.1f}")
    # Product commands are smooth AND feasible.
    cmds = out["product"]["cmds"]
    v = np.hypot(cmds[..., 0], cmds[..., 1])
    print(f"product max ||v||: {v.max():.3f} m/s "
          f"(bound {out['max_vel_trans']})")
    assert v.max() <= out["max_vel_trans"] + 1e-3


if __name__ == "__main__":
    main()
