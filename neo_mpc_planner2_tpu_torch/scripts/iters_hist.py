"""Per-tick SQP iteration-count distribution at an operating point.

Answers "when does the alive set collapse?" for lockstep-depth levers
(adaptive compaction): a lane with iters=k was alive through full-batch
iterations 1..k, so frac(iters > k) is the alive fraction entering
iteration k+1. Closed loop on the card (`simulation.batch_simulate`),
warm ticks only (tick 0 is cold). --regime picks the map: the static
fleet (the JAX script's one regime) or six moving obstacles re-synthesized
every tick (the bench's dynamic row, `bench.obstacles("dynamic", ...)`).

    python -m neo_mpc_planner2_tpu_torch.scripts.iters_hist --max-iters 8
    python -m neo_mpc_planner2_tpu_torch.scripts.iters_hist --regime dynamic
"""

from __future__ import annotations

import argparse

import numpy as np

from ..utils.entrypoints import add_device_arg, resolve_device

__all__ = ["config", "histogram", "run", "main"]


def config(max_iters: int = 8):
    """fleet_config() at the JAX script's operating point: the sample
    weights with the live footprint weight, the one-hot sampler, the f32
    map and no adaptive compaction."""
    from ..config import fleet_config

    return fleet_config().replace(
        prediction_horizon=0.8, control_steps=3, opt_tolerance=1e-3,
        footprint_edge_samples=16, max_plan_points=64,
        solver_max_iters=max_iters, solver_compact_adaptive=False,
        min_vel_x=-0.7, min_vel_y=-0.7, min_vel_theta=-0.7,
        max_vel_x=0.7, max_vel_y=0.7, max_vel_trans=0.7, max_vel_theta=0.7,
        w_trans=0.82, w_orient=0.5, w_control=0.05, w_terminal=0.05,
        w_costmap=0.05, w_footprint=2000.0, costmap_sampling="onehot",
        solver_costmap_u8=False,
        lookahead_dist_min=0.4, lookahead_dist_max=0.4,
        lookahead_dist_close_to_goal=0.4)


def histogram(iters: np.ndarray, max_iters: int) -> dict:
    """The warm solves of `iters` (B, T) (tick 0 dropped): their count,
    mean and max iterations, and for k = 0..max_iters the fraction of
    them with more than k iterations (the alive fraction entering
    iteration k + 1)."""
    warm = iters[:, 1:]
    return {"warm_solves": warm.shape[0] * warm.shape[1],
            "mean_iters": warm.mean(), "max_iters": warm.max(),
            "alive": [(warm > k).mean() for k in range(max_iters + 1)]}


def run(batch: int = 4096, ticks: int = 20, map_size: int = 64,
        max_iters: int = 8, regime: str = "static", device="cuda") -> dict:
    """The closed loop's solver iterations (B, T) as numpy and their
    histogram."""
    from ..bench import obstacles
    from ..scenarios import make_scenario_batch
    from ..simulation import batch_simulate

    if regime not in ("static", "dynamic"):
        raise ValueError(f"regime must be 'static' or 'dynamic': {regime!r}")
    device = resolve_device(device)
    cfg = config(max_iters)
    sb = make_scenario_batch(cfg, batch, seed=0, map_size=map_size,
                             plan_points=64, maps_on_device=True,
                             device=device)
    kw = ({} if regime == "static" else
          {"dynamic_obstacles": obstacles("dynamic", batch, map_size,
                                          device)})
    iters = batch_simulate(cfg, sb, ticks, **kw).solver_iters.cpu().numpy()
    return {"iters": iters, **histogram(iters, max_iters)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--map-size", type=int, default=64)
    ap.add_argument("--max-iters", type=int, default=8)
    ap.add_argument("--regime", default="static",
                    choices=["static", "dynamic"])
    add_device_arg(ap)
    args = ap.parse_args(argv)
    out = run(args.batch, args.ticks, args.map_size, args.max_iters,
              args.regime, args.device)
    print(f"warm solves: {out['warm_solves']}  mean iters "
          f"{out['mean_iters']:.2f}  max {out['max_iters']}")
    for k, alive in enumerate(out["alive"]):
        print(f"alive entering iter {k + 1:>2}: {alive:8.4f} "
              f"({alive * args.batch:7.0f} lanes of {args.batch})")


if __name__ == "__main__":
    main()
