"""Demo: a fleet of robots runs the full FollowPath loop, sharded over the
cards of a world.

Thousands of scenarios (obstacle layouts, plans, weight grids) a control
step go through `parallel.sharding.ShardedEngine`, one process a card,
with the fleet metrics reduced over the world by NCCL. With one process
(the default) the world is that process and its card, and the demo
batches, as the JAX demo does on one chip:

    python -m neo_mpc_planner2_tpu_torch.examples.fleet_demo --batch 512 --ticks 60
    python -m neo_mpc_planner2_tpu_torch.examples.fleet_demo --batch 64 --ticks 20 --device cpu

Across cards, one process a rank, all given the same --port (the group
meets at tcp://127.0.0.1:PORT; rank r takes card r modulo the visible
cards), as `parallel/smoke.py` is launched:

    for r in 0 1; do python -m neo_mpc_planner2_tpu_torch.examples.fleet_demo \\
        --batch 512 --ticks 60 --world 2 --rank $r --port 29631 & done; wait

Rank 0 prints the fleet's lines.
"""

from __future__ import annotations

import argparse
import datetime
import time

import numpy as np

from ..utils.entrypoints import add_device_arg, free_port, resolve_device

__all__ = ["config", "run", "main"]


def config():
    """The demo's config: the library default at the sample weights, a
    0.8 s horizon, 16 samples an edge, 64 plan points, 8 SQP iterations
    and the one-hot sampler."""
    from ..config import default_config

    return default_config().replace(
        prediction_horizon=0.8, opt_tolerance=1e-3, footprint_edge_samples=16,
        max_plan_points=64, solver_max_iters=8, costmap_sampling="onehot",
        min_vel_x=-0.7, min_vel_y=-0.7, min_vel_theta=-0.7,
        max_vel_x=0.7, max_vel_y=0.7, max_vel_trans=0.7, max_vel_theta=0.7,
        w_trans=0.82, w_orient=0.5, w_control=0.05, w_terminal=0.05,
        w_costmap=0.05, w_footprint=0.0,
        lookahead_dist_min=0.4, lookahead_dist_max=0.4,
        lookahead_dist_close_to_goal=0.4,
    )


def run(batch: int = 512, ticks: int | None = 60, device="cuda",
        world: int = 1, rank: int = 0, port: int | None = None) -> dict:
    """`ticks` closed-loop ticks of `batch` robots (seed 7, 64x64 maps,
    48-point plans) over a world of `world` processes, this one rank
    `rank`. A process group that exists is used as it is; otherwise one is
    made (NCCL on the card, gloo on the CPU, at tcp://127.0.0.1:port, a
    free port when port is None and world is 1) and ended at return.
    Returns this rank's commands and poses (T, B/world, 3), the fleet
    metrics a tick (T,) each, the mesh's shape, the wall and solves/s."""
    import torch
    import torch.distributed as dist

    from ..ops.rollout import rollout
    from ..parallel.sharding import (ShardedEngine, initialize_distributed,
                                     make_mesh)
    from ..scenarios import make_scenario_batch

    ticks = 60 if ticks is None else ticks
    own_group = not dist.is_initialized()
    if own_group:
        if port is None and world > 1:
            raise ValueError("a world of several processes needs --port")
        initialize_distributed(
            device=str(torch.device(device)),
            init_method=f"tcp://127.0.0.1:{port or free_port()}",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=120))
    try:
        cfg = config()
        mesh = make_mesh()
        eng = ShardedEngine(cfg, mesh)
        dev = resolve_device(eng.device)
        sb = make_scenario_batch(cfg, batch, seed=7, map_size=64,
                                 plan_points=48, device=dev)
        state = eng.shard(sb.state)
        plan = eng.shard(sb.plan)
        rest = tuple(eng.shard(x) for x in (sb.robot_pose, sb.current_vel,
                                            sb.costmap, sb.footprint,
                                            sb.delta_t))
        poses = rest[0]
        dt = cfg.control_interval
        cmds, pose_seq, metrics = [], [], []
        t0 = time.time()
        for _ in range(ticks):
            out, m = eng.step(state, plan, poses, *rest[1:])
            state = out.state
            # Integrate each robot one control period (the omni model).
            with torch.no_grad():
                poses = rollout(out.cmd_vel[:, None, :], dt, poses)[:, 0]
            cmds.append(out.cmd_vel)
            pose_seq.append(poses)
            metrics.append(torch.stack([m.mean_cost, m.converged_frac,
                                        m.collision_frac, m.mean_cmd_speed]))
        metrics = torch.stack(metrics).cpu().numpy()
        wall = time.time() - t0
        return {"cmds": torch.stack(cmds).cpu().numpy(),
                "poses": torch.stack(pose_seq).cpu().numpy(),
                "mean_cost": metrics[:, 0], "converged_frac": metrics[:, 1],
                "collision_frac": metrics[:, 2],
                "mean_cmd_speed": metrics[:, 3],
                "mesh_shape": tuple(mesh.shape), "world": mesh.size(),
                "wall_s": wall, "solves_per_sec": batch * ticks / wall}
    finally:
        if own_group:
            dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--ticks", type=int, default=60)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--port", type=int, default=None)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    out = run(args.batch, args.ticks, args.device, args.world, args.rank,
              args.port)
    if args.rank:
        return
    print(f"mesh: {out['mesh_shape']} over {out['world']} device(s)")
    for t in range(0, args.ticks, 10):
        print(f"tick {t:3d}: mean cost {out['mean_cost'][t]:.4f} "
              f"converged {out['converged_frac'][t]:.2f} "
              f"collisions {out['collision_frac'][t]:.3f} "
              f"mean speed {out['mean_cmd_speed'][t]:.3f} m/s")
    print(f"\n{args.batch} robots × {args.ticks} ticks in "
          f"{out['wall_s']:.1f} s = {out['solves_per_sec']:.0f} solves/s")


if __name__ == "__main__":
    main()
