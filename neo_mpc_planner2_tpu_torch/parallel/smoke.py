"""Multi-process smoke run of the sharded engine: W processes, one a rank,
step one sharded fleet twice and reduce the fleet metrics over the world.

    python -m neo_mpc_planner2_tpu_torch.parallel.smoke RANK WORLD PORT OUT \\
        [--device cpu|cuda] [--batch 8] [--steps 2] [--checkpoint DIR]

Start it once for each rank 0..WORLD-1 with the same PORT (the group meets
at tcp://127.0.0.1:PORT). Every rank builds the same scenario batch from
seed 0 (48x48 maps, 24-point plans), steps its shard with ShardedEngine
(each process its own host row of the mesh) and prints one line a step
with the metrics' exact float values, then `[rank R] OK`. OUT is an .npz
the rank writes its lanes' commands, iterations and metrics into.

With --checkpoint DIR, every rank saves its shard of the state after the
first step into the directory DIR (one collective save,
`checkpoint.save_state(..., mesh=)`), loads its shard back from DIR into a
fresh state (equal to the saved one) and takes the second step from it:
OUT then also holds the loaded state's fields (`ckpt_<field>`), the
resumed step's commands (`resumed_cmd_vel1`, to equal `cmd_vel1`) and the
save and load walls in seconds (`ckpt_save_s`, `ckpt_load_s`).
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import sys
import time

import numpy as np


def smoke_config():
    """A small config (the JAX package's multi-host smoke's)."""
    from neo_mpc_planner2_tpu_torch.config import default_config

    return default_config().replace(
        prediction_horizon=0.8, opt_tolerance=1e-3, footprint_edge_samples=8,
        max_plan_points=32, solver_max_iters=25,
        min_vel_x=-0.7, min_vel_y=-0.7, min_vel_theta=-0.7,
        max_vel_x=0.7, max_vel_y=0.7, max_vel_trans=0.7, max_vel_theta=0.7,
        w_trans=0.82, w_orient=0.5, w_control=0.05, w_terminal=0.05,
        w_costmap=0.05, w_footprint=0.0,
        lookahead_dist_min=0.4, lookahead_dist_max=0.4,
        lookahead_dist_close_to_goal=0.4)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("out")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--checkpoint", default=None, metavar="DIR")
    a = ap.parse_args(argv)
    if a.checkpoint is not None and a.steps < 2:
        ap.error("--checkpoint resumes the second step: --steps >= 2")

    import torch.distributed as dist

    from neo_mpc_planner2_tpu_torch.parallel.sharding import (
        ShardedEngine, initialize_distributed, make_mesh)
    from neo_mpc_planner2_tpu_torch.scenarios import make_scenario_batch

    initialize_distributed(device=a.device,
                           init_method=f"tcp://127.0.0.1:{a.port}",
                           world_size=a.world, rank=a.rank,
                           timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(hosts=a.world)
        cfg = smoke_config()
        eng = ShardedEngine(cfg, mesh)
        dev = "cpu" if eng.device.type == "cpu" else eng.device
        sb = make_scenario_batch(cfg, a.batch, seed=0, map_size=48,
                                 plan_points=24, device=dev)
        args = eng.shard((sb.plan, sb.robot_pose, sb.current_vel,
                          sb.costmap, sb.footprint, sb.delta_t))
        state = eng.init_state(a.batch)
        rec = {}
        for s in range(a.steps):
            if s == 1 and a.checkpoint is not None:
                rec.update(_resume(a.checkpoint, eng, state, args, mesh,
                                   a.batch))
            out, metrics = eng.step(state, *args)
            state = out.state
            vals = {k: float(v) for k, v in metrics._asdict().items()}
            print(f"[rank {a.rank}] mesh={tuple(mesh.shape)} step{s} "
                  + " ".join(f"{k}={v!r}" for k, v in vals.items()),
                  flush=True)
            rec[f"cmd_vel{s}"] = out.cmd_vel.cpu().numpy()
            rec[f"iters{s}"] = out.solver_iters.cpu().numpy()
            rec[f"metrics{s}"] = np.array(list(vals.values()))
            if not np.isfinite(rec[f"cmd_vel{s}"]).all():
                raise AssertionError("non-finite commands")
        np.savez(a.out, rank=a.rank, world=a.world, **rec)
        print(f"[rank {a.rank}] OK", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def _resume(path, eng, state, args, mesh, batch) -> dict:
    """Save `state` collectively to `path`, load this rank's shard back
    into a fresh state (equal to `state`, or AssertionError) and step it:
    the loaded fields, the resumed step's commands and the save and load
    walls, for the rank's OUT."""
    import torch
    # Its import (about a second) is not the save's.
    import torch.distributed.checkpoint  # noqa: F401

    from neo_mpc_planner2_tpu_torch import checkpoint

    def wall(fn):
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        t0 = time.perf_counter()
        res = fn()
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        return res, time.perf_counter() - t0

    _, save_s = wall(lambda: checkpoint.save_state(path, state, mesh=mesh))
    loaded, load_s = wall(lambda: checkpoint.load_state(
        path, template=eng.init_state(batch), mesh=mesh))
    for f in dataclasses.fields(loaded):
        if not torch.equal(getattr(loaded, f.name), getattr(state, f.name)):
            raise AssertionError(f"checkpoint field {f.name} loads unequal "
                                 "to the saved shard")
    out, _ = eng.step(loaded, *args)
    rec = {f"ckpt_{f.name}": getattr(loaded, f.name).cpu().numpy()
           for f in dataclasses.fields(loaded)}
    return dict(rec, resumed_cmd_vel1=out.cmd_vel.cpu().numpy(),
                ckpt_save_s=save_s, ckpt_load_s=load_s)


if __name__ == "__main__":
    sys.exit(main())
