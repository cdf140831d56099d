"""Old against new K1 and K3 on one GPU, in turns, and K3's launch shapes.

    git show <commit>:neo_mpc_planner2_tpu_torch/csrc/qp_admm.cu \
        > build/old_kernels/qp_admm.cu        # and spd_inverse.cuh,
                                              # footprint_cost.cu
    python3 scripts/torch_kernel_turns.py --old build/old_kernels

Builds the earlier design's sources from `--old` (one thread a lane, K1's
operands lane-minor behind 18 transposes; K3 one warp a polygon, 8 to a
block) into their own library beside the port's, and binds them with the
earlier C signatures. Captures the arguments of K3's calls in the product
slice (4096 lanes, a 2-tick run), then, for each turn of `--turns`
(default old,new,new,old) on the same card:

- K1's device time at m = 9 and m = 15, B = 4096, 60 iterations, and the
  CUDA launches of one `sqp.qp_admm` call;
- K3's device time on each captured call (gate R = 1, gradient R = 3, wave
  R = 21), held exactly equal between the two designs;
- both slices' solves/s (4096 lanes x 20 ticks after a warm-up) and their
  CUDA launches a tick (torch.profiler).

The old design is swapped in by replacing `sqp.qp_admm` and
`binding.launch_footprint_cost`, which the port looks up at every call; the
launch counters keep counting. `--shapes` times K3 on the captured calls at
each (lanes_per_block, warps_per_lane) instead. Prints one JSON line per
measurement and the card's name and power limit. Needs one CUDA device;
imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def load_old(old_dir: pathlib.Path):
    """Build and load the earlier sources with their C signatures."""
    from neo_mpc_planner2_tpu_torch.kernels import build

    path = build.build_library(
        csrc=old_dir, build_dir=ROOT / "build" / "old_kernels_lib",
        sources=("qp_admm.cu", "footprint_cost.cu"),
        headers=("spd_inverse.cuh",))
    lib = ctypes.CDLL(str(path))
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.neo_qp_admm_f32.argtypes = [i, i, i, f, f, f, vp, vp, vp]
    lib.neo_qp_admm_f32.restype = i
    lib.neo_footprint_cost_f32.argtypes = [i] * 6 + [vp] * 9
    lib.neo_footprint_cost_f32.restype = i
    print(json.dumps({"phase": "old build", "seconds":
                      build.last_build["seconds"],
                      "ptxas": cs._ptxas_report(build.last_build["log"])}),
          flush=True)
    return lib


def old_wrappers(lib):
    """The earlier qp_admm wrapper (lane-minor operands: 12 transposes in,
    6 out, and rho * wc) and K3 launcher, over the old library."""
    import torch

    from neo_mpc_planner2_tpu_torch import sqp

    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))
    stream = lambda dev: torch.cuda.current_stream(dev).cuda_stream

    def qp_admm(Bflat, g, x, c, dxy, lo, hi, d0, zb0, zc0, wb0, wc0, *,
                iters, rho=1.0, sigma=1e-6):
        args = (Bflat, g, x, c, dxy, lo, hi, d0, zb0, zc0, wb0, wc0)
        B, m = x.shape
        n = m // 3
        ins = [a.t().contiguous() for a in args]
        outs = [torch.empty((r, B), dtype=torch.float32, device=x.device)
                for r in (m, m, m, n, m, n)]
        rc = lib.neo_qp_admm_f32(m, B, int(iters), float(rho), float(sigma),
                                 float(sigma + rho), ptrs(ins), ptrs(outs),
                                 stream(x.device))
        if rc:
            raise RuntimeError(f"old qp_admm launch failed: cudaError {rc}")
        sqp.qp_admm.launches += 1
        d_out, d, zb, zc, wb, wc = (o.t().contiguous() for o in outs)
        return d_out, rho * wc, d, zb, zc, wb, wc

    qp_admm.launches = 0

    def launch_footprint_cost(data, origin, res, bounds, verts, n_valid, t,
                              shape=None):
        Bm, H, W = data.shape
        R, V = verts.shape[1], verts.shape[2]
        out = torch.empty((Bm, R), dtype=torch.float32, device=data.device)
        rc = lib.neo_footprint_cost_f32(
            Bm, R, H, W, V, t.shape[0], data.data_ptr(), origin.data_ptr(),
            res.data_ptr(), None if bounds is None else bounds.data_ptr(),
            verts.data_ptr(), n_valid.data_ptr(), t.data_ptr(),
            out.data_ptr(), stream(data.device))
        if rc:
            raise RuntimeError(f"old footprint_cost launch failed: {rc}")
        return out

    return qp_admm, launch_footprint_cost


class Design:
    """Swaps the old K1 wrapper and K3 launcher in and out."""

    def __init__(self, old):
        from neo_mpc_planner2_tpu_torch import sqp
        from neo_mpc_planner2_tpu_torch.kernels import binding

        self.sqp, self.binding = sqp, binding
        self.new = (sqp.qp_admm, binding.launch_footprint_cost)
        self.old = old

    def use(self, which: str):
        qp, k3 = self.new if which == "new" else self.old
        self.sqp.qp_admm = qp
        self.binding.launch_footprint_cost = k3


def capture(device, batch: int):
    """K3's calls in the first two ticks of the product slice."""
    from neo_mpc_planner2_tpu_torch.scenarios import make_scenario_batch
    from neo_mpc_planner2_tpu_torch.simulation import batch_simulate

    cfg = cs.product_cfg()
    sb = make_scenario_batch(cfg, batch, seed=0, map_size=64, plan_points=64,
                             device=device)
    with cs.K3Recorder() as rec:
        batch_simulate(cfg, sb, 2, parity=False)
    return cs.captured_k3_cases(rec)


def slice_run(device, cfg, parity: bool, batch: int, ticks: int) -> dict:
    import torch

    from neo_mpc_planner2_tpu_torch.scenarios import make_scenario_batch
    from neo_mpc_planner2_tpu_torch.simulation import batch_simulate

    sb = make_scenario_batch(cfg, batch, seed=0, map_size=64, plan_points=64,
                             device=device)
    batch_simulate(cfg, sb, ticks, parity=parity)           # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = batch_simulate(cfg, sb, ticks, parity=parity)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = cs.count_launches(lambda: batch_simulate(cfg, sb, ticks,
                                                 parity=parity))
    return {"solves_per_s": batch * ticks / wall,
            "cuda_launches_per_tick": n["launches"] / ticks,
            "cmds": res.cmds}


def kernel_turn(which: str, design: Design, device, cases: dict,
                ref: dict) -> dict:
    import numpy as np
    import torch

    from neo_mpc_planner2_tpu_torch.ops import footprint as fpm

    design.use(which)
    out = {"turn": which}
    rng = np.random.default_rng(0)
    for m in (9, 15):
        args = cs._qp_inputs(rng, 4096, m, device)
        call = lambda: design.sqp.qp_admm(*args, iters=60, rho=1.0,
                                          sigma=1e-6)
        got = call()
        key = f"qp_m{m}"
        if key in ref:
            err = max(float((g - w).abs().max())
                      for g, w in zip(got, ref[key]))
            out[f"qp_admm_m{m}_max_diff_vs_first_turn"] = err
        else:
            ref[key] = got
        out[f"qp_admm_m{m}_ms"] = cs._device_ms(call, "qp_admm_kernel")
        out[f"qp_admm_m{m}_launches_per_call"] = cs.count_launches(call)
    for label, args in cases.items():
        got = fpm.footprint_cost_batch(*args)
        if label in ref and not torch.equal(got, ref[label]):
            raise AssertionError(f"K3 {label}: the designs differ")
        ref.setdefault(label, got)
        out[f"footprint_cost_{label}_ms"] = cs._device_ms(
            lambda: fpm.footprint_cost_batch(*args), "footprint_cost_kernel")
    print(json.dumps(out), flush=True)
    return out


def slice_turn(which: str, design: Design, device, batch: int, ticks: int,
               ref: dict) -> dict:
    design.use(which)
    out = {"turn": which}
    for name, cfg, parity in (("fleet", cs.fleet_cfg(), True),
                              ("product", cs.product_cfg(), False)):
        run = slice_run(device, cfg, parity, batch, ticks)
        cmds = run.pop("cmds")
        key = f"{name}_cmds"
        if key in ref:
            run["max_cmd_diff_vs_first_turn"] = float(
                (cmds - ref[key]).abs().max())
        else:
            ref[key] = cmds
        out.update({f"{name}_{k}": v for k, v in run.items()})
    print(json.dumps(out), flush=True)
    return out


def shapes(cases: dict):
    """K3's device time on each captured call at each launch shape."""
    import torch

    from neo_mpc_planner2_tpu_torch.kernels import binding
    from neo_mpc_planner2_tpu_torch.ops import footprint as fpm

    for label, args in cases.items():
        R = args[4].shape[1]
        want = fpm.footprint_cost_batch_plain(*args)
        out = {"case": label, "default": list(binding.k3_launch_shape(R))}
        for lanes in (1, 2, 4, 8, 16):
            for warps in sorted({1, 2, 3, 4, 7, 8}):
                if warps > R or lanes * warps > 32:
                    continue
                f = lambda: binding.launch_footprint_cost(
                    *args, shape=(lanes, warps))
                got = f()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"K3 {label} at {lanes, warps}")
                out[f"{lanes}x{warps}"] = cs._device_ms(
                    f, "footprint_cost_kernel")
        print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=pathlib.Path,
                    help="directory with the earlier qp_admm.cu, "
                         "spd_inverse.cuh and footprint_cost.cu")
    ap.add_argument("--turns", default="old,new,new,old")
    ap.add_argument("--shapes", action="store_true",
                    help="time K3's launch shapes instead of the turns")
    ap.add_argument("--kernels-only", action="store_true",
                    help="skip the slices' turns")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--ticks", type=int, default=cs.SLICE_TICKS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    smi = cs._nvidia_smi()
    print(json.dumps({"phase": "device", "nvidia_smi": smi,
                      "torch": torch.__version__}), flush=True)
    cases = capture(device, args.batch)
    if args.shapes:
        shapes(cases)
    else:
        if args.old is None:
            ap.error("--old is required for the turns")
        design = Design(old_wrappers(load_old(args.old)))
        ref = {}
        order = args.turns.split(",")
        # The kernels' short traces first: after the slices' long traces
        # the profiler may drop records of short ones.
        rows = [kernel_turn(w, design, device, cases, ref) for w in order]
        slices = [] if args.kernels_only else [
            slice_turn(w, design, device, args.batch, args.ticks, ref)
            for w in order]
        design.use("new")
        summary = {}
        for table in filter(None, (rows, slices)):
            keys = [k for k in table[0] if isinstance(table[0][k], float)
                    and "diff" not in k]
            for w in ("old", "new"):
                summary.setdefault(w, {}).update(
                    {k: [r[k] for r in table if r["turn"] == w]
                     for k in keys})
        print(json.dumps({"phase": "summary", **summary}), flush=True)
    print(cs._nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
