"""Old against new K1 and K2 on one GPU, in turns, and the launch shapes of
K2 and K3.

    mkdir -p build/old_kernels
    for f in qp_admm.cu spd_inv.cu spd_inverse.cuh; do
        git show <commit>:neo_mpc_planner2_tpu_torch/csrc/$f \
            > build/old_kernels/$f
    done
    python3 scripts/torch_kernel_turns.py --old build/old_kernels

`--old` builds the earlier sources (those of a commit from before the
runtime-m redesign: a C interface with no launch-shape argument for K1 and
one, warps a block, for K2) into their own library beside the port's and
binds them. Then, for each turn of `--turns` (default old,new,new,old) on
the same card:

- K2 at B = 4096 and each m of K2_TURN_M (the unrolled m = 9, the runtime-m
  widths 4, 24, 36 and the cap 240): the kernel's device time, one
  `torch.linalg.inv` call's and the bound, the inverses held against the
  plain version (rtol 2e-4 / atol 2e-5), each timed call on the next of
  copies of M that together exceed twice the L2;
- K1 at B = 4096, 60 iterations, each m of K1_TURN_M: its device time and
  bound, its outputs held against the plain version and, at the widths
  both builds serve with the same warp-team instance (m <= 18), bit for bit
  against the first turn's.

`--k3-old DIR` builds an earlier `footprint_cost.cu` from DIR (e.g.
`git show <commit>:neo_mpc_planner2_tpu_torch/csrc/footprint_cost.cu`)
and holds the port's K3 bit for bit against it at the shapes the earlier
kernel took (B in {1, 131, 4096}, R in {1, 3, 21}, S in {8, 16, 32, 64},
the whole grid, patch bounds and a view; the walk at the same B and R)
and on the product slice's captured calls, whose device times it takes
in turns (old, new, new, old).
`--shapes` times K3 on the arguments of its calls in the product slice
(4096 lanes, a 2-tick run) at each (lanes_per_block, warps_per_lane);
`--k2-shapes` times K2 at each of its widths (warps a block), each held
against the plain version first. `--runtime-shapes` times the runtime-m
designs' launch shapes at B = 4096 around the boundaries that
`kernels/binding.py` sets (RUNTIME_K2_SHAPES, RUNTIME_K1_WARPS): K2 a
warp a matrix against a block a matrix and the warps of a block, K1 the
warp team against the warp lane, the warp lane against the block lane and
the block lane's warps; each held against the plain version, and K2's
shapes bit for bit against each other. Prints one JSON line per measurement and
the card's name and power limit. Needs one CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

K2_SIZES = (4096, 65536)
K2_M = (6, 9, 15)
# The turns' widths: K2 at B = 4096 (unrolled at 9, runtime-m otherwise),
# K1 at B = 4096 and 60 iterations (the warp team at 9 and 18 in both
# builds; 21-30 the warp team before, the warp lane now; 36 and the cap).
K2_TURN_M = (4, 9, 24, 36, 240)
K1_TURN_M = (9, 18, 21, 24, 27, 30, 36, 237)


def load_old(old_dir: pathlib.Path):
    """Build and load the earlier K1 and K2 sources, with the C interface
    they had before the runtime-m redesign: neo_qp_admm_f32(m, B, iters,
    rho, sigma, sigma + rho, 12 operands, 7 outputs, stream) and
    neo_spd_inv_f32(m, B, warps_per_block, A, X, stream)."""
    from neo_mpc_planner2_tpu_torch.kernels import build

    path = build.build_library(
        csrc=old_dir, build_dir=ROOT / "build" / "old_kernels_lib",
        sources=("qp_admm.cu", "spd_inv.cu"), headers=("spd_inverse.cuh",))
    lib = ctypes.CDLL(str(path))
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.neo_qp_admm_f32.restype = i
    lib.neo_qp_admm_f32.argtypes = [i, i, i, f, f, f] + [vp] * 20
    lib.neo_spd_inv_f32.restype = i
    lib.neo_spd_inv_f32.argtypes = [i, i, i, vp, vp, vp]
    print(json.dumps({"phase": "old build", "seconds":
                      build.last_build["seconds"],
                      "ptxas": cs._ptxas_report(build.last_build["log"])}),
          flush=True)
    return lib


def old_wrappers(lib):
    """The earlier chol_inverse (batch-major, the unrolled design's warps a
    block from binding.k2_launch_shape, which the earlier runtime-m kernel
    ignored) and qp_admm, over the old library."""
    import torch

    from neo_mpc_planner2_tpu_torch.kernels import binding

    stream = lambda dev: torch.cuda.current_stream(dev).cuda_stream

    def chol_inverse(M):
        X = torch.empty_like(M)
        rc = lib.neo_spd_inv_f32(M.shape[-1], M.shape[0],
                                 binding.k2_launch_shape(M.shape[0],
                                                         M.device),
                                 M.data_ptr(), X.data_ptr(), stream(M.device))
        if rc:
            raise RuntimeError(f"old spd_inv launch failed: cudaError {rc}")
        return X

    def qp_admm(*args, iters, rho=1.0, sigma=1e-6):
        B, m = args[2].shape
        rows = binding.qp_rows(m)
        outs = [torch.empty((B, rows[n]), dtype=torch.float32,
                            device=args[0].device) for n in binding.QP_OUTPUTS]
        rc = lib.neo_qp_admm_f32(m, B, int(iters), float(rho), float(sigma),
                                 float(sigma + rho),
                                 *(t.data_ptr() for t in args),
                                 *(t.data_ptr() for t in outs),
                                 stream(args[0].device))
        if rc:
            raise RuntimeError(f"old qp_admm launch failed: cudaError {rc}")
        d_out, d, zb, zc, wb, wc, y_cone = outs
        return d_out, y_cone, d, zb, zc, wb, wc

    return {"chol_inverse": chol_inverse, "qp_admm": qp_admm}


def spd_batch(rng, B: int, m: int, device):
    import numpy as np
    import torch

    A = rng.normal(size=(B, m, m)).astype(np.float32) * 0.3
    return torch.as_tensor(A @ np.swapaxes(A, -1, -2)
                           + np.eye(m, dtype=np.float32), device=device)


def spd_ring(M) -> list:
    """M and copies of it, as many as chip_smoke.l2_copies asks for a call
    that reads and writes M's bytes."""
    n = cs.l2_copies(M.device, 2 * M.numel() * 4)
    return [M] + [M.clone() for _ in range(n - 1)]


def kernel_turn(which: str, fns: dict, device, ref: dict) -> dict:
    """One turn. K2's timed calls rotate over copies of their operands that
    together exceed twice the L2 (chip_smoke.rotating): every launch reads
    its input from, and writes its output to, memory the card's L2 does not
    hold. From chip_smoke.EVENTS_FROM_M on a call takes over 1 ms and is
    timed between CUDA events (chip_smoke._kernel_ms)."""
    import numpy as np
    import torch

    from neo_mpc_planner2_tpu_torch import sqp
    from neo_mpc_planner2_tpu_torch.kernels import binding, bounds

    out = {"turn": which}
    rng = np.random.default_rng(0)
    for m in K2_TURN_M:
        ring = spd_ring(spd_batch(rng, 4096, m, device))
        call = cs.rotating(fns["chol_inverse"], ring)
        key = f"spd_inv_m{m}"
        if key not in ref:
            ref[key] = sqp.chol_inverse_plain(ring[0][:256])
        got = fns["chol_inverse"](ring[0])
        torch.cuda.synchronize()
        ex = cs._excess(got[:256], ref[key], 2e-4, 2e-5)
        if ex > 0:
            raise AssertionError(f"K2 m={m}: the {which} design is off its "
                                 f"plain version by {ex:.3g}")
        out[f"{key}_max_abs_err"] = float((got[:256] - ref[key]).abs().max())
        out[f"{key}_ms"] = cs._kernel_ms(call, "spd_inv_kernel", m)
        library = cs.rotating(torch.linalg.inv, ring)
        out[f"{key}_library_ms"] = (cs._time_ms(library, cs._reps(m))
                                    if m >= cs.EVENTS_FROM_M
                                    else cs._device_total_ms(library))
        out[f"{key}_bound_ms"] = bounds.spd_inv_work(4096, m)["bound_ms"]
        del ring, call, library
    for m in K1_TURN_M:
        args = cs._qp_inputs(rng, 4096, m, device)
        kw = dict(iters=60, rho=1.0, sigma=1e-6)
        call = lambda: fns["qp_admm"](*args, **kw)
        got = call()
        key = f"qp_admm_m{m}"
        if key not in ref:
            J = sqp._cone_jacobian(args[4][:256], m)
            ref[key] = sqp.qp_admm_plain(*(a[:256] for a in args[:4]), J,
                                         *(a[:256] for a in args[5:]), **kw)
            ref[key + "_first"] = got
        torch.cuda.synchronize()
        ex = max(cs._excess(g[:256], w, 2e-4, 2e-5)
                 for g, w in zip(got, ref[key]))
        if ex > 0:
            raise AssertionError(f"K1 m={m}: the {which} design is off its "
                                 f"plain version by {ex:.3g}")
        if m <= binding.K1_WARP_TEAM_MAX_M:
            same = all(torch.equal(g, w)
                       for g, w in zip(got, ref[key + "_first"]))
            if not same:
                raise AssertionError(f"K1 m={m}: the {which} design's "
                                     "outputs differ from the first turn's")
            out[f"{key}_bit_identical_to_first_turn"] = same
        else:
            out[f"{key}_max_diff_vs_first_turn"] = max(
                float((g - w).abs().max())
                for g, w in zip(got, ref[key + "_first"]))
        out[f"{key}_ms"] = cs._kernel_ms(call, "qp_admm_kernel", m)
        out[f"{key}_bound_ms"] = bounds.qp_admm_work(4096, m, 60)["bound_ms"]
    print(json.dumps(out), flush=True)
    return out


def k3_shapes(device, batch: int):
    """K3's device time on each captured product-slice call at each launch
    shape."""
    import torch

    from neo_mpc_planner2_tpu_torch.kernels import binding
    from neo_mpc_planner2_tpu_torch.ops import footprint as fpm
    from neo_mpc_planner2_tpu_torch.scenarios import make_scenario_batch
    from neo_mpc_planner2_tpu_torch.simulation import batch_simulate

    cfg = cs.product_cfg()
    sb = make_scenario_batch(cfg, batch, seed=0, map_size=64, plan_points=64,
                             device=device)
    with cs.K3Recorder() as rec:
        batch_simulate(cfg, sb, 2, parity=False)
    for label, args in cs.captured_k3_cases(rec).items():
        R = args[4].shape[1]
        want = fpm.footprint_cost_batch_plain(*args)
        out = {"case": label, "default": list(binding.k3_launch_shape(R))}
        for lanes in (1, 2, 4, 8, 16):
            for warps in (1, 2, 3, 4, 7, 8):
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


def load_old_k3(old_dir: pathlib.Path):
    """Build and load an earlier K3 source, whose sampled launcher took no
    chunk (its block staged a lane's R polygons whole)."""
    from neo_mpc_planner2_tpu_torch.kernels import build

    path = build.build_library(
        csrc=old_dir, build_dir=ROOT / "build" / "old_k3_lib",
        sources=("footprint_cost.cu",), headers=())
    lib = ctypes.CDLL(str(path))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.neo_footprint_cost_f32.restype = i
    lib.neo_footprint_cost_f32.argtypes = [i] * 8 + [vp] * 10
    lib.neo_footprint_walk_f32.restype = i
    lib.neo_footprint_walk_f32.argtypes = [i] * 6 + [vp] * 9
    return lib


def k3_old(device, old_dir: pathlib.Path, turns: str, batch: int):
    """The port's K3 against an earlier build: bit for bit at the earlier
    shapes, timed in turns on the product slice's captured calls."""
    import numpy as np
    import torch

    from neo_mpc_planner2_tpu_torch.kernels import binding
    from neo_mpc_planner2_tpu_torch.ops import costmap as cmap
    from neo_mpc_planner2_tpu_torch.ops import footprint as fpm
    from neo_mpc_planner2_tpu_torch.scenarios import make_scenario_batch
    from neo_mpc_planner2_tpu_torch.simulation import batch_simulate

    lib = load_old_k3(old_dir)
    stream = lambda: torch.cuda.current_stream(device).cuda_stream

    def old(data, origin, res, bounds, verts, n_valid, t, shift=None):
        Bm, H, W = data.shape
        R, V = verts.shape[1], verts.shape[2]
        out = torch.empty((Bm, R), dtype=torch.float32, device=device)
        ptrs = [None if a is None else a.data_ptr()
                for a in (data, origin, res, bounds, shift, verts, n_valid)]
        if t is None:
            rc = lib.neo_footprint_walk_f32(Bm, R, H, W, V,
                                            binding.K3_WALK_THREADS, *ptrs,
                                            out.data_ptr(), stream())
        else:
            lanes, warps = binding.k3_launch_shape(R)
            rc = lib.neo_footprint_cost_f32(Bm, R, H, W, V, t.shape[0],
                                            lanes, warps, *ptrs,
                                            t.data_ptr(), out.data_ptr(),
                                            stream())
        if rc != 0:
            raise RuntimeError(f"old K3 launch failed: cudaError {rc}")
        return out

    rng = np.random.default_rng(11)
    cases = 0
    for B in (1, 131, 4096):
        for R in (1, 3, 21):
            for walk in (False, True):
                make = cs._walk_inputs if walk else cs._k3_inputs
                data, origin, res, verts, nv = make(rng, B, R, device)
                cm = cmap.Costmap(data=data, origin=origin, resolution=res)
                cx = torch.as_tensor(rng.uniform(-2.0, 2.0, B),
                                     dtype=torch.float32, device=device)
                view = cm.replace(win_lo=torch.as_tensor(
                    rng.integers(0, 25, (B, 2)), dtype=torch.int32,
                    device=device), win_cells=40)
                vo, vb, vs = (a.contiguous()
                              for a in fpm.kernel_map_arguments(view))
                maps = [(origin, None, None), (vo, vb, vs)]
                if not walk:
                    maps.append((origin, cmap.product_patch_bounds(
                        cm, cx, cx.flip(0), 28), None))
                for S in ((None,) if walk else (8, 16, 32, 64)):
                    t = None if S is None else fpm.edge_parameters(S, device)
                    for o, bnd, shift in maps:
                        args = (data, o, res, bnd, verts, nv, t, shift)
                        want = old(*args)
                        got = binding.launch_footprint_cost(*args)
                        torch.cuda.synchronize()
                        if not torch.equal(got, want):
                            raise AssertionError(
                                f"K3 B={B} R={R} S={S}: differs from the "
                                "earlier build")
                        cases += 1
    cfg = cs.product_cfg()
    sb = make_scenario_batch(cfg, batch, seed=0, map_size=64, plan_points=64,
                             maps_on_device=True, device=device)
    with cs.K3Recorder() as rec:
        batch_simulate(cfg, sb, 2, parity=False)
    times = {}
    for label, args in cs.captured_k3_cases(rec).items():
        new = lambda: binding.launch_footprint_cost(*args)
        if not torch.equal(new(), old(*args)):
            raise AssertionError(f"K3 {label}: differs from the earlier "
                                 "build")
        cases += 1
        for which in turns.split(","):
            f = new if which == "new" else (lambda: old(*args))
            times.setdefault(f"{label}_{which}_ms", []).append(
                cs._device_ms(f, "footprint_cost_kernel"))
    print(json.dumps({"phase": "K3 against the earlier build",
                      "bit_equal_cases": cases, "turns": turns, **times,
                      "card": cs._nvidia_smi()}), flush=True)


def k2_shapes(device):
    """K2's device time at each of binding.K2_WIDTHS warps a block, B in
    {4096, ..., 65536}, m in K2_M, the launches rotating over copies that
    together exceed twice the L2 (as in the turns). Each width is first
    held against the plain version (also on a 131-matrix view that starts
    off a 16-byte boundary) and against the first width, bit for bit."""
    import numpy as np
    import torch

    from neo_mpc_planner2_tpu_torch import sqp
    from neo_mpc_planner2_tpu_torch.kernels import binding

    rng = np.random.default_rng(1)
    for B in (4096, 8192, 16384, 32768, 65536):
        for m in K2_M:
            ring = spd_ring(spd_batch(rng, B, m, device))
            M = ring[0]
            want = sqp.chol_inverse_plain(M)
            out = {"B": B, "m": m, "copies": len(ring),
                   "default": binding.k2_launch_shape(B, device)}
            first = None
            for warps in binding.K2_WIDTHS:
                at = lambda A: binding._launch_spd_inv_at(
                    A, (warps, binding.K2_UNROLLED_MATRICES))
                got, odd = at(M), at(M[1:132])
                torch.cuda.synchronize()
                ex = max(cs._excess(got, want, 2e-4, 2e-5),
                         cs._excess(odd, want[1:132], 2e-4, 2e-5))
                if ex > 0:
                    raise AssertionError(f"K2 B={B} m={m} warps={warps}: "
                                         f"off its plain version by {ex:.3g}")
                first = got if first is None else first
                if not torch.equal(got, first):
                    raise AssertionError(f"K2 B={B} m={m}: warps={warps} "
                                         "differs from the first width")
                out[f"warps{warps}_ms"] = cs._device_ms(cs.rotating(at, ring),
                                                        "spd_inv_kernel")
            print(json.dumps(out), flush=True)
            del ring, M, want


# K2's runtime-m launch shapes (warps_per_block, matrices_per_block) at
# each m: a warp a matrix, four to a block, against a block of 2 or 4 warps
# a matrix around K2_WARP_MAX_M; the block's warps above it.
RUNTIME_K2_SHAPES = {
    **{m: ((4, 4), (2, 1), (4, 1))
       for m in (32, 36, 38, 40, 41, 42, 43, 44, 48)},
    64: ((4, 4), (2, 1), (3, 1), (4, 1), (8, 1)),
    **{m: tuple((w, 1) for w in (2, 4, 6, 8, 12, 16)) for m in (96, 128)},
    240: tuple((w, 1) for w in (8, 12, 16, 20, 23, 24, 28, 32)),
}
# K1's warps_per_lane at each m (0 the warp team, 1 the warp lane, more the
# block lane): the team against the lane at 18, the lane against the block
# lane at 48 and 63, the block lane's warps above.
RUNTIME_K1_WARPS = {
    18: (0, 1),
    48: (1, 2, 3, 4),
    63: (1, 3, 4, 6, 8),
    66: (3, 4, 5, 6, 8),
    96: (4, 5, 6, 8, 12),
    237: (8, 16, 24, 28, 32),
}


def runtime_shapes(device):
    """The device time (torch.profiler) of K2's runtime-m kernel at each
    shape of RUNTIME_K2_SHAPES and of K1 at each warps_per_lane of
    RUNTIME_K1_WARPS, B = 4096 (K1 60 iterations; K2's calls on copies of
    M that exceed twice the L2), beside the shape binding picks and the
    bound. One JSON line a width."""
    import numpy as np
    import torch

    from neo_mpc_planner2_tpu_torch import sqp
    from neo_mpc_planner2_tpu_torch.kernels import binding, bounds

    rng = np.random.default_rng(2)
    for m, shapes in RUNTIME_K2_SHAPES.items():
        ring = spd_ring(spd_batch(rng, 4096, m, device))
        want = sqp.chol_inverse_plain(ring[0][:256])
        reps = 20 if m <= 64 else 3
        out = {"kernel": "K2", "m": m,
               "picked": list(binding.k2_runtime_shape(m)),
               "bound_ms": bounds.spd_inv_work(4096, m)["bound_ms"]}
        first = None
        for shape in shapes:
            at = lambda A: binding._launch_spd_inv_at(A, shape)
            got = at(ring[0])
            torch.cuda.synchronize()
            ex = cs._excess(got[:256], want, 2e-4, 2e-5)
            if ex > 0:
                raise AssertionError(f"K2 m={m} at {shape}: off its plain "
                                     f"version by {ex:.3g}")
            first = got if first is None else first
            if not torch.equal(got, first):
                raise AssertionError(f"K2 m={m}: {shape} differs from "
                                     f"{shapes[0]}")
            plan = binding.k2_runtime_plan(shape)
            out[f"{plan}_{shape[0]}x{shape[1]}_ms"] = cs._device_ms(
                cs.rotating(at, ring), "spd_inv_kernel", reps=reps)
        print(json.dumps(out), flush=True)
        del ring, want, first, got
    kw = dict(iters=60, rho=1.0, sigma=1e-6)
    for m, warp_counts in RUNTIME_K1_WARPS.items():
        args = cs._qp_inputs(rng, 4096, m, device)
        J = sqp._cone_jacobian(args[4][:256], m)
        want = sqp.qp_admm_plain(*(a[:256] for a in args[:4]), J,
                                 *(a[:256] for a in args[5:]), **kw)
        out = {"kernel": "K1", "m": m,
               "picked": binding.k1_warps_per_lane(m),
               "bound_ms": bounds.qp_admm_work(4096, m, 60)["bound_ms"]}
        for warps in warp_counts:
            call = lambda: binding.launch_qp_admm(
                args, m, kw["iters"], kw["rho"], kw["sigma"],
                warps_per_lane=warps)
            d_out, d, zb, zc, wb, wc, y_cone = call()
            torch.cuda.synchronize()
            ex = max(cs._excess(g[:256], w, 2e-4, 2e-5) for g, w in
                     zip((d_out, y_cone, d, zb, zc, wb, wc), want))
            if ex > 0:
                raise AssertionError(f"K1 m={m} at {warps} warps a lane: "
                                     f"off its plain version by {ex:.3g}")
            out[f"warps{warps}_ms"] = cs._device_ms(
                call, "qp_admm_kernel", reps=20 if m <= 66 else 3)
        print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=pathlib.Path,
                    help="directory with the earlier qp_admm.cu, spd_inv.cu "
                         "and spd_inverse.cuh")
    ap.add_argument("--turns", default="old,new,new,old")
    ap.add_argument("--shapes", action="store_true",
                    help="time K3's launch shapes instead of the turns")
    ap.add_argument("--k2-shapes", action="store_true",
                    help="time K2's launch shapes instead of the turns")
    ap.add_argument("--runtime-shapes", action="store_true",
                    help="time the runtime-m designs' launch shapes")
    ap.add_argument("--k3-old", type=pathlib.Path,
                    help="directory with an earlier footprint_cost.cu")
    ap.add_argument("--batch", type=int, default=4096)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    print(json.dumps({"phase": "device", "nvidia_smi": cs._nvidia_smi(),
                      "torch": torch.__version__}), flush=True)
    from neo_mpc_planner2_tpu_torch.kernels import build

    build.build_library()
    print(json.dumps({"phase": "build", "seconds": build.last_build["seconds"],
                      "ptxas": cs._ptxas_report(build.last_build["log"])}),
          flush=True)
    if args.shapes:
        k3_shapes(device, args.batch)
    if args.k2_shapes:
        k2_shapes(device)
    if args.runtime_shapes:
        runtime_shapes(device)
    if args.k3_old is not None:
        k3_old(device, args.k3_old, args.turns, args.batch)
    if args.old is None and not (args.shapes or args.k2_shapes
                                 or args.runtime_shapes or args.k3_old):
        ap.error("--old is required for the turns")
    if args.old is not None:
        from neo_mpc_planner2_tpu_torch import sqp

        designs = {"old": old_wrappers(load_old(args.old)),
                   "new": {"chol_inverse": sqp.chol_inverse,
                           "qp_admm": sqp.qp_admm}}
        ref = {}
        rows = [kernel_turn(w, designs[w], device, ref)
                for w in args.turns.split(",")]
        summary = {}
        keys = [k for k in rows[0] if isinstance(rows[0][k], float)
                and "diff" not in k and "err" not in k and "bound" not in k]
        for w in ("old", "new"):
            summary[w] = {k: [r[k] for r in rows if r["turn"] == w]
                          for k in keys}
        print(json.dumps({"phase": "summary", **summary}), flush=True)
    print(cs._nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
