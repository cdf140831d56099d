"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from `neo_mpc_planner2_tpu_torch/csrc/`, checks each
(K3 in its sampled and its walk mode; K1 and K2 also at the widths of other
horizons, each design and each kernel's cap) against its plain PyTorch
version on the card, and drives the seven slices of the port through
`batch_simulate`
(4096 lanes, control_steps=3, 10 ticks each): on 64x64 maps the fleet
closed loop (parity objective), the
product closed loop (smooth objective, candidate-wave line search, patch
sampler) and the prox closed loop (the product point with the prox-FISTA
solver, bench.py's prox row); then the fleet point on the three live maps
of bench.py: a 64x64 rolling window over 128x128 world maps, six moving
obstacles re-synthesized every tick, and one 16x16 obstacle update a lane
a tick; and the fleet point in exact footprint mode (every footprint cost
a cell walk: K3's walk mode). For each slice it compares its first tick on
the card with the same tick on the CPU, and reads the CUDA launches, the
device's busy time and its idle share of a tick with torch.profiler; for
each live map, the device time of the map's refresh a tick. Then it serves
over TCP: the port's `serve` on 127.0.0.1, driven by its OptimizerClient
(`optimizer`, `tick`, `optimizer_batch` and `tick_batch` at fleet sizes,
checkpoints as .npz files and as directories), with each request's
p50/p99 latency, and the same script on the card against the CPU. Then
the single-robot controller (`NeoMpcController`, fleet point, a 64x64
map, MPO-700) on its fused route and with the C++ host's geometry (built
with g++ from the port's copy): 30 closed-loop ticks a route, p50/p99 ms
a tick, CUDA launches and host syncs a tick from the port's device_trace,
its first 10 ticks against the CPU, K1's and K3's batch-1 calls held
against their plain versions; the ROS adapter's core on the card, and the
console script (`cli.server_main --device cuda`) answering one request.
Then the SQP's schedules at the fleet point, each group in turns:
lockstep-tail compaction (off, adaptive, fixed after 3 iterations: solves/s,
the solves that took the compact branch, K1 on a sub-batch, card vs CPU on
the adaptive arm) and the K-wide wave line search (K = 1, 2, 4: solves/s,
line-search trips a solve); the MPO-700 suite gate (64 scenarios, the
port's solve on the card against its scipy oracle on the host: >= 0.9 of
the commands within 1e-2 m/s, worst objective gap < 5e-4); the sharded
engine (`parallel.sharding`, NCCL over the visible cards: its commands
equal to the one-process engine's, its metrics to local reductions, the
all-reduce's wall; its state saved collectively as a
torch.distributed.checkpoint directory, a step resumed from the loaded
shard equal to the uninterrupted one, the directory loaded whole by a
process with no group bit-equal to the ranks' states); and the server's
fleet ops sharded over the visible cards, answering as one card does.
Then the horizons: the fleet closed loop at control_steps 1, 5, 8 and 12
(m = 3, 15, 24, 36; 8 and 12 run K1's warp-lane design), each with K1's first
call held against its plain version and its first tick against the CPU;
the product loop at control_steps 5 with K3 held on its captured calls;
tests/test_horizons.py's oracle cases with the solve on the card; and a
server session across a `configure` of control_steps 5 and back.
K3 is also held to its plain version, and timed, on the arguments of its
own calls in the product slice (a gate at R = 1, a gradient call at R = 3
and a wave at R = 21), in the rolling slice (R = 1 through the view, with
the window's cell shift) and in the exact slice (the walk), captured
during the slices' warm-up runs; past its earlier caps (20 and 40
vertices, 12, 68, 100 and 101 samples an edge, 1000 and 2000 polygons a
lane: each launch plan of `kernels.binding.k3_variant`, and the walk past
32 vertices); and end to end, a server session with an MPO-500 on a
0.015 m map (69 samples an edge) and the controller with a 20-vertex
footprint, each against the CPU.
Then the port's benchmark (`python -m neo_mpc_planner2_tpu_torch.bench`,
every pass of bench.py) in a child process at 4096 lanes and 64x64 maps,
its depth cut (BENCH_ARGS): it must exit 0 with one JSON line whose every
field is set, on one card, having launched K1 and K3. Then the port's
demos and studies, each group in a process of its own: the seven examples
(`neo_mpc_planner2_tpu_torch.examples`) at 30 ticks each on the card, their
first 3 ticks' commands against the CPU, and serving_demo's own child
server; the six studies (`neo_mpc_planner2_tpu_torch.scripts`) at a cut
depth (STUDY_ARGS: 4096 lanes, 1-2 ticks, the parity study's gate and
sequence suites at n = 16),
their outputs checked; each launching K1 and K3.
Every phase prints a line; any failure exits non-zero. The `kernels` line
lists every kernel with its launches, its time beside its bound
(`kernels/bounds.py`) and, where one PyTorch call computes the same
function, that call's time; the second-to-last line is the card's name and
power limit, the last line `{"ok": true, "device": {...}}`. Needs a CUDA
device: without one it exits non-zero and prints no result. Imports no
JAX.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import statistics
import subprocess
import sys
import time

# Every hand-written kernel: its source, the TPU kernel it replaces
# (file:line of its `def`) and its launcher in kernels/binding.py.
KERNELS = [
    dict(name="qp_admm", route="cuda",
         source="neo_mpc_planner2_tpu_torch/csrc/qp_admm.cu",
         replaces="neo_mpc_planner2_tpu/sqp.py:318",
         launcher="launch_qp_admm"),
    dict(name="spd_inv", route="cuda",
         source="neo_mpc_planner2_tpu_torch/csrc/spd_inv.cu",
         replaces="neo_mpc_planner2_tpu/sqp.py:144",
         launcher="launch_spd_inv"),
    dict(name="footprint_cost", route="cuda",
         source="neo_mpc_planner2_tpu_torch/csrc/footprint_cost.cu",
         replaces="neo_mpc_planner2_tpu/ops/pallas_kernels.py:44",
         launcher="launch_footprint_cost"),
]


# The keys of each entry of the `kernels` line.
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches",
               "launches_per_tick", "max_abs_err", "ms", "plain_ms",
               "bound_ms", "bound_by", "share_of_bound", "library_ms",
               "variants")

# How the phase lines time each kernel; the `kernels` line's "ms" is the
# first of these, its "plain_ms" the last.
TIMING = ("*_ms: the kernel's device time (torch.profiler, median of 3 x "
          "20 launches); *_wrapper_ms and *_plain_ms: one call between CUDA "
          "events, median of 20; *_library_ms: the device time of one "
          "PyTorch call's kernels, mean of 20; from m = 96 on, where a call "
          "takes over 1 ms, *_ms and *_library_ms are one call between CUDA "
          "events too, the enqueue included (median of 20, of 2 at the caps)")

# The timed run of each slice, SQP schedule arm and horizon loop: 20 ticks
# until the bench phase joined the smoke, which then took 786 s on one
# NVIDIA H100 80GB HBM3 (PERF.md); every number they give is per tick.
SLICE_TICKS = 10
# Each slice's warm-up run (the product and rolling slices' K3 calls are
# captured there) and, per slice, the ticks that the launch count
# profiles, as (first tick, ticks). Reading the profiler's records takes
# longer than the ticks they record (a fleet tick makes ~10^4 launches,
# a prox tick ~3·10^4), so the SQP slices profile their first tick and
# the prox slice one tick from the middle of a run (5 and 2 ticks until
# the whole run passed 600 s).
WARM_TICKS = 2
LAUNCH_TICKS = {"fleet": (0, 1), "product": (0, 1),
                "prox": (SLICE_TICKS // 2, 1), "rolling": (0, 1),
                "dynamic": (0, 1), "updates": (0, 1), "exact": (0, 1)}


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _ptxas_report(log: str) -> dict:
    """Registers, stack and spill bytes per kernel instance from nvcc's
    `-Xptxas -v` output, keyed like "qp_admm_m15", "spd_inv_m9_w4",
    "footprint_cost_S16", "footprint_walk", or, for the kernels that take m
    at run time, "qp_admm_warp_lane_64" (its row capacity),
    "qp_admm_block_lane", "spd_inv_runtime_warp" and
    "spd_inv_runtime_block"."""
    import re

    report, name = {}, None
    for line in log.splitlines():
        walk = re.search(r"Compiling entry function '\w*?"
                         r"footprint_walk_kernel", line)
        runtime_m = re.search(r"Compiling entry function '\w*?"
                              r"(qp_admm|spd_inv)_kernel_"
                              r"(warp_lane|block_lane|runtime_warp|"
                              r"runtime_block)(?:ILi(\d+)E)?", line)
        hit = re.search(r"Compiling entry function '\w*?"
                        r"(qp_admm|spd_inv|footprint_cost)_kernelILi(\d+)E"
                        r"(?:Li(\d+)E)?(?:Lb(\d)E)?", line)
        if walk:
            name = "footprint_walk"
            report[name] = {}
        elif runtime_m:
            name = f"{runtime_m.group(1)}_{runtime_m.group(2)}"
            if runtime_m.group(3):
                name += f"_{runtime_m.group(3)}"
            report[name] = {}
        elif hit:
            # K1 instances are keyed by m, K2's by m and warps a block, K3's
            # by S (S0: any other S) and "_shift" for a view's.
            key = "S" if hit.group(1) == "footprint_cost" else "m"
            name = f"{hit.group(1)}_{key}{hit.group(2)}"
            if hit.group(3):
                name += f"_w{hit.group(3)}"
            if hit.group(4) == "1":
                name += "_shift"
            report[name] = {}
        elif name and "spill stores" in line:
            nums = [int(v) for v in re.findall(r"(\d+) bytes", line)]
            report[name].update(stack=nums[0], spill_stores=nums[1],
                                spill_loads=nums[2])
        elif name and "registers" in line:
            report[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return report


# Idle host time at each end of a profiler session. Late in a long process
# a short session was seen to report none of its device records (the
# profiler keeps only those inside its capture window); with this margin
# they were kept.
PROFILE_PAD_S = 0.05


def _time_ms(fn, reps: int = 20) -> float:
    """Median of `reps` CUDA-event timings of fn(), after one warm-up: what
    one call costs on the card, the host's enqueue of its launches
    included."""
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


def l2_copies(device, nbytes: int) -> int:
    """How many copies of a call's operands (nbytes read and written in
    all) its timed calls rotate over so that each call finds none of them
    in the card's L2: together at least twice the L2, and at least 3."""
    import torch

    l2 = torch.cuda.get_device_properties(device).L2_cache_size
    return max(3, -(-2 * l2 // nbytes))


def rotating(fn, inputs: list):
    """A call of fn on the next of `inputs` each time, which keeps each
    output until its input comes round again: the caching allocator then
    rotates the outputs over len(inputs) + 1 blocks, and a call reads and
    writes memory that the last len(inputs) - 1 calls did not touch."""
    outs = [None] * len(inputs)
    turn = [0]

    def call():
        k = turn[0] % len(inputs)
        turn[0] += 1
        outs[k] = fn(inputs[k])
        return outs[k]

    return call


def _device_ms(fn, kernel: str, reps: int = 20, traces: int = 3) -> float:
    """Median device time of the `kernel` launches in `traces` profiles of
    `reps` calls of fn() each, after one warm-up, from torch.profiler's
    CUDA trace: the kernel alone on the card, without the host's enqueue
    (which a single short launch between two CUDA events also times). The
    profiler may drop a record of a short trace, so the records of all
    traces are pooled, and up to `traces` more are taken while fewer than
    a third of the first `traces` profiles' launches were seen."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    times = []
    for i in range(2 * traces):
        if i >= traces and 3 * len(times) >= reps * traces:
            break
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        seen = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                if e.device_type == DeviceType.CUDA and kernel in e.name]
        if len(seen) > reps:
            raise AssertionError(f"the profiler saw {len(seen)} launches "
                                 f"of {kernel} in {reps} calls")
        times += seen
    if 3 * len(times) < reps * traces:
        raise AssertionError(f"the profiler saw {len(times)} of "
                             f"{reps * traces} launches of {kernel}")
    return statistics.median(times)


def _device_total_ms(fn, reps: int = 20) -> float:
    """Device time of all the work one call of fn() puts on the card (every
    kernel, copy and fill, summed), averaged over `reps` calls after one
    warm-up, from torch.profiler's CUDA trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    total = sum(e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == DeviceType.CUDA)
    if total <= 0:
        raise AssertionError("the profiler saw no device time")
    return total / 1e3 / reps


LAUNCH_EVENTS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx")
SYNC_EVENTS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


def profile_run(fn) -> dict:
    """One call of fn() under torch.profiler: the CUDA launches (host API
    calls), the kernels that ran on the card, the device time of all of
    them summed (ms) and that of each hand-written kernel (_wrappers)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    events = prof.events()
    dev = [(e.name, e.time_range.elapsed_us() / 1e3) for e in events
           if e.device_type == DeviceType.CUDA]
    return {"launches": sum(e.name in LAUNCH_EVENTS for e in events),
            "syncs": sum(e.name in SYNC_EVENTS for e in events),
            "kernels": len(dev),
            "device_ms": sum(ms for _, ms in dev),
            "kernel_ms": {name: sum(ms for n, ms in dev
                                    if f"{name}_kernel" in n)
                          for name in _wrappers()}}


def count_launches(fn, traces: int = 3) -> dict:
    """The CUDA launches (host API calls) and the kernels that ran on the
    card during one call of fn(), from torch.profiler. The profiler may
    drop the device record of a short trace, so the call is traced
    `traces` times, and up to `traces` more while no trace saw as many
    kernels as launches: the kernels are the most that one trace saw, and
    every trace must see the same launches."""
    runs = [profile_run(fn) for _ in range(traces)]
    while (max(run["kernels"] for run in runs) < runs[0]["launches"]
           and len(runs) < 2 * traces):
        runs.append(profile_run(fn))
    launches = {run["launches"] for run in runs}
    if len(launches) != 1:
        raise AssertionError(f"the same call made {sorted(launches)} "
                             "launches in its traces")
    return {"launches": launches.pop(),
            "kernels": max(run["kernels"] for run in runs)}


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


def _spd_inputs(rng, B, m, device):
    """B random SPD m x m matrices, batch-major (B, m, m)."""
    import numpy as np
    import torch

    A = rng.normal(size=(B, m, m)).astype(np.float32) * 0.3
    return torch.as_tensor(
        A @ np.swapaxes(A, -1, -2) + np.eye(m, dtype=np.float32),
        device=device)


def phase_launch_counts(device) -> dict:
    """One qp_admm call is one CUDA launch and one kernel on the card at
    every width of K1_TIMED (B = 4096, 60 iterations: each design), and so
    is one chol_inverse call of each K2 plan (m = 9 unrolled, 24 a warp a
    matrix, 65 a block a matrix; B = 4096). First after the build:
    torch.profiler may lose the device records of a short trace once the
    process has taken many traces."""
    import numpy as np

    from neo_mpc_planner2_tpu_torch import sqp
    from neo_mpc_planner2_tpu_torch.kernels import binding

    rng = np.random.default_rng(0)
    out = {"phase": "one launch a call"}
    calls = {}
    for m in K1_TIMED:
        m = binding.K1_MAX_M if m == "cap" else m
        args = _qp_inputs(rng, 4096, m, device)
        calls[f"qp_admm_m{m}"] = (lambda a: lambda: sqp.qp_admm(
            *a, iters=60))(args)
    for m in (9, 24, 65):
        A = _spd_inputs(rng, 4096, m, device)
        calls[f"spd_inv_m{m}"] = (lambda M: lambda: sqp.chol_inverse(M))(
            A.contiguous())
    for name, call in calls.items():
        n = count_launches(call)
        out[name] = n
        if n != {"launches": 1, "kernels": 1}:
            raise AssertionError(f"one {name} call made {n}, expected one "
                                 "launch")
    print(json.dumps(out), flush=True)
    return out


# K1's checked cases: (m, batch sizes, iteration counts). m = 6, 9, 15 at
# every size; the other designs' boundaries and the horizons' widths (the
# warp team at 3 and 18, the warp lane at 21, 24, 33, 36 and 63, the block
# lane at 66, 96 and K1's cap) at B = 1 and 4096.
K1_CASES = tuple((m, (1, 131, 4096), (6, 60)) for m in (6, 9, 15)) + tuple(
    (m, (1, 4096), (60,))
    for m in (3, 18, 21, 24, 33, 36, 63, 66, 96, "cap"))
# The widths timed at B = 4096, 60 iterations: every design's boundaries.
K1_TIMED = (3, 9, 15, 18, 21, 24, 36, 63, 66, 96, "cap")


def _reps(m: int) -> int:
    """Timed calls a trace: fewer past m = 96, where one call takes tens
    of ms (the caps)."""
    return 20 if m <= 96 else 2


# From this width on a K1 or K2 call's device time is one call between
# CUDA events, the host's enqueue included: the first timed width where a
# call of either kernel takes over 1 ms on an H100 (PERF.md), so the
# enqueue, which the events read ~0.06 ms above the profiler's device
# time, is a few per cent of it. Below it, the profiler's device time.
EVENTS_FROM_M = 96


def _kernel_ms(call, kernel: str, m: int) -> float:
    """The device time of one call of a K1 or K2 kernel at width m."""
    if m >= EVENTS_FROM_M:
        return _time_ms(call, _reps(m))
    return _device_ms(call, kernel, reps=_reps(m))


def phase_kernels(device):
    """K1 against its plain version at every case of K1_CASES, within rtol
    2e-4 / atol 2e-5; timed at B = 4096 at each width of K1_TIMED (the
    kernel, the whole call, the plain version, the bound; one launch a
    call: phase_launch_counts). K1 is also timed without ADMM iterations at
    m = 9 and 15 (the inverse and the operands' traffic alone)."""
    import numpy as np
    import torch

    from neo_mpc_planner2_tpu_torch import sqp
    from neo_mpc_planner2_tpu_torch.kernels import binding, bounds

    rng = np.random.default_rng(0)
    rtol, atol = 2e-4, 2e-5
    cap = binding.K1_MAX_M
    timed = {cap if m == "cap" else m for m in K1_TIMED}
    report = {"cap_m": cap, "variants": []}
    worst = 0.0
    for m, sizes, iter_counts in K1_CASES:
        m = cap if m == "cap" else m
        worst_m = 0.0
        for B in sizes:
            for iters in iter_counts:
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
                    worst_m = max(worst_m, float((gt - w).abs().max()))
                if not (B == 4096 and iters == 60 and m in timed):
                    continue
                call = lambda: sqp.qp_admm(*args, **kw)
                reps = _reps(m)
                ms = _kernel_ms(call, "qp_admm_kernel", m)
                report[f"qp_admm_m{m}_ms"] = ms
                if m in (9, 15, 36):
                    report[f"qp_admm_m{m}_iters0_ms"] = _device_ms(
                        lambda: sqp.qp_admm(*args, iters=0, rho=1.0,
                                            sigma=1e-6), "qp_admm_kernel")
                report[f"qp_admm_wrapper_m{m}_ms"] = _time_ms(call, reps)
                plain_ms = _time_ms(
                    lambda: sqp.qp_admm_plain(*plain_args, **kw), reps)
                report[f"qp_admm_plain_m{m}_ms"] = plain_ms
                work = bounds.qp_admm_work(B, m, iters)
                report[f"qp_admm_m{m}_bound_ms"] = work["bound_ms"]
                report[f"qp_admm_m{m}_bound_by"] = work["bound_by"]
                report["variants"].append({
                    "m": m, "variant": binding.qp_admm_variant(m),
                    "warps_per_lane": binding.k1_warps_per_lane(m), "B": B,
                    "iters": iters, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": work["bound_ms"],
                    "bound_by": work["bound_by"],
                    "share_of_bound": work["bound_ms"] / ms,
                    "library_ms": None})
        for v in report["variants"]:
            if v["m"] == m:
                v["max_abs_err"] = worst_m
        worst = max(worst, worst_m)
    report["qp_admm_max_abs_err"] = worst
    print(json.dumps({"phase": "K1 qp_admm vs plain", "rtol": rtol,
                      "atol": atol, "timing": TIMING, **report}), flush=True)
    return report


K2_SIZES = (1, 131, 4096, 65536)
K2_TIMED = (4096, 65536)
# K2's checked cases: (m, batch sizes). m = 6, 9, 15 at every size of
# K2_SIZES; m = 3 (unrolled) and the runtime-m kernel's widths (a warp a
# matrix at 1, 2, 4, 19, 24, 33, 36, 40 and 41, its last; a block a matrix
# at 42, its first, 64, 96 and K2's cap) at B = 1 and 4096.
K2_CASES = tuple((m, K2_SIZES) for m in (6, 9, 15)) + tuple(
    (m, (1, 4096))
    for m in (3, 1, 2, 4, 19, 24, 33, 36, 40, 41, 42, 64, 96, "cap"))


def phase_k2(device):
    """K2 against its plain version at every case of K2_CASES and on
    tests/test_solver.py's ill-conditioned diagonal (in each plan), within
    rtol 2e-4 / atol 2e-5, with the residual |MX - I|; timed at B = 4096
    (and 65536), each timed call on the next of copies of M that together
    exceed twice the L2: the kernel, the whole call, the plain version, the
    library call (torch.linalg.inv), the bound (one launch a call:
    phase_launch_counts)."""
    import numpy as np
    import torch

    from neo_mpc_planner2_tpu_torch import sqp
    from neo_mpc_planner2_tpu_torch.kernels import binding, bounds

    rng = np.random.default_rng(0)
    rtol, atol = 2e-4, 2e-5
    inv = {"cap_m": binding.K2_MAX_M, "variants": []}
    worst_inv, worst_res = 0.0, 0.0
    cap = binding.K2_MAX_M
    # The ill-conditioned diagonal in each plan: unrolled at 9, a warp a
    # matrix at 24 and 41, a block a matrix at 42 and the cap (padded with
    # ones).
    diag = [1e4, 1e3, 1e2, 10, 1, 1, 0.1, 0.01, 1e-3]
    cases = [(m, torch.diag(torch.tensor(diag + [1.0] * (m - 9),
                                         device=device))[None])
             for m in (9, 24, 41, 42, cap)]
    for m, sizes in K2_CASES:
        m = cap if m == "cap" else m
        for B in sizes:
            cases.append((m, _spd_inputs(rng, B, m, device)))
    for m, M in cases:
        B = M.shape[0]
        got = sqp.chol_inverse(M)
        want = sqp.chol_inverse_plain(M)
        torch.cuda.synchronize()
        ex = _excess(got, want, rtol, atol)
        if ex > 0 or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"K2 m={m} B={B}: off its plain version by "
                                 f"{ex:.3g} past rtol/atol")
        res = float((M @ got - torch.eye(m, device=device)).abs().max())
        if res > 1e-3:
            raise AssertionError(f"K2 m={m} B={B}: |MX - I| = {res:.3g}")
        worst_inv = max(worst_inv, float((got - want).abs().max()))
        worst_res = max(worst_res, res)
        if B not in K2_TIMED:
            continue
        tag = f"m{m}" if B == 4096 else f"m{m}_B{B}"
        # Every timed call reads and writes memory that is not in L2 (at
        # B = 65536, m = 9 one call's 42 MB would fit the H100's 50 MB).
        ring = [M] + [M.clone() for _ in
                      range(l2_copies(device, 2 * M.numel() * 4) - 1)]
        call = rotating(sqp.chol_inverse, ring)
        reps = _reps(m)
        inv[f"spd_inv_{tag}_copies"] = len(ring)
        shape = binding.spd_inv_shape(m, B, device)
        inv[f"spd_inv_{tag}_variant"] = binding.spd_inv_variant(m)
        inv[f"spd_inv_{tag}_shape"] = shape
        inv[f"spd_inv_{tag}_ms"] = _kernel_ms(call, "spd_inv_kernel", m)
        inv[f"spd_inv_wrapper_{tag}_ms"] = _time_ms(call, reps)
        inv[f"spd_inv_plain_{tag}_ms"] = _time_ms(
            rotating(sqp.chol_inverse_plain, ring), reps)
        # The one PyTorch call for the same function (the port never calls
        # it).
        library = rotating(torch.linalg.inv, ring)
        inv[f"spd_inv_library_{tag}_ms"] = (
            _time_ms(library, reps) if m >= EVENTS_FROM_M
            else _device_total_ms(library, reps))
        work = bounds.spd_inv_work(B, m)
        inv[f"spd_inv_{tag}_bound_ms"] = work["bound_ms"]
        inv[f"spd_inv_{tag}_bound_by"] = work["bound_by"]
        inv[f"spd_inv_{tag}_share_of_bound"] = (work["bound_ms"]
                                                / inv[f"spd_inv_{tag}_ms"])
        inv["variants"].append({
            "m": m, "variant": inv[f"spd_inv_{tag}_variant"],
            "plan": ("unrolled" if m in binding.K2_UNROLLED_M
                     else binding.k2_runtime_plan(shape)),
            "warps_per_block": shape[0], "matrices_per_block": shape[1],
            "B": B,
            "ms": inv[f"spd_inv_{tag}_ms"],
            "plain_ms": inv[f"spd_inv_plain_{tag}_ms"],
            "bound_ms": work["bound_ms"], "bound_by": work["bound_by"],
            "share_of_bound": inv[f"spd_inv_{tag}_share_of_bound"],
            "library_ms": inv[f"spd_inv_library_{tag}_ms"],
            "max_abs_err": float((got - want).abs().max())})
        del ring, call
    inv["spd_inv_max_abs_err"] = worst_inv
    inv["spd_inv_max_residual"] = worst_res
    print(json.dumps({"phase": "K2 spd_inv vs plain", "rtol": rtol,
                      "atol": atol, "sizes": K2_SIZES,
                      "launches": sqp.chol_inverse.launches,
                      "timing": TIMING, **inv}), flush=True)
    return inv


def _k3_inputs(rng, B: int, R: int, device):
    """Maps with a lethal row each and (B, R) polygons of five kinds, in
    turn: placed rectangles, padded triangles, grid-aligned rectangles
    (samples on cell boundaries), corners in the (origin - res, origin)
    band, and polygons off the map. Padded vertex slots hold garbage."""
    import numpy as np
    import torch

    H = W = 64
    f = np.float32
    res, o = f(0.05), f(-1.6)
    data = rng.uniform(0, 0.95, (B, H, W)).astype(f)
    data[np.arange(B), rng.integers(0, H, B), :] = 1.0
    n = B * R
    kind = np.arange(n) % 5
    centre = rng.uniform(-1.2, 1.2, (n, 2)).astype(f)
    centre[kind == 4] += f(4.0)
    yaw = rng.uniform(-np.pi, np.pi, n)
    half = np.asarray([[0.365, 0.275], [-0.365, 0.275], [-0.365, -0.275],
                       [0.365, -0.275]])
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    quad = centre[:, None, :] + np.stack(
        [half[:, 0] * c - half[:, 1] * s, half[:, 0] * s + half[:, 1] * c],
        -1)
    k = rng.integers(-3, 67, (n, 2))
    lo = o + k.astype(f) * res
    hi = o + (k + rng.integers(1, 8, (n, 2))).astype(f) * res
    aligned = np.stack([hi, np.stack([lo[:, 0], hi[:, 1]], -1), lo,
                        np.stack([hi[:, 0], lo[:, 1]], -1)], 1)
    quad[kind == 2] = aligned[kind == 2]
    band = (o - rng.uniform(0.01, 0.99, (n, 4, 2)).astype(f) * res)
    quad[kind == 3] = np.where(rng.random((n, 4, 2)) < 0.5, band,
                               o + rng.uniform(0, 0.3, (n, 4, 2)))[kind == 3]
    verts = rng.uniform(50, 90, (n, 8, 2))
    verts[:, :4] = quad
    nv = np.where(kind == 1, 3, 4).astype(np.int32)
    verts[kind == 1, 3] = rng.uniform(50, 90, (int((kind == 1).sum()), 2))
    T = lambda a, dt=torch.float32: torch.as_tensor(
        np.ascontiguousarray(a), dtype=dt, device=device)
    return (T(data), T(np.full((B, 2), o)), T(np.full((B,), res)),
            T(verts.reshape(B, R, 8, 2)), T(nv.reshape(B, R), torch.int32))


def _walk_inputs(rng, B: int, R: int, device):
    """_k3_inputs' maps and polygons (placed rectangles, padded triangles,
    grid-aligned rectangles whose axis-aligned edges end on cell
    boundaries, corners in the band below the origin, polygons off the
    map) with two more kinds for the walk: every 7th polygon degenerate
    (its vertices one point: zero-length edges) and every 11th a
    diamond with its vertices on cell corners (diagonals through
    corners)."""
    import numpy as np
    import torch

    data, origin, res, verts, nv = _k3_inputs(rng, B, R, device)
    v = verts.cpu().numpy().reshape(B * R, 8, 2)
    n = np.arange(B * R)
    v[n % 7 == 0, :4] = v[n % 7 == 0, :1]
    o, r = np.float32(-1.6), np.float32(0.05)
    k = rng.integers(4, 60, ((n % 11 == 0).sum(), 1, 2))
    step = rng.integers(1, 5, ((n % 11 == 0).sum(), 1, 1))
    diamond = np.asarray([[1, 0], [0, 1], [-1, 0], [0, -1]])[None] * step
    v[n % 11 == 0, :4] = o + (k + diamond).astype(np.float32) * r
    nvv = nv.cpu().numpy().reshape(-1)
    nvv[n % 11 == 0] = 4
    return (data, origin, res,
            torch.as_tensor(v.reshape(B, R, 8, 2), device=device),
            torch.as_tensor(nvv.reshape(B, R), device=device))


def _widen(rng, verts, nv, V: int):
    """_k3_inputs' or _walk_inputs' (B, R, 8, 2) polygons and counts in V
    vertex slots (garbage in the new ones), every third polygon replaced
    by a regular polygon of V // 2 + 1 to V vertices (a radius footprint,
    as nav2's 16-gon) of radius 0.25-0.6 m at a random place and turn, a
    fifth of them off the map."""
    import numpy as np
    import torch

    B, R = nv.shape
    v = np.ascontiguousarray(verts.cpu().numpy().reshape(B * R, 8, 2))
    n = nv.cpu().numpy().reshape(-1).copy()
    wide = rng.uniform(50, 90, (B * R, V, 2)).astype(np.float32)
    wide[:, :8] = v
    gon = np.flatnonzero(np.arange(B * R) % 3 == 2)
    k = rng.integers(V // 2 + 1, V + 1, gon.size)
    centre = rng.uniform(-1.2, 1.2, (gon.size, 2))
    centre[rng.random(gon.size) < 0.2] += 4.0
    radius = rng.uniform(0.25, 0.6, gon.size)
    turn = rng.uniform(-np.pi, np.pi, gon.size)
    for i, q in enumerate(gon):
        a = turn[i] + 2 * np.pi * np.arange(k[i]) / k[i]
        wide[q, :k[i]] = centre[i] + radius[i] * np.stack(
            [np.cos(a), np.sin(a)], -1)
    n[gon] = k
    dev = verts.device
    return (torch.as_tensor(wide.reshape(B, R, V, 2), device=dev),
            torch.as_tensor(n.reshape(B, R), dtype=torch.int32, device=dev))


# K3's shapes past the earlier caps of 16 vertices and 64 samples an edge,
# as (B, R, V, S): radius footprints (V = 20, 40), an MPO-500's samples on
# a 0.015 m map (68) and a 0.01 m map (101), S = 12 and 100, and more
# polygons a lane than a block of the measured shape stages: R = 1000
# (binding.k3_variant's "lane" plan) and 2000 (its "split" plan).
K3_WIDE_CASES = ((131, 1, 20, 32), (131, 21, 20, 32), (4096, 1, 8, 68),
                 (131, 5, 8, 101), (131, 21, 8, 100), (131, 1, 40, 12),
                 (131, 3, 40, 12), (64, 1000, 8, 16), (64, 2000, 8, 16),
                 (16, 1200, 40, 12))
# Where the new plans are timed: (B, R, V, S) on the whole grid; and
# where the general-S instance is timed beside the S = 64 instance on the
# same polygons.
K3_TIMED_PLANS = {"lane": (256, 1000, 8, 16), "split": (256, 2000, 8, 16)}
K3_TIMED_GENERAL_S = (4096, 1, 8, 68)
# K3's walk past 32 vertices (and at 20): (B, R, V); timed at V = 40.
K3_WALK_WIDE_CASES = ((131, 1, 20), (131, 21, 20), (131, 1, 40),
                      (131, 21, 40), (4096, 1, 40))
K3_WALK_TIMED = (4096, 1, 40)


def _k3_timed(call, plain, work, kernel: str) -> dict:
    """A K3 call's device ms, plain ms, bound and share."""
    ms = _device_ms(call, kernel)
    return {"ms": ms, "plain_ms": _time_ms(plain), "bound_ms":
            work["bound_ms"], "bound_by": work["bound_by"],
            "share_of_bound": work["bound_ms"] / ms,
            **{k: work[k] for k in ("samples", "steps", "edges", "cells")
               if k in work}}


def phase_k3_walk(device):
    """K3's walk mode against the plain walk: exact (torch.equal), at
    every shape and polygon kind of _walk_inputs, on the whole grid and
    through a 40x40 rolling-window view at a random corner (the window's
    origin, its rectangle and the cell shift); one launch a call. Timed at
    B = 4096, R = 1 on the whole grid (the shape of the exact slice's
    gate)."""
    import numpy as np
    import torch

    from neo_mpc_planner2_tpu_torch.kernels import bounds
    from neo_mpc_planner2_tpu_torch.ops import costmap as cmap
    from neo_mpc_planner2_tpu_torch.ops import footprint as fpm

    rng = np.random.default_rng(5)
    cases, report = 0, {}
    for B in (1, 131, 4096):
        for R in (1, 3, 21):
            data, origin, res, verts, nv = _walk_inputs(rng, B, R, device)
            cm = cmap.Costmap(data=data, origin=origin, resolution=res)
            view = cm.replace(win_lo=torch.as_tensor(
                rng.integers(0, 25, (B, 2)), dtype=torch.int32,
                device=device), win_cells=40)
            v_origin, v_bounds, v_shift = fpm.kernel_map_arguments(view)
            maps = {"grid": (origin, None, None),
                    "view": (v_origin.contiguous(), v_bounds.contiguous(),
                             v_shift.contiguous())}
            for kind, (o, bnd, shift) in maps.items():
                args = (data, o, res, bnd, verts, nv, shift)
                before = fpm.footprint_walk_batch.launches
                got = fpm.footprint_walk_batch(*args)
                want = fpm.footprint_walk_batch_plain(*args)
                torch.cuda.synchronize()
                if fpm.footprint_walk_batch.launches != before + 1:
                    raise AssertionError("K3 walk: a call is not one launch")
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"K3 walk B={B} R={R} {kind}: differs from the plain "
                        f"walk by {float((got - want).abs().max())}")
                cases += 1
            if B == 4096 and R == 1:
                args = (data, origin, res, None, verts, nv)
                ms = _device_ms(lambda: fpm.footprint_walk_batch(*args),
                                "footprint_walk_kernel")
                work = bounds.footprint_walk_work(*args)
                report["walk_synthetic"] = {
                    "ms": ms, "bound_ms": work["bound_ms"],
                    "bound_by": work["bound_by"],
                    "share_of_bound": work["bound_ms"] / ms,
                    "steps": work["steps"], "cells": work["cells"]}
    # Past 32 vertices a thread walks every 32nd edge of its polygon.
    plans = collections.Counter(fpm.footprint_walk_batch.plans)
    for B, R, V in K3_WALK_WIDE_CASES:
        data, origin, res, verts, nv = _walk_inputs(rng, B, R, device)
        verts, nv = _widen(rng, verts, nv, V)
        cm = cmap.Costmap(data=data, origin=origin, resolution=res)
        view = cm.replace(win_lo=torch.as_tensor(
            rng.integers(0, 25, (B, 2)), dtype=torch.int32, device=device),
            win_cells=40)
        v_origin, v_bounds, v_shift = fpm.kernel_map_arguments(view)
        for kind, (o, bnd, shift) in {
                "grid": (origin, None, None),
                "view": (v_origin.contiguous(), v_bounds.contiguous(),
                         v_shift.contiguous())}.items():
            args = (data, o, res, bnd, verts, nv, shift)
            got = fpm.footprint_walk_batch(*args)
            want = fpm.footprint_walk_batch_plain(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"K3 walk B={B} R={R} V={V} {kind}: differs from the "
                    f"plain walk by {float((got - want).abs().max())}")
            cases += 1
        if (B, R, V) == K3_WALK_TIMED:
            args = (data, origin, res, None, verts, nv)
            report["walk_V40"] = {"shape": list(verts.shape), **_k3_timed(
                lambda: fpm.footprint_walk_batch(*args),
                lambda: fpm.footprint_walk_batch_plain(*args),
                bounds.footprint_walk_work(*args), "footprint_walk_kernel")}
    calls = collections.Counter(fpm.footprint_walk_batch.plans)
    calls.subtract(plans)
    report["plans"] = {k: n for k, n in calls.items() if n}
    print(json.dumps({"phase": "K3 walk mode vs plain walk",
                      "tolerance": "exact (torch.equal)", "cases": cases,
                      "timed_at": "B=4096 R=1 full grid, synthetic; "
                      "walk_V40: B=4096 R=1 V=40",
                      "timing": TIMING, **report}), flush=True)
    return report


def phase_k3(device):
    """K3 against its plain version: exact (the outputs are picked map
    values), at every shape and polygon kind, full-grid and patch bounds,
    and through a 40x40 rolling-window view at a random corner (the
    window's origin, its rectangle and the cell shift). Timed on these
    synthetic polygons at B = 4096, R = 21, S = 16, full grid, the shape
    the earlier one-warp-a-polygon design was timed at."""
    import numpy as np
    import torch

    from neo_mpc_planner2_tpu_torch.ops import costmap as cmap
    from neo_mpc_planner2_tpu_torch.ops import footprint as fpm

    rng = np.random.default_rng(3)
    worst, cases, report = 0.0, 0, {}
    for B in (1, 131, 4096):
        for R in (1, 3, 21):
            data, origin, res, verts, nv = _k3_inputs(rng, B, R, device)
            cm = cmap.Costmap(data=data, origin=origin, resolution=res)
            cx = torch.as_tensor(rng.uniform(-2.0, 2.0, B),
                                 dtype=torch.float32, device=device)
            patch = cmap.product_patch_bounds(cm, cx, cx.flip(0), 28)
            view = cm.replace(win_lo=torch.as_tensor(
                rng.integers(0, 25, (B, 2)), dtype=torch.int32,
                device=device), win_cells=40)
            v_origin, v_bounds, v_shift = fpm.kernel_map_arguments(view)
            maps = {"grid": (origin, None, None),
                    "patch": (origin, patch, None),
                    "view": (v_origin.contiguous(), v_bounds.contiguous(),
                             v_shift.contiguous())}
            for S in (8, 16, 32, 64):
                t = fpm.edge_parameters(S, device)
                for kind, (o, bounds, shift) in maps.items():
                    args = (data, o, res, bounds, verts, nv, t, shift)
                    got = fpm.footprint_cost_batch(*args)
                    want = fpm.footprint_cost_batch_plain(*args)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"K3 B={B} R={R} S={S} {kind}: differs from "
                            "its plain version by "
                            f"{float((got - want).abs().max())}")
                    worst = max(worst, float((got - want).abs().max()))
                    cases += 1
                if B == 4096 and R == 21 and S == 16:
                    args = (data, origin, res, None, verts, nv, t)
                    report["footprint_cost_synthetic_ms"] = _device_ms(
                        lambda: fpm.footprint_cost_batch(*args),
                        "footprint_cost_kernel")
    # Past the earlier caps: every (B, R, V, S) of K3_WIDE_CASES on the
    # whole grid, patch bounds and a view, each at the plan k3_variant
    # gives it; the one-lane and split plans timed.
    from neo_mpc_planner2_tpu_torch.kernels import binding, bounds as kb

    plans = collections.Counter(fpm.footprint_cost_batch.plans)
    for B, R, V, S in K3_WIDE_CASES + tuple(K3_TIMED_PLANS.values()):
        data, origin, res, verts, nv = _k3_inputs(rng, B, R, device)
        verts, nv = _widen(rng, verts, nv, V)
        cm = cmap.Costmap(data=data, origin=origin, resolution=res)
        cx = torch.as_tensor(rng.uniform(-2.0, 2.0, B), dtype=torch.float32,
                             device=device)
        patch = cmap.product_patch_bounds(cm, cx, cx.flip(0), 28)
        view = cm.replace(win_lo=torch.as_tensor(
            rng.integers(0, 25, (B, 2)), dtype=torch.int32, device=device),
            win_cells=40)
        v_origin, v_bounds, v_shift = fpm.kernel_map_arguments(view)
        t = fpm.edge_parameters(S, device)
        plan = binding.k3_variant(R, V, S)[0]
        for kind, (o, bnd, shift) in {
                "grid": (origin, None, None), "patch": (origin, patch, None),
                "view": (v_origin.contiguous(), v_bounds.contiguous(),
                         v_shift.contiguous())}.items():
            args = (data, o, res, bnd, verts, nv, t, shift)
            got = fpm.footprint_cost_batch(*args)
            want = fpm.footprint_cost_batch_plain(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"K3 B={B} R={R} V={V} S={S} ({plan} plan) {kind}: "
                    "differs from its plain version by "
                    f"{float((got - want).abs().max())}")
            cases += 1
        if (B, R, V, S) == K3_TIMED_GENERAL_S:
            for n in (S, 64):
                tn = fpm.edge_parameters(n, device)
                args = (data, origin, res, None, verts, nv, tn)
                report[f"general_S{n}" if n == S else "unrolled_S64"] = {
                    "shape": [B, R, V, n], **_k3_timed(
                        lambda: fpm.footprint_cost_batch(*args),
                        lambda: fpm.footprint_cost_batch_plain(*args),
                        kb.footprint_cost_work(*args),
                        "footprint_cost_kernel")}
        for name, shape in K3_TIMED_PLANS.items():
            if (B, R, V, S) == shape:
                if plan != name:
                    raise AssertionError(f"K3 {shape}: plan {plan}, not "
                                         f"{name}")
                args = (data, origin, res, None, verts, nv, t)
                report[f"plan_{name}"] = {"shape": list(shape), **_k3_timed(
                    lambda: fpm.footprint_cost_batch(*args),
                    lambda: fpm.footprint_cost_batch_plain(*args),
                    kb.footprint_cost_work(*args), "footprint_cost_kernel")}
        del data, verts, want, got
    calls = collections.Counter(fpm.footprint_cost_batch.plans)
    calls.subtract(plans)
    report["plans"] = {k: n for k, n in calls.items() if n}
    report["footprint_cost_max_abs_err"] = worst
    print(json.dumps({"phase": "K3 footprint_cost vs plain",
                      "tolerance": "exact (torch.equal)", "cases": cases,
                      "timed_at": "B=4096 R=21 S=16 full grid, synthetic; "
                      "plan_*: at their shapes, full grid",
                      "wide_cases": [list(c) for c in K3_WIDE_CASES],
                      "timing": TIMING, **report}),
          flush=True)
    return report


class K3Recorder:
    """While active, counts K3's launches by R and keeps a copy of the
    arguments of the first call for each (R, whole grid or bounds, shift or
    none, sampled or walk mode): it wraps `binding.launch_footprint_cost`,
    which the port looks up at every call, and restores it on exit."""

    def __init__(self):
        self.by_r = collections.Counter()
        self.args = {}

    def __enter__(self):
        from neo_mpc_planner2_tpu_torch.kernels import binding

        self._launch = binding.launch_footprint_cost

        def launch(*args, **kw):
            R, bounds, t, shift = (args[4].shape[1], args[3], args[6],
                                   args[7])
            self.by_r[R] += 1
            key = (R, bounds is None, shift is None, t is None)
            if key not in self.args:
                self.args[key] = tuple(
                    None if a is None else a.clone() for a in args)
            return self._launch(*args, **kw)

        binding.launch_footprint_cost = launch
        return self

    def __exit__(self, *exc):
        from neo_mpc_planner2_tpu_torch.kernels import binding

        binding.launch_footprint_cost = self._launch
        return False


def captured_k3_cases(recorder: K3Recorder, required=("wave", "gate"),
                      steps: int = 3) -> dict:
    """A slice's K3 calls to hold and time: label -> args. A walk-mode call
    is a "walk"; of the sampled calls, one with a shift reads through a
    view ("view"), one without bounds the whole grid ("gate"), one with
    bounds a patch: the gradient's R = control_steps polygons ("grad") or
    the wave's candidates, more ("wave")."""
    labels = {}
    for (R, whole, unshifted, walk), args in sorted(recorder.args.items()):
        name = ("walk" if walk else "view" if not unshifted
                else "gate" if whole else "wave" if R > steps else "grad")
        labels[f"{name}_R{R}"] = args
    for name in required:
        if not any(k.startswith(name) for k in labels):
            raise AssertionError(f"the slice made no {name} call of K3: "
                                 f"{sorted(recorder.args)}")
    return labels


def phase_k3_captured(recorder: K3Recorder, ticks: int,
                      slice_name: str = "product",
                      required=("wave", "gate")):
    """K3 on a slice's own inputs (hold_k3_captured), one line."""
    report = hold_k3_captured(recorder, required)
    per_tick = {f"R{R}": n / ticks for R, n in sorted(recorder.by_r.items())}
    print(json.dumps({"phase": f"K3 on the {slice_name} slice's inputs",
                      "tolerance": "exact (torch.equal)",
                      "launches_per_tick_by_R": per_tick,
                      "timing": TIMING, **report}), flush=True)
    return report


def hold_k3_captured(recorder: K3Recorder, required=("wave", "gate"),
                     steps: int = 3):
    """K3 on a path's own captured calls (at `steps` control steps):
    exactly equal to its plain version, timed, its bound from the cells
    these samples read."""
    import torch

    from neo_mpc_planner2_tpu_torch.kernels import bounds
    from neo_mpc_planner2_tpu_torch.ops import footprint as fpm

    report = {}
    for label, args in captured_k3_cases(recorder, required,
                                         steps).items():
        # The launcher's arguments: (data, origin, res, bounds, verts,
        # n_valid, t, shift), t None for the walk mode.
        t, shift = args[6], args[7]
        if t is None:
            args = args[:6] + (shift,)
            call, plain = (fpm.footprint_walk_batch,
                           fpm.footprint_walk_batch_plain)
            work, kernel = bounds.footprint_walk_work(*args), "walk"
        else:
            call, plain = (fpm.footprint_cost_batch,
                           fpm.footprint_cost_batch_plain)
            work, kernel = bounds.footprint_cost_work(*args), "cost"
        got = call(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K3 on the captured {label} call differs "
                                 "from its plain version by "
                                 f"{float((got - want).abs().max())}")
        ms = _device_ms(lambda: call(*args), f"footprint_{kernel}_kernel")
        report[label] = {
            "shape": list(args[4].shape),
            "S": None if t is None else int(t.shape[0]),
            "bounds": args[3] is not None, "shift": shift is not None,
            "ms": ms, "plain_ms": _time_ms(lambda: plain(*args)),
            "bound_ms": work["bound_ms"], "bound_by": work["bound_by"],
            "share_of_bound": work["bound_ms"] / ms,
            **{k: work[k] for k in ("samples", "steps", "edges", "cells",
                                    "bytes", "ops") if k in work}}
    return report


def fleet_cfg():
    """fleet_config() with the fleet benchmark's overrides: the port's
    bench module's (`bench.fleet_cfg`, bench.py's headline point)."""
    from neo_mpc_planner2_tpu_torch import bench

    return bench.fleet_cfg()


def product_cfg(base=None):
    """The product-SQP point of the benchmark (`bench.product_cfg`) on the
    fleet overrides (or on `base`): quirks off, the candidate-wave line
    search, no quadratic interpolation, and the patch sampler sized for the
    MPO-700 footprint (0.46 m circumradius; 28 cells at 0.05 m at the
    fleet point's horizon)."""
    from neo_mpc_planner2_tpu_torch import bench

    return bench.product_cfg(fleet_cfg() if base is None else base)


def exact_cfg():
    """The fleet point in exact footprint mode: every footprint cost (the
    pursuit gate, the parity term, the post-solve check) walks the cells
    its edges cross (K3's walk mode)."""
    return fleet_cfg().replace(footprint_exact=True)


def _wrappers():
    """Each wrapper that counts its kernel's launches, by the name the
    phase lines give it: K1, K2, K3's sampled mode and K3's walk mode
    (`bench.kernel_wrappers`)."""
    from neo_mpc_planner2_tpu_torch import bench

    return bench.kernel_wrappers()


def _launch_counts():
    """Each wrapper's launches by its name, and K3's by launch plan as
    "footprint_cost:<plan>" / "footprint_walk:<plan>"
    (`bench.kernel_launches`)."""
    from neo_mpc_planner2_tpu_torch import bench

    return bench.kernel_launches()


def _reset_launch_counts():
    for fn in _wrappers().values():
        fn.launches = 0
        if hasattr(fn, "plans"):
            fn.plans.clear()


def prox_solver(cfg):
    """The prox slice's solver (`bench.prox_solver`): prox-FISTA on the
    smooth objective."""
    from neo_mpc_planner2_tpu_torch import bench

    return bench.prox_solver(cfg)


# The live maps of bench.py's deployment regimes (bench.py:276-378), each
# on the fleet point: the scenario seed and map side, and
#   rolling: the window's side over a 2x world map;
#   dynamic / updates: the obstacles' generator seed and count a lane (the
#   updates regime moves one obstacle a lane) and the update block's side.
LIVE_MAPS = {
    "rolling": dict(seed=2, map_size=128, window_cells=64),
    "dynamic": dict(seed=0, map_size=64, obstacle_seed=3, obstacles=6),
    "updates": dict(seed=0, map_size=64, obstacle_seed=4, obstacles=1,
                    update_cells=16),
}

# Each slice: (config, parity, its solver or None for the SQP, the kernels
# its closed loop must launch). A slice named in LIVE_MAPS runs on that
# live map, the others on static 64x64 maps.
SLICES = {
    "fleet": (fleet_cfg, True, None, ("qp_admm", "footprint_cost")),
    "product": (product_cfg, False, None, ("qp_admm", "footprint_cost")),
    "prox": (product_cfg, False, prox_solver, ("footprint_cost",)),
    "rolling": (fleet_cfg, True, None, ("qp_admm", "footprint_cost")),
    "dynamic": (fleet_cfg, True, None, ("qp_admm", "footprint_cost")),
    "updates": (fleet_cfg, True, None, ("qp_admm", "footprint_cost")),
    "exact": (exact_cfg, True, None, ("qp_admm", "footprint_walk")),
}


def obstacles(name: str, batch: int, device):
    """A live map's moving obstacles (`bench.obstacles` on the slice's
    map): (B, 6, ...) for the dynamic map, (B, ...) for the updates (one
    obstacle a lane)."""
    from neo_mpc_planner2_tpu_torch import bench

    return bench.obstacles(name, batch, LIVE_MAPS[name]["map_size"], device)


def slice_inputs(name: str, batch: int, device, seed: int | None = None):
    """A slice's config, scenario batch and batch_simulate arguments.
    seed: the scenario seed in place of the slice's own."""
    from neo_mpc_planner2_tpu_torch.scenarios import make_scenario_batch

    make_cfg, parity, make_solver, _ = SLICES[name]
    cfg = make_cfg()
    run = dict(parity=parity, solver_batch=None if make_solver is None
               else make_solver(cfg))
    live = LIVE_MAPS.get(name, dict(seed=0, map_size=64))
    sb = make_scenario_batch(cfg, batch,
                             seed=live["seed"] if seed is None else seed,
                             map_size=live["map_size"], plan_points=64,
                             maps_on_device=True, device=device)
    if name == "rolling":
        run.update(window_cells=live["window_cells"])
    elif name == "dynamic":
        run.update(dynamic_obstacles=obstacles(name, batch, device))
    elif name == "updates":
        run.update(costmap_updates=obstacles(name, batch, device),
                   update_cells=live["update_cells"])
    return cfg, sb, run


def phase_slice(device, smi: str, name: str, batch: int = 4096,
                ticks: int = SLICE_TICKS,
                recorder: "K3Recorder | None" = None):
    """One slice's closed loop: a warm-up run of WARM_TICKS (K3's calls
    recorded there when a recorder is given), then a timed run with the
    launch counts set to 0 just before it and read just after."""
    import contextlib

    import torch

    from neo_mpc_planner2_tpu_torch.simulation import batch_simulate

    required = SLICES[name][3]
    cfg, sb, run = slice_inputs(name, batch, device)
    with recorder if recorder is not None else contextlib.nullcontext():
        batch_simulate(cfg, sb, WARM_TICKS, **run)         # warm-up
    torch.cuda.synchronize()
    _reset_launch_counts()
    t0 = time.perf_counter()
    res = batch_simulate(cfg, sb, ticks, **run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()

    cmds = res.cmds
    if not bool(torch.isfinite(cmds).all()):
        raise AssertionError(f"{name}: non-finite commands")
    speed = torch.linalg.vector_norm(cmds[..., :2], dim=-1)
    if float(speed.max()) > cfg.max_vel_trans + 1e-5:
        raise AssertionError(f"{name}: |cmd_xy| {float(speed.max())} above "
                             f"max_vel_trans {cfg.max_vel_trans}")
    for kernel in required:
        if launches[kernel] <= 0:
            raise AssertionError(f"{name}: {kernel} was never launched")
    out = {"phase": f"{name} slice", "batch": batch, "ticks": ticks,
           "map": sb.costmap.data.shape[-1], "live_map": LIVE_MAPS.get(name),
           "control_steps": cfg.control_steps,
           "wall_s": wall, "solves_per_s": batch * ticks / wall,
           "launches": launches,
           "goal_reached_frac": float((res.goal_dist[:, -1] < 0.10)
                                      .float().mean()),
           "final_dist_p50": float(res.goal_dist[:, -1].median()),
           "converged_frac": float(res.converged.float().mean()),
           "mean_solver_iters": float(res.solver_iters.float().mean()),
           "lethal_frac": float(res.lethal.float().mean()),
           "collision_frac": float(res.collisions.float().mean()),
           "card": smi}
    print(json.dumps(out), flush=True)
    return out


def phase_map_refresh(device, smi: str, batch: int = 4096) -> dict:
    """Each live map's refresh a tick on its slice's own inputs (the first
    tick's): its device time (every kernel summed, torch.profiler, mean of
    20), one call between CUDA events, and its CUDA launches (the host's
    launch calls of one call, count_launches). rolling: the view (and, beside
    it, the materialized window the view replaces, flattened); dynamic: the
    re-synthesized, flattened map; updates: the block's synthesis and its
    write into a carried map."""
    from neo_mpc_planner2_tpu_torch.ops.costmap import write_window_
    from neo_mpc_planner2_tpu_torch.simulation import (
        dynamic_obstacle_map, obstacle_update, rolling_view, rolling_window)

    report = {}
    for name in LIVE_MAPS:
        cfg, sb, run = slice_inputs(name, batch, device)
        dt = cfg.control_interval
        world = sb.costmap.with_flat()
        if name == "rolling":
            cells = run["window_cells"]
            calls = {"view": lambda: rolling_view(world, sb.robot_pose,
                                                  cells),
                     "materialized": lambda: rolling_window(
                         world, sb.robot_pose, cells).with_flat()}
        elif name == "dynamic":
            calls = {"synthesis": lambda: dynamic_obstacle_map(
                sb.costmap, run["dynamic_obstacles"], 0, dt)}
        else:
            carry = world.replace(data=world.data.clone()).with_flat()
            cells = run["update_cells"]

            def paint():
                block, lo = obstacle_update(carry, world.data,
                                            run["costmap_updates"], 0, dt,
                                            cells)
                write_window_(carry, block, lo)

            calls = {"synthesis_and_write": paint}
        for what, fn in calls.items():
            out = {"phase": f"{name} slice: map refresh a tick",
                   "what": what, "batch": batch,
                   "device_ms": _device_total_ms(fn),
                   "wall_ms": _time_ms(fn),
                   "launches": count_launches(fn)["launches"], "card": smi}
            report[f"{name}_{what}"] = out
            print(json.dumps(out), flush=True)
    return report


def phase_launches_per_tick(device, slices: dict, batch: int = 4096) -> dict:
    """Each slice's run again under torch.profiler, over the ticks
    LAUNCH_TICKS[slice] = (first, n): `first` ticks unprofiled, then n
    ticks on from where they stopped. Per tick: the CUDA launches (host API
    calls), the device kernels, the device's busy time and each
    hand-written kernel's device time; and the device's idle share, one
    less the busy time over a tick's wall time in the slice's timed run
    (slices: name -> that slice phase's output). Last, because after a
    trace this long the profiler may drop records of a short one."""
    from neo_mpc_planner2_tpu_torch.simulation import batch_simulate

    out = {"phase": "CUDA launches a tick", "batch": batch,
           "ticks": LAUNCH_TICKS}
    for name in SLICES:
        first, ticks = LAUNCH_TICKS[name]
        cfg, sb, run = slice_inputs(name, batch, device)
        init = None
        if first:
            head = batch_simulate(cfg, sb, first, **run)
            init = (head.final_state, head.poses[:, -1], head.cmds[:, -1])
        p = profile_run(lambda: batch_simulate(cfg, sb, ticks, init=init,
                                               **run))
        busy = p["device_ms"] / ticks
        wall = 1e3 * slices[name]["wall_s"] / slices[name]["ticks"]
        out[name] = {"cuda_launches_per_tick": p["launches"] / ticks,
                     "device_kernels_per_tick": p["kernels"] / ticks,
                     "device_busy_ms_per_tick": busy,
                     "kernel_ms_per_tick": {k: v / ticks for k, v in
                                            p["kernel_ms"].items()},
                     "timed_run_wall_ms_per_tick": wall,
                     "device_idle_share": 1.0 - busy / wall}
    print(json.dumps(out), flush=True)
    return out


def phase_card_vs_cpu(device, name: str, lanes: int = 256, cfg=None,
                      label: str | None = None):
    """The slice's first tick on the card against the same tick on the CPU
    (plain versions), through batch_simulate: on a live map the tick reads
    the view, the re-synthesized map or the map after its first update. At
    least 99 % of lanes within 1e-3 (a 1-ulp tie in f may move a lane's
    termination by one iteration). cfg: a config in place of the slice's
    (an arm's), reported under `label`."""
    from neo_mpc_planner2_tpu_torch.simulation import batch_simulate
    from neo_mpc_planner2_tpu_torch.tree import tree_map

    cfg0, sb, run = slice_inputs(name, lanes, device, seed=1)
    cfg = cfg0 if cfg is None else cfg
    name = name if label is None else label
    gpu = batch_simulate(cfg, sb, 1, **run).cmds[:, 0].cpu()
    to_cpu = lambda t: t.cpu()
    cpu = batch_simulate(cfg, tree_map(to_cpu, sb), 1,
                         **tree_map(to_cpu, run)).cmds[:, 0]
    diff = (gpu - cpu).abs().amax(-1)
    frac = float((diff <= 1e-3).float().mean())
    out = {"phase": f"{name} slice: card vs cpu, one step", "lanes": lanes,
           "max_cmd_diff": float(diff.max()), "frac_within_1e-3": frac}
    print(json.dumps(out), flush=True)
    if frac < 0.99:
        raise AssertionError(f"{name} card vs CPU: only {frac:.4f} of lanes "
                             "within 1e-3")
    return out


# The SQP's schedules at the fleet point, each arm a config:
# lockstep-tail compaction off (the slice's config), adaptive, and fixed
# after 3 iterations; the K-wide wave at K = 1, 2, 4 (quadratic
# interpolation off: a wave refuses it). Each group runs in turns (A B C C
# B A), SLICE_TICKS a run; its launches a tick are profiled over
# ARM_PROFILE = (first tick, ticks) with the slices, at the end.
COMPACT_ARMS = {
    "compact_plain": lambda: fleet_cfg(),
    "compact_adaptive": lambda: fleet_cfg().replace(
        solver_compact_adaptive=True),
    "compact_fixed": lambda: fleet_cfg().replace(solver_compact_after=3),
}
WAVE_ARMS = {
    f"wave_K{k}": (lambda k=k: fleet_cfg().replace(
        solver_ls_quad_interp=False, solver_ls_wave=k))
    for k in (1, 2, 4)}
ARM_PROFILE = (2, 1)


class TripCounter:
    """The SQP's objective, counting its calls without autograd: the line
    search's merit evaluations, one a trip (the gradient's calls run with
    autograd on)."""

    def __init__(self, objective):
        self.objective = objective
        self.parity = objective.parity
        self.trips = 0

    def __call__(self, *args, **kw):
        import torch

        if not torch.is_grad_enabled():
            self.trips += 1
        return self.objective(*args, **kw)


class SolveRecorder:
    """While active, counts the batched solves of `batch` lanes and keeps
    the size of each sub-batch that lockstep-tail compaction finishes: both
    build their SQP machinery through `sqp._make_sqp`, which the batched
    front end looks up at every solve, at the full batch or at the alive
    lanes' count. Restores it on exit."""

    def __init__(self, batch: int):
        self.batch = batch
        self.solves = 0
        self.sub = []

    def __enter__(self):
        from neo_mpc_planner2_tpu_torch import sqp

        self._make = sqp._make_sqp

        def make(f, cfg, batch, *args, **kw):
            if batch < self.batch:
                self.sub.append(batch)
            else:
                self.solves += 1
            return self._make(f, cfg, batch, *args, **kw)

        sqp._make_sqp = make
        return self

    def __exit__(self, *exc):
        from neo_mpc_planner2_tpu_torch import sqp

        sqp._make_sqp = self._make
        return False


def arm_inputs(make_cfg, batch: int, device):
    """An arm's config, its counted objective, the fleet slice's scenario
    batch and the batch_simulate arguments with the arm's solver."""
    from neo_mpc_planner2_tpu_torch.ops.objective import make_objective
    from neo_mpc_planner2_tpu_torch.sqp import make_sqp_solver_batched

    _, sb, run = slice_inputs("fleet", batch, device)
    cfg = make_cfg()
    obj = TripCounter(make_objective(cfg, parity=True))
    return cfg, obj, sb, dict(run, solver_batch=make_sqp_solver_batched(
        cfg, obj))


def phase_arms(device, smi: str, arms: dict, label: str,
               batch: int = 4096, ticks: int = SLICE_TICKS) -> dict:
    """A group of arms at the fleet point: per arm a warm-up run of
    WARM_TICKS (K1's calls recorded), then two timed runs in turns (A B C C
    B A), the launch counts set to 0 just before each and read just after.
    Per arm: solves/s (each run, and their median), the kernels' launches,
    the batched solves and the compact branch's sub-batches (their count and
    sizes), line-search trips a solve, and the largest command difference
    from the group's first arm; K1 on the largest sub-batch call recorded
    in the warm-up (where the compact branch ran), held against its plain
    version and timed."""
    import torch

    from neo_mpc_planner2_tpu_torch.simulation import batch_simulate

    runs = {}
    for name, make_cfg in arms.items():
        cfg, obj, sb, run = arm_inputs(make_cfg, batch, device)
        with K1Recorder() as rec:
            batch_simulate(cfg, sb, WARM_TICKS, **run)
        sub = {k: v for k, v in rec.args.items() if k[0] < batch}
        runs[name] = dict(cfg=cfg, obj=obj, sb=sb, run=run, walls=[],
                          solves=0, sub=[], trips=0, sub_k1=sub,
                          launches=collections.Counter())
    first = next(iter(arms))
    for name in list(arms) + list(reversed(arms)):
        r = runs[name]
        torch.cuda.synchronize()
        r["obj"].trips = 0
        _reset_launch_counts()
        with SolveRecorder(batch) as solves:
            t0 = time.perf_counter()
            res = batch_simulate(r["cfg"], r["sb"], ticks, **r["run"])
            torch.cuda.synchronize()
            r["walls"].append(time.perf_counter() - t0)
        r["launches"].update(_launch_counts())
        r["solves"] += solves.solves
        r["sub"] += solves.sub
        r["trips"] += r["obj"].trips
        r["cmds"] = res.cmds
        r["res"] = res
        if not bool(torch.isfinite(res.cmds).all()):
            raise AssertionError(f"{name}: non-finite commands")
    report = {}
    for name, r in runs.items():
        for kernel in ("qp_admm", "footprint_cost"):
            if r["launches"][kernel] <= 0:
                raise AssertionError(f"{name}: {kernel} was never launched")
        k1 = None
        if r["sub_k1"]:
            rec = K1Recorder()
            rec.args = dict([max(r["sub_k1"].items())])
            k1 = phase_k1_captured(rec, f"{name} sub-batch")
        res = r["res"]
        diff = float((r["cmds"] - runs[first]["cmds"]).abs().max())
        out = {"phase": f"{label}: {name}", "batch": batch, "ticks": ticks,
               "runs": len(r["walls"]),
               "solves_per_s": [batch * ticks / w for w in r["walls"]],
               "solves_per_s_median": batch * ticks
               / statistics.median(r["walls"]),
               "wall_ms_per_tick": 1e3 * statistics.median(r["walls"])
               / ticks,
               "launches": dict(r["launches"]),
               "batched_solves": r["solves"],
               "compact_solves": len(r["sub"]),
               "sub_batch_lanes": ({"min": min(r["sub"]),
                                    "median": statistics.median(r["sub"]),
                                    "max": max(r["sub"])}
                                   if r["sub"] else None),
               "ls_trips_per_solve": r["trips"] / max(r["solves"], 1),
               "converged_frac": float(res.converged.float().mean()),
               "mean_solver_iters": float(res.solver_iters.float().mean()),
               f"max_cmd_diff_vs_{first}": diff,
               "k1_sub_batch": k1, "card": smi}
        print(json.dumps(out), flush=True)
        report[name] = dict(out, ticks=ticks * len(r["walls"]))
    return report


def phase_arm_launches(device, arms: dict, batch: int = 4096) -> dict:
    """Each arm again under torch.profiler over ARM_PROFILE = (first, n):
    `first` ticks unprofiled, then n: CUDA launches, host syncs
    (cudaStreamSynchronize) and device busy ms a tick, each kernel's device
    ms a tick, and the device's idle share against the arm's timed wall
    (arms: name -> that arm's phase_arms output)."""
    from neo_mpc_planner2_tpu_torch.simulation import batch_simulate

    first, ticks = ARM_PROFILE
    out = {"phase": "CUDA launches a tick: SQP schedules", "batch": batch,
           "ticks": ARM_PROFILE}
    makers = {**COMPACT_ARMS, **WAVE_ARMS}
    for name in arms:
        cfg, _, sb, run = arm_inputs(makers[name], batch, device)
        head = batch_simulate(cfg, sb, first, **run)
        init = (head.final_state, head.poses[:, -1], head.cmds[:, -1])
        p = profile_run(lambda: batch_simulate(cfg, sb, ticks, init=init,
                                               **run))
        busy = p["device_ms"] / ticks
        wall = arms[name]["wall_ms_per_tick"]
        out[name] = {"cuda_launches_per_tick": p["launches"] / ticks,
                     "host_syncs_per_tick": p["syncs"] / ticks,
                     "device_busy_ms_per_tick": busy,
                     "kernel_ms_per_tick": {k: v / ticks for k, v in
                                            p["kernel_ms"].items()},
                     "timed_run_wall_ms_per_tick": wall,
                     "device_idle_share": 1.0 - busy / wall}
    print(json.dumps(out), flush=True)
    return out


# The horizons phase: (control_steps, prediction_horizon) pairs of the
# JAX package's horizon tests (tests/test_horizons.py:14) and 12, the first
# horizon past one warp's team (K1's warp-lane design); the product
# point's horizon; the rows of the first tick held against the CPU.
HORIZONS = ((1, 0.3), (5, 1.0), (8, 1.6), (12, 2.4))
HORIZON_PRODUCT = (5, 1.0)
HORIZON_CPU_LANES = 64
HORIZON_PROFILE_TICKS = 1


def horizon_cfg(steps: int, horizon: float):
    """The fleet point at another horizon."""
    return fleet_cfg().replace(control_steps=steps,
                               prediction_horizon=horizon)


def horizon_oracle_cfg():
    """The JAX package's test config (tests/conftest.py's `cfg`): the
    README sample's values, 8 edge samples, no footprint term."""
    import neo_mpc_planner2_tpu_torch as tp

    return tp.default_config().replace(
        prediction_horizon=0.8, control_steps=3, opt_tolerance=1e-3,
        footprint_edge_samples=8, acc_x_limit=2.5, acc_y_limit=2.5,
        acc_theta_limit=3.0, min_vel_x=-0.7, min_vel_y=-0.7,
        min_vel_theta=-0.7, max_vel_x=0.7, max_vel_y=0.7, max_vel_trans=0.7,
        max_vel_theta=0.7, w_trans=0.82, w_orient=0.5, w_control=0.05,
        w_terminal=0.05, w_costmap=0.05, w_footprint=0.0,
        lookahead_dist_min=0.4, lookahead_dist_max=0.4,
        lookahead_dist_close_to_goal=0.4)


def _horizon_loop(device, smi: str, cfg, name: str, parity: bool,
                  batch: int, recorder):
    """One closed loop at the fleet point's size: a warm-up run of
    WARM_TICKS under `recorder` (K1's or K3's calls captured there) and a
    timed run of SLICE_TICKS with the launch counts set to 0 just before
    it and read just after. -> (its line, its scenarios, its first tick's
    commands, a function that profiles HORIZON_PROFILE_TICKS more ticks
    from where it stopped and returns their per-tick numbers)."""
    import torch

    from neo_mpc_planner2_tpu_torch.scenarios import make_scenario_batch
    from neo_mpc_planner2_tpu_torch.simulation import batch_simulate

    sb = make_scenario_batch(cfg, batch, seed=0, map_size=64,
                             plan_points=64, maps_on_device=True,
                             device=device)
    with recorder:
        batch_simulate(cfg, sb, WARM_TICKS, parity=parity)
    torch.cuda.synchronize()
    _reset_launch_counts()
    t0 = time.perf_counter()
    res = batch_simulate(cfg, sb, SLICE_TICKS, parity=parity)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    cmds = res.cmds
    if not bool(torch.isfinite(cmds).all()):
        raise AssertionError(f"{name}: non-finite commands")
    speed = torch.linalg.vector_norm(cmds[..., :2], dim=-1)
    if float(speed.max()) > cfg.max_vel_trans + 1e-5:
        raise AssertionError(f"{name}: |cmd_xy| {float(speed.max())} above "
                             f"max_vel_trans {cfg.max_vel_trans}")
    if res.final_state.initial_guess.shape != (batch,
                                               3 * cfg.control_steps):
        raise AssertionError(f"{name}: carried guess of shape "
                             f"{tuple(res.final_state.initial_guess.shape)}")
    for kernel in ("qp_admm", "footprint_cost"):
        if launches[kernel] <= 0:
            raise AssertionError(f"{name}: {kernel} was never launched")
    init = (res.final_state, res.poses[:, -1], res.cmds[:, -1])
    tick_wall = 1e3 * wall / SLICE_TICKS
    out = {"batch": batch, "ticks": SLICE_TICKS,
           "control_steps": cfg.control_steps,
           "prediction_horizon": cfg.prediction_horizon,
           "m": 3 * cfg.control_steps, "wall_s": wall,
           "solves_per_s": batch * SLICE_TICKS / wall,
           "launches": launches,
           "converged_frac": float(res.converged.float().mean()),
           "mean_solver_iters": float(res.solver_iters.float().mean()),
           "timed_run_wall_ms_per_tick": tick_wall, "card": smi}

    def profile() -> dict:
        ticks = HORIZON_PROFILE_TICKS
        prof = profile_run(lambda: batch_simulate(cfg, sb, ticks, init=init,
                                                  parity=parity))
        busy = prof["device_ms"] / ticks
        return {"profiled_ticks": ticks,
                "cuda_launches_per_tick": prof["launches"] / ticks,
                "device_busy_ms_per_tick": busy,
                "kernel_ms_per_tick": {k: v / ticks for k, v in
                                       prof["kernel_ms"].items()},
                "device_idle_share": 1.0 - busy / tick_wall}

    return out, sb, cmds[:, 0], profile


def _horizon_card_vs_cpu(cfg, sb, card_tick, lanes: int,
                         parity: bool = True) -> dict:
    """The loop's first tick on the card (its first `lanes` lanes) against
    the same tick on the CPU: at least 99 % of lanes within 1e-3."""
    from neo_mpc_planner2_tpu_torch.simulation import batch_simulate
    from neo_mpc_planner2_tpu_torch.tree import tree_map

    head = tree_map(lambda t: t[:lanes].cpu(), sb)
    cpu = batch_simulate(cfg, head, 1, parity=parity).cmds[:, 0]
    diff = (card_tick[:lanes].cpu() - cpu).abs().amax(-1)
    frac = float((diff <= 1e-3).float().mean())
    if frac < 0.99:
        raise AssertionError(f"control_steps {cfg.control_steps} card vs "
                             f"CPU: only {frac:.4f} of lanes within 1e-3")
    return {"lanes": lanes, "max_cmd_diff": float(diff.max()),
            "frac_within_1e-3": frac}


def _horizon_oracle(device) -> dict:
    """tests/test_horizons.py:14's three cases on the card: the port's
    make_sqp_solver at ftol 1e-8 and 300 iterations (batch 1, K1 on the
    card) against its scipy oracle on the host. Its criteria: objective
    gap < 1e-4, and x within 1e-2 or the gap < 2e-6."""
    import numpy as np
    import torch

    import neo_mpc_planner2_tpu_torch as tp
    from neo_mpc_planner2_tpu_torch import oracle
    from neo_mpc_planner2_tpu_torch.ops.objective import Scenario

    fp = np.array([[0.3, 0.2], [-0.3, 0.2], [-0.3, -0.2], [0.3, -0.2]])
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    out = {}
    for steps, horizon in HORIZONS[:3]:
        cfg = horizon_oracle_cfg().replace(
            control_steps=steps, prediction_horizon=horizon,
            opt_tolerance=1e-8)
        scen = Scenario(
            current_pose=f32([0, 0, 0]), carrot_pose=f32([0.4, 0.1, 0.2]),
            goal_pose=f32([1.0, 0.5, 0.3]), current_vel=f32([0.3, 0, 0]),
            footprint=tp.Footprint.rectangle(0.6, 0.4, device=device),
            costmap=tp.Costmap.create(np.zeros((40, 40)),
                                      origin=(-1.0, -1.0), resolution=0.05,
                                      device=device),
            switch_opt=torch.tensor(False, device=device))
        solve = tp.make_sqp_solver(cfg, tp.make_objective(cfg), ftol=1e-8,
                                   max_iters=300)
        before = _launch_counts()["qp_admm"]
        res = solve(torch.zeros(3 * steps, device=device), scen)
        x = res.x.cpu().numpy()
        if _launch_counts()["qp_admm"] <= before:
            raise AssertionError(f"oracle at {steps} steps: no K1 launch")
        npcm = oracle.NpCostmap(np.zeros((40, 40)), np.array([-1.0, -1.0]),
                                0.05)
        nps = oracle.NpScenario(np.zeros(3), np.array([0.4, 0.1, 0.2]),
                                np.array([1.0, 0.5, 0.3]),
                                np.array([0.3, 0, 0]), fp, npcm)
        _, diag = oracle.OracleServer(cfg).solve(nps, 0.033)
        gap = float(res.fun) - diag["fun"]
        dx = float(np.abs(diag["raw"] - x).max())
        ok = gap < 1e-4 and (dx < 1e-2 or gap < 2e-6)
        out[f"steps_{steps}"] = {"gap": gap, "dx": dx,
                                 "iters": int(res.iters), "passed": ok}
        if not ok:
            raise AssertionError(f"oracle at {steps} steps: gap {gap:.3g}, "
                                 f"dx {dx:.3g}")
    return out


def _horizon_server(device, fleet: int, lanes: int) -> dict:
    """A session on the card answers across a `configure` of control_steps
    5 and back to 3: `optimizer` for one robot, `optimizer_batch` at
    `fleet` robots at 5 steps, `optimizer` again at 3. The same script on a
    CPU session (its batch cut to the first `lanes` robots, which are
    independent of the rest) answers each one-robot request within 1e-3,
    with the same flags, and the batch's first `lanes` robots within 1e-3
    on at least 99 % of them."""
    import numpy as np

    from neo_mpc_planner2_tpu_torch.serving import OptimizerSession

    traffic = serving_traffic(fleet)
    robot = {"op": "optimizer", **traffic["robots"][0],
             "control_interval": 1 / 30, "delta_t": 1 / 30}

    def script(n):
        return [{"op": "configure", "params": _fleet_params()},
                traffic["costmap"], traffic["footprint"], robot,
                {"op": "configure", "params": {"control_steps": 5}}, robot,
                {"op": "optimizer_batch", "robots": traffic["robots"][:n],
                 "control_interval": 1 / 30, "delta_t": 1 / 30},
                {"op": "configure", "params": {"control_steps": 3}}, robot]

    def answers(dev, n):
        session = OptimizerSession(device=dev)
        return [_call(session, msg) for msg in script(n)]

    card, cpu = answers(device, fleet), answers("cpu", lanes)
    one = [3, 5, 8]
    flags = ("collision", "collision_footprint", "lethal", "plan_empty")
    diffs = [float(np.abs(np.subtract(card[i]["output_vel"],
                                      cpu[i]["output_vel"])).max())
             for i in one]
    same_flags = all(card[i].get(k) == cpu[i].get(k) for i in one
                     for k in flags)
    batch = [float(np.abs(np.subtract(x["output_vel"],
                                      y["output_vel"])).max())
             for x, y in zip(card[6]["results"][:lanes],
                             cpu[6]["results"])]
    frac = float(np.mean(np.asarray(batch) <= 1e-3))
    if len(card[6]["results"]) != fleet:
        raise AssertionError(f"optimizer_batch answered "
                             f"{len(card[6]['results'])} of {fleet} robots")
    if max(diffs) > 1e-3 or not same_flags or frac < 0.99:
        raise AssertionError(f"server across control_steps 5: one-robot "
                             f"diffs {diffs}, flags equal {same_flags}, "
                             f"batch {frac:.4f} within 1e-3")
    return {"robots": fleet, "one_robot_diffs": diffs,
            "flags_equal": same_flags, "batch_lanes_checked": lanes,
            "batch_frac_within_1e-3": frac,
            "batch_max_diff": max(batch)}


def phase_horizons(device, smi: str, batch: int = 4096) -> dict:
    """The slice at other horizons, on the card:
    (a) the fleet closed loop at each of HORIZONS (4096 lanes, 64x64 maps,
        seed 0; WARM_TICKS, then SLICE_TICKS timed): solves/s, converged
        fraction, mean iterations, K1's launches a tick; K1's first call
        held against its plain version (rtol 2e-4 / atol 2e-5), timed, its
        share of bound; the first tick against the CPU on the first
        HORIZON_CPU_LANES lanes (>= 99 % within 1e-3);
    (b) the product closed loop at HORIZON_PRODUCT (K3's wave at R = 7n
        and its gradient calls at R = n), K3 held exactly against its plain
        version on its captured calls;
    (c) tests/test_horizons.py's three oracle cases, the solve on the card;
    (d) a server session across a configure of control_steps 5 and back;
    then, after every timing (a short trace after a long one may lose
    records), torch.profiler over HORIZON_PROFILE_TICKS ticks of each loop:
    CUDA launches, device busy ms and idle share, K1's device ms a tick.
    One line for each loop and one for the phase with its wall time.
    Returns each loop's line (its timed run's launches) by name."""
    from neo_mpc_planner2_tpu_torch.kernels import binding, bounds

    t0 = time.perf_counter()
    loops, profiles = {}, {}
    for steps, horizon in HORIZONS:
        cfg = horizon_cfg(steps, horizon)
        name = f"horizon_{steps}"
        rec = K1Recorder()
        out, sb, first, profiles[name] = _horizon_loop(
            device, smi, cfg, name, True, batch, rec)
        m = 3 * steps
        # Compaction is off at the fleet point: every K1 call of the loop
        # is at (batch, m).
        k1 = phase_k1_captured(rec, name)[f"B{batch}_m{m}"]
        out.update(
            k1_variant=binding.qp_admm_variant(m),
            k1_launches_per_tick=out["launches"]["qp_admm"] / SLICE_TICKS,
            k1_first_call=k1,
            k1_bound_ms_per_call=bounds.qp_admm_work(
                batch, m, cfg.qp_iters)["bound_ms"],
            card_vs_cpu=_horizon_card_vs_cpu(cfg, sb, first,
                                             HORIZON_CPU_LANES))
        loops[name] = {"phase": "horizons: fleet closed loop at "
                       f"control_steps {steps}", **out}
    steps, horizon = HORIZON_PRODUCT
    cfg = product_cfg(horizon_cfg(steps, horizon))
    name = f"horizon_product_{steps}"
    rec = K3Recorder()
    out, _, _, profiles[name] = _horizon_loop(device, smi, cfg, name, False,
                                              batch, rec)
    out["k3_captured"] = hold_k3_captured(rec, ("wave", "grad", "gate"),
                                          steps)
    out["k3_launches_per_warm_tick_by_R"] = {
        f"R{R}": n / WARM_TICKS for R, n in sorted(rec.by_r.items())}
    loops[name] = {"phase": "horizons: product closed loop at "
                   f"control_steps {steps}",
                   "k3_tolerance": "exact (torch.equal)", **out}
    oracle_cases = _horizon_oracle(device)
    server = _horizon_server(device, batch, HORIZON_CPU_LANES)
    for name, line in loops.items():
        line.update(profiles[name]())
        if "k1_first_call" in line:
            line["k1_device_ms_per_tick"] = line["kernel_ms_per_tick"][
                "qp_admm"]
        print(json.dumps(line), flush=True)
    wall = time.perf_counter() - t0
    print(json.dumps({"phase": "horizons", "wall_s": wall,
                      "oracle_other_horizons": oracle_cases,
                      "server_across_control_steps_5": server,
                      "card": smi}), flush=True)
    return loops


def phase_oracle(device, smi: str, n: int = 64) -> dict:
    """The north-star gate on the card: the MPO-700 suite of
    tests/test_mpo700_suite.py (n scenarios, seed 123) through the port's
    batched pursuit and solve on the card, against the port's scipy oracle
    on the host (parity.run_suite). Passes at a matched fraction >= 0.9
    (1e-2 m/s) with the worst objective gap < 5e-4 over at least 3n/4
    checked scenarios (48 of 64, as the JAX test asks); K1 and K3 must
    have run."""
    from neo_mpc_planner2_tpu_torch import parity

    _reset_launch_counts()
    t0 = time.perf_counter()
    rep = parity.run_suite(parity.suite_config(), n, seed=123, device=device)
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    out = {"phase": "oracle gate: MPO-700 suite, the solve on the card",
           "n": n, **rep, "wall_s": wall, "launches": launches,
           "gate": {"match_tol": parity.MATCH_TOL,
                    "frac": parity.MATCH_FRAC_GATE,
                    "gap": parity.UNMATCHED_GAP_TOL,
                    "checked_min": 3 * n // 4},
           "card": smi}
    print(json.dumps(out), flush=True)
    if not rep["passed"] or rep["checked"] < 3 * n // 4:
        raise AssertionError(f"the MPO-700 gate failed: {rep}")
    for kernel in ("qp_admm", "footprint_cost"):
        if launches[kernel] <= 0:
            raise AssertionError(f"oracle gate: {kernel} was never launched")
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def phase_sharded(device, smi: str, batch: int = 4096,
                  ticks: int = 5) -> dict:
    """The sharded engine over a world of the visible cards. With one card:
    a world of one in this process (NCCL at tcp://127.0.0.1), ShardedEngine
    stepping the fleet slice's batch `ticks` times with the launch counts
    set to 0 just before and read just after; each tick's commands equal to
    MpcEngine.batch_step's on the same inputs and its metrics equal to the
    same reductions taken locally; the metrics' wall with its all-reduces
    and without them, per step. With more cards: one process a card
    (`neo_mpc_planner2_tpu_torch.parallel.smoke`), every rank's metrics
    equal. Then the checkpoint of the state after tick 1
    (`_sharded_checkpoint`)."""
    import tempfile

    import torch
    import torch.distributed as dist

    import neo_mpc_planner2_tpu_torch as tp
    from neo_mpc_planner2_tpu_torch.parallel import sharding

    world = torch.cuda.device_count()
    if world > 1:
        return _sharded_processes(smi, world, batch, ticks)
    sharding.initialize_distributed(
        device="cuda", init_method=f"tcp://127.0.0.1:{_free_port()}",
        world_size=1, rank=0)
    tmp = tempfile.TemporaryDirectory()
    ckpt = f"{tmp.name}/state"
    try:
        mesh = sharding.make_mesh()
        cfg, sb, _ = slice_inputs("fleet", batch, device)
        eng = sharding.ShardedEngine(cfg, mesh)
        args = eng.shard((sb.plan, sb.robot_pose, sb.current_vel,
                          sb.costmap, sb.footprint, sb.delta_t))
        state = eng.init_state(batch)
        outs, metrics, walls = [], [], []
        torch.cuda.synchronize()
        _reset_launch_counts()
        for _ in range(ticks):
            t0 = time.perf_counter()
            out, m = eng.step(state, *args)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            state = out.state
            outs.append(out)
            metrics.append(m)
        launches = _launch_counts()
        reduce_ms = {True: [], False: []}
        for out in outs:
            for distributed in (True, False, False, True):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sharding.fleet_metrics(out, distributed)
                torch.cuda.synchronize()
                reduce_ms[distributed].append(
                    1e3 * (time.perf_counter() - t0))
        ref = tp.MpcEngine(cfg, device=device)
        st = ref.init_batch_state(batch)
        worst = 0.0
        for out, m in zip(outs, metrics):
            r = ref.batch_step(st, sb.plan, sb.robot_pose, sb.current_vel,
                               sb.costmap, sb.footprint, sb.delta_t)
            st = r.state
            if not torch.equal(out.cmd_vel, r.cmd_vel):
                worst = max(worst, float((out.cmd_vel - r.cmd_vel).abs()
                                         .max()))
            local = sharding.fleet_metrics(out, distributed=False)
            if any(not torch.equal(a, b) for a, b in zip(m, local)):
                raise AssertionError(f"sharded metrics {m} differ from the "
                                     f"local reductions {local}")
        out = {"phase": "sharded engine (NCCL)", "world_size": world,
               "mesh": list(mesh.shape), "batch": batch, "ticks": ticks,
               "step_ms": [1e3 * w for w in walls],
               "metrics_ms_with_all_reduce": statistics.median(
                   reduce_ms[True]),
               "metrics_ms_local": statistics.median(reduce_ms[False]),
               "max_cmd_diff_vs_one_process": worst,
               "metrics": {k: float(v) for k, v in
                           metrics[-1]._asdict().items()},
               "launches": launches, "card": smi}
        print(json.dumps(out), flush=True)
        if worst:
            raise AssertionError("the sharded engine's commands differ from "
                                 f"MpcEngine.batch_step's by {worst}")
        for kernel in ("qp_admm", "footprint_cost"):
            if launches[kernel] <= 0:
                raise AssertionError(f"sharded engine: {kernel} was never "
                                     "launched")
        ckpt_ms = _checkpoint_in_world(eng, mesh, outs, args, batch, ckpt)
    finally:
        dist.destroy_process_group()
    with tmp:
        # No process group from here: the directory loads whole.
        _sharded_checkpoint(smi, ckpt, world, batch, ckpt_ms, {
            f.name: getattr(outs[0].state, f.name)
            for f in dataclasses.fields(outs[0].state)})
    return dict(out, ticks=ticks)


def _checkpoint_in_world(eng, mesh, outs, args, batch: int, path: str,
                         rounds: int = 3) -> dict:
    """Inside the world: the state after tick 1 saved collectively to
    `path` (checkpoint.save_state with the mesh) and this rank's shard
    loaded back into a fresh state, `rounds` times (each save replaces the
    last; the first pays the process's one-time set-up), then stepped: the
    resumed step's commands must equal tick 2's. -> each round's save and
    shard-load wall ms."""
    import torch
    # Its import (about a second) is not the save's.
    import torch.distributed.checkpoint  # noqa: F401

    from neo_mpc_planner2_tpu_torch import checkpoint

    walls = {"save_ms": [], "load_shard_ms": []}
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save_state(path, outs[0].state, mesh=mesh)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loaded = checkpoint.load_state(path, template=eng.init_state(batch),
                                       mesh=mesh)
        torch.cuda.synchronize()
        walls["save_ms"].append(1e3 * (t1 - t0))
        walls["load_shard_ms"].append(1e3 * (time.perf_counter() - t1))
    resumed, _ = eng.step(loaded, *args)
    if not torch.equal(resumed.cmd_vel, outs[1].cmd_vel):
        diff = float((resumed.cmd_vel - outs[1].cmd_vel).abs().max())
        raise AssertionError("the step resumed from the checkpoint differs "
                             f"from the uninterrupted one by {diff}")
    return walls


def _sharded_checkpoint(smi: str, path: str, world: int, batch: int,
                        ranks: dict, want: dict) -> dict:
    """The ranks' checkpoint directory loaded whole onto cuda:0 in this
    process, which has no process group: every field bit-equal to `want`
    (the ranks' states joined in rank order). Prints the ranks' save and
    shard-load walls, this load's wall and the directory's bytes."""
    import pathlib

    import torch

    from neo_mpc_planner2_tpu_torch import checkpoint

    t0 = time.perf_counter()
    whole = checkpoint.load_state(path, device="cuda:0")
    torch.cuda.synchronize()
    load_ms = 1e3 * (time.perf_counter() - t0)
    for name, w in want.items():
        got, w = getattr(whole, name), torch.as_tensor(w, device="cuda:0")
        if got.dtype != w.dtype or not torch.equal(got, w):
            raise AssertionError(f"checkpoint field {name} loads unequal "
                                 "to the ranks' state")
    out = {"phase": "sharded checkpoint (torch.distributed.checkpoint)",
           "world_size": world, "lanes": batch, **ranks,
           "load_whole_ms": load_ms,
           "bytes": sum(f.stat().st_size
                        for f in pathlib.Path(path).iterdir()),
           "files": len(list(pathlib.Path(path).iterdir())),
           "whole_bit_equal": True, "resumed_step_equal": True, "card": smi}
    print(json.dumps(out), flush=True)
    return out


def _sharded_processes(smi: str, world: int, batch: int, ticks: int) -> dict:
    """The sharded engine as one process a card, at the rank script's own
    small config (`parallel.smoke`): every rank must finish and print the same
    metrics each step, and each rank's commands must agree with the
    one-process engine's on card 0 for the same lanes (at least 99 % of
    lanes within 1e-3; the fraction bit-equal is reported). The ranks save
    their shards after step 1 into one checkpoint directory, each resumes
    step 2 from its loaded shard (equal to the uninterrupted step), and
    this process loads the directory whole (`_sharded_checkpoint`)."""
    import re
    import tempfile

    import numpy as np
    import torch

    import neo_mpc_planner2_tpu_torch as tp
    from neo_mpc_planner2_tpu_torch.engine import ControlState
    from neo_mpc_planner2_tpu_torch.parallel.smoke import smoke_config
    from neo_mpc_planner2_tpu_torch.scenarios import make_scenario_batch

    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-m",
             "neo_mpc_planner2_tpu_torch.parallel.smoke", str(r), str(world),
             str(port), f"{tmp}/rank{r}.npz", "--device", "cuda",
             "--batch", str(batch), "--steps", str(ticks),
             "--checkpoint", f"{tmp}/state"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for r, (p, o) in enumerate(zip(procs, outs)):
            if p.returncode != 0 or f"[rank {r}] OK" not in o:
                raise AssertionError(f"rank {r} failed:\n{o}")
        recs = [dict(np.load(f"{tmp}/rank{r}.npz")) for r in range(world)]
        cmds = [np.concatenate([rec[f"cmd_vel{s}"] for rec in recs])
                for s in range(ticks)]
        for r, rec in enumerate(recs):
            if not np.array_equal(rec["resumed_cmd_vel1"], rec["cmd_vel1"]):
                raise AssertionError(f"rank {r}: the step resumed from the "
                                     "checkpoint differs from the "
                                     "uninterrupted one")
        _sharded_checkpoint(smi, f"{tmp}/state", world, batch, {
            "save_ms": [1e3 * float(rec["ckpt_save_s"]) for rec in recs],
            "load_shard_ms": [1e3 * float(rec["ckpt_load_s"])
                              for rec in recs]}, {
            f.name: np.concatenate([rec[f"ckpt_{f.name}"] for rec in recs])
            for f in dataclasses.fields(ControlState)})
    lines = [re.findall(r"step\d .*", o) for o in outs]
    cfg = smoke_config()
    sb = make_scenario_batch(cfg, batch, seed=0, map_size=48, plan_points=24,
                             device="cuda:0")
    eng = tp.MpcEngine(cfg, device="cuda:0")
    st = eng.init_batch_state(batch)
    diffs = []
    for s in range(ticks):
        o = eng.batch_step(st, sb.plan, sb.robot_pose, sb.current_vel,
                           sb.costmap, sb.footprint, sb.delta_t)
        st = o.state
        diffs.append(np.abs(cmds[s] - o.cmd_vel.cpu().numpy()).max(-1))
    diff = np.concatenate(diffs)
    torch.cuda.synchronize()
    out = {"phase": "sharded engine (NCCL)", "world_size": world,
           "batch": batch, "ticks": ticks, "rank0": lines[0],
           "max_cmd_diff_vs_one_process": float(diff.max()),
           "frac_bit_equal": float((diff == 0).mean()),
           "frac_within_1e-3": float((diff <= 1e-3).mean()), "card": smi}
    print(json.dumps(out), flush=True)
    if any(ln != lines[0] or len(ln) != ticks for ln in lines):
        raise AssertionError(f"the ranks' metrics differ: {lines}")
    if out["frac_within_1e-3"] < 0.99:
        raise AssertionError("the ranks' commands leave the one-process "
                             f"engine's: {out}")
    return out


def phase_server_shards(device, smi: str, fleet: int = 4096) -> dict:
    """OptimizerSession(device="cuda"), the fleet ops over every visible
    card, against one on "cuda:0": the same staging (the serving phase's
    map and MPO-700), then two optimizer_batch requests at `fleet` robots
    each, the launch counts set to 0 just before the sharded session's and
    read just after; the answers must be equal. Prints the shard count
    and the wall of each request."""
    from neo_mpc_planner2_tpu_torch.serving import OptimizerSession

    traffic = serving_traffic(fleet)
    msg = {"op": "optimizer_batch", "robots": traffic["robots"],
           "delta_t": 1 / 30}
    replies, walls = {}, {}
    for name in ("cuda:0", "cuda"):
        sess = OptimizerSession(fleet_cfg(), device=name)
        _call(sess, traffic["costmap"])
        _call(sess, traffic["footprint"])
        if name == "cuda":
            _reset_launch_counts()
        walls[name] = []
        replies[name] = []
        for _ in range(2):
            t0 = time.perf_counter()
            replies[name].append(_call(sess, msg))
            walls[name].append(1e3 * (time.perf_counter() - t0))
        if name == "cuda":
            launches = _launch_counts()
            shards = [(str(d), hi - lo) for d, lo, hi in
                      sess._bounds(fleet)]
    import numpy as np

    vel = lambda name: np.array([[r["output_vel"] for r in rep["results"]]
                                 for rep in replies[name]])
    out = {"phase": "server: fleet ops sharded over the visible cards",
           "robots": fleet, "devices": [str(d) for d in sess.devices],
           "shards": shards, "wall_ms": walls,
           "equal_to_one_card": replies["cuda"] == replies["cuda:0"],
           "max_output_vel_diff": float(np.abs(vel("cuda")
                                               - vel("cuda:0")).max()),
           "launches": launches, "card": smi}
    print(json.dumps(out), flush=True)
    if not out["equal_to_one_card"]:
        raise AssertionError("the sharded server's answers differ from one "
                             "card's")
    for kernel in ("qp_admm", "footprint_cost"):
        if launches[kernel] <= 0:
            raise AssertionError(f"server shards: {kernel} was never "
                                 "launched")
    return out


# The serving phase: the reference's controller period (30 Hz) and the
# per-solve budget of BASELINE.md, in ms.
PERIOD_30HZ_MS = 1000.0 / 30.0
BUDGET_MS = 20.0


def serving_traffic(robots: int, seed: int = 0) -> dict:
    """Requests for the serving phase, from the scenario generator at the
    fleet point (one 64x64 map, MPO-700): the map, the footprint, one
    `optimizer` request a robot (its pose, a carrot 0.4 m ahead, its plan's
    goal, its velocity), each robot's plan and its tick_batch entry."""
    import numpy as np

    from neo_mpc_planner2_tpu_torch.scenarios import make_scenario_batch

    sb = make_scenario_batch(fleet_cfg(), robots, seed=seed, map_size=64,
                             plan_points=64, maps_on_device=True,
                             device="cpu")
    pose = sb.robot_pose.numpy().astype(float)
    vel = sb.current_vel.numpy().astype(float)
    plans = sb.plan.poses.numpy().astype(float)
    nv = sb.footprint.n_valid[0]
    return {
        "costmap": {"op": "set_costmap",
                    "data": sb.costmap.data[0].numpy().tolist(),
                    "origin": sb.costmap.origin[0].tolist(),
                    "resolution": float(sb.costmap.resolution[0])},
        "footprint": {"op": "set_footprint",
                      "points": sb.footprint.vertices[0, :nv].tolist()},
        "robots": [{"current_pose": pose[i].tolist(),
                    "carrot_pose": [0.4, 0.0, 0.0],
                    "goal_pose": plans[i, -1].tolist(),
                    "current_vel": vel[i].tolist()} for i in range(robots)],
        "plans": [plans[i].tolist() for i in range(robots)],
        "ticks": [{"pose": pose[i].tolist(), "vel": vel[i].tolist()}
                  for i in range(robots)]}


def _fleet_params() -> dict:
    """fleet_cfg() as the ROS parameters of a `configure` request."""
    import dataclasses

    cfg = fleet_cfg()
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "compat"}


def _serve_thread(**kw):
    """The port's serve() on 127.0.0.1 at a free port, in a daemon thread
    (it ends with the process); its port once it listens."""
    import threading

    from neo_mpc_planner2_tpu_torch.serving import serve

    port = _free_port()
    ready = threading.Event()
    threading.Thread(target=serve, daemon=True,
                     kwargs=dict(host="127.0.0.1", port=port,
                                 ready_event=ready, **kw)).start()
    if not ready.wait(60):
        raise AssertionError("the server did not start listening")
    return port


def _call(server, msg: dict) -> dict:
    """server.call(msg) for a client, server.handle(msg) for a session;
    an error response raises."""
    resp = (server.call if hasattr(server, "call") else server.handle)(msg)
    if "error" in resp:
        raise AssertionError(f"{msg.get('op')}: {resp['error']}")
    return resp


def _timed(server, msg: dict, reps: int, warm: int = 2) -> list:
    """Wall ms of `reps` answers to msg (after `warm` untimed ones), each
    checked for an error: a round trip for a client, a handle() call for an
    in-process session (which returns after its one device-to-host
    copy)."""
    for _ in range(warm):
        _call(server, msg)
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _call(server, msg)
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def _p(ms: list) -> dict:
    import numpy as np

    return {"p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)), "n": len(ms)}


def phase_serving(device, smi: str, fleet: int = 4096, big: int = 8192,
                  check_lanes: int = 256) -> dict:
    """The port's TCP server on the card, driven by its OptimizerClient:
    configure at fleet_cfg(), set_costmap (a 64x64 map from the scenario
    generator), set_footprint (MPO-700); then, as p50/p99 ms a request,
    `optimizer` (one robot, 50 requests: the reference's per-tick service
    call, against the 30 Hz period and the 20 ms budget), set_plan + `tick`
    (50), `optimizer_batch` at 4096 robots (5) and at 8192 robots in turns
    with one dispatch and with fleet_chunk=4096 (a second server, 3 each),
    set_plans + `tick_batch` at 4096 (3); save_state and load_state
    through a checkpoint directory under build/, as .npz files, then at
    4096 robots as a torch.distributed.checkpoint directory
    (`_serving_checkpoint_directory`). The launch counts are set to 0
    before this traffic and read before the directory's round trip: K1
    and K3 must have run.
    Then `optimizer` and `optimizer_batch` answered by an in-process
    session on the card (no socket, no JSON). Last, the same script
    through a session on the card and one on the
    CPU at 256 robots: output_vel within 1e-3 on >= 99 % of robots, the
    collision flags equal."""
    import pathlib
    import shutil
    import tempfile

    import numpy as np

    from neo_mpc_planner2_tpu_torch.serving import (OptimizerClient,
                                                    OptimizerSession)

    traffic = serving_traffic(big)
    build = pathlib.Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="serving_ckpt_", dir=build)
    try:
        ports = {"one": _serve_thread(device=device, checkpoint_dir=ckpt),
                 "chunked": _serve_thread(device=device, fleet_chunk=fleet)}
        clients = {k: OptimizerClient(port=p) for k, p in ports.items()}
        for c in clients.values():
            _call(c, {"op": "configure", "params": _fleet_params()})
            _call(c, traffic["costmap"])
            _call(c, traffic["footprint"])
        c = clients["one"]
        ping = _call(c, {"op": "ping"})
        if ping["backend"] != ("gpu" if device.type == "cuda" else "cpu"):
            raise AssertionError(f"the server is not on {device}: {ping}")
        _reset_launch_counts()
        robot = traffic["robots"][0]
        one = {"op": "optimizer", **robot, "control_interval": 1 / 30,
               "delta_t": 1 / 30}
        report = {"optimizer": _p(_timed(c, one, 50))}
        _call(c, {"op": "set_plan", "poses": traffic["plans"][0]})
        tick = {"op": "tick", **traffic["ticks"][0], "delta_t": 1 / 30}
        report["tick"] = _p(_timed(c, tick, 50))

        def batch(n):
            return {"op": "optimizer_batch", "robots": traffic["robots"][:n],
                    "control_interval": 1 / 30, "delta_t": 1 / 30}

        report["optimizer_batch"] = _p(_timed(c, batch(fleet), 5, 1))
        turns = {"one": [], "chunked": []}
        for k in ("one", "chunked"):
            _call(clients[k], batch(big))
        for _ in range(3):
            for k in ("one", "chunked"):
                turns[k] += _timed(clients[k], batch(big), 1, 0)
        report["optimizer_batch_big_one_dispatch"] = _p(turns["one"])
        report["optimizer_batch_big_chunked"] = _p(turns["chunked"])
        _call(c, {"op": "set_plans", "plans": traffic["plans"][:fleet]})
        report["tick_batch"] = _p(_timed(
            c, {"op": "tick_batch", "robots": traffic["ticks"][:fleet],
                "delta_t": 1 / 30}, 3, 1))
        for name, n in (("optimizer_batch", fleet), ("tick_batch", fleet),
                        ("optimizer_batch_big_one_dispatch", big),
                        ("optimizer_batch_big_chunked", big)):
            report[name].update(robots=n,
                                per_robot_ms=report[name]["p50_ms"] / n)
        saved = _call(c, {"op": "save_state", "path": "fleet.npz",
                          "fleet": True})
        loaded = _call(c, {"op": "load_state", "path": "fleet.npz",
                           "fleet": True})
        _call(c, {"op": "save_state", "path": "one.npz"})
        _call(c, {"op": "load_state", "path": "one.npz", "robot": "copy"})
        if not saved["lanes"] == saved["robots"] == loaded["lanes"] == big:
            raise AssertionError(f"fleet checkpoint: {saved}, {loaded}")
        launches = _launch_counts()
        for kernel in ("qp_admm", "footprint_cost"):
            if launches[kernel] <= 0:
                raise AssertionError(f"serving: {kernel} was never launched")
        report["checkpoint_directory"] = _serving_checkpoint_directory(
            c, batch(fleet), ckpt, device)
        for c_ in clients.values():
            c_.close()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)

    # The same requests answered in-process (no socket, no JSON): what the
    # round trips above spend outside the session.
    session = OptimizerSession(device=device)
    for msg in ({"op": "configure", "params": _fleet_params()},
                traffic["costmap"], traffic["footprint"]):
        _call(session, msg)
    report["in_process"] = {"optimizer": _p(_timed(session, one, 20)),
                            "optimizer_batch": _p(_timed(session,
                                                         batch(fleet), 3, 1))}

    # The same script on the card and on the CPU, in-process.
    lanes = check_lanes
    script = [{"op": "configure", "params": _fleet_params()},
              traffic["costmap"], traffic["footprint"],
              {"op": "optimizer_batch", "robots": traffic["robots"][:lanes],
               "delta_t": 1 / 30},
              {"op": "optimizer_batch", "robots": traffic["robots"][:lanes],
               "delta_t": 1 / 30},
              {"op": "set_plans", "plans": traffic["plans"][:lanes]},
              {"op": "tick_batch", "robots": traffic["ticks"][:lanes],
               "delta_t": 1 / 30}]
    answers = {}
    for dev in (device, "cpu"):
        session = OptimizerSession(device=dev)
        answers[str(dev)] = [session.handle(m) for m in script][3:]
    card, cpu = answers[str(device)], answers["cpu"]
    diff, flags_equal = [], True
    for a, b in zip(card, cpu):
        if "results" not in a:
            continue
        for x, y in zip(a["results"], b["results"]):
            diff.append(float(np.abs(np.subtract(x["output_vel"],
                                                 y["output_vel"])).max()))
            flags_equal &= all(x[k] == y[k] for k in (
                "collision", "collision_footprint", "lethal", "plan_empty")
                if k in x)
    frac = float(np.mean(np.asarray(diff) <= 1e-3))
    report["card_vs_cpu"] = {"robots": lanes, "responses": len(diff),
                             "max_output_vel_diff": max(diff),
                             "frac_within_1e-3": frac,
                             "flags_equal": bool(flags_equal)}
    out = {"phase": "serving (TCP, the port's serve and OptimizerClient)",
           "config": "fleet_cfg()", "map": 64, "footprint": "MPO-700",
           "period_30hz_ms": PERIOD_30HZ_MS, "budget_ms": BUDGET_MS,
           "optimizer_meets_30hz": report["optimizer"]["p99_ms"]
           < PERIOD_30HZ_MS,
           "optimizer_meets_budget": report["optimizer"]["p99_ms"]
           < BUDGET_MS,
           "fleet_chunk": fleet, "launches": launches, **report,
           "card": smi}
    print(json.dumps(out), flush=True)
    if frac < 0.99 or not flags_equal:
        raise AssertionError(f"serving card vs CPU: {frac:.4f} of robots "
                             f"within 1e-3, flags equal: {flags_equal}")
    return out


def _serving_checkpoint_directory(client, msg: dict, ckpt: str,
                                  device) -> dict:
    """A fleet round trip through a checkpoint directory at the robots of
    `msg` (an optimizer_batch request): after one answer to msg, the fleet
    saved as the directory `fleet_dir` (twice: the second save replaces
    the first) and as `fleet_dir.npz`; the next
    answer (from the saved state), the answer after loading the directory
    and the one after loading the .npz must be equal, and the directory
    loads in this process bit-equal to the .npz. A robot's slot saved to a
    directory loads into another slot. -> the saves' and the load's
    request wall ms and the directory's bytes."""
    import pathlib

    import torch

    from neo_mpc_planner2_tpu_torch import checkpoint

    robots = len(msg["robots"])
    _call(client, msg)
    save_ms = []
    for _ in range(2):      # the second save replaces the first
        t0 = time.perf_counter()
        saved = _call(client, {"op": "save_state", "path": "fleet_dir",
                               "fleet": True})
        save_ms.append(1e3 * (time.perf_counter() - t0))
    _call(client, {"op": "save_state", "path": "fleet_dir.npz",
                   "fleet": True})
    want = _call(client, msg)
    t0 = time.perf_counter()
    loaded = _call(client, {"op": "load_state", "path": "fleet_dir",
                            "fleet": True})
    load_ms = 1e3 * (time.perf_counter() - t0)
    after_dir = _call(client, msg)
    _call(client, {"op": "load_state", "path": "fleet_dir.npz",
                   "fleet": True})
    after_npz = _call(client, msg)
    if not saved["lanes"] == loaded["lanes"] == robots:
        raise AssertionError(f"directory checkpoint: {saved}, {loaded}")
    if not after_dir == want == after_npz:
        raise AssertionError("the fleet loaded from the checkpoint directory "
                             "answers otherwise than the saved one")
    path = pathlib.Path(ckpt) / "fleet_dir"
    a = checkpoint.load_state(str(path), device=device)
    b = checkpoint.load_state(f"{path}.npz", device=device)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x.dtype != y.dtype or not torch.equal(x, y):
            raise AssertionError(f"checkpoint field {f.name}: the directory "
                                 "and the .npz differ")
    _call(client, {"op": "save_state", "path": "one_dir"})
    _call(client, {"op": "load_state", "path": "one_dir",
                   "robot": "copy_dir"})
    return {"robots": robots, "save_request_ms": save_ms,
            "load_request_ms": load_ms,
            "bytes": sum(f.stat().st_size for f in path.iterdir()),
            "answers_equal": True}


# The controller phase: closed-loop ticks a route, the ticks its card-vs-CPU
# check compares, and the ticks whose traces it reads (one tick a trace).
CONTROLLER_TICKS = 30
CONTROLLER_CHECK_TICKS = 10
CONTROLLER_TRACED_TICKS = 3


class K1Recorder:
    """While active, counts K1's launches and keeps a copy of the arguments
    of its first call for each (B, m): it wraps `binding.launch_qp_admm`,
    which `sqp.qp_admm` looks up at every call, and restores it on exit."""

    def __init__(self):
        self.launches = 0
        self.args = {}

    def __enter__(self):
        from neo_mpc_planner2_tpu_torch.kernels import binding

        self._launch = binding.launch_qp_admm

        def launch(ins, m, iters, rho, sigma):
            self.launches += 1
            key = (ins[0].shape[0], m)
            if key not in self.args:
                self.args[key] = ([a.clone() for a in ins],
                                  dict(iters=iters, rho=rho, sigma=sigma))
            return self._launch(ins, m, iters, rho, sigma)

        binding.launch_qp_admm = launch
        return self

    def __exit__(self, *exc):
        from neo_mpc_planner2_tpu_torch.kernels import binding

        binding.launch_qp_admm = self._launch
        return False


def phase_k1_captured(recorder: K1Recorder, label: str) -> dict:
    """K1 on a path's own captured calls, held against its plain version
    within rtol 2e-4 / atol 2e-5, timed, its bound from the call's
    shape."""
    import torch

    from neo_mpc_planner2_tpu_torch import sqp
    from neo_mpc_planner2_tpu_torch.kernels import bounds

    if not recorder.args:
        raise AssertionError(f"{label}: no K1 call was captured")
    rtol, atol = 2e-4, 2e-5
    report = {}
    for (B, m), (args, kw) in sorted(recorder.args.items()):
        plain_args = (args[:4] + [sqp._cone_jacobian(args[4], m)]
                      + args[5:])
        got = sqp.qp_admm(*args, **kw)
        want = sqp.qp_admm_plain(*plain_args, **kw)
        torch.cuda.synchronize()
        worst = 0.0
        for g, w in zip(got, want):
            if _excess(g, w, rtol, atol) > 0:
                raise AssertionError(f"K1 on the {label} call B={B} m={m} "
                                     "differs from its plain version by "
                                     f"{float((g - w).abs().max())}")
            worst = max(worst, float((g - w).abs().max()))
        ms = _device_ms(lambda: sqp.qp_admm(*args, **kw), "qp_admm_kernel")
        work = bounds.qp_admm_work(B, m, kw["iters"])
        report[f"B{B}_m{m}"] = {
            "iters": kw["iters"], "max_abs_err": worst, "ms": ms,
            "plain_ms": _time_ms(lambda: sqp.qp_admm_plain(*plain_args,
                                                           **kw)),
            "bound_ms": work["bound_ms"], "bound_by": work["bound_by"],
            "share_of_bound": work["bound_ms"] / ms}
    return report


def controller_scene(seed: int = 0) -> dict:
    """One robot from the scenario generator at the fleet point (a 64x64
    map, MPO-700, one plan of 64 points), as host arrays."""
    from neo_mpc_planner2_tpu_torch.scenarios import make_scenario_batch

    sb = make_scenario_batch(fleet_cfg(), 1, seed=seed, map_size=64,
                             plan_points=64, device="cpu")
    nv = int(sb.footprint.n_valid[0])
    return dict(grid=sb.costmap.data[0].numpy(),
                origin=tuple(sb.costmap.origin[0].tolist()),
                res=float(sb.costmap.resolution[0]),
                plan=sb.plan.poses[0].numpy(),
                pose=sb.robot_pose[0].numpy().astype(float),
                vel=sb.current_vel[0].numpy().astype(float),
                fp=sb.footprint.vertices[0, :nv].numpy())


def make_controller(scene: dict, device, native: bool):
    """A NeoMpcController on `device` at fleet_cfg(), configured with the
    scene's map and footprint (the C++ host's geometry when native),
    activated, its plan set."""
    from neo_mpc_planner2_tpu_torch import Costmap, Footprint
    from neo_mpc_planner2_tpu_torch.controller import NeoMpcController

    ctrl = NeoMpcController(device=device)
    ctrl.configure(fleet_cfg(),
                   costmap=Costmap.create(scene["grid"], scene["origin"],
                                          scene["res"], device=device),
                   footprint=Footprint.create(scene["fp"], device=device),
                   native_geometry=native)
    ctrl.activate()
    ctrl.set_plan(scene["plan"])
    return ctrl


def drive(ctrl, pose, vel, ticks: int, shadow=None, tracker=None):
    """`ticks` closed-loop ticks of ctrl from (pose, vel) at 30 Hz, the
    robot integrating its commands; a `shadow` controller is fed the same
    pose and velocity each tick. Returns (commands, shadow's commands,
    last pose, last velocity)."""
    import contextlib

    import numpy as np

    from neo_mpc_planner2_tpu_torch.utils.se2_np import integrate_cmd_np

    cmds, shadowed = [], []
    pose, vel = np.array(pose, float), np.array(vel, float)
    for _ in range(ticks):
        with tracker.measure() if tracker else contextlib.nullcontext():
            cmd = ctrl.compute_velocity_commands(pose, vel, 1 / 30)
        cmds.append(cmd)
        if shadow is not None:
            shadowed.append(shadow.compute_velocity_commands(pose, vel,
                                                             1 / 30))
        pose = integrate_cmd_np(pose, cmd, 1 / 30)
        vel = np.asarray(cmd, float)
    return np.array(cmds), np.array(shadowed), pose, vel


def trace_ticks(ctrl, pose, vel, ticks: int, logdir: str) -> dict:
    """`ticks` more ticks, each under the port's device_trace: per tick the
    CUDA launches, host synchronizations and host-device copies (the
    host's runtime calls, less those of a trace of nothing, which closes
    with synchronizes of its own), the device's kernels and their summed
    device time, and the device ms by kernel name over all the ticks
    (device_module_durations_ms; the profiler may drop some device records
    of a short trace, so the names are pooled over the ticks)."""
    import os

    from neo_mpc_planner2_tpu_torch.utils import profiling

    def counted(tick_dir):
        calls = profiling.host_call_counts(tick_dir)
        return calls, {
            "launches": sum(calls.get(n, 0) for n in LAUNCH_EVENTS),
            "syncs": sum(calls.get(n, 0) for n in SYNC_EVENTS),
            "memcpys": calls.get("cudaMemcpyAsync", 0)}

    with profiling.device_trace(os.path.join(logdir, "empty")):
        pass
    _, empty = counted(os.path.join(logdir, "empty"))
    per = {k: [] for k in empty}
    kernels, busy, names, first = [], [], {}, None
    for k in range(ticks):
        tick_dir = os.path.join(logdir, f"tick{k}")
        with profiling.device_trace(tick_dir):
            _, _, pose, vel = drive(ctrl, pose, vel, 1)
        calls, n = counted(tick_dir)
        first = calls if first is None else first
        for key, v in n.items():
            per[key].append(v - empty[key])
        durations = profiling.device_module_durations_ms(tick_dir)
        kernels.append(sum(len(v) for v in durations.values()))
        busy.append(sum(sum(v) for v in durations.values()))
        for name, ms in durations.items():
            names[name] = names.get(name, 0.0) + sum(ms)
    return {"cuda_launches_per_tick": per["launches"],
            "host_syncs_per_tick": per["syncs"],
            "host_memcpys_per_tick": per["memcpys"],
            "device_kernels_per_tick": kernels,
            "device_busy_ms_per_tick": busy,
            "device_ms_by_kernel": names,
            "host_calls_first_tick": first,
            "empty_trace_counts": empty}


# The wide-footprint phase: closed-loop ticks a run and traced ticks.
WIDE_TICKS = 10
WIDE_TRACED_TICKS = 2


def _mpo500_server_scene() -> dict:
    """An MPO-500 (0.99 x 0.67 m) robot on a 0.015 m map, 200 x 200 cells
    (3 m), from the scenario generator at the fleet point: the map,
    footprint and plan requests, its pose and velocity."""
    from neo_mpc_planner2_tpu_torch.scenarios import (
        make_scenario_batch, mpo500_footprint)

    sb = make_scenario_batch(fleet_cfg(), 1, seed=3, map_size=200,
                             resolution=0.015, plan_points=64,
                             plan_length_range=(0.6, 1.0),
                             footprint=mpo500_footprint(device="cpu"),
                             device="cpu")
    nv = int(sb.footprint.n_valid[0])
    return {"costmap": {"op": "set_costmap",
                        "data": sb.costmap.data[0].numpy().tolist(),
                        "origin": sb.costmap.origin[0].tolist(),
                        "resolution": 0.015},
            "footprint": {"op": "set_footprint",
                          "points": sb.footprint.vertices[0, :nv].tolist()},
            "plan": {"op": "set_plan",
                     "poses": sb.plan.poses[0].numpy().tolist()},
            "pose": sb.robot_pose[0].numpy().astype(float),
            "vel": sb.current_vel[0].numpy().astype(float)}


def phase_wide_footprints(device, smi: str) -> dict:
    """K3 past its earlier caps, end to end: (1) a server session on the
    card with an MPO-500 on a 0.015 m map, where the session raises
    footprint_edge_samples to ceil(0.99 / 0.015) + 2 (69 from the float32
    footprint) after `configure`, `set_costmap` and `set_footprint`:
    WIDE_TICKS `tick`
    requests, the robot integrating the card's commands, each answered
    within 1e-3 by a CPU session given the same request, with K3's
    launches a tick by launch plan; (2) the fused controller with a
    20-vertex footprint (a radius footprint, max_footprint_vertices 20):
    WIDE_TICKS ticks against a CPU controller fed the same poses, within
    1e-3, then WIDE_TRACED_TICKS traced ticks. Returns the two runs'
    launches for the `kernels` line."""
    import os
    import tempfile

    import numpy as np

    from neo_mpc_planner2_tpu_torch import Costmap, Footprint
    from neo_mpc_planner2_tpu_torch.controller import NeoMpcController
    from neo_mpc_planner2_tpu_torch.serving import OptimizerSession
    from neo_mpc_planner2_tpu_torch.utils.se2_np import integrate_cmd_np

    scene = _mpo500_server_scene()
    setup = [{"op": "configure", "params": _fleet_params()},
             scene["costmap"], scene["footprint"], scene["plan"]]
    card, cpu = OptimizerSession(device=device), OptimizerSession(
        device="cpu")
    for msg in setup:
        _call(card, msg)
        _call(cpu, msg)
    # 69 samples: the staged float32 edge, 0.99000001 m, over 0.015 m
    # rounds up past 66.
    samples = card.cfg.footprint_edge_samples
    if samples <= 64 or cpu.cfg.footprint_edge_samples != samples:
        raise AssertionError(f"MPO-500 at 0.015 m: {samples} samples an "
                             "edge, not past K3's earlier cap of 64")
    pose, vel = scene["pose"], scene["vel"]
    diffs, walls = [], []
    _reset_launch_counts()
    for _ in range(WIDE_TICKS):
        msg = {"op": "tick", "pose": pose.tolist(), "vel": vel.tolist(),
               "delta_t": 1 / 30}
        t0 = time.perf_counter()
        got = _call(card, msg)
        walls.append(1e3 * (time.perf_counter() - t0))
        want = _call(cpu, msg)
        diffs.append(float(np.abs(np.subtract(got["output_vel"],
                                              want["output_vel"])).max()))
        cmd = np.asarray(got["output_vel"], float)
        pose, vel = integrate_cmd_np(pose, cmd, 1 / 30), cmd
    server_launches = _launch_counts()
    server = {"footprint": "MPO-500", "map": [200, 200],
              "resolution": 0.015, "footprint_edge_samples": samples,
              "ticks": WIDE_TICKS, "max_cmd_diff_vs_cpu": max(diffs),
              "tick_ms_p50": statistics.median(walls[1:]),
              "launches": server_launches,
              "k3_launches_per_tick": {
                  k: v / WIDE_TICKS for k, v in server_launches.items()
                  if k.startswith("footprint_cost")}}
    if max(diffs) > 1e-3:
        raise AssertionError(f"MPO-500 server tick: card vs CPU {diffs}")
    if server_launches["footprint_cost"] <= 0:
        raise AssertionError("MPO-500 server tick: K3 never launched")

    base = controller_scene()
    a = 2 * np.pi * np.arange(20) / 20
    gon = 0.4 * np.stack([np.cos(a), np.sin(a)], -1)
    cfg = fleet_cfg().replace(max_footprint_vertices=20)

    def ctrl(dev):
        c = NeoMpcController(device=dev)
        c.configure(cfg, costmap=Costmap.create(
            base["grid"], base["origin"], base["res"], device=dev),
            footprint=Footprint.create(gon, max_vertices=20, device=dev))
        c.activate()
        c.set_plan(base["plan"])
        return c

    on_card, on_cpu = ctrl(device), ctrl("cpu")
    _reset_launch_counts()
    cmds, shadow, pose, vel = drive(on_card, base["pose"], base["vel"],
                                    WIDE_TICKS, shadow=on_cpu)
    ctrl_launches = _launch_counts()
    diff = float(np.abs(cmds - shadow).max())
    if diff > 1e-3:
        raise AssertionError(f"20-vertex controller: card vs CPU {diff}")
    if ctrl_launches["footprint_cost"] <= 0:
        raise AssertionError("20-vertex controller: K3 never launched")
    with tempfile.TemporaryDirectory() as logdir:
        traced = trace_ticks(on_card, pose, vel, WIDE_TRACED_TICKS,
                             os.path.join(logdir, "trace"))
    controller = {"footprint": "20-gon, radius 0.4 m", "route": "fused",
                  "ticks": WIDE_TICKS, "max_cmd_diff_vs_cpu": diff,
                  "launches": ctrl_launches,
                  "cuda_launches_per_tick": traced["cuda_launches_per_tick"],
                  "device_busy_ms_per_tick":
                      traced["device_busy_ms_per_tick"]}
    print(json.dumps({"phase": "wide footprints: MPO-500 server tick "
                      "past 64 samples an edge, 20-vertex controller tick",
                      "server": server, "controller": controller,
                      "card": smi}), flush=True)
    return {"server_mpo500": server, "controller_20gon": controller}


def phase_adapter_and_cli(device, smi: str) -> dict:
    """The ROS adapter's pure core and the console script on the card:
    `ros_adapter.costmap_refresh_op` stages a map and its dirty box into a
    session on the card, `optimizer_callback_core` answers a duck-typed
    Optimizer request (held against a CPU session within 1e-3); then
    `cli.server_main --device cuda` in a thread on a free port answers one
    `optimizer` request from the port's OptimizerClient."""
    import socket
    import threading
    from types import SimpleNamespace as NS

    import numpy as np

    from neo_mpc_planner2_tpu_torch import cli, ros_adapter
    from neo_mpc_planner2_tpu_torch.serving import (OptimizerClient,
                                                    OptimizerSession)

    scene = controller_scene()
    meta = (scene["origin"], scene["res"])
    grid = scene["grid"]
    changed = grid.copy()
    changed[5:9, 40:47] = 0.5
    q = lambda yaw: NS(x=0.0, y=0.0, z=float(np.sin(yaw / 2)),
                       w=float(np.cos(yaw / 2)))
    pose = lambda p: NS(position=NS(x=float(p[0]), y=float(p[1]), z=0.0),
                        orientation=q(p[2]))
    request = NS(current_pose=NS(pose=pose(scene["pose"])),
                 carrot_pose=NS(pose=pose([0.4, 0.0, 0.0])),
                 goal_pose=pose(scene["plan"][-1]),
                 current_vel=NS(linear=NS(x=scene["vel"][0],
                                          y=scene["vel"][1], z=0.0),
                                angular=NS(x=0.0, y=0.0, z=scene["vel"][2])),
                 switch_opt=False, control_interval=1 / 30)
    answers, ops = {}, []
    for dev in (device, "cpu"):
        session = OptimizerSession(fleet_cfg(), device=dev)
        _call(session, {"op": "set_footprint",
                        "points": scene["fp"].tolist()})
        prev = None
        for g in (grid, changed):
            op = ros_adapter.costmap_refresh_op(prev, meta, g, meta)
            _call(session, op)
            if dev is device:
                ops.append((op["op"], list(op["data"].shape)))
            prev = g
        staged = session.costmap.data.cpu().numpy()
        if not np.array_equal(staged, changed):
            raise AssertionError("adapter: the staged map is not the grid")
        response = NS(output_vel=NS(twist=NS(linear=NS(x=0.0, y=0.0, z=0.0),
                                             angular=NS(x=0.0, y=0.0,
                                                        z=0.0))))
        tw = ros_adapter.optimizer_callback_core(
            session, request, response, delta_t=1 / 30).output_vel.twist
        answers[str(dev)] = [tw.linear.x, tw.linear.y, tw.angular.z]
    diff = float(np.abs(np.subtract(answers[str(device)],
                                    answers["cpu"])).max())
    if not np.isfinite(answers[str(device)]).all() or diff > 1e-3:
        raise AssertionError(f"adapter: card {answers[str(device)]} vs cpu "
                             f"{answers['cpu']}")

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    threading.Thread(target=cli.server_main, daemon=True, args=(
        ["--port", str(port), "--device", "cuda"],)).start()
    client = OptimizerClient(port=port, wait_timeout=60)
    try:
        backend = _call(client, {"op": "ping"})["backend"]
        for msg in ({"op": "configure", "params": _fleet_params()},
                    ros_adapter.occupancy_grid_to_costmap_msg(NS(
                        info=NS(height=64, width=64, resolution=scene["res"],
                                origin=NS(position=NS(x=scene["origin"][0],
                                                      y=scene["origin"][1]))),
                        data=np.rint(grid * 100).astype(np.int8))),
                    {"op": "set_footprint",
                     "points": scene["fp"].tolist()}):
            _call(client, msg)
        t0 = time.perf_counter()
        cli_answer = _call(client, ros_adapter.request_to_msg(
            request, delta_t=1 / 30))["output_vel"]
        cli_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        client.close()
    if backend != "gpu" or not np.isfinite(cli_answer).all():
        raise AssertionError(f"cli: backend {backend}, answer {cli_answer}")
    out = {"phase": "controller path: ROS adapter core and CLI on the card",
           "adapter_ops": ops, "adapter_output_vel": answers[str(device)],
           "adapter_card_vs_cpu_max_diff": diff,
           "cli": {"backend": backend, "output_vel": cli_answer,
                   "first_optimizer_ms": cli_ms}, "card": smi}
    print(json.dumps(out), flush=True)
    return out


def timed_routes(scene: dict, device, routes: dict, ticks: int) -> dict:
    """`ticks` closed-loop ticks of a fresh controller a route, the routes
    in turns (ABBA: the order flips every tick, so that the host's drift
    falls on both), each controller carrying its own robot. Around each
    tick the launch counts are set to 0 just before it and read just
    after. Returns route -> (RateTracker, launches summed over its ticks,
    commands, last pose, last velocity, controller)."""
    import collections

    import numpy as np

    from neo_mpc_planner2_tpu_torch.utils.profiling import RateTracker

    run = {name: dict(ctrl=make_controller(scene, device, native),
                      tracker=RateTracker(), launches=collections.Counter(),
                      cmds=[], pose=scene["pose"], vel=scene["vel"])
           for name, native in routes.items()}
    order = list(routes)
    for t in range(ticks):
        for name in (order if t % 2 == 0 else order[::-1]):
            r = run[name]
            _reset_launch_counts()
            cmds, _, r["pose"], r["vel"] = drive(r["ctrl"], r["pose"],
                                                 r["vel"], 1,
                                                 tracker=r["tracker"])
            r["launches"].update(_launch_counts())
            r["cmds"].append(cmds[0])
    return {name: (r["tracker"], dict(r["launches"]), np.array(r["cmds"]),
                   r["pose"], r["vel"], r["ctrl"])
            for name, r in run.items()}


def phase_controller(device, smi: str) -> dict:
    """The single-robot controller on the card, on each route: fused (the
    whole tick on the card) and native (the C++ host's geometry, built
    with g++ from the port's copy, and the solve on the card). On the
    scene of controller_scene(): a 2-tick warm-up a route on a fresh
    controller that captures K1's and K3's batch-1 calls; then
    CONTROLLER_TICKS closed-loop ticks a route, the routes in turns
    (timed_routes), p50/p99 ms a tick (RateTracker) against the 33.3 ms
    period of 30 Hz; CONTROLLER_TRACED_TICKS more ticks, one a trace,
    through the port's device_trace: CUDA launches and host syncs a tick,
    and K1's and K3's kernels seen on the device; the first
    CONTROLLER_CHECK_TICKS ticks on the card against a CPU controller fed
    the same poses, within 1e-3; the captured K1 and K3 calls held against
    their plain versions. One line a route; returns name -> its output,
    shaped as a slice phase's (launches, ticks) for the `kernels` line."""
    import pathlib
    import shutil
    import tempfile

    import numpy as np

    from neo_mpc_planner2_tpu_torch.native import host

    t0 = time.perf_counter()
    built = not host.library_path().exists()
    lib = host.build_library()
    native_build = {"library": str(lib.relative_to(
        pathlib.Path(__file__).resolve().parent)), "built": built,
        "seconds": time.perf_counter() - t0}
    scene = controller_scene()
    cfg = fleet_cfg()
    routes = {"fused": False, "native": True}
    captured = {}
    for route, native in routes.items():
        with K1Recorder() as k1, K3Recorder() as k3:
            drive(make_controller(scene, device, native), scene["pose"],
                  scene["vel"], WARM_TICKS)
        captured[route] = (k1, k3)
    timed = timed_routes(scene, device, routes, CONTROLLER_TICKS)
    build = pathlib.Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    logdir = tempfile.mkdtemp(prefix="controller_trace_", dir=build)
    out_routes = {}
    try:
        for route, native in routes.items():
            tracker, launches, cmds, pose, vel, ctrl = timed[route]
            k1, k3 = captured[route]
            if not np.isfinite(cmds).all():
                raise AssertionError(f"controller {route}: non-finite "
                                     "commands")
            speed = float(np.hypot(cmds[:, 0], cmds[:, 1]).max())
            if speed > cfg.max_vel_trans + 1e-5:
                raise AssertionError(f"controller {route}: |cmd_xy| {speed}")
            for kernel in ("qp_admm", "footprint_cost"):
                if launches[kernel] <= 0:
                    raise AssertionError(f"controller {route}: {kernel} was "
                                         "never launched")
            traced = trace_ticks(ctrl, pose, vel, CONTROLLER_TRACED_TICKS,
                                 f"{logdir}/{route}")
            seen = list(traced["device_ms_by_kernel"])
            for kernel in ("qp_admm_kernel", "footprint_cost_kernel"):
                if not any(kernel in name for name in seen):
                    raise AssertionError(f"controller {route}: the traces "
                                         f"saw no {kernel}: {seen}")
            traced["device_ms_by_kernel"] = {
                name: ms for name, ms in traced["device_ms_by_kernel"].items()
                if name.startswith("void neo_mpc::")}
            card, cpu, _, _ = drive(
                make_controller(scene, device, native), scene["pose"],
                scene["vel"], CONTROLLER_CHECK_TICKS,
                shadow=make_controller(scene, "cpu", native))
            diff = float(np.abs(card - cpu).max())
            if diff > 1e-3:
                raise AssertionError(f"controller {route}: card vs CPU "
                                     f"{diff} over 1e-3")
            stats = tracker.stats()
            out = {"phase": f"controller ({route} route, batch 1)",
                   "config": "fleet_cfg()", "map": 64,
                   "footprint": "MPO-700", "ticks": CONTROLLER_TICKS,
                   "timed": "in turns with the other route", "tick": stats,
                   "period_30hz_ms": PERIOD_30HZ_MS,
                   "meets_30hz": stats["p99_ms"] < PERIOD_30HZ_MS,
                   "launches": launches,
                   "launches_per_tick": {k: v / CONTROLLER_TICKS
                                         for k, v in launches.items()},
                   "traced_ticks": traced,
                   "device_idle_share": 1.0 - (
                       sum(traced["device_busy_ms_per_tick"])
                       / len(traced["device_busy_ms_per_tick"])
                       / stats["mean_ms"]),
                   "card_vs_cpu": {"ticks": CONTROLLER_CHECK_TICKS,
                                   "max_cmd_diff": diff},
                   "k1_captured": phase_k1_captured(k1,
                                                    f"controller {route}"),
                   "k1_launches_per_tick_warm_up": k1.launches / WARM_TICKS,
                   "k3_launches_per_tick_warm_up": {
                       f"R{R}": n / WARM_TICKS
                       for R, n in sorted(k3.by_r.items())},
                   "k3_captured": hold_k3_captured(k3, required=("gate",)),
                   "final_pose": pose.tolist(),
                   "goal_dist": float(np.hypot(*(pose[:2]
                                                 - scene["plan"][-1, :2]))),
                   "timing": TIMING, "card": smi}
            if native:
                out["native_library"] = native_build
            print(json.dumps(out), flush=True)
            out_routes[f"controller_{route}"] = out
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    return out_routes


# The bench phase: the port's benchmark entry (`python -m
# neo_mpc_planner2_tpu_torch.bench`) at bench.py's full width (4096 lanes,
# 64x64 maps) with its depth cut: 2 ticks a run and of quality, 4 latency
# steps, 2 traced steps (the device p99 reads the second). The deadline
# stays the bench's default, so that every pass's budget rule lets it run;
# the child's time limit is above it.
BENCH_ARGS = ("--device", "cuda:0", "--batch", "4096", "--map-size", "64",
              "--ticks", "2", "--quality-ticks", "2", "--latency-reps", "4",
              "--trace-reps", "2", "--deadline", "560")
BENCH_TIMEOUT_S = 620
BENCH_LAUNCHES = "[bench] kernel launches "


def check_bench_output(returncode: int, stdout: str, stderr: str) -> dict:
    """The bench child's JSON line and its kernels' launches; raises unless
    it exited 0, printed exactly one line on stdout, every field of it is
    set (the device p99s and every quality field included), it ran on one
    card at 4096 lanes, and it launched K1 and K3."""
    if returncode != 0:
        raise AssertionError(f"bench: exit {returncode}")
    lines = stdout.splitlines()
    if len(lines) != 1:
        raise AssertionError(f"bench: {len(lines)} stdout lines, not one")
    line = json.loads(lines[0])
    unset = [k for k, v in line.items() if v is None]
    if unset:
        raise AssertionError(f"bench: fields left null: {unset}")
    if line.get("devices") != 1 or line.get("batch") != 4096:
        raise AssertionError(f"bench: devices {line.get('devices')}, "
                             f"batch {line.get('batch')}: not 1 card at "
                             "4096 lanes")
    counts = [ln[len(BENCH_LAUNCHES):] for ln in stderr.splitlines()
              if ln.startswith(BENCH_LAUNCHES)]
    if len(counts) != 1:
        raise AssertionError("bench: no kernel launches line on stderr")
    launches = json.loads(counts[0])
    for kernel in ("qp_admm", "footprint_cost"):
        if launches.get(kernel, 0) <= 0:
            raise AssertionError(f"bench: {kernel} was never launched")
    return {"line": line, "launches": launches}


def phase_bench(device, smi: str) -> dict:
    """The port's benchmark in a child process on cuda:0 (BENCH_ARGS; a
    fresh process, so its kernels' launch counts start at 0 and its
    profiled passes run in a process of their own), its stderr relayed,
    its output held by check_bench_output. Prints the bench's line beside
    the card's name and power limit; returns its launches (its runs are at
    control_steps 3)."""
    import os

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "neo_mpc_planner2_tpu_torch.bench",
         *BENCH_ARGS], capture_output=True, text=True,
        timeout=BENCH_TIMEOUT_S,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    sys.stderr.write(proc.stderr)
    got = check_bench_output(proc.returncode, proc.stdout, proc.stderr)
    print(json.dumps({"phase": "bench", "nvidia_smi": smi, **got["line"],
                      "args": list(BENCH_ARGS), "wall_s": wall,
                      "launches": got["launches"]}), flush=True)
    return {"launches": got["launches"], "control_steps": 3}


# The port's demos and studies (neo_mpc_planner2_tpu_torch.examples /
# .scripts),
# each phase in a process of its own (isolated): every example at
# EXAMPLE_TICKS ticks on the card, its first EXAMPLE_CPU_TICKS ticks'
# commands held against the same example on the CPU; every study at a cut
# depth (STUDY_ARGS), its output checked. The launch counts are set to 0
# just before each and read just after.
EXAMPLE_TICKS = 30
EXAMPLE_CPU_TICKS = 3
STUDY_ARGS = {
    "iters_hist": [("--batch", "4096", "--ticks", "2"),
                   ("--batch", "4096", "--ticks", "2", "--regime",
                    "dynamic")],
    "trace_headline": [("--batch", "4096", "--ticks", "1", "--top", "12")],
    "dyn_decompose": [("--batch", "4096", "--ticks", "1", "--reps", "1",
                       "--launch-ticks", "1")],
    "scaling_bench": [("--ticks", "2", "--repeats", "1")],
    "product_decompose": [("--batch", "4096", "--ticks", "1",
                           "--quality-ticks", "1")],
    # The gate's suite and the stateful one: each suite's oracle pool
    # spawns its workers anew (all five suites took 75 s of the phase).
    "parity_study": [("--n", "16", "--suites", "mpo700,sequence",
                      "--perturb-reps", "1", "--sequence-n", "8",
                      "--sequence-ticks", "2", "--workers", "4")],
}

# The kernels each study must launch: K1 and K3, but the product study's
# prox-FISTA solver has no QP (K3 only).
STUDY_KERNELS = {"product_decompose": ("footprint_cost",)}


def _example_runs(name: str, device, ticks: int) -> dict:
    """One example's run on `device`; serving_demo's client loops go to a
    `serve` thread of this process on `device` (the demo's own child
    server keeps its launches in its own process)."""
    import importlib

    mod = importlib.import_module(
        f"neo_mpc_planner2_tpu_torch.examples.{name}")
    if name != "serving_demo":
        return mod.run(ticks=ticks, device=device)
    import threading

    from neo_mpc_planner2_tpu_torch.serving import OptimizerClient, serve

    if str(device) == "cpu":
        from neo_mpc_planner2_tpu_torch.serving import OptimizerSession

        return mod.run(ticks, call=OptimizerSession(device="cpu").handle,
                       fleet_ticks=ticks)
    port, ready = _free_port(), threading.Event()
    threading.Thread(target=serve, daemon=True, kwargs=dict(
        host="127.0.0.1", port=port, ready_event=ready,
        device=str(device))).start()
    ready.wait(30)
    client = OptimizerClient(port=port, wait_timeout=30)
    try:
        return mod.run(ticks, call=client.call, fleet_ticks=ticks)
    finally:
        client.close()


def _example_cmds(name: str, out: dict, ticks: int):
    """An example's commands of its first `ticks` ticks as (lanes, -1)."""
    import numpy as np

    if name == "fleet_demo":
        return np.moveaxis(out["cmds"][:ticks], 1, 0).reshape(
            out["cmds"].shape[1], -1)
    if name == "product_mode_demo":
        return np.concatenate([out[m]["cmds"][:, :ticks].reshape(
            out[m]["cmds"].shape[0], -1) for m in ("product", "parity")])
    if name == "serving_demo":
        return np.concatenate([out["cmds"][:ticks].reshape(1, -1),
                               np.moveaxis(out["fleet_cmds"][:ticks], 1,
                                           0).reshape(3, -1)])
    return out["cmds"][:ticks].reshape(1, -1)


def _example_outcome(name: str, out: dict) -> dict:
    """The numbers an example's docstring promises, at this run's length."""
    import numpy as np

    if name == "product_mode_demo":
        return {m: {"goals_within_10cm": int(
            (out[m]["goal_dist"][:, -1] < 0.10).sum()),
            "mean_iters": float(out[m]["solver_iters"].mean())}
            for m in ("product", "parity")}
    if name == "fleet_demo":
        return {"solves_per_sec": out["solves_per_sec"],
                "mean_cmd_speed_last": float(out["mean_cmd_speed"][-1])}
    keys = ("reached_tick", "fleet_reached_tick", "latch_first",
            "latch_last", "lethal_first", "lethal_last", "latched_en_route")
    res = {k: out[k] for k in keys if k in out}
    if "goal_dist" in out:
        res["goal_dist_last"] = float(np.asarray(out["goal_dist"])[-1])
    return res


def phase_examples(device) -> dict:
    """Every example (`neo_mpc_planner2_tpu_torch.examples.NAMES`) on the
    card at EXAMPLE_TICKS ticks (a run that reaches its goal stops there),
    its launch counts set to 0 just before and read just after; its
    commands finite; its first EXAMPLE_CPU_TICKS ticks' commands against
    the same example on the CPU (at least 99 % of lanes within 1e-3, as
    phase_card_vs_cpu); K1 and K3 launched. Then serving_demo as a user
    runs it: the console script in a child process on cuda:0, 2 ticks.
    Prints a line an example; returns the launches summed."""
    import numpy as np

    from neo_mpc_planner2_tpu_torch import examples
    from neo_mpc_planner2_tpu_torch.examples import serving_demo

    total = collections.Counter()
    for name in examples.NAMES:
        _reset_launch_counts()
        t0 = time.perf_counter()
        out = _example_runs(name, device, EXAMPLE_TICKS)
        wall = time.perf_counter() - t0
        launches = _launch_counts()
        card = _example_cmds(name, out, EXAMPLE_TICKS)
        if not np.isfinite(card).all():
            raise AssertionError(f"{name}: non-finite commands on the card")
        cpu = _example_cmds(name, _example_runs(name, "cpu",
                                                EXAMPLE_CPU_TICKS),
                            EXAMPLE_CPU_TICKS)
        diff = np.abs(_example_cmds(name, out, EXAMPLE_CPU_TICKS)
                      - cpu).max(-1)
        frac = float((diff <= 1e-3).mean())
        line = {"phase": f"example {name}", "device": str(device),
                "ticks": EXAMPLE_TICKS, "wall_s": wall,
                "cpu_ticks": EXAMPLE_CPU_TICKS,
                "max_cmd_diff_vs_cpu": float(diff.max()),
                "frac_within_1e-3": frac, "launches": launches,
                **_example_outcome(name, out)}
        print(json.dumps(line, default=float), flush=True)
        if frac < 0.99:
            raise AssertionError(f"{name} card vs CPU: only {frac:.4f} of "
                                 "lanes within 1e-3")
        for kernel in ("qp_admm", "footprint_cost"):
            if launches[kernel] <= 0:
                raise AssertionError(f"{name}: {kernel} never launched")
        total.update(launches)
    t0 = time.perf_counter()
    wire = serving_demo.run(2, device=str(device), fleet_ticks=2)
    if wire["ping"].get("backend") != "gpu" or not np.isfinite(
            wire["cmds"]).all():
        raise AssertionError(f"serving_demo's child server: {wire['ping']}")
    print(json.dumps({"phase": "example serving_demo (child server)",
                      "ping": wire["ping"], "ticks": 2,
                      "wall_s": time.perf_counter() - t0}), flush=True)
    out = {"phase": "examples", "launches": dict(total), "control_steps": 3}
    print(json.dumps(out), flush=True)
    return out


def _check_study(name: str, text: str) -> None:
    """Raises unless a study's output at its cut depth is what it must
    be on a card."""
    lines = text.splitlines()
    recs = [json.loads(ln) for ln in lines if ln.startswith("{")]
    if name == "iters_hist":
        alive = [float(ln.split(":")[1].split()[0]) for ln in lines[1:]]
        if (not lines[0].startswith("warm solves: 4096") or alive[0] != 1.0
                or any(b > a for a, b in zip(alive, alive[1:]))):
            raise AssertionError(f"iters_hist: {lines[:3]}")
    elif name == "trace_headline":
        top = [ln for ln in lines if ln.startswith("top ")]
        if (len(top) != 2 or top[0].startswith("top 0 ")
                or top[1].startswith("top 0 ")):
            raise AssertionError(f"trace_headline saw no device lane or "
                                 f"no launches: {top}")
    elif name == "dyn_decompose":
        if (len(recs) != 4
                or min(r["launches_per_tick"] for r in recs) <= 0):
            raise AssertionError(f"dyn_decompose: {recs}")
    elif name == "scaling_bench":
        if not recs or recs[0]["devices"] != 1 or not (
                0 < recs[0]["efficiency"] < 2):
            raise AssertionError(f"scaling_bench: {recs}")
    elif name == "product_decompose":
        if [r["pass"] for r in recs] != ["map64", "map128", "map128_cap16",
                                         "embed_lethal"]:
            raise AssertionError(f"product_decompose: {recs}")
    elif name == "parity_study":
        if not lines[-1].startswith("wrote "):
            raise AssertionError(f"parity_study: {lines[-3:]}")


def phase_studies(device) -> dict:
    """Every study (`neo_mpc_planner2_tpu_torch.scripts.NAMES`) through
    its main() on the card at STUDY_ARGS (a cut depth), its launch counts
    set to 0 just before and read just after, its output checked
    (_check_study), K1 and K3 launched (STUDY_KERNELS): a line a run with
    its wall and launches. The parity study's report goes under
    build/chip_smoke/. Returns the launches summed."""
    import contextlib
    import importlib
    import io
    import os

    total = collections.Counter()
    report = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "chip_smoke", "parity_report.json")
    for name, runs in STUDY_ARGS.items():
        mod = importlib.import_module(
            f"neo_mpc_planner2_tpu_torch.scripts.{name}")
        for args in runs:
            argv = ["--device", str(device), *args] + (
                ["--out", report] if name == "parity_study" else [])
            _reset_launch_counts()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                mod.main(argv)
            wall = time.perf_counter() - t0
            launches = _launch_counts()
            _check_study(name, buf.getvalue())
            print(json.dumps({"phase": f"study {name}", "args": list(args),
                              "wall_s": wall, "launches": launches,
                              "output": buf.getvalue().splitlines()[-14:]}),
                  flush=True)
            for kernel in STUDY_KERNELS.get(name, ("qp_admm",
                                                   "footprint_cost")):
                if launches[kernel] <= 0:
                    raise AssertionError(f"{name}: {kernel} never launched")
            total.update(launches)
    out = {"phase": "studies", "launches": dict(total), "control_steps": 3}
    print(json.dumps(out), flush=True)
    return out


def kernels_line(slices: dict, measured: dict) -> list:
    """The `kernels` line's entries, one per KERNELS entry, with the keys
    of KERNEL_KEYS. slices: name -> a timed run's output (its launches,
    its ticks where it has a tick count and, where not 3, control_steps); measured: name ->
    {max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms} at the
    slices' width and, optionally, "variants": the same numbers at each
    timed width m, to which each gets the launches of the runs at m, or
    at each launch plan (K3), to which each gets the launches its
    `counter` (a key of the runs' launches) counted."""
    entries = []
    for k in KERNELS:
        got = measured[k["name"]]
        runs = {s: out["launches"][k["name"]] for s, out in slices.items()}
        # K1's and K2's variants are widths m, launched by the runs at
        # that control_steps; K3's are launch plans, counted by plan.
        variants = [{**v, "launches": sum(
            n for s, n in runs.items()
            if 3 * slices[s].get("control_steps", 3) == v["m"])}
            if "m" in v else {**v, "launches": sum(
                out["launches"].get(v["counter"], 0)
                for out in slices.values())}
            for v in got.get("variants", [])]
        entries.append({
            "name": k["name"], "route": k["route"], "source": k["source"],
            "replaces": k["replaces"],
            # Launches on the slices' timed runs, all together.
            "launches": sum(runs.values()),
            "launches_per_tick": {s: n / slices[s]["ticks"]
                                  for s, n in runs.items()
                                  if "ticks" in slices[s]},
            "max_abs_err": got["max_abs_err"], "ms": got["ms"],
            "plain_ms": got["plain_ms"], "bound_ms": got["bound_ms"],
            "bound_by": got["bound_by"],
            "share_of_bound": got["bound_ms"] / got["ms"],
            "library_ms": got["library_ms"], "variants": variants})
    return entries


def k3_variants(k3: dict, walk_report: dict, wave: dict,
                walk: dict) -> list:
    """The `kernels` line's K3 variants: each launch plan of
    binding.k3_variant and k3_walk_variant that ran, its timing (the
    measured plan on the product wave, the walk's first plan on the exact
    slice's gate, the others at their timed shapes in the K3 phases), its
    calls in those phases and the counter of its launches on the runs."""
    timed = {"measured": wave, "lane": k3["plan_lane"],
             "split": k3["plan_split"]}
    walk_timed = {"edge_a_thread": walk,
                  "edges_a_thread": walk_report["walk_V40"]}
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound")
    out = []
    for mode, plans, calls in (
            ("footprint_cost", timed, k3["plans"]),
            ("footprint_walk", walk_timed, walk_report["plans"])):
        for plan, t in plans.items():
            out.append({"plan": plan, "mode": mode,
                        "shape": t.get("shape"), "max_abs_err": 0.0,
                        "library_ms": None, "calls_in_k3_phase":
                        calls.get(plan, 0), "counter": f"{mode}:{plan}",
                        **{k: t[k] for k in keys}})
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing runs on the CPU",
              file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(json.dumps({"phase": "device", "name": kind, "nvidia_smi": smi,
                      "torch": torch.__version__, "cuda": torch.version.cuda}),
          flush=True)

    from neo_mpc_planner2_tpu_torch.kernels import build

    build.build_library()
    print(json.dumps({"phase": "build", "built": build.last_build["built"],
                      "seconds": build.last_build["seconds"],
                      "ptxas": _ptxas_report(build.last_build["log"])}),
          flush=True)

    t0 = time.perf_counter()

    def progress(what: str) -> None:
        print(f"[chip_smoke] {what} done at {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)

    phase_launch_counts(device)
    k1 = isolated("phase_kernels")
    k2 = isolated("phase_k2")
    k3 = phase_k3(device)
    walk_report = phase_k3_walk(device)
    progress("kernel phases")
    slices = {}
    # K3's calls are captured in the product slice's warm-up (the gate, the
    # gradient calls, the wave), in the rolling slice's (through views) and
    # in the exact slice's (the walk mode).
    recorders = {"product": K3Recorder(), "rolling": K3Recorder(),
                 "exact": K3Recorder()}
    for name in SLICES:
        slices[name] = phase_slice(device, smi, name,
                                   recorder=recorders.get(name))
        phase_card_vs_cpu(device, name)
        progress(f"{name} slice")
    captured = phase_k3_captured(recorders["product"], WARM_TICKS)
    wave = next(v for k, v in captured.items() if k.startswith("wave"))
    phase_k3_captured(recorders["rolling"], WARM_TICKS, "rolling",
                      required=("view",))
    exact = phase_k3_captured(recorders["exact"], WARM_TICKS, "exact",
                              required=("walk",))
    walk = next(v for k, v in exact.items() if k.startswith("walk"))
    phase_map_refresh(device, smi)
    progress("captured K3 and map refresh")
    compact = phase_arms(device, smi, COMPACT_ARMS, "compaction")
    phase_card_vs_cpu(device, "fleet", cfg=COMPACT_ARMS["compact_adaptive"](),
                      label="compact_adaptive")
    waves = phase_arms(device, smi, WAVE_ARMS, "wave")
    progress("compaction and wave")
    phase_oracle(device, smi)
    progress("oracle gate")
    sharded = phase_sharded(device, smi)
    phase_server_shards(device, smi)
    progress("sharded engine and server")
    phase_serving(device, smi)
    progress("serving")
    controller = phase_controller(device, smi)
    phase_adapter_and_cli(device, smi)
    progress("controller")
    wide = phase_wide_footprints(device, smi)
    progress("wide footprints")
    horizons = phase_horizons(device, smi)
    progress("horizons")
    bench_run = phase_bench(device, smi)
    progress("bench")
    examples_run = isolated("phase_examples")
    progress("examples")
    studies_run = isolated("phase_studies")
    progress("studies")
    phase_launches_per_tick(device, slices)
    phase_arm_launches(device, {**compact, **waves})
    progress("launches a tick")

    measured = {
        "qp_admm": dict(max_abs_err=k1["qp_admm_max_abs_err"],
                        ms=k1["qp_admm_m9_ms"],
                        plain_ms=k1["qp_admm_plain_m9_ms"],
                        bound_ms=k1["qp_admm_m9_bound_ms"],
                        bound_by=k1["qp_admm_m9_bound_by"], library_ms=None,
                        variants=k1["variants"]),
        "spd_inv": dict(max_abs_err=k2["spd_inv_max_abs_err"],
                        ms=k2["spd_inv_m9_ms"],
                        plain_ms=k2["spd_inv_plain_m9_ms"],
                        bound_ms=k2["spd_inv_m9_bound_ms"],
                        bound_by=k2["spd_inv_m9_bound_by"],
                        library_ms=k2["spd_inv_library_m9_ms"],
                        variants=k2["variants"]),
        # On the product slice's own wave (R = 21, patch bounds).
        "footprint_cost": dict(max_abs_err=k3["footprint_cost_max_abs_err"],
                               ms=wave["ms"], plain_ms=wave["plain_ms"],
                               bound_ms=wave["bound_ms"],
                               bound_by=wave["bound_by"], library_ms=None,
                               variants=k3_variants(k3, walk_report, wave,
                                                    walk)),
    }
    # The launches of the timed runs: the slices, the SQP schedules' arms,
    # the sharded engine, the controller routes, the wide footprints, the
    # horizons' loops, the bench's passes, the examples and the studies.
    runs = {**slices, **compact, **waves, "sharded": sharded, **controller,
            **wide, **horizons, "bench": bench_run,
            "examples": examples_run, "studies": studies_run}
    print(json.dumps({"kernels": kernels_line(runs, measured)}), flush=True)
    print(_nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# The phases that isolated() runs in a process of their own.
ISOLATED = ("phase_kernels", "phase_k2", "phase_examples",
            "phase_studies")


def isolated(name: str) -> dict:
    """Run the phase `name` of ISOLATED on cuda:0 in a child process, with
    a fresh torch.profiler (on an H100, after K1's phase in the same
    process, profiled sessions were seen to report no device records),
    relay its output and return its line. Raises if it fails."""
    import os

    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--phase", name], capture_output=True, text=True,
                          timeout=900)
    sys.stdout.write(proc.stdout)
    sys.stdout.flush()
    sys.stderr.write(proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(f"{name} failed in its process "
                             f"(exit {proc.returncode})")
    return json.loads([line for line in proc.stdout.splitlines()
                       if line.startswith("{")][-1])


def run_isolated(name: str) -> int:
    """The child side of isolated(): the kernels are already built."""
    import torch

    from neo_mpc_planner2_tpu_torch.kernels import build

    if name not in ISOLATED or not torch.cuda.is_available():
        print(f"chip_smoke: no isolated phase {name!r} here", file=sys.stderr)
        return 2
    build.build_library()
    globals()[name](torch.device("cuda:0"))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--phase":
        sys.exit(run_isolated(sys.argv[2]))
    sys.exit(main())
