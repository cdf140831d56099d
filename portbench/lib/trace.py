"""The traced part of a run: one torch.profiler session over a bounded
piece of work, and the arithmetic over its events.

The session covers only the piece it is given (a few ticks, or a few dozen
requests), in a fresh process, so that it stays small and none of the
profiler's records are lost to an earlier session. Its chrome trace is
written once to the run's TMPDIR, read back and deleted.

Event arithmetic (the categories and call names are torch.profiler's):
- launches: host calls that launch a kernel (runtime or driver API);
- syncs: host calls that wait for the device;
- busy: the union of the intervals in which the device ran a kernel, a
  copy or a fill;
- each launch's host op: the innermost torch op or named range open
  around it on its thread.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
HOST_API = ("cuda_runtime", "cuda_driver")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile(fn) -> tuple:
    """Run fn() under torch.profiler (host and device activity) and return
    (events, wall seconds of fn, ending in a device sync)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return [e for e in events if e.get("ph") == "X"], wall


def _cat(e) -> str:
    return str(e.get("cat", "")).lower()


def count_launches(events) -> int:
    return sum(1 for e in events
               if _cat(e) in HOST_API and e.get("name") in LAUNCH_CALLS)


def count_syncs(events) -> int:
    return sum(1 for e in events
               if _cat(e) in HOST_API and e.get("name") in SYNC_CALLS)


def device_intervals(events) -> list:
    """(start, end, name, correlation) of every device operation, in µs."""
    out = []
    for e in events:
        if _cat(e) in DEVICE_CATS:
            ts = float(e.get("ts", 0.0))
            out.append((ts, ts + float(e.get("dur", 0.0)),
                        str(e.get("name", "")),
                        (e.get("args") or {}).get("correlation")))
    out.sort()
    return out


def busy_us(events) -> float:
    """The union of the device's operation intervals, µs."""
    total, end = 0.0, None
    for lo, hi, _, _ in device_intervals(events):
        if end is None or lo > end:
            total += hi - lo
            end = hi
        elif hi > end:
            total += hi - end
            end = hi
    return total


def launch_ops(events) -> dict:
    """correlation id of each launch -> the innermost host op around it."""
    marks = []
    for e in events:
        cat, tid = _cat(e), str(e.get("tid"))
        ts = float(e.get("ts", 0.0))
        if cat in ("cpu_op", "user_annotation"):
            marks.append((tid, ts, 0, ts + float(e.get("dur", 0.0)),
                          str(e.get("name", ""))))
        elif cat in HOST_API and e.get("name") in LAUNCH_CALLS:
            corr = (e.get("args") or {}).get("correlation")
            marks.append((tid, ts, 1, ts, corr))
    marks.sort(key=lambda m: (m[0], m[1], m[2], -m[3]))
    out, stack, tid = {}, [], None
    for t, ts, kind, end, what in marks:
        if t != tid:
            stack, tid = [], t
        while stack and stack[-1][0] < ts:
            stack.pop()
        if kind == 0:
            stack.append((end, what))
        else:
            out[what] = stack[-1][1] if stack else "(no op)"
    return out


def short_name(name: str, width: int = 120) -> str:
    """A kernel's name without the namespaces and return type, cut to
    `width` characters."""
    for junk in ("void ", "at::native::", "(anonymous namespace)::",
                 "std::"):
        name = name.replace(junk, "")
    return name[:width]


def breakdown(events, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps by the host op that launched the operation ending each gap
    (seconds, as measured)."""
    ops, gaps = {}, {}
    names = launch_ops(events)
    end = None
    for lo, hi, name, corr in device_intervals(events):
        name = short_name(name)
        ops[name] = ops.get(name, 0.0) + (hi - lo) / 1e6
        if end is not None and lo > end:
            key = names.get(corr, "(device op without a launch)")
            gaps[key] = gaps.get(key, 0.0) + (lo - end) / 1e6
        end = hi if end is None else max(end, hi)
    pick = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])[:top]]
    return {"device_ops": pick(ops), "idle_gaps": pick(gaps)}


def kernel_durations_us(events, needle: str) -> list:
    return [hi - lo for lo, hi, name, _ in device_intervals(events)
            if needle in name]
