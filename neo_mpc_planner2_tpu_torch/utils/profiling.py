"""Tracing / profiling utilities (port of `utils/profiling.py`).

- `device_trace(logdir)`: context manager around torch.profiler, with CUDA
  activity where a card is present, that writes a chrome trace of what ran
  inside it into `logdir`.
- `device_module_durations_ms(logdir)` / `host_call_counts(logdir)`: read
  the newest such trace: each kernel's device durations, and the host's
  CUDA runtime calls (launches, synchronizations) by name.
- `device_step_durations_ms(logdir, prefix)`: the device time of each
  host range (`torch.profiler.record_function`) named `prefix...` in the
  newest trace: the summed durations of the kernels it launched.
- `host_launches_by_op(logdir)`: the newest trace's kernel launches by
  the host op (a torch op or a named range) that made them.
- `Timer` / `RateTracker`: host-side phase timers exporting the solves/s
  and p50/p99 latency counters the benchmarks and the serving layer report
  (copied unchanged).
"""

from __future__ import annotations

import bisect
import contextlib
import glob
import json
import os
import time
from collections import deque
from typing import Deque, Dict

import numpy as np

__all__ = ["device_trace", "device_module_durations_ms", "host_call_counts",
           "device_step_durations_ms", "host_launches_by_op", "LAUNCH_CALLS",
           "SYNC_CALLS", "Timer", "RateTracker"]

_TRACE_GLOB = "trace_*.json"


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the body with torch.profiler (CPU activity, and CUDA activity
    when a card is present) and write its chrome trace to
    `logdir/trace_<ns>.json` on exit; the body's queued device work is
    waited for before the trace closes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{time.time_ns()}.json"))


def _latest_trace_events(logdir: str) -> list:
    paths = sorted(glob.glob(os.path.join(logdir, _TRACE_GLOB)))
    if not paths:
        return []
    with open(paths[-1]) as f:
        return json.load(f).get("traceEvents", [])


def device_module_durations_ms(logdir: str) -> Dict[str, list]:
    """Per-launch DEVICE durations of each kernel in the newest trace that
    `device_trace` wrote to `logdir`.

    The JAX package's function of this name reads the `jit_*` XLA modules
    of a jax.profiler trace; eager PyTorch runs no such modules, so this
    one reads the kernels (chrome-trace events of category "kernel", the
    device lane) of a torch.profiler trace: the card's own record of what
    it spent, without the host's enqueue.

    Returns {kernel name: [duration_ms, ...]} in time order; {} when the
    trace has no device lane (as on the CPU) or there is no trace.
    """
    out: Dict[str, list] = {}
    for e in _latest_trace_events(logdir):
        if e.get("ph") == "X" and str(e.get("cat", "")).lower() == "kernel":
            out.setdefault(str(e.get("name", "")), []).append(
                (float(e.get("ts", 0.0)), float(e.get("dur", 0.0)) / 1e3))
    return {k: [d for _, d in sorted(v)] for k, v in out.items()}


def host_call_counts(logdir: str) -> Dict[str, int]:
    """How many times the host called each CUDA runtime function (category
    "cuda_runtime": cudaLaunchKernel, cudaStreamSynchronize,
    cudaMemcpyAsync, ...) in the newest trace that `device_trace` wrote to
    `logdir`; {} without a card."""
    counts: Dict[str, int] = {}
    for e in _latest_trace_events(logdir):
        if (e.get("ph") == "X"
                and str(e.get("cat", "")).lower() == "cuda_runtime"):
            name = str(e.get("name", ""))
            counts[name] = counts.get(name, 0) + 1
    return counts


# The host calls that launch a kernel: CUDA runtime or driver API calls.
_LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
# Their names, and those of the host calls that wait for the card.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


def host_launches_by_op(logdir: str) -> Dict[str, int]:
    """The kernel launches (LAUNCH_CALLS) in the newest trace that
    `device_trace` wrote to `logdir`, by the innermost host op around each
    on its thread: a torch op ("aten::add_", category "cpu_op") or a named
    range (`record_function`, "user_annotation"); "(no op)" where none
    holds it. {} without a card."""
    events = [e for e in _latest_trace_events(logdir) if e.get("ph") == "X"]
    marks = []  # (ts, kind, end, name): ops open before the launches at ts
    for e in events:
        cat = str(e.get("cat", "")).lower()
        ts, tid = float(e.get("ts", 0.0)), e.get("tid")
        if cat in ("cpu_op", "user_annotation"):
            marks.append((tid, ts, 0, ts + float(e.get("dur", 0.0)),
                          str(e.get("name", ""))))
        elif (cat in _LAUNCH_CATEGORIES
              and str(e.get("name", "")) in LAUNCH_CALLS):
            marks.append((tid, ts, 1, ts, None))
    marks.sort(key=lambda m: (str(m[0]), m[1], m[2], -m[3]))
    counts: Dict[str, int] = {}
    stack, tid = [], object()
    for t, ts, kind, end, name in marks:
        if t != tid:
            stack, tid = [], t
        while stack and stack[-1][0] < ts:
            stack.pop()
        if kind == 0:
            stack.append((end, name))
        else:
            op = stack[-1][1] if stack else "(no op)"
            counts[op] = counts.get(op, 0) + 1
    return counts


def device_step_durations_ms(logdir: str, prefix: str) -> list:
    """The device time of each step in the newest trace that `device_trace`
    wrote to `logdir`, a step being a host range whose name starts with
    `prefix` (a `torch.profiler.record_function` around it): the summed
    device durations, in ms, of the kernels that the host calls inside the
    range launched (the card's busy time for the step; a kernel belongs to
    its launch by the trace's correlation id). One entry a range, in time
    order; a range that launched no recorded kernel reads 0.0, as does
    every range of a trace without a device lane (the CPU)."""
    events = [e for e in _latest_trace_events(logdir) if e.get("ph") == "X"]
    ranges = sorted((float(e.get("ts", 0.0)),
                     float(e.get("ts", 0.0)) + float(e.get("dur", 0.0)))
                    for e in events
                    if str(e.get("cat", "")).lower() == "user_annotation"
                    and str(e.get("name", "")).startswith(prefix))
    launched_at = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if (corr is not None
                and str(e.get("cat", "")).lower() in _LAUNCH_CATEGORIES):
            launched_at[corr] = float(e.get("ts", 0.0))
    out = [0.0] * len(ranges)
    starts = [lo for lo, _ in ranges]
    for e in events:
        if str(e.get("cat", "")).lower() != "kernel":
            continue
        ts = launched_at.get((e.get("args") or {}).get("correlation"))
        if ts is None:
            continue
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= ranges[i][1]:
            out[i] += float(e.get("dur", 0.0)) / 1e3
    return out


class Timer:
    """Accumulating per-phase wall timers: Timer.phase('solve') context."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": v, "count": self.counts[k],
                "mean_ms": 1e3 * v / max(self.counts[k], 1)}
            for k, v in self.totals.items()
        }


class RateTracker:
    """Sliding-window latency/rate stats (p50/p99/Hz) for the control loop."""

    def __init__(self, window: int = 512):
        self.samples: Deque[float] = deque(maxlen=window)

    def record(self, seconds: float) -> None:
        self.samples.append(seconds)

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(time.perf_counter() - t0)

    def stats(self) -> Dict[str, float]:
        if not self.samples:
            return {"count": 0}
        a = np.array(self.samples)
        return {
            "count": len(a),
            "p50_ms": float(np.percentile(a, 50) * 1e3),
            "p99_ms": float(np.percentile(a, 99) * 1e3),
            "mean_ms": float(a.mean() * 1e3),
            "rate_hz": float(1.0 / a.mean()) if a.mean() > 0 else float("inf"),
        }
