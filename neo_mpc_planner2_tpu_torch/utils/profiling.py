"""Tracing and profiling (port of `utils/profiling.py`).

Spans and counters inside the program, on a clock that maps onto a
torch.profiler trace:

- `span(name, **attrs)`: a context manager around a piece of the
  program's host work. A root span may name its trace id with the attr
  `trace`; every span under it shares that id.
- `count(name, n=1)`: adds n to a named counter. It takes host-known
  values only: it never reads a tensor and never waits for the device.
- `recording()`: records the spans and counts of every thread of the
  process while it is open, and yields the log they are merged into on
  exit (`SpanLog`: `.spans`, `.counts`, `.dropped`, `.offset_us`).
- `tally()`: the calling thread's counts go into the dict it yields, and
  not into a recording, while it is open: a CUDA graph's capture runs the
  program's host code without doing its work, and each replay adds what
  the capture counted.

Outside `recording()` (and `device_trace`) and `tally()` nothing is
recorded: `span()` returns one shared no-op object after one read of a
module global, and `count()` returns after two such reads; neither takes
a lock nor calls torch.

Device traces:

- `device_trace(logdir)`: context manager around torch.profiler, with
  CUDA activity where a card is present, that writes a chrome trace of
  what ran inside it into `logdir`, the program's spans of its body
  included (category "program_span", each thread's on a row of its own
  under the process "program spans").
- `device_module_durations_ms(logdir)` / `host_call_counts(logdir)`: read
  the newest such trace: each kernel's device durations, and the host's
  CUDA runtime calls (launches, synchronizations) by name.
- `device_step_durations_ms(logdir, prefix)`: the device time of each
  host range (`torch.profiler.record_function`) named `prefix...` in the
  newest trace: the summed durations of the kernels it launched.
- `host_launches_by_op(logdir)`: the newest trace's kernel launches by
  the host op (a torch op or a named range) that made them.
- `RateTracker`: sliding-window latency and rate statistics (p50/p99/Hz),
  copied unchanged.

The JAX package's `Timer` has no counterpart: `span` and `recording`
time the program's phases.
"""

from __future__ import annotations

import bisect
import contextlib
import glob
import itertools
import json
import os
import re
import threading
import time
import warnings
from collections import deque
from typing import Deque, Dict, NamedTuple, Optional

import numpy as np

__all__ = ["span", "count", "tally", "recording", "SpanLog", "SpanRecord",
           "device_trace", "device_module_durations_ms", "host_call_counts",
           "device_step_durations_ms", "host_launches_by_op", "LAUNCH_CALLS",
           "SYNC_CALLS", "RateTracker"]

# The most records one recording keeps; the rest are counted as dropped.
RECORD_CAP = 1 << 20
# The name of the clock anchors: a record_function range and a span each.
ANCHOR = "neo_mpc.clock_anchor"
# The anchors taken back to back at a recording's entry and at its exit.
ANCHOR_SAMPLES = 5
# Entry and exit offsets that differ by more than this share no clock.
ANCHOR_TOLERANCE_US = 100.0
SPAN_CATEGORY = "program_span"

_ON = False          # recording, for every thread
_TALLY = None        # (thread ident, counts) while tally() is open
_SESSION = None      # the current (or last) recording's _Session
_IDS = itertools.count()
_TLS = threading.local()


class SpanRecord(NamedTuple):
    """One finished span. Times are time.monotonic_ns()."""

    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]  # id of the span open around it on its thread
    trace: object          # the trace id every span under its root shares
    tid: int               # threading.get_native_id() of its thread
    attrs: dict
    id: int
    # threading.get_ident() of its thread: torch.profiler gives the CUDA
    # calls of a thread it did not see start this id's low 32 bits as
    # their tid, in place of the native id.
    ident: int


class _NoSpan:
    """What span() returns while nothing is recorded."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NO_SPAN = _NoSpan()


class _Buffer:
    """One thread's records and counts in one recording."""

    __slots__ = ("records", "counts", "dropped", "tid", "ident")

    def __init__(self):
        self.records, self.counts, self.dropped = [], {}, 0
        self.tid = threading.get_native_id()
        self.ident = threading.get_ident()


class _Session:
    """One recording: the buffers of the threads that recorded in it."""

    def __init__(self):
        self.cap = RECORD_CAP
        self.kept = itertools.count()   # records offered (next() is atomic)
        self.roots = itertools.count(1)
        self.buffers: list = []
        self.lock = threading.Lock()

    def buffer(self) -> _Buffer:
        """The calling thread's buffer, made at its first record."""
        tls = _TLS
        if getattr(tls, "session", None) is not self:
            buf = _Buffer()
            with self.lock:
                self.buffers.append(buf)
            tls.session, tls.buffer = self, buf
        return tls.buffer

    def keep(self, span: "_Span", end: int) -> None:
        buf = self.buffer()
        if next(self.kept) < self.cap:
            buf.records.append(SpanRecord(
                span.name, span.start, end, span.parent, span.trace,
                buf.tid, span.attrs, span.id, buf.ident))
        else:
            buf.dropped += 1


def _stack() -> list:
    """The calling thread's open spans, innermost last."""
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


class _Span:
    __slots__ = ("name", "attrs", "session", "id", "parent", "trace",
                 "start")

    def __init__(self, name: str, attrs: dict, session: _Session):
        self.name, self.attrs, self.session = name, attrs, session

    def __enter__(self):
        st = _stack()
        trace = self.attrs.pop("trace", None)
        self.id = next(_IDS)
        if st:
            self.parent, self.trace = st[-1].id, st[-1].trace
        else:
            # A root: its own trace id, or a fresh negative one (tick
            # indices and request numbers are not negative).
            self.parent = None
            self.trace = (trace if trace is not None
                          else -next(self.session.roots))
        st.append(self)
        self.start = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        end = time.monotonic_ns()
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        elif self in st:
            st.remove(self)
        self.session.keep(self, end)
        return False

    def set(self, **attrs) -> None:
        """Add attrs known only once the span is open."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A context manager that records one span of the calling thread
    while `recording()` is open, and does nothing otherwise. `attrs` are
    kept with the record (host-known values only); a root span's `trace`
    attr is its trace id. The object it yields takes more attrs with
    `.set(**attrs)`."""
    if not _ON:
        return _NO_SPAN
    return _Span(name, attrs, _SESSION)


def count(name: str, n: int = 1) -> None:
    """Add n, a host-known number, to the counter `name` while
    `recording()` is open, or to the calling thread's `tally()`; nothing
    otherwise."""
    tally_ = _TALLY
    if tally_ is not None and tally_[0] == threading.get_ident():
        tally_[1][name] = tally_[1].get(name, 0) + n
        return
    if not _ON:
        return
    counts = _SESSION.buffer().counts
    counts[name] = counts.get(name, 0) + n


class SpanLog:
    """What one `recording()` kept: `spans` (SpanRecords, by start),
    `counts` ({name: total}), `dropped` (records past the cap) and
    `anchors` (its clock anchors: ANCHOR_SAMPLES at entry, then as many
    at exit)."""

    def __init__(self):
        self.spans: list = []
        self.counts: Dict[str, int] = {}
        self.dropped = 0
        self.anchors: list = []

    def offset_us(self, events) -> float:
        """The offset that maps this log's times onto the `ts` (µs) of a
        chrome trace of a torch.profiler session that was open around the
        recording: ts = ns / 1e3 + offset. Read from the clock anchors,
        matched at their ends (the profiler stamps a range's end at the
        end of its exit; its start comes after a variable share of the
        entry's work). An anchor's clock is read after its range's end,
        so an anchor read late (its thread preempted between the two)
        gives too small an offset: of the samples taken back to back at
        entry, and of those at exit, the largest offset is kept. Raises
        ValueError where the trace lacks the anchors, or where the
        entry's and the exit's offsets differ by more than
        ANCHOR_TOLERANCE_US."""
        marks = sorted((float(e["ts"]) + float(e.get("dur", 0.0)))
                       for e in events
                       if e.get("ph") == "X" and e.get("name") == ANCHOR)
        ends = [a.end_ns / 1e3 for a in self.anchors]
        n = len(ends)
        if n != 2 * ANCHOR_SAMPLES or len(marks) < n:
            raise ValueError(f"{len(marks)} clock anchors in the trace, "
                             f"{n} in the log; need {2 * ANCHOR_SAMPLES}")

        def offsets(i):
            return [marks[i + j] - ends[j] for j in range(n)]

        def scatter(i):
            off = offsets(i)
            mid = float(np.median(off))
            return float(np.median([abs(o - mid) for o in off]))

        # The trace may hold other recordings' anchors: take the run of n
        # consecutive ones whose offsets agree best with this log's.
        off = offsets(min(range(len(marks) - n + 1), key=scatter))
        entry, exit_ = max(off[:ANCHOR_SAMPLES]), max(off[ANCHOR_SAMPLES:])
        if abs(entry - exit_) > ANCHOR_TOLERANCE_US:
            raise ValueError(f"the clock anchors' offsets differ by "
                             f"{abs(entry - exit_):.1f} us")
        return (entry + exit_) / 2.0

    def trace_events(self, offset_us: float) -> list:
        """The spans as chrome-trace events (category SPAN_CATEGORY), on
        the trace's clock."""
        return [{"ph": "X", "cat": SPAN_CATEGORY, "name": s.name,
                 "pid": "program spans", "tid": s.tid,
                 "ts": s.start_ns / 1e3 + offset_us,
                 "dur": (s.end_ns - s.start_ns) / 1e3,
                 "args": {**s.attrs, "id": s.id, "parent": s.parent,
                          "trace": s.trace}}
                for s in self.spans]


def _anchors(session: _Session) -> list:
    """ANCHOR_SAMPLES clock anchors back to back, each a record_function
    range (which a profiler session records) and, around it, a span of the
    same name (kept past the cap)."""
    from torch.profiler import record_function

    out = []
    for _ in range(ANCHOR_SAMPLES):
        start = time.monotonic_ns()
        with record_function(ANCHOR):
            pass
        end = time.monotonic_ns()
        out.append(SpanRecord(ANCHOR, start, end, None, -next(session.roots),
                              threading.get_native_id(), {}, next(_IDS),
                              threading.get_ident()))
    return out


@contextlib.contextmanager
def tally():
    """Yield a dict {name: total} that takes the calling thread's counts
    while open, in place of the recording (other threads count as
    before). Not nested."""
    global _TALLY
    if _TALLY is not None:
        raise RuntimeError("tally() is already open")
    counts: Dict[str, int] = {}
    _TALLY = (threading.get_ident(), counts)
    try:
        yield counts
    finally:
        _TALLY = None


@contextlib.contextmanager
def recording():
    """Record the spans and counts of every thread of the process, those
    started before it included, while the body runs. Yields a SpanLog,
    filled on exit from the threads' buffers; at most RECORD_CAP records
    are kept, the rest counted in `.dropped`. Clock anchors are taken on
    the calling thread at entry and at exit (see SpanLog.offset_us).
    Recordings do not nest."""
    global _ON, _SESSION
    if _ON:
        raise RuntimeError("recording() is already open")
    session = _Session()
    log = SpanLog()
    _SESSION = session
    _ON = True
    try:
        log.anchors.extend(_anchors(session))
        yield log
    finally:
        log.anchors.extend(_anchors(session))
        _ON = False
        with session.lock:
            buffers = list(session.buffers)
        spans = list(log.anchors)
        for buf in buffers:
            spans.extend(buf.records)
            log.dropped += buf.dropped
            for k, v in list(buf.counts.items()):
                log.counts[k] = log.counts.get(k, 0) + v
        spans.sort(key=lambda s: (s.start_ns, s.id))
        log.spans = spans


_TRACE_GLOB = "trace_*.json"


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the body with torch.profiler (CPU activity, and CUDA activity
    when a card is present) and write its chrome trace to
    `logdir/trace_<ns>.json` on exit; the body's queued device work is
    waited for before the trace closes. The program's spans of the body
    are recorded (unless a recording is already open) and written into
    the trace as category "program_span"; a trace whose clock anchors do
    not match is written without them, with a warning."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        with (contextlib.nullcontext() if _ON else recording()) as log:
            try:
                yield
            finally:
                if cuda:
                    torch.cuda.synchronize()
    path = os.path.join(logdir, f"trace_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    if log is not None:
        _write_spans(path, log)


def _write_spans(path: str, log: SpanLog) -> None:
    """Add the log's spans to the chrome trace at `path`. The trace is
    read as text and not parsed: only its clock anchors are decoded, and
    the spans go in at the head of its traceEvents list."""
    with open(path) as f:
        text = f.read()
    decode = json.JSONDecoder().raw_decode
    anchors = []
    at = text.find(f'"{ANCHOR}"')
    while at >= 0:
        try:
            event, _ = decode(text, text.rfind("{", 0, at))
        except ValueError:
            event = None
        if isinstance(event, dict) and event.get("name") == ANCHOR:
            anchors.append(event)
        at = text.find(f'"{ANCHOR}"', at + 1)
    head = re.search(r'"traceEvents":\s*\[', text)
    try:
        if head is None:
            raise ValueError("the trace has no traceEvents list")
        offset = log.offset_us(anchors)
    except ValueError as e:
        warnings.warn(f"device_trace: program spans left out: {e}")
        return
    spans = "".join(json.dumps(e, default=str) + ",\n"
                    for e in log.trace_events(offset))
    with open(path, "w") as f:
        f.write(text[:head.end()])
        f.write("\n" + spans)
        f.write(text[head.end():])


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
