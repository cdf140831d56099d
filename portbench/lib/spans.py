"""The program's own spans and counters (neo_mpc_planner2_tpu_torch's
`utils.profiling.recording`) over a profiled piece of work, and their
arithmetic against the piece's device trace.

A span here is a record with the program's SpanRecord fields: name,
start_ns, end_ns (time.monotonic_ns), parent (the id of the span open
around it on its thread, or None), trace (the id its root gave every span
under it), tid (the thread's native id), attrs, id and ident (the
thread's `threading.get_ident()`). torch.profiler gives a thread's CUDA
calls its native id as their tid, or, for a thread it did not see start
(the server's, started before the session), the low 32 bits of its
ident.

- `piece`: one profiled piece with the program's recording open inside
  the profiler session; its spans, counts and clock offset.
- `self_ms`: each span name's time less its children's.
- `gap_seconds_by_span`: each idle gap of the device by the innermost
  program span open, on the issuing thread, at the host call (found by
  correlation id among every CUDA runtime and driver call, copies
  included) that issued the device operation ending the gap.
- `fleet_readings` / `serve_readings`: the per-layer numbers of a fleet
  piece and of a serve piece.
"""

from __future__ import annotations

import numpy as np

from . import trace

OUTSIDE = "(outside the program's spans)"
NO_CALL = "(device op without a host call)"
OTHER_THREAD = " (other thread)"


def piece(recording, fn) -> dict:
    """Run fn() under torch.profiler (lib/trace.profile) with the program's
    `recording` open inside the session. -> {events, wall_s, spans, counts,
    dropped, offset_us (span ns / 1e3 + offset = the trace's ts; None where
    the log's clock anchors do not map onto the trace), offset_error (why,
    or None), result (fn's)}."""
    got = {}

    def body():
        with recording() as log:
            got["result"] = fn()
        got["log"] = log

    events, wall = trace.profile(body)
    log = got["log"]
    try:
        offset, error = log.offset_us(events), None
    except ValueError as e:
        offset, error = None, str(e)
    return {"events": events, "wall_s": wall, "spans": list(log.spans),
            "counts": dict(log.counts), "dropped": log.dropped,
            "offset_us": offset, "offset_error": error,
            "result": got["result"]}


def _dur_ms(s) -> float:
    return (s.end_ns - s.start_ns) / 1e6


def self_ms(spans) -> dict:
    """{name: summed time of its spans less their children's, ms}."""
    inner = {}
    for s in spans:
        if s.parent is not None:
            inner[s.parent] = inner.get(s.parent, 0.0) + _dur_ms(s)
    out = {}
    for s in spans:
        own = _dur_ms(s) - inner.get(s.id, 0.0)
        out[s.name] = out.get(s.name, 0.0) + own
    return out


def _innermost(spans, offset_us: float, calls: dict) -> dict:
    """{correlation: the span a call goes to}, for calls {correlation:
    (tid, ts)}: the innermost span open on the call's thread at its time;
    on a thread with none open, the innermost span open on the one other
    thread that has one, its name + OTHER_THREAD; else OUTSIDE."""
    alias = {str(s.ident & 0xFFFFFFFF): str(s.tid) for s in spans}
    marks = [(s.start_ns / 1e3 + offset_us, 0, -(s.end_ns / 1e3 + offset_us),
              str(s.tid), s.name) for s in spans]
    marks += [(ts, 1, 0.0, alias.get(tid, tid), corr)
              for corr, (tid, ts) in calls.items()]
    marks.sort(key=lambda m: m[:3])  # a span before a call at its start
    stacks = {}  # tid -> [(end, name)], the spans open, innermost last

    def open_at(tid, ts):
        st = stacks.get(tid)
        while st and st[-1][0] < ts:
            st.pop()
        return st[-1][1] if st else None

    out = {}
    for ts, kind, neg_end, tid, what in marks:
        if kind == 0:
            open_at(tid, ts)
            stacks.setdefault(tid, []).append((-neg_end, what))
            continue
        own = open_at(tid, ts)
        if own is not None:
            out[what] = own
            continue
        others = [n for n in (open_at(t, ts) for t in stacks if t != tid)
                  if n is not None]
        out[what] = others[0] + OTHER_THREAD if len(others) == 1 else OUTSIDE
    return out


def gap_seconds_by_span(events, spans, offset_us: float) -> dict:
    """{span name: idle seconds of the device}: every gap between device
    operations, put down to the innermost program span open on the thread
    of the host call that issued the operation ending the gap. A call on
    a thread with no span open (the autograd engine's device thread runs
    the backward of `torch.autograd.grad` while its caller waits inside a
    span) goes to the innermost span then open on the one thread that has
    one, named with OTHER_THREAD; OUTSIDE where no span (or more than one
    thread's) was open, NO_CALL where the trace holds no host call of that
    correlation id. {} where offset_us is None (no clock shared with the
    trace)."""
    if offset_us is None:
        return {}
    calls = {}
    for e in events:
        if trace._cat(e) in trace.HOST_API:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                calls[corr] = (str(e.get("tid")), float(e.get("ts", 0.0)))
    gaps, end = [], None
    for lo, hi, _, corr in trace.device_intervals(events):
        if end is not None and lo > end:
            gaps.append((corr, (lo - end) / 1e6))
        end = hi if end is None else max(end, hi)
    names = _innermost(spans, offset_us,
                       {c: calls[c] for c, _ in gaps if c in calls})
    out = {}
    for corr, s in gaps:
        key = names.get(corr, NO_CALL)
        out[key] = out.get(key, 0.0) + s
    return out


def top(d: dict, n: int = 10) -> list:
    """The n largest entries of {name: value}, as [[name, value], ...]."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def named_share(gaps: dict, other_threads: bool = True) -> float:
    """The share of the idle seconds put down to a program span, in %;
    with other_threads False, only to one open on the issuing thread."""
    total = sum(gaps.values())
    named = sum(v for k, v in gaps.items() if k not in (OUTSIDE, NO_CALL)
                and (other_threads or not k.endswith(OTHER_THREAD)))
    return 100.0 * named / total if total else 0.0


def fleet_readings(spans, counts: dict, lane_iters: int) -> dict:
    """The fleet piece's numbers; lane_iters is the piece's
    SimResult.solver_iters summed (each lane's iterations, every tick).
    {} where the program recorded no solve."""
    solves = counts.get("sqp.solves", 0)
    ticks = [s for s in spans if s.name == "tick"]
    if not solves or not ticks:
        return {}
    solve_ms = sum(_dur_ms(s) for s in spans if s.name == "sqp.solve")
    tick_ms = sum(_dur_ms(s) for s in ticks)
    return {
        "sqp.trips_per_solve": counts["sqp.trips"] / solves,
        "sqp.lane_use": 100.0 * lane_iters / counts["sqp.lane_slots"],
        "sqp.ls_evals_per_solve": counts.get("sqp.ls_evals", 0) / solves,
        "sqp.host_ms_per_tick": solve_ms / len(ticks),
        "engine.host_ms_per_tick": (tick_ms - solve_ms) / len(ticks),
    }


def _root_of(spans) -> dict:
    """{span id: its `serve.request` ancestor}."""
    by_id = {s.id: s for s in spans}
    out = {}
    for s in spans:
        p = s
        while p is not None and p.name != "serve.request":
            p = by_id.get(p.parent)
        if p is not None:
            out[s.id] = p
    return out


def serve_readings(spans, counts: dict, latencies_s) -> dict:
    """The serve piece's numbers over its `optimizer` requests (the
    `set_costmap` calls between episodes are left out); latencies_s are
    the client's latencies of those requests, in order. The server closes
    a request's span after its reply is sent, so the piece's last request
    may have a latency and no span: latencies pair with spans in order
    where there are as many, or one more. {} where the program recorded
    no request."""
    reqs = sorted((s for s in spans if s.name == "serve.request"
                   and s.attrs.get("op") == "optimizer"),
                  key=lambda s: s.start_ns)
    if not reqs:
        return {}
    root = _root_of(spans)
    solve = {root[s.id].id: s for s in spans
             if s.name == "serve.solve" and s.id in root}
    solve_ms = [_dur_ms(solve[r.id]) for r in reqs if r.id in solve]
    host_ms = [_dur_ms(r) - _dur_ms(solve[r.id]) for r in reqs
               if r.id in solve]
    if not solve_ms:
        return {}
    out = {
        "serving.solve_ms_p50": float(np.percentile(solve_ms, 50)),
        "serving.solve_ms_p95": float(np.percentile(solve_ms, 95)),
        "serving.host_ms_p50": float(np.percentile(host_ms, 50)),
    }
    lat = list(latencies_s)
    if len(reqs) <= len(lat) <= len(reqs) + 1:
        out["serving.transport_ms_p50"] = float(np.percentile(
            [1e3 * t - _dur_ms(r) for t, r in zip(lat, reqs)], 50))
    if counts.get("sqp.solves"):
        out["sqp.trips_per_request"] = (counts["sqp.trips"]
                                        / counts["sqp.solves"])
    return out
