"""The port's spans and counters (`utils.profiling.span`, `count`,
`recording`), on the CPU at a tiny size.

- Outside `recording()` a closed loop and a served request record nothing.
- A thread started before `recording()` opens has its spans recorded,
  with its native thread id, its parent and its root's trace id; many
  threads at once lose no record and no count, and records past the cap
  are counted as dropped.
- Under a torch.profiler session both clock anchors map span time onto
  the trace's `ts` within 100 µs of each other, and `device_trace`
  writes the spans into its chrome trace, aligned with the profiler's own
  ranges.
- On a parity closed loop the SQP's counters agree with its results: the
  masked loop's trips a tick are the tick's most iterations, each trip
  holds every lane, and the line search evaluates the merit at least once
  a trip. Commands and states are bit-identical with recording on and
  off.
- One `optimizer` request through `serve` on loopback is one trace of
  nested server spans.
"""

import dataclasses
import glob
import json
import sys
import threading

import numpy as np
import pytest
import torch

import neo_mpc_planner2_tpu_torch as tp
from neo_mpc_planner2_tpu_torch.utils import profiling

LANES, TICKS = 6, 3


def _cfg():
    # The tolerance of the benchmark's parity point, so that lanes stop at
    # different iterations.
    return dataclasses.replace(tp.fleet_config(), opt_tolerance=1e-3)


def _loop():
    cfg = _cfg()
    sb = tp.make_scenario_batch(cfg, LANES, seed=3, map_size=48,
                                plan_points=64, device="cpu")
    return lambda: tp.batch_simulate(cfg, sb, TICKS)


def _server():
    """The port's server on a free loopback port, a costmap and a
    footprint staged. -> a connected client."""
    from neo_mpc_planner2_tpu_torch.serving import OptimizerClient, serve
    from neo_mpc_planner2_tpu_torch.utils.entrypoints import free_port

    port, ready = free_port(), threading.Event()
    threading.Thread(target=serve, daemon=True, kwargs=dict(
        host="127.0.0.1", port=port, cfg=_cfg(), ready_event=ready,
        device="cpu")).start()
    assert ready.wait(30)
    client = OptimizerClient(port=port, wait_timeout=30)
    grid = np.zeros((32, 32), np.float32)
    grid[20:24, 4:28] = 0.6
    assert "error" not in client.call({"op": "set_costmap",
                                       "data": grid.tolist(),
                                       "origin": [-0.8, -0.8],
                                       "resolution": 0.05})
    assert "error" not in client.call({
        "op": "set_footprint",
        "points": [[0.3, 0.2], [-0.3, 0.2], [-0.3, -0.2], [0.3, -0.2]]})
    return client


OPTIMIZER = {"op": "optimizer", "current_pose": [0.0, 0.0, 0.0],
             "carrot_pose": [0.3, 0.1, 0.0], "goal_pose": [0.6, 0.2, 0.0],
             "current_vel": [0.0, 0.0, 0.0], "switch_opt": False,
             "control_interval": 0.033, "delta_t": 0.033}


def test_nothing_is_recorded_outside_recording(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("recorded outside recording()")

    monkeypatch.setattr(profiling, "_Span", refuse)
    monkeypatch.setattr(profiling._Session, "buffer", refuse)
    assert profiling.span("x", lanes=3) is profiling.span("y")
    profiling.count("sqp.trips")
    _loop()()
    client = _server()
    try:
        resp = client.call(OPTIMIZER)
    finally:
        client.close()
    assert "error" not in resp and len(resp["output_vel"]) == 3


def test_a_thread_started_before_recording_is_recorded():
    go, done, seen = threading.Event(), threading.Event(), {}

    def worker():
        seen["tid"] = threading.get_native_id()
        seen["ident"] = threading.get_ident()
        go.wait(10)
        with profiling.span("outer", trace=7, op="probe"):
            with profiling.span("inner"):
                profiling.count("probe.n", 2)
        done.set()

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    with profiling.recording() as log:
        go.set()
        assert done.wait(10)
    t.join(10)
    by = {s.name: s for s in log.spans}
    outer, inner = by["outer"], by["inner"]
    assert outer.tid == inner.tid == seen["tid"] != threading.get_native_id()
    assert outer.ident == inner.ident == seen["ident"]
    assert outer.parent is None and inner.parent == outer.id
    assert outer.trace == inner.trace == 7
    assert outer.attrs == {"op": "probe"}
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert log.counts == {"probe.n": 2} and log.dropped == 0
    assert [a.name for a in log.anchors] == \
        [profiling.ANCHOR] * (2 * profiling.ANCHOR_SAMPLES)


@pytest.mark.parametrize("cap", [profiling.RECORD_CAP, 1000])
def test_many_threads_lose_no_record_and_no_count(cap, monkeypatch):
    """More threads than cores, switching every µs: every span is kept or
    counted as dropped, up to the cap, and no count is lost."""
    monkeypatch.setattr(profiling, "RECORD_CAP", cap)
    threads, each = 16, 300
    start = threading.Barrier(threads + 1, timeout=10)

    def worker():
        start.wait()
        for _ in range(each):
            with profiling.span("s"):
                profiling.count("n")
                profiling.count("lanes", 3)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=worker, daemon=True)
                for _ in range(threads)]
        for t in pool:
            t.start()
        with profiling.recording() as log:
            start.wait()
            for t in pool:
                t.join(30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    kept = sum(s.name == "s" for s in log.spans)
    assert kept == min(cap, threads * each)
    assert kept + log.dropped == threads * each
    assert log.counts == {"n": threads * each, "lanes": 3 * threads * each}
    assert len({s.id for s in log.spans}) == len(log.spans)


def _profiled(body):
    """Run body() inside recording() inside a CPU profiler session. ->
    (the log, the trace's events)."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.recording() as log:
            body()
    with tempfile.TemporaryDirectory() as d:
        path = d + "/t.json"
        prof.export_chrome_trace(path)
        with open(path) as f:
            return log, json.load(f)["traceEvents"]


def test_anchors_share_the_profilers_clock(tmp_path):
    from torch.profiler import record_function

    def body():
        x = torch.ones(64, 64)
        for _ in range(20):
            x = x @ x / 64

    log, events = _profiled(body)
    ends = sorted(e["ts"] + e["dur"] for e in events
                  if e.get("name") == profiling.ANCHOR)
    k = profiling.ANCHOR_SAMPLES
    assert len(ends) == len(log.anchors) == 2 * k
    offsets = [end - a.end_ns / 1e3 for end, a in zip(ends, log.anchors)]
    entry, exit_ = max(offsets[:k]), max(offsets[k:])
    assert abs(entry - exit_) <= 100.0
    assert log.offset_us(events) == pytest.approx((entry + exit_) / 2)

    # device_trace puts the spans of its body into its trace, on the
    # profiler's clock: a span around a named range lands on it.
    with profiling.device_trace(str(tmp_path / "dt")):
        with profiling.span("probe", trace=3):
            with record_function("probe_range"):
                torch.ones(8).sum()
    [trace] = glob.glob(str(tmp_path / "dt" / "trace_*.json"))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    rng = next(e for e in events if e.get("name") == "probe_range")
    sp = next(e for e in events if e.get("cat") == profiling.SPAN_CATEGORY
              and e["name"] == "probe")
    assert sp["args"]["trace"] == 3
    assert sp["tid"] == threading.get_native_id()
    assert sp["ts"] - 100.0 <= rng["ts"]
    assert rng["ts"] + rng["dur"] <= sp["ts"] + sp["dur"] + 100.0
    assert profiling.host_launches_by_op(str(tmp_path / "dt")) == {}


def test_an_anchor_read_late_does_not_move_the_clock(monkeypatch):
    """A thread preempted between an anchor's range and its clock read
    (planted: 5 ms of sleep before the read, in one sample at entry and
    one at exit) leaves the offset on the profiler's clock: a span around
    a named range still lands on it."""
    from torch.profiler import record_function

    real = profiling.time
    reads = iter(range(1, 10 ** 6))
    k = profiling.ANCHOR_SAMPLES
    # The clock's reads: a start and an end an anchor, the probe span's
    # two between entry and exit. Late: the first entry anchor's end and
    # the second exit anchor's.
    late = {2, 2 * k + 6}

    class Late:
        def __getattr__(self, name):
            return getattr(real, name)

        def monotonic_ns(self):
            if next(reads) in late:
                real.sleep(0.005)
            return real.monotonic_ns()

    def body():
        with profiling.span("probe"):
            with record_function("probe_range"):
                torch.ones(8).sum()

    monkeypatch.setattr(profiling, "time", Late())
    log, events = _profiled(body)
    monkeypatch.setattr(profiling, "time", real)
    offset = log.offset_us(events)
    rng = next(e for e in events if e.get("name") == "probe_range")
    [sp] = [s for s in log.spans if s.name == "probe"]
    assert sp.start_ns / 1e3 + offset - 100.0 <= rng["ts"]
    assert rng["ts"] + rng["dur"] <= sp.end_ns / 1e3 + offset + 100.0
    # One sample alone would be 5 ms off at each planted read.
    ends = sorted(e["ts"] + e["dur"] for e in events
                  if e.get("name") == profiling.ANCHOR)
    offsets = [end - a.end_ns / 1e3 for end, a in zip(ends, log.anchors)]
    assert offset - offsets[0] > 4000.0 and offset - offsets[k + 1] > 4000.0


def test_sqp_counters_agree_with_the_loop_and_change_nothing():
    run = _loop()
    off = run()
    with profiling.recording() as log:
        on = run()
    for a, b in ((off.poses, on.poses), (off.cmds, on.cmds),
                 (off.solver_iters, on.solver_iters)):
        assert torch.equal(a, b)
    for a, b in zip(dataclasses.astuple(off.final_state),
                    dataclasses.astuple(on.final_state)):
        assert torch.equal(a, b)

    iters = on.solver_iters                                   # (B, T)
    most = iters.max(0).values
    c = log.counts
    assert c["sqp.solves"] == TICKS
    assert c["sqp.trips"] == int(most.sum())
    assert c["sqp.lane_slots"] == c["sqp.trips"] * LANES
    assert c["sqp.ls_evals"] >= c["sqp.trips"]
    assert int(iters.sum()) < c["sqp.lane_slots"]  # some lanes stop early
    for t in range(TICKS):
        trips = [s for s in log.spans if s.name == "sqp.iter" and s.trace == t]
        assert len(trips) == int(most[t])
        assert all(s.attrs == {"lanes": LANES} for s in trips)
    names = {s.name for s in log.spans}
    assert {"tick", "tick.plant", "engine.pre", "engine.solve_lanes",
            "engine.post", "engine.post_solve", "sqp.solve", "sqp.init",
            "sqp.iter", "sqp.qp", "sqp.ls"} <= names
    assert "tick.map" not in names  # a static map is neither made nor written


def test_a_served_request_is_one_trace_of_nested_spans():
    client = _server()
    try:
        with profiling.recording() as log:
            resp = client.call(OPTIMIZER)
            # The server closes a request's span after its reply is sent,
            # and reads the next line only then: a second reply means the
            # first request's spans are all recorded.
            assert "error" in client.call({"op": "no_such_op"})
    finally:
        client.close()
    assert "error" not in resp
    [req] = [s for s in log.spans if s.name == "serve.request"
             and s.attrs.get("op") == "optimizer"]
    assert req.attrs == {"op": "optimizer"} and req.parent is None
    under = [s for s in log.spans if s.trace == req.trace and s is not req]
    by = {s.name: s for s in under}
    for name in ("serve.decode", "serve.lock_wait", "serve.handle",
                 "serve.encode"):
        assert by[name].parent == req.id, name
    assert by["serve.solve"].parent == by["serve.pack"].parent \
        == by["serve.handle"].id
    assert by["sqp.solve"].parent == by["serve.solve"].id
    assert all(req.start_ns <= s.start_ns <= s.end_ns <= req.end_ns
               for s in under)
    assert log.counts["sqp.solves"] == 1
