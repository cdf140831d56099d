"""lib/spans.py on synthetic spans and trace events: self time, the serve
readings' pairing of client latencies with `optimizer` requests (the
`set_costmap` calls left out), the fleet readings' identity with the
program's iterations, and idle gaps put down by the issuing thread; and
one profiled piece with the program's recording on the CPU."""

import json
from collections import namedtuple

import pytest

from portbench.lib import spans, trace

Span = namedtuple("Span",
                  "name start_ns end_ns parent trace tid attrs id ident")


def _s(id, name, lo_us, hi_us, parent=None, tid=11, trace_id=0, **attrs):
    return Span(name, int(lo_us * 1e3), int(hi_us * 1e3), parent, trace_id,
                tid, attrs, id, (7 << 32) + 1000 + tid)


def test_self_time_is_a_span_less_its_children():
    sp = [_s(1, "tick", 0, 100), _s(2, "sqp.solve", 10, 70, parent=1),
          _s(3, "sqp.iter", 20, 40, parent=2),
          _s(4, "sqp.iter", 40, 65, parent=2), _s(5, "tick", 100, 150)]
    got = spans.self_ms(sp)
    assert got["tick"] == pytest.approx((100 - 60 + 50) / 1e3)
    assert got["sqp.solve"] == pytest.approx((60 - 45) / 1e3)
    assert got["sqp.iter"] == pytest.approx(45 / 1e3)


def test_serve_readings_pair_latencies_with_optimizer_requests_only():
    sp = [_s(1, "serve.request", 0, 10_000, trace_id=0, op="optimizer"),
          _s(2, "serve.handle", 1_000, 9_000, parent=1),
          _s(3, "serve.solve", 2_000, 8_000, parent=2),
          _s(4, "serve.request", 20_000, 21_000, trace_id=1,
             op="set_costmap"),
          _s(5, "serve.request", 30_000, 44_000, trace_id=2,
             op="optimizer"),
          _s(6, "serve.handle", 31_000, 43_000, parent=5),
          _s(7, "serve.solve", 32_000, 42_000, parent=6)]
    counts = {"sqp.solves": 2, "sqp.trips": 7}
    got = spans.serve_readings(sp, counts, [0.0105, 0.0150])
    assert got["serving.solve_ms_p50"] == pytest.approx(8.0)
    assert got["serving.solve_ms_p95"] == pytest.approx(6.0 + 0.95 * 4.0)
    assert got["serving.host_ms_p50"] == pytest.approx(4.0)
    assert got["serving.transport_ms_p50"] == pytest.approx(0.75)
    assert got["sqp.trips_per_request"] == 3.5
    # Latencies that do not pair one to one with the requests: no
    # transport reading.
    assert "serving.transport_ms_p50" not in spans.serve_readings(
        sp, counts, [0.0105])
    assert spans.serve_readings([], {}, []) == {}


def test_fleet_readings_agree_with_the_lanes_iterations():
    sp = [_s(1, "tick", 0, 100, trace_id=0),
          _s(2, "sqp.solve", 10, 90, parent=1, trace_id=0),
          _s(3, "tick", 100, 160, trace_id=1),
          _s(4, "sqp.solve", 110, 150, parent=3, trace_id=1)]
    lanes, iters = 4, [[3, 1], [2, 1], [3, 2], [1, 2]]  # (lane, tick)
    trips = sum(max(col) for col in zip(*iters))
    counts = {"sqp.solves": 2, "sqp.trips": trips,
              "sqp.lane_slots": trips * lanes, "sqp.ls_evals": 9}
    got = spans.fleet_readings(sp, counts, sum(map(sum, iters)))
    mean_iters = sum(map(sum, iters)) / (lanes * 2)
    assert (got["sqp.lane_use"] / 100 * got["sqp.trips_per_solve"]
            == pytest.approx(mean_iters))
    assert got["sqp.trips_per_solve"] == 2.5
    assert got["sqp.ls_evals_per_solve"] == 4.5
    assert got["sqp.host_ms_per_tick"] == pytest.approx(0.06)
    assert got["engine.host_ms_per_tick"] == pytest.approx(0.02)
    assert spans.fleet_readings(sp, {}, 0) == {}


def _ev(cat, name, ts, dur=0.0, tid=11, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_idle_gaps_go_to_the_span_open_on_the_issuing_thread():
    off = 1000.0  # the trace's ts = span ns / 1e3 + off
    sp = [_s(1, "serve.request", 0, 500, tid=11),
          _s(2, "serve.solve", 100, 400, parent=1, tid=11),
          _s(3, "tick", 0, 440, tid=22)]
    events = [
        _ev("kernel", "k0", 1000, 10, tid=7, corr=1),
        # Launched on thread 11 inside serve.solve: gap 1010 -> 1200.
        _ev("cuda_runtime", "cudaLaunchKernel", 1150, tid=11, corr=2),
        _ev("kernel", "k1", 1200, 10, tid=7, corr=2),
        # A copy issued on thread 11 after serve.solve, inside the request,
        # under the tid the profiler gives a thread it did not see start
        # (its ident's low 32 bits): gap 1210 -> 1450.
        _ev("cuda_runtime", "cudaMemcpyAsync", 1420, tid=1011, corr=3),
        _ev("gpu_memcpy", "Memcpy DtoH", 1450, 5, tid=7, corr=3),
        # Issued on thread 33, which has no span, while only thread 11 has
        # one open: gap 1455 -> 1480 goes to it, marked.
        _ev("cuda_driver", "cuLaunchKernel", 1470, tid=33, corr=4),
        _ev("kernel", "k2", 1480, 5, tid=7, corr=4),
        # Issued on thread 33 while threads 11 and 22 both have one open:
        # gap 1485 -> 1500 goes outside.
        _ev("cuda_runtime", "cudaLaunchKernel", 1430, tid=33, corr=5),
        _ev("kernel", "k3", 1500, 5, tid=7, corr=5),
        # No host call of this correlation id: gap 1505 -> 1600.
        _ev("kernel", "k4", 1600, 5, tid=7, corr=99),
    ]
    got = spans.gap_seconds_by_span(events, sp, off)
    assert got == pytest.approx({
        "serve.solve": 190e-6, "serve.request": 240e-6,
        "serve.request" + spans.OTHER_THREAD: 25e-6,
        spans.OUTSIDE: 15e-6, spans.NO_CALL: 95e-6})
    assert sum(got.values()) == pytest.approx(
        sum(b[0] - a[1] for a, b in zip(trace.device_intervals(events),
                                        trace.device_intervals(events)[1:]))
        / 1e6)
    assert spans.named_share(got) == pytest.approx(100 * 455 / 565)
    assert spans.named_share(got, other_threads=False) == pytest.approx(
        100 * 430 / 565)
    assert spans.top(got, 2) == [["serve.request", got["serve.request"]],
                                 ["serve.solve", got["serve.solve"]]]


def test_a_piece_records_the_programs_spans_on_the_cpu(monkeypatch,
                                                         tmp_path):
    """lib/trace.profile needs a card; a CPU session stands in for it."""
    from torch.profiler import ProfilerActivity, profile

    from neo_mpc_planner2_tpu_torch.utils.profiling import recording, span

    def cpu_profile(fn):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
        path = str(tmp_path / "t.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        return [e for e in events if e.get("ph") == "X"], 0.5

    def work():
        with span("tick", trace=0):
            with span("sqp.solve"):
                pass
        return "done"

    monkeypatch.setattr(trace, "profile", cpu_profile)
    got = spans.piece(recording, work)
    assert got["result"] == "done" and got["wall_s"] == 0.5
    assert [s.name for s in got["spans"]
            if s.name != "neo_mpc.clock_anchor"] == ["tick", "sqp.solve"]
    assert isinstance(got["offset_us"], float) and got["dropped"] == 0
