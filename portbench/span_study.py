"""The program's spans and counters over one cell, on a card.

    python3 portbench/span_study.py --workload <cell> --seed <n> \
        --seconds <s>

Runs the cell as `run.py --trace 1` does, and prints run.py's line. Right
after the traced piece it runs a second profiled piece with the program's
`recording()` open inside the profiler session: the same ticks again from
the same carry (fleet), or the next requests (serve), each request's
client latency kept, and then the same work unprofiled, three times with
recording off and three times on, in turns. Then it prints one more
line, {"spans": ...}: the per-layer numbers of lib/spans.py, the idle
gaps of the second piece by program span, the self time of each span
name a tick or request, the counts, both pieces' walls, the off and on
walls and the on-cost (median on / median off - 1), the cost of a span
and of a counter with recording off and on (ns a call, on this host),
and from those the recording's cost a tick or request (ms).

The entry loops (lib/fleet.py, lib/serve.py) do not run the second piece
themselves; this script puts it after their traced piece by replacing,
for its own process, two names of the harness. This is its contract with
run.py and lib/:

- `portbench.lib.trace.profile(fn) -> (events, wall_s)`: the cell's
  traced piece is the first call of it in a `--trace 1` run; the
  script's wrapper runs that piece, then the second piece and the on/off
  walls over the same `fn`.
- `portbench.lib.serve.Robot.step(robot) -> latency_s`: one request of
  the serve client, its latency kept while the second piece runs.

Where either changes, this script has to change with it. It goes when
the harness runs the second piece itself (PERF.md, Open questions).
"""

from __future__ import annotations

import json
import statistics
import sys
import time
import timeit
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))


def call_cost_ns(n: int = 50_000, repeat: int = 5) -> dict:
    """ns a call of span() (entered and left) and of count(), with
    recording off and on (the least of `repeat` runs of n calls; on, each
    run in a recording of its own)."""
    import contextlib

    from neo_mpc_planner2_tpu_torch.utils import profiling

    def one_span():
        with profiling.span("x"):
            pass

    def one_count():
        profiling.count("x")

    out = {}
    for side in ("off", "on"):
        for name, fn in (("span", one_span), ("count", one_count)):
            best = float("inf")
            for _ in range(repeat):
                with (profiling.recording() if side == "on"
                      else contextlib.nullcontext()):
                    best = min(best, timeit.timeit(fn, number=n))
            out[f"{name}_{side}_ns"] = best / n * 1e9
    return out


def counter_calls(counts: dict) -> int:
    """count() calls behind the counts: one a unit of every counter but
    `sqp.lane_slots`, which is called once a trip with the trip's
    lanes."""
    return (sum(v for k, v in counts.items() if k != "sqp.lane_slots")
            + counts.get("sqp.trips", 0))


def on_off_walls(recording, fn, rounds: int = 3) -> dict:
    """Walls of fn() with recording off and on, in turns (off, on, on,
    off, ...), each ending in a device sync: {"off": [s], "on": [s]}."""
    import torch

    walls = {"off": [], "on": []}
    for side in (["off", "on", "on", "off"] * rounds)[:2 * rounds]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if side == "on":
            with recording():
                fn()
        else:
            fn()
        torch.cuda.synchronize()
        walls[side].append(time.perf_counter() - t0)
    return walls


def study(piece: dict, first_wall_s: float, latencies_s: list,
          walls: dict) -> dict:
    from portbench.lib import spans, stats

    sp, counts = piece["spans"], piece["counts"]
    gaps = spans.gap_seconds_by_span(piece["events"], sp, piece["offset_us"])
    cost = call_cost_ns()
    res = piece["result"]
    if res is not None:  # a fleet piece: the SimResult of its ticks
        iters = res.solver_iters
        n = iters.shape[1]
        readings = spans.fleet_readings(sp, counts, int(iters.sum()))
        readings["mean_iters"] = float(iters.sum()) / iters.numel()
    else:
        n = sum(1 for s in sp if s.name == "serve.request"
                and s.attrs.get("op") == "optimizer")
        readings = spans.serve_readings(sp, counts, latencies_s)
        readings.update({"client_" + k: v for k, v in
                         stats.latency_ms(latencies_s).items()})
    spans_each = len(sp) / n
    calls_each = counter_calls(counts) / n
    return {"readings": readings,
            "idle_gaps_by_span": spans.top(gaps),
            "idle_s": sum(gaps.values()),
            "named_idle_share": spans.named_share(gaps),
            "named_idle_share_own_thread": spans.named_share(
                gaps, other_threads=False),
            "self_ms_each": {k: v / n for k, v in sorted(
                spans.self_ms(sp).items(), key=lambda kv: -kv[1])},
            "counts": counts, "dropped": piece["dropped"],
            "spans_each": spans_each, "counter_calls_each": calls_each,
            "units": n,
            "offset_us": piece["offset_us"],
            "offset_error": piece["offset_error"],
            "first_wall_s": first_wall_s, "second_wall_s": piece["wall_s"],
            "on_off_walls_s": walls,
            "on_cost": (statistics.median(walls["on"])
                        / statistics.median(walls["off"]) - 1.0),
            **cost,
            "recording_ms_each": {
                side: (spans_each * cost[f"span_{side}_ns"]
                       + calls_each * cost[f"count_{side}_ns"]) / 1e6
                for side in ("off", "on")}}


def main(argv=None) -> int:
    from neo_mpc_planner2_tpu_torch.utils.profiling import recording
    from portbench import run as bench
    from portbench.lib import serve, spans, trace

    args = list(sys.argv[1:] if argv is None else argv)
    got, latencies = {}, []
    first_profile, step = trace.profile, serve.Robot.step

    def profile(fn):
        events, wall = first_profile(fn)        # the cell's traced piece
        trace.profile = first_profile           # the second piece's session
        got["collect"] = True
        got["piece"] = spans.piece(recording, fn)
        got["collect"] = False
        got["walls"] = on_off_walls(recording, fn)
        got["first_wall_s"] = wall
        return events, wall

    def timed_step(robot):
        lat = step(robot)
        if got.get("collect"):
            latencies.append(lat)
        return lat

    trace.profile, serve.Robot.step = profile, timed_step
    try:
        rc = bench.main(args + ["--trace", "1"])
    finally:
        trace.profile, serve.Robot.step = first_profile, step
    if rc or "piece" not in got:
        return rc or 1
    print(json.dumps({"spans": study(got["piece"], got["first_wall_s"],
                                     latencies, got["walls"])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
