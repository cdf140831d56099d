"""The readings the limits of `correct` are set from, many seeds in one
process (one set-up): the program's numbers (the lower readings) and the
lower-precision control's (the upper ones), each seed through the cell's
own window, judge and sizes.

    python3 portbench/readings.py --workload <cell> --of program|control \
        --seeds <n> [<n> ...] --seconds <s>

One JSON line a seed on stdout: {"seed", "of", "correct", "numbers"}.
`--device cpu --lanes N --ticks N` run it small on the CPU, as the tests
do.
"""

from __future__ import annotations

import importlib
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench import run as bench  # noqa: E402
from portbench.lib import cells, judge  # noqa: E402


def readings(workload: str, of: str, seeds, seconds: float,
             device: str = "cuda", lanes=None, ticks=None):
    """Yield (seed, correct, numbers) for each seed."""
    if device != "cpu" and (lanes or ticks):
        raise ValueError("lanes and ticks cut the cell for tests: cpu only")
    cell = cells.cell(workload, cells.benchmark(REPO))
    config = cells.config(cell["config"])
    traffic = cells.traffic(cell["traffic"])
    limits = cells.checks(cell["name"])["limits"]
    loop = cells.entry(traffic["entry"])
    prog = importlib.import_module(f"portbench.lib.{of}")
    for seed in seeds:
        args = bench.parser().parse_args(
            ["--workload", workload, "--seed", str(seed), "--seconds",
             str(seconds), "--device", device]
            + ([] if lanes is None else ["--lanes", str(lanes)])
            + ([] if ticks is None else ["--ticks", str(ticks)]))
        run = bench.Run(args, config, traffic, time.perf_counter(),
                        lambda m: print(f"[readings] {m}", file=sys.stderr,
                                        flush=True))
        run.program = prog
        out = loop.run(run)
        ok, _ = judge.verdict(out["numbers"], out["failed"], limits)
        yield seed, ok, dict(out["numbers"], failed=out["failed"])


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="portbench-readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--of", choices=("program", "control"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--lanes", type=int, default=None)
    ap.add_argument("--ticks", type=int, default=None)
    a = ap.parse_args(argv)
    for seed, ok, nums in readings(a.workload, a.of, a.seeds, a.seconds,
                                   a.device, a.lanes, a.ticks):
        print(json.dumps({"seed": seed, "of": a.of, "correct": ok,
                          "numbers": nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
