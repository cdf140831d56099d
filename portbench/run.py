"""The benchmark of neo_mpc_planner2_tpu_torch on one NVIDIA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of BENCHMARK.json from the root of a checkout and prints, as
the last line of stdout, one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics, or with --trace 1 its per-layer
metrics), device, with --trace 1 a breakdown of the traced part, and last
the numbers that decided `correct`, each beside its limit (also the last
lines of stderr). Progress goes to stderr.

Everything of a cell is found by name: the configuration
(configs/<config>.json), the traffic mix (traffic/<traffic>.json, whose
`entry` names the entry point of the program it drives, lib/<entry>.py), the limits
(checks/<cell>.json), the reference (reference/<name>.py) and each
per-layer metric's reader (layers/<metric>.py).

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with code 2 and prints no result; `--device cpu` runs the same path on the
CPU for tests (host-clock numbers only, named as the CPU's). It exits with
code 3 and prints no result if jax, jaxlib, flax or the JAX package were
loaded in this process.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

BANNED = ("jax", "jaxlib", "flax", "neo_mpc_planner2_tpu")


class Run:
    """What an entry point's loop needs of this run."""

    def __init__(self, args, config, traffic, t_start, log):
        self.seed = args.seed
        self.seconds = args.seconds
        self.trace = bool(args.trace)
        self.device = args.device
        self.lanes = args.lanes
        self.ticks = args.ticks
        self.program = importlib.import_module("portbench.lib.program")
        self.config = config
        self.traffic = traffic
        self.t_start = t_start
        self.log = log


def banned_modules(modules=None) -> list:
    """The loaded modules whose top-level name is a banned one, compared
    whole (the port's name begins with the JAX package's)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(BANNED))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # For tests on a machine without a card: the same path on the CPU.
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    # For tests, with --device cpu only: a smaller fleet and shorter
    # segments than the cell's.
    ap.add_argument("--lanes", type=int, default=None)
    ap.add_argument("--ticks", type=int, default=None)
    return ap


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.device != "cpu" and (args.lanes or args.ticks):
        ap.error("--lanes and --ticks cut the cell for tests: --device cpu "
                 "only")
    log = lambda m: print(f"[portbench] {time.perf_counter() - T0:8.2f} s "
                          f"{m}", file=sys.stderr, flush=True)
    from portbench.lib import cells

    bench = cells.benchmark(REPO)
    cell = cells.cell(args.workload, bench)
    config = cells.config(cell["config"])
    traffic = cells.traffic(cell["traffic"])
    limits = cells.checks(cell["name"])["limits"]

    # Kernel and compiler caches at fixed paths inside the checkout.
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(REPO / "build" / sub))
    import torch

    if args.device == "cuda":
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < int(cell["chips"])):
            log(f"needs {cell['chips']} CUDA card(s); found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        torch.cuda.set_device(0)
    torch.set_num_threads(min(4, os.cpu_count() or 1))

    run = Run(args, config, traffic, T0, log)
    out = cells.entry(traffic["entry"]).run(run)

    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in cells.metrics_of(cell["name"], bench, kind):
        v = (cells.reader(m["name"])(out["layer_ctx"]) if args.trace
             else out["e2e"].get(m["name"]))
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    cuda = args.device == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    line = {"correct": None, "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics,
            "device": device}
    ev = out["layer_ctx"].get("events")
    if args.trace and ev:
        from portbench.lib import trace

        device["busy_s"] = trace.busy_us(ev) / 1e6
        device["window_s"] = out["layer_ctx"]["window_s"]
        line["breakdown"] = trace.breakdown(ev)

    from portbench.lib import judge

    line["correct"], checks = judge.verdict(out["numbers"], out["failed"],
                                            limits)
    line["checks"] = checks

    found = banned_modules()
    if found:
        log(f"loaded in this process, which must not be: {found}")
        return 3
    for k, v in checks.items():
        print(f"[portbench] check {k} = {v['value']!r} "
              f"(limit {v['limit']!r})", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
