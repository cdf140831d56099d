"""Finding a cell's pieces by name.

A cell of BENCHMARK.json names a configuration and a traffic mix; each is
a data file of its own under the benchmark's folder, and each per-layer
metric a reader of its own:

- configs/<config>.json: the deployment's numbers (and `reference`, the
  module under reference/ that re-derives its answers);
- traffic/<traffic>.json: the mix's parameters, and `entry`, the entry
  point of the program it drives (lib/<entry>.py);
- checks/<cell>.json: the limits that decide `correct`, with the readings
  each was set from;
- layers/<metric>.py: `read(ctx)` -> a number, or None where the run has
  nothing to read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(repo: Path = REPO) -> dict:
    return _json(repo / "BENCHMARK.json")


def cell(name: str, bench: dict) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, root: Path = ROOT) -> dict:
    return _json(root / "configs" / f"{name}.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    return _json(root / "traffic" / f"{name}.json")


def checks(cell_name: str, root: Path = ROOT) -> dict:
    return _json(root / "checks" / f"{cell_name}.json")


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """The metric's reader: layers/<metric>.py's read(ctx)."""
    return _module(root / "layers" / f"{metric}.py",
                   "portbench_layer_" + metric.replace(".", "_")).read


def entry(name: str):
    """lib/<name>.py, whose run(run) drives one entry point of the
    program."""
    return importlib.import_module(f"portbench.lib.{name}")


def reference(name: str):
    """reference/<name>.py, the plain reference of a configuration."""
    return importlib.import_module(f"portbench.reference.{name}")


def metrics_of(cell_name: str, bench: dict, kind: str) -> list:
    """The cell's metrics of one kind ("end_to_end" or "per_layer"): those
    that list the cell; one that lists no cells is the cell's where the
    cell reports every end-to-end metric it moves (setup_s: every cell)."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}

    def mine(m):
        if "workloads" in m:
            return cell_name in m["workloads"]
        return "moves" not in m or mine(e2e[m["moves"]])

    return [m for m in bench[kind] if mine(m)]
