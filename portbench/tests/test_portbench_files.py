"""BENCHMARK.json against the benchmark's contract, and every piece of a
cell found by name."""

import json
import re
from pathlib import Path

import pytest

from portbench.lib import cells

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    cells_n = 24
    total = ((2 + 14 * cells_n) * (BENCH["run_seconds"] + 60)
             + cells_n * 2 * 90 + 1200)
    assert total <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        assert (REPO / "portbench" / "layers" / f"{m['name']}.py").exists()
        moved = e2e[m["moves"]].get("workloads")
        assert moved is None or set(m["workloads"]) <= set(moved)
        layers.add(m["layer"])
    assert layers == {"simulation / engine tick", "sqp", "kernels",
                      "device", "serving"}


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_pieces(w):
    cell = cells.cell(w, BENCH)
    assert cell["chips"] == 1 and 1 <= len(cell["why"]) <= 200
    cfg = cells.config(cell["config"])
    tr = cells.traffic(cell["traffic"])
    lim = cells.checks(w)["limits"]
    assert cfg["name"] == cell["config"]
    assert (REPO / "portbench" / "lib" / f"{tr['entry']}.py").exists()
    assert cells.reference(cfg["reference"]).tick
    assert lim and all(v >= 0 for v in lim.values())
    e2e = [m["name"] for m in cells.metrics_of(w, BENCH, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cells.metrics_of(w, BENCH, "per_layer")
    for m in cells.metrics_of(w, BENCH, "per_layer"):
        assert callable(cells.reader(m["name"]))


@pytest.mark.parametrize("c", [c["name"] for c in BENCH["configs"]])
def test_each_config_is_used_and_stands_alone(c):
    entry = next(e for e in BENCH["configs"] if e["name"] == c)
    assert entry["file"] == f"portbench/configs/{c}.json"
    assert any(w["config"] == c for w in BENCH["workloads"])
    cfg = json.loads((REPO / entry["file"]).read_text())
    assert set(entry["reduced"]) == set(cfg["reduced"])
    assert cfg["source"] and cfg["assumed"]


def test_every_traffic_file_loads():
    for p in (REPO / "portbench" / "traffic").glob("*.json"):
        tr = cells.traffic(p.stem)
        assert tr["entry"] in ("fleet", "serve")
