"""A configuration, a traffic mix and a per-layer metric added as files
(and entries in BENCHMARK.json) make a runnable cell, and no file that was
there changes."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def _hashes(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_added_as_files_runs(tmp_path):
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _hashes(tmp_path / "portbench")
    pb = tmp_path / "portbench"

    cfg = json.loads((pb / "configs" / "mpo700_parity.json").read_text())
    cfg["name"] = "mpo700_slow"
    cfg["ros_params"]["max_vel_x"] = 0.5
    (pb / "configs" / "mpo700_slow.json").write_text(json.dumps(cfg))
    tr = json.loads((pb / "traffic" / "fleet.json").read_text())
    tr["plan_length_m"] = [1.0, 1.5]
    (pb / "traffic" / "fleet_short.json").write_text(json.dumps(tr))
    (pb / "layers" / "engine.lanes.py").write_text(
        "def read(ctx):\n    return ctx.get('lanes')\n")
    (pb / "checks" / "mpo700_slow.fleet_short.json").write_text(json.dumps(
        {"limits": {"cmd_mismatch_share": 0.05, "plant_gap": 1e-05}}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "mpo700_slow", "source": "test",
                             "file": "portbench/configs/mpo700_slow.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "mpo700_slow.fleet_short",
                               "config": "mpo700_slow",
                               "traffic": "fleet_short", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "solves_per_s":
            m["workloads"].append("mpo700_slow.fleet_short")
    bench["per_layer"].append({"name": "engine.lanes", "unit": "lanes",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "simulation / engine tick",
                               "moves": "solves_per_s",
                               "workloads": ["mpo700_slow.fleet_short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    env = dict(os.environ, PYTHONPATH=str(REPO))
    p = subprocess.run(
        [sys.executable, str(pb / "run.py"), "--workload",
         "mpo700_slow.fleet_short", "--seed", "5", "--seconds", "0.1",
         "--trace", "1", "--device", "cpu", "--lanes", "4", "--ticks", "3"],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["metrics"]["engine.lanes"]["value"] == 4
    after = _hashes(pb)
    assert {k: after[k] for k in before} == before


def test_the_kept_dynamic_mix_is_a_cell_by_one_entry(tmp_path):
    """traffic/fleet_dynamic.json and its limits are kept for a later cell
    (PERF.md, Open questions): an entry in BENCHMARK.json makes it run, and
    its bfloat16 control is not correct."""
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = "mpo700_parity.fleet_dynamic"
    assert cell not in {w["name"] for w in bench["workloads"]}
    bench["workloads"].append({"name": cell, "config": "mpo700_parity",
                               "traffic": "fleet_dynamic", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "mpo700_parity.fleet" in m.get("workloads", []):
            m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    small = ["--seed", "5", "--seconds", "0.1", "--device", "cpu",
             "--lanes", "4", "--ticks", "4"]
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, *small],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
    p = subprocess.run(
        [sys.executable, "portbench/readings.py", "--workload", cell,
         "--of", "control", "--seeds", "5", "--seconds", "0.1",
         "--device", "cpu", "--lanes", "4", "--ticks", "4"],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is False
