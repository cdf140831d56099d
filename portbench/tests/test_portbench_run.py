"""Whole runs on the CPU at a tiny size: the last line, the device it
names, the import rules."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run as bench

REPO = Path(__file__).resolve().parents[2]
SMALL = {"mpo700_parity.fleet": ["--lanes", "6", "--ticks", "4"],
         "mpo500_product.fleet": ["--lanes", "4", "--ticks", "3"],
         "mpo700_parity.serve_one": []}


def _run(cell, *extra, trace=0, seconds="0.1"):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "3000000019", "--seconds", seconds, "--trace", str(trace),
         "--device", "cpu", *extra],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=600)
    return p


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_cpu_run_reaches_its_last_line(cell):
    seconds = "1.0" if "serve" in cell else "0.1"
    p = _run(cell, *SMALL[cell], seconds=seconds)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "cpu"
    assert line["device"]["kind"] == "cpu"
    assert "busy_s" not in line["device"]
    assert "setup_s" in line["metrics"]
    assert p.stderr.strip().splitlines()[-1].startswith("[portbench] check")


def test_a_traced_cpu_run_carries_no_device_metric():
    p = _run("mpo700_parity.fleet", *SMALL["mpo700_parity.fleet"], trace=1)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert set(line["metrics"]) == {"sqp.mean_iters"}
    assert "breakdown" not in line and "window_s" not in line["device"]


def test_without_a_card_it_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "mpo700_parity.fleet", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=REPO, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode == 2 and p.stdout.strip() == ""


def test_without_the_program_it_prints_no_result(tmp_path):
    import shutil

    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "mpo700_parity.fleet", "--seed", "1", "--seconds", "0.1",
         "--device", "cpu", "--lanes", "2", "--ticks", "2"],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_banned_names_are_compared_whole():
    assert bench.banned_modules(["neo_mpc_planner2_tpu_torch.sqp",
                                 "torch", "jaxtyping"]) == []
    assert bench.banned_modules(["neo_mpc_planner2_tpu.config",
                                 "jax.numpy", "flax"]) == [
        "flax", "jax", "neo_mpc_planner2_tpu"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_the_reference_imports_nothing_of_the_program():
    for p in (REPO / "portbench" / "reference").glob("*.py"):
        assert _imports(p) <= {"__future__", "math", "dataclasses", "torch"}
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.mpc; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(REPO))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    top = set(json.loads(p.stdout.replace("'", '"')))
    assert not top & {"neo_mpc_planner2_tpu_torch", "neo_mpc_planner2_tpu",
                      "jax", "jaxlib", "flax"}


def test_nothing_the_command_runs_imports_jax():
    for p in (REPO / "portbench").rglob("*.py"):
        if "tests" in p.parts:
            continue
        assert not _imports(p) & {"jax", "jaxlib", "flax",
                                  "neo_mpc_planner2_tpu"}, p


@pytest.mark.parametrize("cut", [["--lanes", "4"], ["--ticks", "3"]])
def test_a_cut_cell_runs_only_on_the_cpu(cut):
    with pytest.raises(SystemExit):
        bench.main(["--workload", "mpo700_parity.fleet", "--seed", "1",
                    "--seconds", "1", "--device", "cuda", *cut])
