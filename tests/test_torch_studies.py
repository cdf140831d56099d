"""The port's studies (`neo_mpc_planner2_tpu_torch.scripts`) against the
repository's `scripts/*.py`, on the CPU at a tiny size (a few lanes, 48²
maps, 1-3 ticks).

- `iters_hist`: the JAX script's arithmetic (its statements after it has
  the iteration counts, read with `ast` and run here) on the port's
  solver_iters prints exactly what the port prints, in both regimes.
- The JSON studies (`dyn_decompose`, `scaling_bench`, `product_decompose`,
  `parity_study`): every key of the JAX script's output records (read
  with `ast`) is a key of the port's output, and the port's output has no
  other key but the ones listed in PORT_EXTRAS (each with its reason).
- `trace_headline` prints its tables on the CPU (no device lane: empty),
  and `utils.profiling.host_launches_by_op` attributes a synthetic
  trace's launches to their innermost host op.
- `scaling_bench --pinned` is refused, two gloo ranks make a 2-card
  world's line, and every study raises without a card unless it is given
  --device cpu.

None of these runs JAX: the studies' JAX twins drive a TPU, and their
outputs are compared by their keys and their arithmetic.
"""

import argparse
import ast
import io
import json
import pathlib
from contextlib import redirect_stdout

import numpy as np
import pytest

from neo_mpc_planner2_tpu_torch import scripts
from neo_mpc_planner2_tpu_torch.scripts import (
    dyn_decompose, iters_hist, parity_study, product_decompose,
    scaling_bench, trace_headline)
from neo_mpc_planner2_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parent.parent

# The keys the port's output has beside its JAX twin's, and why.
PORT_EXTRAS = {
    # The launches a tick are the open question of the live maps; the
    # mean SQP iterations say how many masked-loop trips make them.
    "dyn_decompose": {"launch_ticks", "launches_per_tick", "syncs_per_tick",
                      "mean_iters"},
    "scaling_bench": set(),
    "product_decompose": set(),
    # The report says which device ran the device half.
    "parity_study": {"device"},
}


# The names the JAX scripts give their output records (beside the dicts
# they pass to json.dumps).
RECORDS = {"dyn_decompose": (), "scaling_bench": ("rec",),
           "product_decompose": ("rec",),
           "parity_study": ("summary", "report")}


def _literal_keys(node) -> set:
    """The string keys of a dict literal and of the dicts nested in it (a
    dict comprehension over a literal tuple of keys included)."""
    keys = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Dict):
            keys |= {k.value for k in n.keys if isinstance(k, ast.Constant)
                     and isinstance(k.value, str)}
        elif isinstance(n, ast.DictComp):
            for gen in n.generators:
                if isinstance(gen.iter, ast.Tuple):
                    keys |= {e.value for e in gen.iter.elts
                             if isinstance(e, ast.Constant)}
    return keys


def _jax_keys(name: str) -> set:
    """The keys of the JAX script's output records: its dict literals
    passed to json.dumps or assigned to a name of RECORDS[name]."""
    tree = ast.parse((ROOT / "scripts" / f"{name}.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            keys |= _literal_keys(node.args[0])
        elif (isinstance(node, ast.Assign)
              and isinstance(node.value, ast.Dict)
              and getattr(node.targets[0], "id", None) in RECORDS[name]):
            keys |= _literal_keys(node.value)
    return keys


def _keys(obj) -> set:
    """Every key of the dicts in obj, nested in dicts and lists."""
    if isinstance(obj, dict):
        return set(obj).union(*(_keys(v) for v in obj.values()))
    if isinstance(obj, list):
        return set().union(*(_keys(v) for v in obj))
    return set()


def _json_lines(text: str) -> list:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def _main(mod, argv) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        mod.main(argv)
    return buf.getvalue()


def _assert_keys(name: str, records) -> None:
    got, want = _keys(records), _jax_keys(name)
    assert want <= got, sorted(want - got)
    assert got - want == PORT_EXTRAS[name], sorted(got - want)


def test_every_study_is_a_module_of_the_same_name():
    for name in scripts.NAMES:
        assert (ROOT / "scripts" / f"{name}.py").exists(), name
        mod = __import__(f"neo_mpc_planner2_tpu_torch.scripts.{name}",
                         fromlist=["main"])
        assert callable(mod.main), name


def _jax_iters_hist_lines(iters: np.ndarray, batch: int,
                          max_iters: int) -> str:
    """The JAX script's statements after `iters = ...` in its main(), run
    on `iters`; what they print."""
    tree = ast.parse((ROOT / "scripts" / "iters_hist.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    at = next(i for i, st in enumerate(main.body)
              if isinstance(st, ast.Assign)
              and getattr(st.targets[0], "id", None) == "iters")
    code = compile(ast.Module(body=main.body[at + 1:], type_ignores=[]),
                   "iters_hist.py", "exec")
    buf = io.StringIO()
    with redirect_stdout(buf):
        exec(code, {"np": np, "iters": iters, "args": argparse.Namespace(
            batch=batch, max_iters=max_iters)})
    return buf.getvalue()


@pytest.mark.parametrize("regime", ["static", "dynamic"])
def test_iters_hist_prints_the_jax_scripts_arithmetic(regime, monkeypatch):
    batch, max_iters = 16, 8
    out = iters_hist.run(batch, 3, 48, max_iters, regime, device="cpu")
    assert out["iters"].shape == (batch, 3)
    monkeypatch.setattr(iters_hist, "run", lambda *a, **k: out)
    got = _main(iters_hist, ["--batch", str(batch), "--max-iters",
                             str(max_iters), "--regime", regime])
    want = _jax_iters_hist_lines(out["iters"], batch, max_iters)
    assert got == want
    assert len(got.splitlines()) == max_iters + 2


def test_dyn_decompose_keys_and_programs():
    text = _main(dyn_decompose, ["--device", "cpu", "--batch", "8",
                                 "--ticks", "2", "--map-size", "48",
                                 "--reps", "1", "--launch-ticks", "1"])
    recs = _json_lines(text)
    assert [r["program"] for r in recs] == [
        "static", "dynamic_resynth", "dynamic_updates", "synthesis_only"]
    _assert_keys("dyn_decompose", recs)
    for r in recs:
        assert r["ms_per_tick"] > 0 and r["launches_per_tick"] == 0
    assert recs[-1]["mean_iters"] is None
    assert all(r["mean_iters"] >= 1 for r in recs[:3])


def test_dyn_decompose_draws_follow_the_jax_scripts_order():
    """One generator (seed 3): the six blobs a lane, then the updates."""
    dyn, upd = dyn_decompose.draws(4, 64, "cpu")
    rng = np.random.default_rng(3)
    half = 64 * 0.05 / 2
    want = [rng.uniform(-half + 0.8, half - 0.3, (4, 6, 2)),
            rng.uniform(0.3, 0.95, (4, 6)),
            rng.uniform(-0.25, 0.25, (4, 6, 2)),
            rng.uniform(-half + 0.8, half - 0.3, (4, 2)),
            rng.uniform(0.3, 0.95, (4,)),
            rng.uniform(-0.25, 0.25, (4, 2))]
    for got, w in zip(dyn + upd, want):
        np.testing.assert_array_equal(got.numpy(), w.astype(np.float32))


def test_scaling_bench_keys_on_one_and_two_ranks():
    text = _main(scaling_bench, ["--device", "cpu", "--batch-per-device",
                                 "4", "--ticks", "2", "--map-size", "48",
                                 "--repeats", "1"])
    [rec] = _json_lines(text)
    _assert_keys("scaling_bench", rec)
    assert rec["devices"] == 1 and rec["batch"] == 4
    args = argparse.Namespace(batch_per_device=4, ticks=2, map_size=48,
                              repeats=1, ticks_per_dispatch=0, device="cpu")
    two = scaling_bench._world(args, 2)
    _assert_keys("scaling_bench", two)
    assert two["devices"] == 2 and two["batch"] == 8
    assert scaling_bench.world_sizes(8, 8) == [1, 2, 4, 8]
    assert scaling_bench.world_sizes(6, 8) == [1, 2, 4, 6]
    assert scaling_bench.world_sizes(1, 8) == [1]


def test_scaling_bench_refuses_pinned():
    with pytest.raises(SystemExit, match="--pinned"):
        scaling_bench.main(["--pinned"])


def test_product_decompose_keys_and_passes():
    text = _main(product_decompose, ["--device", "cpu", "--batch", "4",
                                     "--ticks", "1", "--quality-ticks", "1"])
    recs = _json_lines(text)
    assert [r["pass"] for r in recs] == [
        "map64", "map128", "map128_cap16", "embed_lethal"]
    _assert_keys("product_decompose", recs)
    assert [r["map_cells"] for r in recs] == [64, 128, 128, 128]
    assert [r["solver_cap"] for r in recs] == [8, 8, 16, 8]


def test_embed_keeps_the_world_content():
    """The embedded 128² map samples as the 64² one inside it, and lethal
    outside."""
    import torch

    from neo_mpc_planner2_tpu_torch.ops.costmap import cost_at_world

    sb = product_decompose.suite(product_decompose.config(), 2, 64, "cpu")
    big = product_decompose.embed(sb)
    xy = torch.tensor([[0.3, -0.2], [-1.0, 1.2], [1.5, 0.1]])
    for lane in range(2):
        pick = lambda cm: cost_at_world(
            cm.replace(data=cm.data[lane], origin=cm.origin[lane],
                       resolution=cm.resolution[lane]), xy[:, 0], xy[:, 1])
        assert torch.equal(pick(big.costmap), pick(sb.costmap))
    assert float(big.costmap.data[:, 0, 0].min()) == 1.0


def test_parity_study_keys_and_its_report(tmp_path):
    out = tmp_path / "report.json"
    text = _main(parity_study, ["--device", "cpu", "--n", "4",
                                "--workers", "1", "--perturb-reps", "1",
                                "--sequence-n", "2", "--sequence-ticks", "2",
                                "--out", str(out)])
    report = json.loads(out.read_text())
    assert f"wrote {out}" in text
    assert [s["suite"] for s in report["suites"]] == [
        "mpo700", "mpo500", "lethal_adjacent", "mpo700_cs5",
        "mpo700_sequence"]
    # A suite whose commands all matched lists no unmatched row: its
    # keys come from a row of a synthetic unmatched list.
    row = {k: 0 for k in ("idx", "cmd_diff", "obj_gap", "scipy_success",
                          "scipy_nit", "scipy_self_diff", "device_converged",
                          "collision")}
    _assert_keys("parity_study", [report, row])
    for s in report["suites"]:
        assert s["checked"] > 0 and 0.0 <= s["matched_frac"] <= 1.0


def test_parity_study_never_writes_the_reference_report():
    with pytest.raises(SystemExit, match="never written"):
        parity_study.main(["--device", "cpu",
                           "--out", str(ROOT / "PARITY_REPORT.json")])


@pytest.mark.parametrize("step_mode", [False, True])
def test_trace_headline_prints_its_tables_on_the_cpu(step_mode):
    argv = ["--device", "cpu", "--batch", "4", "--ticks", "1", "--reps", "2",
            "--map-size", "48"] + (["--step-mode"] if step_mode else [])
    lines = _main(trace_headline, argv).splitlines()
    assert lines[0].startswith("top 0 device ops")
    assert lines[1].startswith("top 0 host ops by kernel launches")


def test_host_launches_by_op_reads_a_synthetic_trace(tmp_path):
    """Launches go to the innermost op around them on their thread; a
    launch with no op around it is "(no op)"; syncs are not launches."""
    ev = lambda cat, name, ts, dur=1.0, tid=1: {
        "ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
        "tid": tid}
    trace = {"traceEvents": [
        ev("user_annotation", "tick", 0, 100),
        ev("cpu_op", "aten::add", 10, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 12),
        ev("cuda_runtime", "cudaLaunchKernel", 15),
        ev("cpu_op", "aten::where", 30, 20),
        ev("cpu_op", "aten::copy_", 35, 5),
        ev("cuda_runtime", "cudaLaunchKernel", 36),
        ev("cuda_runtime", "cudaLaunchKernel", 45),
        ev("cuda_runtime", "cudaStreamSynchronize", 60),
        ev("cuda_runtime", "cudaLaunchKernel", 70),
        ev("cuda_runtime", "cudaLaunchKernel", 150),
        ev("cpu_op", "aten::mul", 10, 10, tid=2),
        ev("cuda_driver", "cuLaunchKernel", 5, tid=2),
        ev("cuda_driver", "cuLaunchKernel", 12, tid=2),
    ]}
    (tmp_path / "trace_1.json").write_text(json.dumps(trace))
    assert profiling.host_launches_by_op(str(tmp_path)) == {
        "aten::add": 2, "aten::copy_": 1, "aten::where": 1, "tick": 1,
        "(no op)": 2, "aten::mul": 1}


@pytest.mark.parametrize("name", scripts.NAMES)
def test_study_refuses_to_start_without_a_card(name, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = __import__(f"neo_mpc_planner2_tpu_torch.scripts.{name}",
                     fromlist=["main"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
