"""The port's benchmark (`neo_mpc_planner2_tpu_torch.bench`) against the
repository's bench.py, which it ports.

- Its JSON line has exactly bench.py's keys, in bench.py's order (read from
  bench.py's `_results` literals and assignments with `ast`; bench.py is
  never run: it imports JAX and drives a TPU).
- A small run on the CPU prints one line with every field set except the
  two device p99s (no device lane on the CPU), `devices` 1, a positive
  value, and the kernels' launch counts on stderr.
- Its configurations, the live maps' obstacle draws and the quality
  scenario equal bench.py's: the statements of bench.py that build them are
  read with `ast` and run here against the JAX package, then compared field
  by field (the draws exactly).
- Its quality reductions on the port's closed loop equal bench.py's
  formulas on the JAX package's, 8 lanes chained over 3 segments of 20
  ticks from the same inputs: each lane's final goal distance within 1e-3
  m (the golden gate of tests/test_golden.py), so at most one lane may
  flip at the 0.10 m threshold; and on the port's own run, bench.py's jnp
  formulas give the port's numbers exactly.
- Without a card and without --device cpu it raises and prints nothing.
- `device_step_durations_ms` reads a synthetic trace: kernels attributed to
  the range of their launch by correlation id.
"""

import ast
import dataclasses
import json
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neo_mpc_planner2_tpu as mpc
from neo_mpc_planner2_tpu.ops.costmap import required_product_patch_halfwidth
from neo_mpc_planner2_tpu.scenarios import make_scenario_batch as jmake
from neo_mpc_planner2_tpu.simulation import batch_simulate as jsimulate

from neo_mpc_planner2_tpu_torch import bench
from neo_mpc_planner2_tpu_torch.engine import MpcEngine
from neo_mpc_planner2_tpu_torch.simulation import batch_simulate
from neo_mpc_planner2_tpu_torch.utils import profiling

from test_torch_slice import _from_jax

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH_PY = ROOT / "bench.py"
DEVICE_FIELDS = ("device_p99_ms", "device_p99_default_ms")
SMALL_RUN = ["--device", "cpu", "--batch", "4", "--ticks", "2",
             "--quality-ticks", "4", "--latency-reps", "2",
             "--trace-reps", "2"]


def _bench_tree():
    source = BENCH_PY.read_text()
    return source, ast.parse(source)


def _bench_keys() -> list:
    """The keys bench.py writes into `_results`, in the order of their
    first appearance: `_results.update({...})` literals and
    `_results["key"] = ...` assignments."""
    _, tree = _bench_tree()
    found = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "update"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "_results"):
            found += [(k.lineno, k.col_offset, k.value)
                      for k in node.args[0].keys]
        if (isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Name)
                and node.value.id == "_results"
                and isinstance(node.ctx, ast.Store)):
            found.append((node.lineno, node.col_offset, node.slice.value))
    keys = []
    for _, _, k in sorted(found):
        if k not in keys:
            keys.append(k)
    return keys


def _assignments(*names) -> list:
    """The source of each statement of bench.py that assigns one of
    `names`, in source order."""
    source, tree = _bench_tree()
    seen, out = set(), []
    for node in sorted((n for n in ast.walk(tree)
                        if isinstance(n, ast.Assign)),
                       key=lambda n: n.lineno):
        target = node.targets[0]
        if isinstance(target, ast.Name) and target.id in names:
            seen.add(target.id)
            out.append(ast.get_source_segment(source, node))
    assert seen == set(names), set(names) - seen
    return out


def _run_bench_py(*names, **namespace) -> dict:
    """bench.py's statements assigning `names`, run against the JAX package
    in `namespace`; the namespace after."""
    ns = dict(mpc=mpc, np=np, _jnp=jnp, _dc=dataclasses,
              required_product_patch_halfwidth=required_product_patch_halfwidth,
              **namespace)
    for stmt in _assignments(*names):
        exec(stmt, ns)
    return ns


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


def test_bench_py_keys_are_read_from_its_literals():
    keys = _bench_keys()
    assert keys[:4] == ["metric", "control_steps", "value", "unit"]
    assert len(keys) == len(set(keys)) == 43
    assert keys[-1] == "serving_fleet64_per_robot_ms"


def test_small_cpu_run_prints_bench_py_line(capsys, monkeypatch):
    # The launch counters are the process's: other tests in this worker
    # may have counted launches before. Start them at zero for this run.
    for fn in bench.kernel_wrappers().values():
        monkeypatch.setattr(fn, "launches", 0)
        if hasattr(fn, "plans"):
            monkeypatch.setattr(fn, "plans", type(fn.plans)())
    bench.main(SMALL_RUN)
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1, out
    line = json.loads(lines[0])
    assert list(line) == _bench_keys()
    unset = [k for k, v in line.items() if v is None]
    assert sorted(unset) == sorted(DEVICE_FIELDS), err
    assert line["devices"] == 1 and line["batch"] == 4
    assert line["value"] > 0 and line["map_size"] == 64
    assert line["quality_ticks"] == 4
    assert line["product_sqp_quality_ticks"] == 4
    assert line["product_quality_ticks"] == 4
    assert line["metric"] == "MPC solves/sec/chip (horizon 0.8s, closed loop)"
    assert line["unit"] == "solves/s/chip"
    # The kernels' launches on stderr: on the CPU the plain versions ran.
    counts = [ln for ln in err.splitlines()
              if ln.startswith("[bench] kernel launches ")]
    assert len(counts) == 1
    launches = json.loads(counts[0][len("[bench] kernel launches "):])
    assert set(launches) >= {"qp_admm", "spd_inv", "footprint_cost",
                             "footprint_walk"}
    assert not any(launches.values())


@pytest.mark.parametrize("control_steps,adaptive,u8", [
    (3, "false", "false"), (5, "true", "auto")])
def test_configurations_equal_bench_py(control_steps, adaptive, u8):
    args = types.SimpleNamespace(control_steps=control_steps,
                                 compact_adaptive=adaptive)
    u8_value = {"false": False, "true": True, "auto": "auto"}[u8]
    ns = _run_bench_py("cfg", "cfg40", "pcfg", args=args,
                       costmap_u8=u8_value)
    cfg = bench.fleet_cfg(control_steps, adaptive == "true", u8_value)
    assert _fields(cfg) == _fields(ns["cfg"])
    assert _fields(bench.default_cfg(cfg)) == _fields(ns["cfg40"])
    assert _fields(bench.product_cfg(cfg)) == _fields(ns["pcfg"])


@pytest.mark.parametrize("kind,names,draws", [
    ("dynamic", ("rngd", "n_obs", "half", "dyn"), "dyn"),
    ("updates", ("rngu", "half", "updp"), "updp")])
def test_obstacle_draws_equal_bench_py(kind, names, draws):
    args = types.SimpleNamespace(batch=5, map_size=48)
    want = _run_bench_py(*names, args=args)[draws]
    got = bench.obstacles(kind, 5, 48, "cpu")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", ["qsb", "sq", "pq"])
def test_quality_scenario_equals_bench_py(name):
    source, tree = _bench_tree()
    (stmt,) = [n for n in ast.walk(tree) if isinstance(n, ast.Assign)
               and isinstance(n.targets[0], ast.Name)
               and n.targets[0].id == name]
    call = stmt.value
    assert call.func.id == "make_scenario_batch"
    kw = {k.arg: k.value for k in call.keywords}
    assert ast.get_source_segment(source, kw.pop("map_size")) == (
        "args.map_size")
    assert ast.literal_eval(kw.pop("maps_on_device")) is True
    assert {k: ast.literal_eval(v) for k, v in kw.items()} == (
        bench.QUALITY_SCENARIO)


def _jax_quality(run):
    """bench.py's quality reductions (bench.py:420-431), as written there,
    on a run's last tick."""
    final_dist = jnp.asarray(run.goal_dist)[:, -1]
    reached = final_dist < 0.10
    goal_reached_frac = float(jnp.mean(reached))
    final_dist_p50 = float(jnp.percentile(final_dist, 50))
    blocked = (jnp.asarray(run.collisions)[:, -1]
               | jnp.asarray(run.lethal)[:, -1])
    n_unreached = float(jnp.sum(~reached))
    unreached_blocked_frac = float(
        jnp.sum(blocked & ~reached) / jnp.maximum(n_unreached, 1.0))
    return goal_reached_frac, final_dist_p50, unreached_blocked_frac


def test_quality_reductions_match_bench_py_on_jax():
    B, T, total = 8, 20, 60
    jcfg = _run_bench_py("cfg", args=types.SimpleNamespace(
        control_steps=3, compact_adaptive="false"), costmap_u8=False)["cfg"]
    jsb = jmake(jcfg, B, map_size=64, **bench.QUALITY_SCENARIO)
    jeng = mpc.MpcEngine(jcfg)
    jsim = jax.jit(lambda b, st, pose, vel, t: jsimulate(
        jcfg, b, t, init=(st, pose, vel)), static_argnums=4)
    want, jticks = bench.chain(
        lambda b, carry, t: jsim(b, *carry, t), jsb,
        (jeng.init_batch_state(B), jsb.robot_pose, jsb.current_vel), T,
        total)

    cfg = bench.fleet_cfg()
    sb = _from_jax(jsb)
    eng = MpcEngine(cfg, device="cpu")
    got, ticks = bench.chain(
        lambda b, carry, t: batch_simulate(cfg, b, t, init=carry), sb,
        (eng.init_batch_state(B), sb.robot_pose, sb.current_vel), T, total)
    assert ticks == jticks == total

    # The closed loops agree lane by lane: the final goal distance within
    # 1e-3 m, so at most one lane crosses 0.10 m on one side only.
    dist, jdist = got.goal_dist[:, -1].numpy(), np.asarray(want.goal_dist)[:, -1]
    np.testing.assert_allclose(dist, jdist, atol=1e-3)
    assert int(((dist < 0.10) != (jdist < 0.10)).sum()) <= 1
    reached, p50, blocked = bench.quality(got)
    j_reached, j_p50, j_blocked = _jax_quality(want)
    # Both sides of the threshold are populated (JAX reads 6 of 8 lanes).
    assert 0.0 < j_reached < 1.0
    assert abs(reached - j_reached) <= 1 / B + 1e-9
    assert abs(p50 - j_p50) <= 1e-3
    blocked_lanes = (got.collisions[:, -1] | got.lethal[:, -1]).numpy()
    j_blocked_lanes = (np.asarray(want.collisions)[:, -1]
                       | np.asarray(want.lethal)[:, -1])
    assert int((blocked_lanes != j_blocked_lanes).sum()) <= 1
    if ((dist < 0.10) == (jdist < 0.10)).all() and (
            blocked_lanes == j_blocked_lanes).all():
        assert blocked == pytest.approx(j_blocked, abs=1e-7)
    # bench.py's formulas on the port's own run give the port's numbers.
    mine = _jax_quality(types.SimpleNamespace(
        goal_dist=got.goal_dist.numpy(), collisions=got.collisions.numpy(),
        lethal=got.lethal.numpy()))
    assert (round(reached, 4), round(p50, 3), round(blocked, 4)) == (
        round(mine[0], 4), round(mine[1], 3), round(mine[2], 4))


def test_no_card_raises_and_prints_no_line(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench.main(["--batch", "4", "--ticks", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--device", "cuda:0", "--batch", "4"])
    assert capsys.readouterr().out == ""


def test_line_prints_once_and_only_with_the_headline(capsys):
    line = bench._Line()
    line.emit()                    # no headline yet: nothing
    line.results.update(value=1.0, metric="m")
    line.emit()
    line.emit()
    assert capsys.readouterr().out == '{"value": 1.0, "metric": "m"}\n'
    # With the run done, the watchdog returns at once and exits nothing.
    line.done.set()
    line.watchdog(1e9, 0.0)


@pytest.mark.parametrize("headline,code", [(True, 0), (False, 3)])
def test_watchdog_at_the_deadline(headline, code):
    """At the deadline the watchdog prints the partial line and exits 0, or
    exits 3 with no line when the headline has not finished."""
    script = (
        "import time\n"
        "from neo_mpc_planner2_tpu_torch import bench\n"
        "line = bench._Line()\n"
        + ("line.results.update(value=2.5, unit='u')\n" if headline else "")
        + "line.watchdog(0.0, time.monotonic())\n"
        "raise SystemExit(7)\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == code, proc.stderr
    assert proc.stdout == ('{"value": 2.5, "unit": "u"}\n' if headline
                           else "")
    assert "watchdog: deadline hit" in proc.stderr


def _trace(tmp_path, events):
    (tmp_path / "trace_1.json").write_text(json.dumps(
        {"traceEvents": events}))
    return str(tmp_path)


def test_device_step_durations_attribute_kernels_by_correlation(tmp_path):
    X = lambda cat, name, ts, dur, corr=None: {
        "ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
        **({"args": {"correlation": corr}} if corr is not None else {})}
    events = [
        X("user_annotation", "bench_step_0", 100.0, 50.0),
        X("user_annotation", "bench_step_1", 200.0, 50.0),
        X("user_annotation", "other_range", 300.0, 50.0),
        X("cuda_runtime", "cudaLaunchKernel", 110.0, 5.0, 1),
        X("cuda_runtime", "cudaLaunchKernel", 120.0, 5.0, 2),
        X("cuda_driver", "cuLaunchKernel", 210.0, 5.0, 3),
        X("cuda_runtime", "cudaLaunchKernel", 310.0, 5.0, 4),
        X("cuda_runtime", "cudaStreamSynchronize", 140.0, 5.0, 9),
        # Kernels run on the device's clock, after their launch range.
        X("kernel", "k1", 160.0, 30.0, 1),
        X("kernel", "k2", 195.0, 12.0, 2),
        X("kernel", "k3", 260.0, 7.0, 3),
        X("kernel", "k4", 360.0, 100.0, 4),
        X("gpu_memcpy", "Memcpy DtoH", 200.0, 40.0, 9),
    ]
    got = profiling.device_step_durations_ms(_trace(tmp_path, events),
                                             "bench_step_")
    assert got == pytest.approx([0.042, 0.007])
    # A trace with the ranges but no device lane: every step reads 0.
    cpu = [e for e in events if e["cat"] in ("user_annotation",
                                             "cuda_runtime")]
    (tmp_path / "trace_2.json").write_text(json.dumps({"traceEvents": cpu}))
    assert profiling.device_step_durations_ms(str(tmp_path),
                                              "bench_step_") == [0.0, 0.0]
