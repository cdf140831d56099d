"""The SQP's CUDA graphs (`sqp._SolveGraphs`) on the card, against the
eager loop they replace (`sqp._make_sqp`'s `run`, with `sqp._graph_rule`
off).

The scenes are the benchmark's fleet traffic at 64 lanes (and 1) on the
parity and product cells' configurations. A graphed solve equals the
eager solve bit for bit in x, fun, iters and converged, on the solve that
captures and on later solves of other scene batches at the same shapes
(a stale static buffer would show there); two solvers that differ in a
field the graph bakes in each equal their own eager solve; a signature
is captured once across solves and rebuilt solvers; every replay counts
one trip, and the kernels' launch counters read as the eager loop's; the
K-wide wave and compaction replay nothing; K1 is still named in a
profiler trace of replays; a closed loop's commands equal the eager
loop's.

Every test needs an NVIDIA GPU: the file carries the `cuda` marker and
each test skips where `torch.cuda.is_available()` is false (the `dev`
fixture). It imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_sqp_graph_cuda.py
"""

import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from neo_mpc_planner2_tpu_torch import engine, sqp  # noqa: E402
from neo_mpc_planner2_tpu_torch.ops import footprint as fpm  # noqa: E402
from neo_mpc_planner2_tpu_torch.ops.objective import (  # noqa: E402
    make_objective)
from neo_mpc_planner2_tpu_torch.simulation import batch_simulate  # noqa: E402
from neo_mpc_planner2_tpu_torch.utils import profiling  # noqa: E402

pytestmark = pytest.mark.cuda

SEEDS = (3000000019, 2718281829)
LANES = 64
CELLS = ("mpo700_parity", "mpo500_product")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    # Each test counts its own captures.
    sqp._GRAPHS.clear()
    return torch.device("cuda")


def _cell(name, dev, lanes=LANES, seed=SEEDS[0], batches=1, **change):
    """The cell's configuration, whether it is the parity objective, and
    `batches` scene batches of the fleet traffic."""
    from portbench.lib import cells, program, scenes

    c, tr = cells.config(name), cells.traffic("fleet")
    cfg = program.port_config(c).replace(**change)
    m = c["map"]
    sbs = [program.scenario_batch(cfg, c, scenes.fleet_scenes(
        scenes.rng(seed, k), lanes, m["cells"], m["resolution_m"],
        tr["plan_points"], c["engine"]["max_plan_points"],
        tr["plan_length_m"], tr["obstacles"], tr["pose_jitter_m"],
        tr["center_on"], dev)) for k in range(batches)]
    return cfg, c["mode"] == "parity", sbs


def _request(cfg, sb, dev):
    """A scene batch's first-tick solve request (pursuit, warm start)."""
    B = sb.robot_pose.shape[0]
    state = engine.batch_state(engine.init_state(cfg, dev), B)
    _, scen, state = engine._tick_pre(cfg, state, sb.plan, sb.robot_pose,
                                      sb.current_vel, sb.costmap.with_flat(),
                                      sb.footprint, None)
    guess, _, _ = engine._pre_solve(cfg, state, scen)
    return guess, scen


def _eager(monkeypatch):
    monkeypatch.setattr(sqp, "_graph_rule", lambda *a, **kw: False)


def _assert_same(got, want):
    for name in ("x", "fun", "iters", "converged"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def _launches():
    return (sqp.qp_admm.launches, sqp.parity_line_search.launches,
            fpm.footprint_cost_batch.launches,
            dict(fpm.footprint_cost_batch.plans))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell,lanes", [
    ("mpo700_parity", LANES), ("mpo700_parity", 1),
    ("mpo500_product", LANES)])
def test_graphed_solves_equal_the_eager_loop(dev, cell, lanes, seed,
                                             monkeypatch):
    """Three solves of three scene batches at one signature: the first
    captures, the next two replay over new inputs."""
    cfg, parity, sbs = _cell(cell, dev, lanes, seed, batches=3)
    reqs = [_request(cfg, sb, dev) for sb in sbs]
    solve = sqp.make_sqp_solver_batched(cfg, make_objective(cfg, parity))
    with profiling.recording() as log:
        got = [solve(*r) for r in reqs]
    c = log.counts
    assert c["sqp.graph_captures"] == 1 and c["sqp.graph_inits"] == 3
    assert c["sqp.graph_replays"] == c["sqp.trips"] > 0
    _eager(monkeypatch)
    for g, r in zip(got, reqs):
        _assert_same(g, solve(*r))


def test_a_baked_in_field_gets_its_own_graphs(dev, monkeypatch):
    """Solvers at the same shapes with another tolerance or other weights:
    each equals its own eager solve, and each captured once."""
    cfg, parity, [sb] = _cell("mpo700_parity", dev)
    cfgs = [cfg, cfg.replace(opt_tolerance=1e-5),
            cfg.replace(w_trans=2.0 * cfg.w_trans)]
    reqs = [_request(c, sb, dev) for c in cfgs]
    with profiling.recording() as log:
        got = [sqp.make_sqp_solver_batched(c, make_objective(c))(*r)
               for c, r in zip(cfgs, reqs)]
    assert log.counts["sqp.graph_captures"] == 3
    _eager(monkeypatch)
    for c, g, r in zip(cfgs, got, reqs):
        _assert_same(g, sqp.make_sqp_solver_batched(c, make_objective(c))(
            *r))
    assert not torch.equal(got[0].fun, got[2].fun)


def test_a_signature_is_captured_once_for_the_process(dev):
    """Three solves, then a rebuilt solver, then two closed loops (each
    builds its solver anew, as the fleet harness does every segment)."""
    cfg, parity, [sb] = _cell("mpo700_parity", dev)
    req = _request(cfg, sb, dev)
    with profiling.recording() as log:
        solve = sqp.make_sqp_solver_batched(cfg, make_objective(cfg))
        for _ in range(3):
            solve(*req)
        sqp.make_sqp_solver_batched(cfg, make_objective(cfg))(*req)
    assert log.counts["sqp.graph_captures"] == 1
    with profiling.recording() as log:
        for _ in range(2):
            batch_simulate(cfg, sb, 2, parity=True)
    c = log.counts
    assert "sqp.graph_captures" not in c
    assert c["sqp.graph_replays"] == c["sqp.trips"]
    assert c["sqp.graph_inits"] == c["sqp.solves"] == 4


@pytest.mark.parametrize("cell", CELLS)
def test_the_kernels_launch_counters_read_as_the_eager_loops(dev, cell,
                                                             monkeypatch):
    cfg, parity, [sb] = _cell(cell, dev)
    req = _request(cfg, sb, dev)
    solve = sqp.make_sqp_solver_batched(cfg, make_objective(cfg, parity))
    solve(*req)                     # the capture
    before = _launches()
    solve(*req)
    graphed = _launches()
    _eager(monkeypatch)
    solve(*req)
    eager = _launches()
    delta = lambda a, b: [y - x if isinstance(x, int) else
                          {k: y[k] - x.get(k, 0) for k in y}
                          for x, y in zip(a, b)]
    assert delta(before, graphed) == delta(graphed, eager)
    assert delta(before, graphed)[0] > 0


@pytest.mark.parametrize("arm", ["k_wave", "compaction"])
def test_the_k_wave_and_compaction_replay_nothing(dev, arm):
    change = (dict(solver_ls_wave=2, solver_ls_quad_interp=False)
              if arm == "k_wave" else
              dict(solver_compact_after=2, solver_compact_min_batch=16))
    cfg, parity, [sb] = _cell("mpo700_parity", dev, **change)
    with profiling.recording() as log:
        batch_simulate(cfg, sb, 2, parity=True)
    assert log.counts["sqp.trips"] > 0
    assert not [k for k in log.counts if k.startswith("sqp.graph_")]


def test_k1_is_named_in_a_trace_of_replays(dev):
    """The benchmark's qp_admm_roofline reads K1's kernels by name from a
    torch.profiler trace: they must show inside a replayed graph."""
    from torch.profiler import ProfilerActivity, profile

    cfg, parity, [sb] = _cell("mpo700_parity", dev)
    req = _request(cfg, sb, dev)
    solve = sqp.make_sqp_solver_batched(cfg, make_objective(cfg))
    solve(*req)
    torch.cuda.synchronize()
    with profiling.recording() as log, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solve(*req)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    k1 = [n for n in names if "qp_admm" in n]
    assert len(k1) == log.counts["sqp.graph_replays"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_a_closed_loop_equals_the_eager_loop(dev, cell, monkeypatch):
    cfg, parity, [sb] = _cell(cell, dev)
    got = batch_simulate(cfg, sb, 5, parity=parity)
    _eager(monkeypatch)
    want = batch_simulate(cfg, sb, 5, parity=parity)
    assert torch.equal(got.cmds, want.cmds)
    assert torch.equal(got.solver_iters, want.solver_iters)
