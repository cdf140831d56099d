"""The SQP's CUDA graph path (`sqp._graph_rule`, `sqp._SolveGraphs`), on
the CPU: what can be checked without a card.

- The rule: a solve is graphed on CUDA operands over the whole batch,
  with the parity line-search kernel or the fused wave; the masked Armijo
  loop, the K-wide wave, compaction's sub-batches, an objective that is
  not make_objective's and the CPU keep the eager loop.
- The cache key: every field a graph bakes in splits it (the solver's
  tolerances and schedule, the quirks, dt, the horizon, the batch, the
  objective, the map's shape, dtype and u8 companion, the footprint's
  shape, whether limits are given, the patch); a rebuilt solver and new
  input values at the same shapes do not.
- The counting: a capture's counts and kernel launches are taken out of
  the live counters and added again by each replay; `tally()` takes only
  its own thread's counts.
- A CPU closed loop records no `sqp.graph_*` counter, and its solves are
  the eager reference's.

The graphs themselves run on the card: tests/test_torch_sqp_graph_cuda.py.
"""

import dataclasses
import threading

import pytest
import torch

import neo_mpc_planner2_tpu_torch as tp
from neo_mpc_planner2_tpu_torch import engine, sqp
from neo_mpc_planner2_tpu_torch.ops import footprint as fpm
from neo_mpc_planner2_tpu_torch.ops.objective import Limits, make_objective
from neo_mpc_planner2_tpu_torch.tree import tree_flatten, tree_unflatten
from neo_mpc_planner2_tpu_torch.utils import profiling


def _cfg(**change):
    return dataclasses.replace(tp.fleet_config(),
                               **{"opt_tolerance": 1e-3, **change})


def _product_cfg(**change):
    return dataclasses.replace(tp.product_config(), solver_costmap_patch=8,
                               **change)


def _request(cfg, lanes=2, seed=3, map_size=24, u8=False, limits=False):
    """The first tick's solve request of a tiny CPU scene batch."""
    sb = tp.make_scenario_batch(cfg, lanes, seed=seed, map_size=map_size,
                                plan_points=16, device="cpu")
    state = engine.batch_state(engine.init_state(cfg, "cpu"), lanes)
    lim = Limits.from_config(cfg, lanes, "cpu") if limits else None
    _, scen, state = engine._tick_pre(cfg, state, sb.plan, sb.robot_pose,
                                      sb.current_vel,
                                      sb.costmap.with_flat(u8=u8),
                                      sb.footprint, lim)
    guess, _, _ = engine._pre_solve(cfg, state, scen)
    return guess, scen


# --- the rule ----------------------------------------------------------------

RULE_CASES = {
    # name: (cfg, parity objective, device, whole batch, graphed)
    "cuda_parity_kernel": (_cfg(), True, "cuda", True, True),
    "cuda_fused_wave": (_product_cfg(), False, "cuda", True, True),
    "cuda_masked_loop": (_cfg(solver_costmap_patch=4), True, "cuda", True,
                         False),
    "cuda_k_wave": (_cfg(solver_ls_wave=2, solver_ls_quad_interp=False),
                    True, "cuda", True, False),
    "compaction_sub_batch": (_cfg(), True, "cuda", False, False),
    "cpu": (_cfg(), True, "cpu", True, False),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_the_rule_engages_where_a_trip_never_reads_the_device(case):
    cfg, parity, device, whole, graphed = RULE_CASES[case]
    _, scen = _request(cfg)
    assert sqp._graph_rule(cfg, make_objective(cfg, parity), scen.costmap,
                           device, cfg.parallel_line_search,
                           whole_batch=whole) is graphed


def test_an_objective_not_of_make_objective_stays_eager():
    """A wrapper (such as a counting one) may do anything a graph would
    replay wrongly: without make_objective's `cfg` the rule says no."""
    cfg = _cfg()
    _, scen = _request(cfg)
    base = make_objective(cfg, True)

    def wrapped(*a, **kw):
        return base(*a, **kw)

    wrapped.parity = True
    assert not sqp._graph_rule(cfg, wrapped, scen.costmap, "cuda", False,
                               whole_batch=True)


# --- the key -----------------------------------------------------------------

class _Keyed(Exception):
    pass


@pytest.fixture
def key_of(monkeypatch):
    """key_of(cfg, x0s, scens, parity=True, **solver_kw) -> the key the
    batched solver asks the graph cache for (the rule forced on; nothing
    is captured or solved)."""
    monkeypatch.setattr(sqp, "_graph_rule", lambda *a, **kw: True)

    def fake(key, prepare, x0s, leaves, treedef, upto_k):
        raise _Keyed(key)

    monkeypatch.setattr(sqp, "_solve_graphs", fake)

    def key_of(cfg, x0s, scens, parity=True, **solver_kw):
        solve = sqp.make_sqp_solver_batched(
            cfg, make_objective(cfg, parity), **solver_kw)
        with pytest.raises(_Keyed) as e:
            solve(x0s, scens)
        return e.value.args[0]

    return key_of


def _longer_footprint(scen):
    fp = scen.footprint
    return scen.replace(footprint=fp.replace(vertices=torch.cat(
        [fp.vertices, fp.vertices[..., :2, :]], -2)))


def _double_map(scen):
    cm = scen.costmap
    return scen.replace(costmap=cm.replace(
        data=cm.data.double(), flat=cm.flat.double()))


SPLITS = {
    # name: (cfg change, request change, scens change, solver kwargs)
    "opt_tolerance": (dict(opt_tolerance=1e-4), {}, None, {}),
    "ftol": ({}, {}, None, dict(ftol=1e-6)),
    "qp_iters": ({}, {}, None, dict(qp_iters=30)),
    "max_iters": ({}, {}, None, dict(max_iters=5)),
    "max_backtracks": (dict(solver_max_backtracks=5), {}, None, {}),
    "backtrack": (dict(solver_ls_backtrack=0.6), {}, None, {}),
    "coarse": (dict(solver_ls_coarse_factor=0.125), {}, None, {}),
    "quirks": (dict(compat=dataclasses.replace(
        tp.fleet_config().compat, lethal_1000x=False)), {}, None, {}),
    "dt": (dict(prediction_horizon=0.9), {}, None, {}),
    "control_steps": (dict(control_steps=4), {}, None, {}),
    "batch": ({}, dict(lanes=3), None, {}),
    "map_shape": ({}, dict(map_size=28), None, {}),
    "map_dtype": ({}, {}, _double_map, {}),
    "u8_companion": ({}, dict(u8=True), None, {}),
    "footprint_shape": ({}, {}, _longer_footprint, {}),
    "limits_given": ({}, dict(limits=True), None, {}),
    "patch": (dict(solver_costmap_patch=4), {}, None, {}),
}


@pytest.mark.parametrize("field", sorted(SPLITS))
def test_a_baked_in_field_splits_the_key(key_of, field):
    change, req, edit, kw = SPLITS[field]
    base = key_of(_cfg(), *_request(_cfg()))
    cfg = _cfg(**change)
    x0s, scens = _request(cfg, **req)
    if edit is not None:
        scens = edit(scens)
    assert key_of(cfg, x0s, scens, **kw) != base


def test_the_objective_splits_the_key(key_of):
    cfg = _product_cfg()
    x0s, scens = _request(cfg)
    assert key_of(cfg, x0s, scens, parity=False) != key_of(
        cfg, x0s, scens, parity=True)


def test_new_values_and_a_rebuilt_solver_share_the_key(key_of):
    """Another scene batch at the same shapes, through a solver built
    anew: the fleet harness rebuilds its solver every segment, and each
    segment's scenes are new."""
    cfg = _cfg()
    assert key_of(cfg, *_request(cfg, seed=3)) == key_of(
        _cfg(), *_request(cfg, seed=11))


# --- the counting ------------------------------------------------------------

def test_a_replay_counts_what_its_capture_counted(monkeypatch):
    """_capture takes the capture's counts and kernel launches out of the
    live counters (nothing ran); each replay's add() puts them back."""
    class Graph:
        def __init__(self, graph, pool=None, capture_error_mode=None):
            assert capture_error_mode == "thread_local"

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "graph", Graph)
    # The counters are the process's: this test's counts go with it.
    for f in (sqp.qp_admm, fpm.footprint_cost_batch):
        monkeypatch.setattr(f, "launches", f.launches)
    monkeypatch.setattr(fpm.footprint_cost_batch, "plans",
                        fpm.footprint_cost_batch.plans.copy())

    def body():
        profiling.count("sqp.trips")
        profiling.count("sqp.lane_slots", 64)
        sqp.qp_admm.launches += 1
        fpm.footprint_cost_batch.launches += 2
        fpm.footprint_cost_batch.plans["measured"] += 2
        return "out"

    qp0 = sqp.qp_admm.launches
    fp0 = fpm.footprint_cost_batch.launches
    plans0 = fpm.footprint_cost_batch.plans.copy()
    with profiling.recording() as log:
        out, rec = sqp._capture(None, None, body)
        assert (sqp.qp_admm.launches, fpm.footprint_cost_batch.launches) \
            == (qp0, fp0)
        assert fpm.footprint_cost_batch.plans == plans0
        rec.add()
        rec.add()
    assert out == "out"
    assert log.counts == {"sqp.trips": 2, "sqp.lane_slots": 128}
    assert sqp.qp_admm.launches == qp0 + 2
    assert fpm.footprint_cost_batch.launches == fp0 + 4
    grown = fpm.footprint_cost_batch.plans.copy()
    grown.subtract(plans0)
    assert +grown == {"measured": 4}


def test_a_tally_takes_only_its_own_threads_counts():
    other = threading.Thread(target=profiling.count, args=("elsewhere",))
    with profiling.recording() as log:
        with profiling.tally() as counts:
            profiling.count("mine", 3)
            other.start()
            other.join(30)
            assert not other.is_alive()
        profiling.count("after")
    assert counts == {"mine": 3}
    assert log.counts == {"elsewhere": 1, "after": 1}


def test_tree_flatten_round_trips_a_request():
    _, scens = _request(_cfg(), limits=True)
    leaves, treedef = tree_flatten(scens)
    hash(treedef)
    back = tree_unflatten(treedef, leaves)
    again, treedef2 = tree_flatten(back)
    assert treedef2 == treedef and type(back) is type(scens)
    assert all(a is b for a, b in zip(again, leaves))
    assert back.costmap.win_cells is None and back.weights is None


# --- the CPU -----------------------------------------------------------------

def test_a_cpu_closed_loop_is_eager_and_records_no_graph_counter():
    cfg = _cfg()
    sb = tp.make_scenario_batch(cfg, 4, seed=5, map_size=24, plan_points=32,
                                device="cpu")
    with profiling.recording() as log:
        tp.batch_simulate(cfg, sb, 2)
    assert log.counts["sqp.trips"] > 0
    assert not [k for k in log.counts if k.startswith("sqp.graph_")]
    x0s, scens = _request(cfg, lanes=4, seed=5, map_size=24)
    got = sqp.make_sqp_solver_batched(cfg, make_objective(cfg))(x0s, scens)
    want = sqp.sqp_solve(lambda u: make_objective(cfg)(u, scens), x0s, cfg)
    assert torch.equal(got.x, want.x) and torch.equal(got.iters, want.iters)
