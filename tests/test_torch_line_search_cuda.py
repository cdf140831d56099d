"""The parity line-search kernel (csrc/parity_line_search.cu) on the card
against the masked loop it replaces (`sqp._masked_armijo`).

The scenes are the parity fleet cell's: portbench's fleet traffic
generator at one seed for `mpo700_parity`, 4096 lanes, the first tick's
SQP trips. Each trip's operands go to both (`chip_smoke.ParityLsRecorder`:
the solve goes on with the masked loop's result), and alpha, f at the
accepted candidate and the acceptance must be bit-equal in every lane, on
both sequential branches (the quadratic interpolation and the two-phase
factor), with per-lane Weights and Limits, and at B = 1. A whole
`solve_batch` with the kernel matches the masked loop's solve at the
tolerances of tests/test_torch_sqp.py (rtol 1e-4, equal iterations and
convergence). (tests/test_torch_spans.py holds the counters: one
`sqp.ls_fused` a trip on the card.)

Every test needs an NVIDIA GPU: the file carries the `cuda` marker and
each test skips where `torch.cuda.is_available()` is false (the `dev`
fixture). It imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_line_search_cuda.py
"""

import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from neo_mpc_planner2_tpu_torch import engine, sqp  # noqa: E402
from neo_mpc_planner2_tpu_torch.ops.objective import (  # noqa: E402
    Limits, Weights, make_objective)
from neo_mpc_planner2_tpu_torch.simulation import batch_simulate  # noqa: E402
from neo_mpc_planner2_tpu_torch.tree import tree_map  # noqa: E402

pytestmark = pytest.mark.cuda

# One seed of the fleet traffic (a large one: seeds run past 32 bits).
SEED = 3000000019
LANES = 4096
BRANCHES = {"quad_interp": True, "two_phase": False}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _fleet(dev, lanes=LANES, **change):
    """The parity fleet cell's configuration and its first scene batch."""
    from portbench.lib import cells, program, scenes

    c, tr = cells.config("mpo700_parity"), cells.traffic("fleet")
    cfg = program.port_config(c).replace(**change)
    m = c["map"]
    sc = scenes.fleet_scenes(
        scenes.rng(SEED, 0), lanes, m["cells"], m["resolution_m"],
        tr["plan_points"], c["engine"]["max_plan_points"],
        tr["plan_length_m"], tr["obstacles"], tr["pose_jitter_m"],
        tr["center_on"], dev)
    return cfg, program.scenario_batch(cfg, c, sc)


def _request(cfg, sb, dev, per_lane: bool):
    """The first tick's solve request (the engine's pursuit and warm start)
    with, if per_lane, each lane's own Weights and Limits drawn around the
    configuration's."""
    B = sb.robot_pose.shape[0]
    state = engine.batch_state(engine.init_state(cfg, dev), B)
    cm = sb.costmap.with_flat()
    limits = None
    if per_lane:
        g = torch.Generator(device=dev).manual_seed(1)
        u = lambda lo, hi: lo + (hi - lo) * torch.rand(B, generator=g,
                                                       device=dev)
        limits = Limits.from_config(cfg, B, dev).replace(
            max_vel_trans=u(0.4, 0.7))
    _, scen, state = engine._tick_pre(cfg, state, sb.plan, sb.robot_pose,
                                      sb.current_vel, cm, sb.footprint,
                                      limits)
    if per_lane:
        w = Weights.from_config(cfg, B, dev)
        scen = scen.replace(weights=Weights(*(
            getattr(w, n) * u(0.5, 2.0) for n in (
                "w_trans", "w_orient", "w_control", "w_terminal",
                "w_costmap", "w_footprint"))))
    guess, _, _ = engine._pre_solve(cfg, state, scen)
    return guess, scen


def _held(rec):
    assert len(rec.trips) >= 3
    diff = rec.differing()
    # Ties of the Armijo test or of a cell index would show here; none was
    # seen on these scenes.
    assert diff["differing"] == 0, diff
    return diff


@pytest.mark.parametrize("branch,steps,lanes", [
    ("quad_interp", 3, LANES), ("two_phase", 3, LANES),
    ("quad_interp", 5, LANES), ("quad_interp", 12, LANES),
    ("quad_interp", 64, 8)])
def test_kernel_takes_the_masked_loops_steps_on_the_fleet_tick(dev, branch,
                                                               steps, lanes):
    """The cell's horizon (3 steps) on both branches; 5 and 12 steps, and
    64 steps at 8 lanes, where PyTorch sums a row over 4, 8 and 64
    threads."""
    cfg, sb = _fleet(dev, lanes, solver_ls_quad_interp=BRANCHES[branch],
                     control_steps=steps)
    with chip_smoke.ParityLsRecorder() as rec:
        batch_simulate(cfg, sb, 1, parity=True)
    _held(rec)


@pytest.mark.parametrize("branch", sorted(BRANCHES))
@pytest.mark.parametrize("lanes", [LANES, 1])
def test_kernel_takes_the_masked_loops_steps_per_lane(dev, branch, lanes):
    """Per-lane Weights and Limits (the cone's radius among them), at the
    fleet's width and at one lane."""
    cfg, sb = _fleet(dev, solver_ls_quad_interp=BRANCHES[branch])
    guess, scen = _request(cfg, sb, dev, per_lane=True)
    if lanes == 1:
        guess, scen = guess[:1], tree_map(lambda t: t[:1], scen)
    solve = sqp.make_sqp_solver_batched(cfg, make_objective(cfg))
    with chip_smoke.ParityLsRecorder() as rec:
        solve(guess, scen)
    _held(rec)


@pytest.mark.parametrize("per_lane", [False, True], ids=["config",
                                                         "per_lane"])
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_solve_with_the_kernel_matches_the_masked_loops(dev, branch,
                                                        per_lane,
                                                        monkeypatch):
    cfg, sb = _fleet(dev, solver_ls_quad_interp=BRANCHES[branch])
    guess, scen = _request(cfg, sb, dev, per_lane)
    solve = sqp.make_sqp_solver_batched(cfg, make_objective(cfg))
    launches = sqp.parity_line_search.launches
    got = solve(guess, scen)
    assert sqp.parity_line_search.launches > launches
    monkeypatch.setattr(sqp, "_fused_line_search_rule", lambda *a: False)
    want = solve(guess, scen)
    torch.testing.assert_close(got.x, want.x, rtol=1e-4, atol=1e-5)
    assert torch.equal(got.iters, want.iters)
    assert torch.equal(got.converged, want.converged)
