"""`correct` comes out false when the timed path is broken underneath or
replaced by the lower-precision control; the harness's look for a card is
skipped (the CPU path at a tiny size), everything else of a run is driven.

Faults planted in the program: a step that returns its state unchanged;
half of the batch left out; an answer altered where it is produced. (The
cells run on one chip, so there is no exchange between chips to leave
out.)"""

import contextlib
import io
import json

import pytest
import torch

from portbench import readings
from portbench import run as bench

FLEET = ["--workload", "mpo700_parity.fleet", "--seed", "4000000007",
         "--seconds", "0.1", "--device", "cpu", "--lanes", "8",
         "--ticks", "6"]
SERVE = ["--workload", "mpo700_parity.serve_one", "--seed", "4000000009",
         "--seconds", "1.5", "--device", "cpu"]


def _line(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert bench.main(argv) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _broken_step(kind):
    import neo_mpc_planner2_tpu_torch.engine as engine

    make = engine.make_batched_controller_step

    def factory(cfg, parity=True, solver_batch=None):
        step = make(cfg, parity, solver_batch)

        def broken(state, plan, pose, vel, cm, fp, dt, limits=None):
            out = step(state, plan, pose, vel, cm, fp, dt, limits)
            if kind == "state_unchanged":
                return out._replace(state=state)
            cmd = out.cmd_vel.clone()
            if kind == "half_left_out":
                cmd[cmd.shape[0] // 2:] = 0.0
            else:
                cmd[:, 0] += 0.01
            return out._replace(cmd_vel=cmd)

        return broken

    return factory


def test_the_sound_program_is_correct():
    assert _line(FLEET)["correct"] is True


@pytest.mark.parametrize("kind", ["state_unchanged", "half_left_out",
                                  "answer_altered"])
def test_a_broken_fleet_step_is_not_correct(kind, monkeypatch):
    import neo_mpc_planner2_tpu_torch.engine as engine

    monkeypatch.setattr(engine, "make_batched_controller_step",
                        _broken_step(kind))
    line = _line(FLEET)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("kind", ["state_unchanged", "answer_altered"])
def test_a_broken_server_is_not_correct(kind, monkeypatch):
    from neo_mpc_planner2_tpu_torch.serving import OptimizerSession

    solve = OptimizerSession._solve_requests

    def broken(self, state, reqs):
        packed, new = solve(self, state, reqs)
        if kind == "state_unchanged":
            return packed, state
        packed = packed.clone()
        packed[:, 0] += 0.01
        return packed, new

    monkeypatch.setattr(OptimizerSession, "_solve_requests", broken)
    line = _line(SERVE)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("workload,extra", [
    ("mpo700_parity.fleet", dict(lanes=8, ticks=6, seconds=0.1)),
    ("mpo500_product.fleet", dict(lanes=4, ticks=4, seconds=0.1)),
    ("mpo700_parity.serve_one", dict(seconds=1.5)),
])
def test_the_bfloat16_control_is_not_correct(workload, extra):
    seconds = extra.pop("seconds")
    got = list(readings.readings(workload, "control", [4000000011],
                                 seconds, "cpu", **extra))
    assert got and got[0][1] is False, got


@pytest.mark.cuda
def test_the_control_fails_at_the_cells_size_on_the_card():
    """The control at the fleet cell's own size (run on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    got = list(readings.readings("mpo700_parity.fleet", "control",
                                 [4000000013], 1.0, "cuda"))
    assert got[0][1] is False, got
