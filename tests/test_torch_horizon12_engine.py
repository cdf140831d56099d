"""One MpcEngine tick at control_steps 12 (m = 36), the port's against the
JAX package's on the CPU: cmd_vel within 1e-4 (the golden gate), a local
plan of 13 poses, a warm start of 36. A file of its own: JAX's program at
this width takes XLA about three minutes to compile on a CPU
(test_torch_horizon12.py)."""

from test_torch_horizons import engine_tick_pair

import numpy as np


def test_engine_tick_matches_jax_at_control_steps_12(cfg, empty_costmap,
                                                     footprint):
    c = cfg.replace(control_steps=12)
    want, got = engine_tick_pair(c, empty_costmap, footprint)
    assert got.local_plan.shape == (13, 3)
    assert got.state.initial_guess.shape == (36,)
    np.testing.assert_allclose(got.cmd_vel.numpy(), np.asarray(want.cmd_vel),
                               rtol=0, atol=1e-4)
    assert float(got.cmd_vel[0]) > 0.0
