"""The port's solver and K1's plain version at control_steps 12 (m = 36,
the first width past one warp's team: K1's block-team design on the card),
against the JAX package on the CPU.

JAX's unrolled SPD inverse at m = 36 takes XLA about three minutes to
compile on a CPU, so each JAX program at this width gets a file of its own
(the test runner spreads files over its workers): the solver here, the
engine tick in test_torch_horizon12_engine.py.

- The solver at (12, 2.4), tests/test_horizons.py's scenario, ftol 1e-8,
  300 iterations. At this width the JAX package's own objective moves by
  ~1.3e-6 when x0 moves by 1e-7 (ftol 1e-8 stops anywhere along a flat
  valley), so the port's objective is held within twice that spread of
  JAX's, measured here, and at least 1e-6; and to the oracle criterion of
  tests/test_horizons.py:33-34 (objective gap < 1e-4, x within 1e-2 or the
  gap < 2e-6), which the JAX package never ran at 12.
- K1's plain version at m = 36 against JAX's plain QP (vmapped, run
  eagerly), B = 8, 6 iterations, rtol 2e-4 / atol 2e-5.
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch

from neo_mpc_planner2_tpu import sqp as jsqp

from neo_mpc_planner2_tpu_torch import sqp as tsqp

from test_torch_horizons import oracle_solve, solve_pair


def test_solver_at_control_steps_12_within_jax_envelope(
        cfg, empty_costmap, footprint, footprint_np):
    c = cfg.replace(control_steps=12, prediction_horizon=2.4,
                    opt_tolerance=1e-8)
    want_solve, got_solve = solve_pair(c, footprint, empty_costmap)
    x0 = np.zeros(36, np.float32)
    want, got = want_solve(x0), got_solve(x0)
    assert got.x.shape == (36,)
    rng = np.random.default_rng(0)
    own = [float(want.fun)] + [
        float(want_solve(x0 + np.float32(1e-7) * rng.choice(
            [-1, 0, 1], 36).astype(np.float32)).fun) for _ in range(3)]
    spread = max(own) - min(own)
    gap = abs(float(got.fun) - float(want.fun))
    assert gap <= max(1e-6, 2 * spread), (gap, own)
    diag = oracle_solve(c, footprint_np)
    fgap = float(got.fun) - diag["fun"]
    dx = np.abs(diag["raw"] - got.x.numpy()).max()
    assert fgap < 1e-4 and (dx < 1e-2 or fgap < 2e-6), (dx, fgap)


@pytest.mark.filterwarnings("ignore")
def test_qp_admm_plain_matches_jax_plain_at_m36():
    from test_torch_kernels import _qp_inputs

    m = 36
    Bf, g, x, c, J, dxy, lo, hi, carry = _qp_inputs(
        np.random.default_rng(36), 8, m)
    T = lambda a: torch.as_tensor(np.array(a))
    kw = dict(iters=6, rho=1.0, sigma=1e-6)
    got = tsqp.qp_admm_plain(T(Bf), T(g), T(x), T(c), T(J), T(lo), T(hi),
                             *map(T, carry), **kw)
    want = jax.vmap(partial(jsqp._qp_admm_plain, **kw))(
        Bf, g, x, c, J, lo, hi, *carry)
    for gt, w in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-5)
