"""The port's QP (K1) and SPD-inverse (K2) paths against the JAX package.

On the CPU the wrappers run their plain PyTorch versions; these are held
against JAX's plain path and its Pallas kernels in interpret mode at
rtol 2e-4 / atol 2e-5, the gate of tests/test_pallas.py. The CUDA kernels
themselves run only on a card: their tests are in test_torch_cuda.py, which
imports no JAX so that it runs on a machine with a card and no JAX."""

import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neo_mpc_planner2_tpu import sqp as jsqp

from neo_mpc_planner2_tpu_torch import sqp as tsqp
from neo_mpc_planner2_tpu_torch.kernels import build

RTOL, ATOL = 2e-4, 2e-5
T = lambda a: torch.as_tensor(np.array(a))


def _qp_inputs(rng, B, m):
    n = m // 3
    A = rng.normal(size=(B, m, m)).astype(np.float32) * 0.3
    Bmat = A @ np.swapaxes(A, -1, -2) + np.eye(m, dtype=np.float32)
    g = rng.normal(size=(B, m)).astype(np.float32)
    x = rng.uniform(-0.5, 0.5, (B, m)).astype(np.float32)
    xy = x.reshape(B, n, 3)[:, :, :2]
    nrm = np.maximum(np.linalg.norm(xy, axis=-1), 1e-12)
    c = (0.7 - nrm).astype(np.float32)
    J = np.zeros((B, n, m), np.float32)
    for k in range(n):
        J[:, k, 3 * k] = -xy[:, k, 0] / nrm[:, k]
        J[:, k, 3 * k + 1] = -xy[:, k, 1] / nrm[:, k]
    dxy = np.stack([J[:, k, 3 * k + a] for k in range(n) for a in (0, 1)],
                   axis=-1)
    lo = np.full((B, m), -0.7, np.float32)
    hi = np.full((B, m), 0.7, np.float32)
    carry = [rng.normal(size=(B, r)).astype(np.float32) * 0.1
             for r in (m, m, n, m, n)]
    return Bmat.reshape(B, m * m), g, x, c, J, dxy, lo, hi, carry


def _spd(rng, B, m):
    A = rng.normal(size=(B, m, m)).astype(np.float32) * 0.3
    return A @ np.swapaxes(A, -1, -2) + np.eye(m, dtype=np.float32)


# The Pallas kernel in interpret mode costs tens of seconds to trace and
# compile at m = 15, and its program grows with `iters` (the loop is
# unrolled). So each m compiles ONE jitted kernel at iters = CHUNK on a
# 131-lane input set, shared by every case of that m: iters = 6 or 60 runs
# it iters / CHUNK times, feeding the returned ADMM carry (d, zb, zc, wb, wc)
# back in, which is the same iteration (each call recomputes the same
# inverse), and B = 8 takes the first 8 lanes (lanes are independent).
CHUNK = 2
LANES = 131


@functools.lru_cache(maxsize=None)
def _qp_case(m):
    rng = np.random.default_rng(10 * m)
    return _qp_inputs(rng, LANES, m)


@functools.lru_cache(maxsize=None)
def _pallas_kernel(m):
    return jax.jit(partial(jsqp._qp_admm_pallas_batched, iters=CHUNK,
                           rho=1.0, sigma=1e-6, interpret=True, block=128))


def _pallas_qp(m, iters):
    Bf, g, x, c, J, dxy, lo, hi, carry = _qp_case(m)
    head = tuple(map(jnp.asarray, (Bf, g, x, c, dxy, lo, hi)))
    state = tuple(map(jnp.asarray, carry))
    for _ in range(iters // CHUNK):
        out = _pallas_kernel(m)(*head, *state)
        state = out[2:]
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize("iters", [6, 60])
@pytest.mark.parametrize("m", [9, 15])
@pytest.mark.parametrize("B", [8, LANES])
@pytest.mark.filterwarnings("ignore")
def test_qp_admm_plain_matches_jax(B, m, iters):
    Bf, g, x, c, J, dxy, lo, hi, carry = (
        a[:B] if isinstance(a, np.ndarray) else [v[:B] for v in a]
        for a in _qp_case(m))
    kw = dict(iters=iters, rho=1.0, sigma=1e-6)
    got = tsqp.qp_admm_plain(T(Bf), T(g), T(x), T(c), T(J), T(lo), T(hi),
                             *map(T, carry), **kw)
    plain = jax.vmap(partial(jsqp._qp_admm_plain, **kw))(
        Bf, g, x, c, J, lo, hi, *carry)
    pallas = [p[:B] for p in _pallas_qp(m, iters)]
    for want in (plain, pallas):
        for gt, w in zip(got, want):
            np.testing.assert_allclose(gt.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=ATOL)


@pytest.mark.parametrize("m", [6, 9, 15])
def test_chol_inverse_plain_matches_jax_and_numpy(m):
    rng = np.random.default_rng(m)
    M = _spd(rng, 131, m)
    got = tsqp.chol_inverse_plain(T(M)).numpy()
    pallas = jsqp._chol_inverse_pallas_batched(jnp.asarray(M),
                                               interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.linalg.inv(M), rtol=RTOL, atol=ATOL)
    # Exactly symmetric: the lower triangle is mirrored.
    np.testing.assert_array_equal(got, np.swapaxes(got, -1, -2))


def test_cpu_dispatch_takes_the_plain_versions():
    rng = np.random.default_rng(1)
    Bf, g, x, c, J, dxy, lo, hi, carry = _qp_inputs(rng, 8, 9)
    tsqp.qp_admm.launches = 0
    tsqp.chol_inverse.launches = 0
    kw = dict(iters=6, rho=1.0, sigma=1e-6)
    got = tsqp.qp_admm(T(Bf), T(g), T(x), T(c), T(dxy), T(lo), T(hi),
                       *map(T, carry), **kw)
    want = tsqp.qp_admm_plain(T(Bf), T(g), T(x), T(c), T(J), T(lo), T(hi),
                              *map(T, carry), **kw)
    for gt, w in zip(got, want):
        torch.testing.assert_close(gt, w, rtol=0, atol=0)
    M = T(_spd(rng, 8, 9))
    torch.testing.assert_close(tsqp.chol_inverse(M),
                               tsqp.chol_inverse_plain(M), rtol=0, atol=0)
    assert tsqp.qp_admm.launches == 0
    assert tsqp.chol_inverse.launches == 0


def test_cone_constraints_match_jax():
    from neo_mpc_planner2_tpu_torch.config import fleet_config

    from neo_mpc_planner2_tpu.config import fleet_config as jfleet

    rng = np.random.default_rng(2)
    x = rng.uniform(-0.7, 0.7, (16, 9)).astype(np.float32)
    x[0, :2] = 0.0                      # inactive cone row: zero Jacobian
    jc, jJ = jax.vmap(lambda u: jsqp._cone_constraints(u, jfleet()))(x)
    c, dxy = tsqp._cone_constraints(T(x), fleet_config())
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tsqp._cone_jacobian(dxy, 9).numpy(),
                                  np.asarray(jJ))


def test_wrappers_refuse_other_devices():
    meta = torch.empty(4, 9, 9, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tsqp.chol_inverse(meta)
    args = [torch.empty(4, r, device="meta")
            for r in (81, 9, 9, 3, 6, 9, 9, 9, 9, 3, 9, 3)]
    with pytest.raises(ValueError, match="unsupported device"):
        tsqp.qp_admm(*args, iters=6)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_library()
    assert not (tmp_path / "build").exists()
