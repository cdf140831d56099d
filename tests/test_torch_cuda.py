"""The CUDA kernels K1 (qp_admm) and K2 (chol_inverse) on the card.

Every test here needs an NVIDIA GPU: it carries the `cuda` marker and skips
where `torch.cuda.is_available()` is false. The file imports no JAX, so it
runs on a machine with a card and without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX). Kernel against plain
version: rtol 2e-4 / atol 2e-5, the gate of tests/test_pallas.py.
"""

import numpy as np
import pytest
import torch

from neo_mpc_planner2_tpu_torch import sqp

RTOL, ATOL = 2e-4, 2e-5
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _spd(rng, B, m):
    A = rng.normal(size=(B, m, m)).astype(np.float32) * 0.3
    return A @ np.swapaxes(A, -1, -2) + np.eye(m, dtype=np.float32)


def _qp_inputs(rng, B, m, dev):
    """Random SPD QP instances with warm carries (tests/test_pallas.py)."""
    n = m // 3
    g = rng.normal(size=(B, m)).astype(np.float32)
    x = rng.uniform(-0.5, 0.5, (B, m)).astype(np.float32)
    xy = x.reshape(B, n, 3)[:, :, :2]
    nrm = np.maximum(np.linalg.norm(xy, axis=-1), 1e-12)
    c = (0.7 - nrm).astype(np.float32)
    dxy = (-xy / nrm[..., None]).reshape(B, 2 * n).astype(np.float32)
    lo = np.full((B, m), -0.7, np.float32)
    hi = np.full((B, m), 0.7, np.float32)
    carry = [rng.normal(size=(B, r)).astype(np.float32) * 0.1
             for r in (m, m, n, m, n)]
    arrays = [_spd(rng, B, m).reshape(B, m * m), g, x, c, dxy, lo, hi, *carry]
    return [torch.as_tensor(a, device=dev) for a in arrays]


def _plain(args, m, **kw):
    J = sqp._cone_jacobian(args[4], m)
    return sqp.qp_admm_plain(*args[:4], J, *args[5:], **kw)


@pytest.mark.parametrize("iters", [6, 60])
@pytest.mark.parametrize("B", [1, 131, 4096])
@pytest.mark.parametrize("m", [6, 9, 15])
def test_qp_admm_kernel_matches_plain(dev, m, B, iters):
    args = _qp_inputs(np.random.default_rng(m * B + iters), B, m, dev)
    kw = dict(iters=iters, rho=1.0, sigma=1e-6)
    before = sqp.qp_admm.launches
    got = sqp.qp_admm(*args, **kw)
    torch.cuda.synchronize()
    assert sqp.qp_admm.launches == before + 1
    for gt, w in zip(got, _plain(args, m, **kw)):
        assert gt.is_cuda and bool(torch.isfinite(gt).all())
        torch.testing.assert_close(gt, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B", [1, 131, 4096])
@pytest.mark.parametrize("m", [6, 9, 15])
def test_chol_inverse_kernel_matches_plain(dev, m, B):
    M = torch.as_tensor(_spd(np.random.default_rng(m + B), B, m), device=dev)
    before = sqp.chol_inverse.launches
    got = sqp.chol_inverse(M)
    torch.cuda.synchronize()
    assert sqp.chol_inverse.launches == before + 1
    torch.testing.assert_close(got, sqp.chol_inverse_plain(M), rtol=RTOL,
                               atol=ATOL)
    eye = torch.eye(m, device=dev).expand(B, m, m)
    assert float((M @ got - eye).abs().max()) < 1e-3
    assert torch.equal(got, got.transpose(-1, -2))


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    rng = np.random.default_rng(0)
    M = torch.as_tensor(_spd(rng, 8, 9), device=dev)
    with pytest.raises(TypeError):
        sqp.chol_inverse(M.double())
    with pytest.raises(ValueError):
        sqp.chol_inverse(M.transpose(0, 1))        # not contiguous
    with pytest.raises(ValueError):
        sqp.chol_inverse(torch.as_tensor(_spd(rng, 4, 12), device=dev))
    args = _qp_inputs(rng, 8, 9, dev)
    with pytest.raises(ValueError):
        sqp.qp_admm(*args[:-1], args[-1].cpu(), iters=6)   # mixed devices
    with pytest.raises(ValueError):
        sqp.qp_admm(*args[:-1], args[-1][:4], iters=6)     # wrong shape


def test_controller_step_on_the_card_matches_the_cpu(dev):
    """One fleet controller step on the card against the same step on the
    CPU (plain versions): commands within 1e-3 on at least 99 % of lanes (a
    1-ulp tie in f may move a lane's termination by one iteration)."""
    import neo_mpc_planner2_tpu_torch as tp
    from neo_mpc_planner2_tpu_torch.tree import tree_map

    cfg = tp.fleet_config().replace(max_plan_points=64,
                                    footprint_edge_samples=16)
    sb = tp.make_scenario_batch(cfg, 64, seed=3, map_size=48, plan_points=32)
    step = tp.make_batched_controller_step(cfg)
    args = (sb.state, sb.plan, sb.robot_pose, sb.current_vel, sb.costmap,
            sb.footprint, sb.delta_t)
    before = sqp.qp_admm.launches
    gpu = step(*tree_map(lambda t: t.to(dev), args))
    assert sqp.qp_admm.launches > before
    diff = (gpu.cmd_vel.cpu() - step(*args).cmd_vel).abs().amax(-1)
    assert float((diff <= 1e-3).float().mean()) >= 0.99
