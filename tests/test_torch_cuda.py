"""The CUDA kernels K1 (qp_admm) and K2 (chol_inverse) at the widths of
every horizon (each design, and each kernel at its cap), K3
(footprint_cost_batch, and its walk) on the card at each launch plan and
past 16 vertices and 64 samples an edge, one step of each slice against the
CPU, and the single-robot controller's ticks (both routes) against the
CPU, with K1 and K3 read from a traced tick, and the benchmark
(`neo_mpc_planner2_tpu_torch.bench`) at 64 lanes.

Every test here needs an NVIDIA GPU: it carries the `cuda` marker and skips
where `torch.cuda.is_available()` is false (decided inside the `dev`
fixture). The file imports no JAX, so it runs on a machine with a card and
without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX). Kernel against plain
version: K1 and K2 at rtol 2e-4 / atol 2e-5, the gate of
tests/test_pallas.py; K3 exactly, since it returns picked map values.
"""

import functools
import pathlib
import sys

import numpy as np
import pytest
import torch

from neo_mpc_planner2_tpu_torch import sqp
from neo_mpc_planner2_tpu_torch.ops import costmap as cmap
from neo_mpc_planner2_tpu_torch.ops import footprint as fpm

ROOT = pathlib.Path(__file__).resolve().parent.parent

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


# K1's widths on the card: the warp team at the slices' 6, 9 and 15, the
# horizons' 3 and its last width 18; the warp lane at its first width 21,
# the horizons' 24 and 36, 33 and its last 63; the block lane at its first
# width 66, 96 and the cap.
K1_M = [3, 6, 9, 15, 18, 21, 24, 33, 36, 63, 66, 96, 237]
# K2's: unrolled at 3, 6, 9, 15; the runtime-m kernel a warp a matrix at 1,
# 2, 4, 19, 21, 24, 32, 33, 36, 40 and 41 (its last), a block a matrix at
# 42 (its first), 64, 65 and the cap.
K2_M = [1, 2, 3, 4, 6, 9, 15, 19, 21, 24, 32, 33, 36, 40, 41, 42, 64, 65,
        240]
# Batch sizes: 65536 lanes only up to m = 36 (at the cap one batch would
# take 15 GB).
K2_CASES = [(m, B) for m in K2_M for B in (1, 131, 4096, 65536)
            if B < 65536 or m <= 36]


def _ill(m):
    """tests/test_solver.py's ill-conditioned diagonal (1e4 down to 1e-3),
    cut or padded with ones to m."""
    d = [1e4, 1e3, 1e2, 10, 1, 1, 0.1, 0.01, 1e-3] + [1.0] * max(0, m - 9)
    return torch.tensor(d[:m])


@pytest.mark.parametrize("iters", [6, 60])
@pytest.mark.parametrize("B", [1, 131, 4096])
@pytest.mark.parametrize("m", K1_M)
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


@pytest.mark.parametrize("m", K1_M)
def test_qp_admm_lane_does_not_depend_on_its_batch(dev, m):
    """A lane's result is the same whatever lanes share its warp and block:
    the whole batch, its first 131 lanes, and the batch shifted by one lane
    (every lane moves to another team slot)."""
    args = _qp_inputs(np.random.default_rng(m), 4096, m, dev)
    kw = dict(iters=60, rho=1.0, sigma=1e-6)
    full = sqp.qp_admm(*args, **kw)
    head = sqp.qp_admm(*(a[:131].contiguous() for a in args), **kw)
    shifted = sqp.qp_admm(*(a[1:].contiguous() for a in args), **kw)
    torch.cuda.synchronize()
    for f, h, s in zip(full, head, shifted):
        assert torch.equal(f[:131], h)
        assert torch.equal(f[1:], s)


# Counts the CUDA launches and the kernels on the card of one qp_admm call
# (B = 512, 60 iterations) or of one chol_inverse call (B = 4096) at each
# of a few widths, with chip_smoke.count_launches, in a process of its
# own: late in a process that has run many kernel calls or taken many
# traces, torch.profiler was seen to report none of a trace's device
# records (PERF.md), and chip_smoke counts first for that
# reason.
_COUNT_LAUNCHES = """
import json, sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from neo_mpc_planner2_tpu_torch import sqp
dev = torch.device("cuda")
rng = np.random.default_rng(0)
out = {}
for m in %s:
    if "%s" == "qp_admm":
        args = cs._qp_inputs(rng, 512, m, dev)
        call = lambda: sqp.qp_admm(*args, iters=60)
    else:
        M = cs._spd_inputs(rng, 4096, m, dev)
        call = lambda: sqp.chol_inverse(M)
    out[m] = cs.count_launches(call)
print(json.dumps(out))
"""


# Widths counted a process, the widest first.
_COUNTS_A_PROCESS = 6


@functools.lru_cache(maxsize=None)
def _launch_counts_of(kernel: str, widths: tuple) -> dict:
    import json
    import subprocess

    proc = subprocess.run(
        [sys.executable, "-c", _COUNT_LAUNCHES % (list(widths), kernel)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    counts = json.loads(proc.stdout.strip().splitlines()[-1])
    return {int(m): n for m, n in counts.items()}


def _launch_counts(kernel: str, m: int) -> dict:
    widths = sorted(K1_M if kernel == "qp_admm" else K2_M, reverse=True)
    k = widths.index(m) // _COUNTS_A_PROCESS * _COUNTS_A_PROCESS
    return _launch_counts_of(kernel,
                             tuple(widths[k:k + _COUNTS_A_PROCESS]))[m]


@pytest.mark.parametrize("m", K1_M)
def test_qp_admm_is_one_launch(dev, m):
    """One qp_admm call on the card is one CUDA launch: the operands and
    outputs are batch-major, so the wrapper copies nothing."""
    assert _launch_counts("qp_admm", m) == {"launches": 1, "kernels": 1}


@pytest.mark.parametrize("m,B", K2_CASES)
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


@pytest.mark.parametrize("m", [9, 4, 24, 40, 41, 42, 240])
def test_chol_inverse_ill_conditioned_matches_plain(dev, m):
    """tests/test_solver.py's ill-conditioned diagonal (1e4 down to 1e-3,
    cut or padded with ones to m) in each plan: unrolled (m = 9), a warp a
    matrix (4, 24, 40, 41), a block a matrix (42, 240)."""
    d = _ill(m).to(dev)
    M = torch.diag(d)[None].contiguous()
    got = sqp.chol_inverse(M)
    torch.testing.assert_close(got, sqp.chol_inverse_plain(M), rtol=RTOL,
                               atol=ATOL)
    torch.testing.assert_close(torch.diagonal(got[0]), 1.0 / d, rtol=1e-4,
                               atol=0.0)


@pytest.mark.parametrize("m", [9, 18, 21, 36, 63, 66, 237])
def test_qp_admm_ill_conditioned_matches_plain(dev, m):
    """K1 with the ill-conditioned diagonal as its curvature B, in each
    design: the warp team (m = 9, 18), the warp lane (21, 36, 63), the
    block lane (66, the cap)."""
    args = _qp_inputs(np.random.default_rng(m), 3, m, dev)
    args[0] = torch.diag(_ill(m)).reshape(1, m * m).repeat(3, 1).to(dev)
    kw = dict(iters=60, rho=1.0, sigma=1e-6)
    for gt, w in zip(sqp.qp_admm(*args, **kw), _plain(args, m, **kw)):
        torch.testing.assert_close(gt, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("m", K2_M)
def test_chol_inverse_is_one_launch(dev, m):
    """One chol_inverse call on the card is one CUDA launch: the kernel
    reads and writes (B, m, m) itself, so the wrapper copies nothing."""
    assert _launch_counts("spd_inv", m) == {"launches": 1, "kernels": 1}


@pytest.mark.parametrize("m", K2_M)
def test_chol_inverse_lane_does_not_depend_on_its_block(dev, m):
    """A lane's inverse is bit-identical whatever lanes share its block and
    however many threads share its work: the whole batch, its first 131
    lanes, the batch shifted by one lane (a view that starts off a 16-byte
    boundary), each at every launch shape K2 takes at m (the unrolled
    design's widths; the runtime-m kernel a warp a matrix, 1, 4 or 8 to a
    block, where they fit, and a block of 4, 16 or 32 warps a matrix),
    and inside the batch repeated 16 times (65,536 lanes at m <= 64; for
    the unrolled design, a batch large enough for the narrow width). The
    upper triangle is never read."""
    from neo_mpc_planner2_tpu_torch.kernels import binding

    B = 4096 if m <= 64 else 512
    M = torch.as_tensor(_spd(np.random.default_rng(m), B, m), device=dev)
    full = sqp.chol_inverse(M)
    if m in binding.K2_UNROLLED_M:
        shapes = [(w, binding.K2_UNROLLED_MATRICES)
                  for w in binding.K2_WIDTHS]
    else:
        shapes = [(w, w) for w in (1, 4, 8)
                  if w * binding.k2_block_smem_bytes(m) <= binding.MAX_SMEM]
        shapes += [(w, 1) for w in (4, 16, 32)]
    for shape in shapes:
        at = lambda A: binding._launch_spd_inv_at(A, shape)
        assert torch.equal(at(M), full)
        assert torch.equal(at(M[:131].contiguous()), full[:131])
        assert torch.equal(at(M[1:]), full[1:])
    big = M.repeat(16, 1, 1)
    if m in binding.K2_UNROLLED_M:
        assert binding.k2_launch_shape(big.shape[0], dev) == 1
    assert torch.equal(sqp.chol_inverse(big)[-B:], full)
    upper = torch.triu(torch.ones(m, m, dtype=torch.bool, device=dev), 1)
    garbage = M.masked_fill(upper, float("nan"))
    assert torch.equal(sqp.chol_inverse(garbage), full)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    """Wrong types, layouts and shapes raise; every width up to a kernel's
    cap is served (m = 12, refused before the kernels took every width,
    equals its plain version), and the width above K2's cap raises, naming
    it."""
    from neo_mpc_planner2_tpu_torch.kernels import binding

    rng = np.random.default_rng(0)
    M = torch.as_tensor(_spd(rng, 8, 9), device=dev)
    with pytest.raises(TypeError):
        sqp.chol_inverse(M.double())
    with pytest.raises(ValueError):
        sqp.chol_inverse(M.transpose(0, 1))        # not contiguous
    M12 = torch.as_tensor(_spd(rng, 4, 12), device=dev)
    torch.testing.assert_close(sqp.chol_inverse(M12),
                               sqp.chol_inverse_plain(M12), rtol=RTOL,
                               atol=ATOL)
    big = binding.K2_MAX_M + 1
    with pytest.raises(ValueError, match=f"1..{binding.K2_MAX_M}"):
        sqp.chol_inverse(torch.eye(big, device=dev)[None].contiguous())
    with pytest.raises(ValueError):                        # 2-D
        sqp.chol_inverse(M[0])
    with pytest.raises(ValueError):                        # not square
        sqp.chol_inverse(M[:, :, :6].contiguous())
    args = _qp_inputs(rng, 8, 9, dev)
    with pytest.raises(ValueError):
        sqp.qp_admm(*args[:-1], args[-1].cpu(), iters=6)   # mixed devices
    with pytest.raises(ValueError):
        sqp.qp_admm(*args[:-1], args[-1][:4], iters=6)     # wrong shape
    with pytest.raises(ValueError):                        # lane-minor
        sqp.qp_admm(*(a.t().contiguous() for a in args), iters=6)


def test_kernels_at_their_caps_match_plain(dev):
    """K1 at its cap (m = 237, control_steps 79: 227,520 bytes of shared
    memory a block) and K2 at its own (m = 240), each against its plain
    version, B = 3; K1 one width above its cap raises, naming the cap."""
    from neo_mpc_planner2_tpu_torch.kernels import binding

    m = binding.K1_MAX_M
    args = _qp_inputs(np.random.default_rng(m), 3, m, dev)
    kw = dict(iters=60, rho=1.0, sigma=1e-6)
    for gt, w in zip(sqp.qp_admm(*args, **kw), _plain(args, m, **kw)):
        torch.testing.assert_close(gt, w, rtol=RTOL, atol=ATOL)
    big = _qp_inputs(np.random.default_rng(0), 1, m + 3, dev)
    with pytest.raises(ValueError, match=f"cap m={m}"):
        sqp.qp_admm(*big, iters=6)
    m = binding.K2_MAX_M
    M = torch.as_tensor(_spd(np.random.default_rng(m), 3, m), device=dev)
    torch.testing.assert_close(sqp.chol_inverse(M),
                               sqp.chol_inverse_plain(M), rtol=RTOL,
                               atol=ATOL)


def test_controller_step_on_the_card_matches_the_cpu(dev):
    """One fleet controller step on the card against the same step on the
    CPU (plain versions): commands within 1e-3 on at least 99 % of lanes (a
    1-ulp tie in f may move a lane's termination by one iteration)."""
    import neo_mpc_planner2_tpu_torch as tp
    from neo_mpc_planner2_tpu_torch.tree import tree_map

    cfg = tp.fleet_config().replace(max_plan_points=64,
                                    footprint_edge_samples=16)
    sb = tp.make_scenario_batch(cfg, 64, seed=3, map_size=48, plan_points=32,
                                device=dev)
    step = tp.make_batched_controller_step(cfg)
    args = (sb.state, sb.plan, sb.robot_pose, sb.current_vel, sb.costmap,
            sb.footprint, sb.delta_t)
    assert sb.robot_pose.is_cuda and sb.costmap.data.is_cuda
    before = sqp.qp_admm.launches
    gpu = step(*args)
    assert sqp.qp_admm.launches > before
    cpu = step(*tree_map(lambda t: t.cpu(), args))
    diff = (gpu.cmd_vel.cpu() - cpu.cmd_vel).abs().amax(-1)
    assert float((diff <= 1e-3).float().mean()) >= 0.99


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("S", [8, 16, 32, 64])
@pytest.mark.parametrize("R", [1, 3, 21])
@pytest.mark.parametrize("B", [1, 131, 4096])
def test_footprint_cost_kernel_matches_plain(dev, B, R, S):
    """Rectangles, padded triangles, samples on cell boundaries and in the
    band below the origin, polygons off the map; the whole grid and a patch
    rectangle."""
    rng = np.random.default_rng(B + 10 * R + S)
    data, origin, res, verts, nv = _chip_smoke()._k3_inputs(rng, B, R, dev)
    cm = cmap.Costmap(data=data, origin=origin, resolution=res)
    cx = torch.as_tensor(rng.uniform(-2.0, 2.0, B), dtype=torch.float32,
                         device=dev)
    t = fpm.edge_parameters(S, dev)
    for bounds in (None, cmap.product_patch_bounds(cm, cx, cx, 28)):
        args = (data, origin, res, bounds, verts, nv, t)
        before = fpm.footprint_cost_batch.launches
        got = fpm.footprint_cost_batch(*args)
        torch.cuda.synchronize()
        assert fpm.footprint_cost_batch.launches == before + 1
        assert got.is_cuda and got.shape == (B, R)
        assert torch.equal(got, fpm.footprint_cost_batch_plain(*args))


@pytest.mark.parametrize("shape", [(1, 1), (4, 1), (2, 2), (1, 7), (8, 3),
                                   (16, 2)])
def test_footprint_cost_kernel_matches_plain_at_every_launch_shape(dev,
                                                                  shape):
    """Any (lanes_per_block, warps_per_lane) gives the same costs: a lane's
    polygons split over its warps in any way, odd S takes the general
    path."""
    from neo_mpc_planner2_tpu_torch.kernels import binding

    rng = np.random.default_rng(sum(shape))
    data, origin, res, verts, nv = _chip_smoke()._k3_inputs(rng, 131, 21,
                                                            dev)
    cm = cmap.Costmap(data=data, origin=origin, resolution=res)
    cx = torch.as_tensor(rng.uniform(-2.0, 2.0, 131), dtype=torch.float32,
                         device=dev)
    for S in (16, 13):
        t = fpm.edge_parameters(S, dev)
        for bounds in (None, cmap.product_patch_bounds(cm, cx, cx, 28)):
            args = (data, origin, res, bounds, verts, nv, t)
            got = binding.launch_footprint_cost(*args, shape=shape)
            torch.cuda.synchronize()
            assert torch.equal(got, fpm.footprint_cost_batch_plain(*args))


def test_footprint_cost_kernel_matches_plain_on_product_slice_calls(dev):
    """K3 on the arguments of its own calls in the product closed loop
    (the gate, the gradient calls and the candidate wave with its patch
    bounds), captured from a 2-tick run."""
    import neo_mpc_planner2_tpu_torch as tp

    cs = _chip_smoke()
    cfg = cs.product_cfg()
    sb = tp.make_scenario_batch(cfg, 256, seed=5, map_size=64,
                                plan_points=64, device=dev)
    with cs.K3Recorder() as rec:
        tp.batch_simulate(cfg, sb, 2, parity=False)
    cases = cs.captured_k3_cases(rec)
    assert {k.split("_")[0] for k in cases} >= {"gate", "wave"}
    for label, args in cases.items():
        got = fpm.footprint_cost_batch(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, fpm.footprint_cost_batch_plain(*args)), label


def test_footprint_cost_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    from neo_mpc_planner2_tpu_torch.kernels import binding

    rng = np.random.default_rng(5)
    data, origin, res, verts, nv = _chip_smoke()._k3_inputs(rng, 4, 3, dev)
    t = fpm.edge_parameters(16, dev)
    ok = (data, origin, res, None, verts, nv, t)
    bad = [
        (TypeError, dict(data=data.double())),
        (TypeError, dict(n_valid=nv.long())),
        (ValueError, dict(verts=verts.transpose(0, 1))),     # not contiguous
        (ValueError, dict(n_valid=nv.cpu())),                # mixed devices
        # Past the one cap left: one polygon's edges and the samples fill a
        # block (binding.k3_max_samples).
        (ValueError, dict(t=torch.zeros(binding.k3_max_samples(8) + 1,
                                        device=dev))),
        (ValueError, dict(bounds=torch.zeros(4, 3, dtype=torch.int32,
                                             device=dev))),  # wrong shape
    ]
    names = ("data", "origin", "res", "bounds", "verts", "n_valid", "t")
    for err, over in bad:
        args = dict(zip(names, ok), **over)
        with pytest.raises(err):
            fpm.footprint_cost_batch(**args)


def test_product_step_on_the_card_matches_the_cpu(dev):
    """One product-mode controller step on the card against the CPU: the
    wave line search and the patch sampler, with K1 and K3 launched."""
    import neo_mpc_planner2_tpu_torch as tp
    from neo_mpc_planner2_tpu_torch.tree import tree_map

    cfg = _chip_smoke().product_cfg()
    sb = tp.make_scenario_batch(cfg, 64, seed=3, map_size=48, plan_points=32,
                                device=dev)
    step = tp.make_batched_controller_step(cfg, parity=False)
    args = (sb.state, sb.plan, sb.robot_pose, sb.current_vel, sb.costmap,
            sb.footprint, sb.delta_t)
    qp0, fp0 = sqp.qp_admm.launches, fpm.footprint_cost_batch.launches
    gpu = step(*args)
    assert sqp.qp_admm.launches > qp0
    assert fpm.footprint_cost_batch.launches > fp0
    cpu = step(*tree_map(lambda t: t.cpu(), args))
    diff = (gpu.cmd_vel.cpu() - cpu.cmd_vel).abs().amax(-1)
    assert float((diff <= 1e-3).float().mean()) >= 0.99


def test_prox_step_on_the_card_matches_the_cpu(dev):
    """One controller step of the prox slice (the product point with the
    prox-FISTA solver) on the card against the CPU on 64 lanes, with K3
    launched: commands within 1e-3 on at least 99 % of lanes."""
    import neo_mpc_planner2_tpu_torch as tp
    from neo_mpc_planner2_tpu_torch.tree import tree_map

    cfg = _chip_smoke().product_cfg()
    sb = tp.make_scenario_batch(cfg, 64, seed=3, map_size=48, plan_points=32,
                                device=dev)
    step = tp.make_batched_controller_step(
        cfg, parity=False, solver_batch=tp.make_solver_batched(
            cfg, tp.make_objective(cfg, parity=False)))
    args = (sb.state, sb.plan, sb.robot_pose, sb.current_vel, sb.costmap,
            sb.footprint, sb.delta_t)
    qp0, fp0 = sqp.qp_admm.launches, fpm.footprint_cost_batch.launches
    gpu = step(*args)
    assert fpm.footprint_cost_batch.launches > fp0
    assert sqp.qp_admm.launches == qp0         # no QP on the prox path
    cpu = step(*tree_map(lambda t: t.cpu(), args))
    diff = (gpu.cmd_vel.cpu() - cpu.cmd_vel).abs().amax(-1)
    assert float((diff <= 1e-3).float().mean()) >= 0.99


@pytest.mark.parametrize("R", [1, 3, 21])
def test_footprint_cost_kernel_with_a_shift_matches_plain(dev, R):
    """K3 through a 40x40 rolling-window view (the window's origin, its
    rectangle, the cell shift) against its plain version, exactly: the
    synthetic polygons, and grid-aligned rectangles whose corners sit on
    the window-local cells -1, 0, 1, 39, 40 and 41, so that samples lie on
    the window's edges and cell boundaries."""
    rng = np.random.default_rng(40 + R)
    B = 131
    data, origin, res, verts, nv = _chip_smoke()._k3_inputs(rng, B, R, dev)
    lo = torch.as_tensor(rng.integers(0, 25, (B, 2)), dtype=torch.int32,
                         device=dev)
    view = cmap.Costmap(data=data, origin=origin, resolution=res, win_lo=lo,
                        win_cells=40)
    o, bounds, shift = fpm.kernel_map_arguments(view)
    ow = o.cpu().numpy()
    f = np.float32
    edge = np.asarray([-1, 0, 1, 39, 40, 41])
    v = verts.cpu().numpy()
    for b in range(B):
        for r in range(0, R, 2):
            k0 = rng.choice(edge, 2)
            k1 = k0 + rng.integers(1, 4, 2)
            a = ow[b] + k0.astype(f) * f(0.05)
            c = ow[b] + k1.astype(f) * f(0.05)
            v[b, r, :4] = [[c[0], c[1]], [a[0], c[1]], [a[0], a[1]],
                           [c[0], a[1]]]
    verts = torch.as_tensor(v, device=dev)
    for S in (8, 16, 32, 64):
        t = fpm.edge_parameters(S, dev)
        args = (data, o.contiguous(), res, bounds.contiguous(), verts, nv, t,
                shift.contiguous())
        before = fpm.footprint_cost_batch.launches
        got = fpm.footprint_cost_batch(*args)
        torch.cuda.synchronize()
        assert fpm.footprint_cost_batch.launches == before + 1
        want = fpm.footprint_cost_batch_plain(*args)
        assert torch.equal(got, want)
        assert bool((want == 1.0).any()) and bool((want < 1.0).any())
        # The view through footprint_cost reads the same.
        placed = fpm.Footprint(vertices=verts, n_valid=nv)
        assert torch.equal(fpm.footprint_cost(view, placed, S), got)


def test_window_write_and_read_on_the_card_match_the_cpu(dev):
    """update_window (an indexed write, with the u8 view refreshed) and
    extract_window (a gather) on the card equal the CPU bit for bit."""
    rng = np.random.default_rng(7)
    data = torch.as_tensor(rng.uniform(0, 1, (64, 40, 48)).astype(np.float32))
    cells = torch.as_tensor(rng.uniform(0, 1, (64, 16, 16)).astype(
        np.float32))
    cells[:, 0, 0] = float("nan")
    lo = torch.as_tensor(rng.integers(-5, 45, (64, 2)), dtype=torch.int32)
    cm = cmap.Costmap(data=data, origin=torch.zeros(64, 2),
                      resolution=torch.full((64,), 0.05)).with_flat(u8=True)
    cpu = cm.update_window(cells, lo)
    gpu = cmap.Costmap(data=data.to(dev), origin=cm.origin.to(dev),
                       resolution=cm.resolution.to(dev)).with_flat(
        u8=True).update_window(cells.to(dev), lo.to(dev))
    for name in ("data", "flat", "flat_u8"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name))
    rows, cols = lo[:, 1] - 3, lo[:, 0] + 2
    assert torch.equal(
        cmap.extract_window(data.to(dev), rows.to(dev), cols.to(dev), 16,
                            9).cpu(),
        cmap.extract_window(data, rows, cols, 16, 9))


@pytest.mark.parametrize("name", ["rolling", "dynamic", "updates"])
def test_live_map_step_on_the_card_matches_the_cpu(dev, name):
    """The first tick of each live-map slice of chip_smoke.py on 64 lanes
    (through the view, the re-synthesized map, the map after its first
    update), on the card against the CPU: K1 and K3 launched (K3 with the
    view's shift on the rolling slice), commands within 1e-3 on at least
    99 % of lanes."""
    import neo_mpc_planner2_tpu_torch as tp
    from neo_mpc_planner2_tpu_torch.tree import tree_map

    cs = _chip_smoke()
    cfg, sb, run = cs.slice_inputs(name, 64, dev, seed=3)
    qp0, fp0 = sqp.qp_admm.launches, fpm.footprint_cost_batch.launches
    with cs.K3Recorder() as rec:
        gpu = tp.batch_simulate(cfg, sb, 1, **run).cmds[:, 0].cpu()
    assert sqp.qp_admm.launches > qp0
    assert fpm.footprint_cost_batch.launches > fp0
    shifted = {key[2] is False for key in rec.args}
    assert shifted == ({True} if name == "rolling" else {False})
    to_cpu = lambda t: t.cpu()
    cpu = tp.batch_simulate(cfg, tree_map(to_cpu, sb), 1,
                            **tree_map(to_cpu, run)).cmds[:, 0]
    diff = (gpu - cpu).abs().amax(-1)
    assert float((diff <= 1e-3).float().mean()) >= 0.99


@pytest.mark.parametrize("B,R,V,S,plan", [
    (131, 1, 20, 32, "measured"), (131, 21, 20, 32, "measured"),
    (4096, 1, 8, 68, "measured"), (131, 5, 8, 101, "measured"),
    (131, 21, 8, 100, "measured"), (131, 3, 40, 12, "measured"),
    (64, 1000, 8, 16, "lane"), (64, 2000, 8, 16, "split"),
    (16, 1200, 40, 12, "split")])
def test_footprint_cost_kernel_past_the_old_caps_matches_plain(dev, B, R, V,
                                                               S, plan):
    """K3 at more than 16 vertices, more than 64 or an unbuilt count of
    samples an edge (the general-S instance) and more polygons a lane than
    a block of the measured shape stages (the one-lane and split plans of
    binding.k3_variant): exactly its plain version, on the whole grid,
    patch bounds and a view; one launch a call, counted under its plan."""
    from neo_mpc_planner2_tpu_torch.kernels import binding

    cs = _chip_smoke()
    rng = np.random.default_rng(B + R + V + S)
    data, origin, res, verts, nv = cs._k3_inputs(rng, B, R, dev)
    verts, nv = cs._widen(rng, verts, nv, V)
    assert binding.k3_variant(R, V, S)[0] == plan
    cm = cmap.Costmap(data=data, origin=origin, resolution=res)
    cx = torch.as_tensor(rng.uniform(-2.0, 2.0, B), dtype=torch.float32,
                         device=dev)
    view = cm.replace(win_lo=torch.as_tensor(
        rng.integers(0, 25, (B, 2)), dtype=torch.int32, device=dev),
        win_cells=40)
    vo, vb, vs = (a.contiguous() for a in fpm.kernel_map_arguments(view))
    t = fpm.edge_parameters(S, dev)
    for o, bounds, shift in ((origin, None, None),
                             (origin, cmap.product_patch_bounds(
                                 cm, cx, cx.flip(0), 28), None),
                             (vo, vb, vs)):
        args = (data, o, res, bounds, verts, nv, t, shift)
        before = fpm.footprint_cost_batch.plans[plan]
        got = fpm.footprint_cost_batch(*args)
        torch.cuda.synchronize()
        assert fpm.footprint_cost_batch.plans[plan] == before + 1
        assert torch.equal(got, fpm.footprint_cost_batch_plain(*args))


@pytest.mark.parametrize("V", [20, 40])
@pytest.mark.parametrize("R", [1, 21])
def test_footprint_walk_kernel_past_32_vertices_matches_plain(dev, R, V):
    """K3's walk at 20 vertices (a thread an edge) and 40 (a thread every
    32nd edge of its polygon): exactly the plain walk, on the whole grid
    and through a view."""
    cs = _chip_smoke()
    rng = np.random.default_rng(R + V)
    data, origin, res, verts, nv = cs._walk_inputs(rng, 131, R, dev)
    verts, nv = cs._widen(rng, verts, nv, V)
    view = cmap.Costmap(data=data, origin=origin, resolution=res).replace(
        win_lo=torch.as_tensor(rng.integers(0, 25, (131, 2)),
                               dtype=torch.int32, device=dev), win_cells=40)
    vo, vb, vs = (a.contiguous() for a in fpm.kernel_map_arguments(view))
    for o, bounds, shift in ((origin, None, None), (vo, vb, vs)):
        args = (data, o, res, bounds, verts, nv, shift)
        got = fpm.footprint_walk_batch(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, fpm.footprint_walk_batch_plain(*args))


@pytest.mark.parametrize("R", [1, 3, 21])
@pytest.mark.parametrize("B", [1, 131, 4096])
def test_footprint_walk_kernel_matches_plain(dev, B, R):
    """K3's walk mode against the plain walk, bit for bit: placed and
    grid-aligned rectangles, padded triangles, degenerate polygons
    (zero-length edges), diamonds through cell corners, corners below the
    origin, polygons off the map; on the whole grid and through a view
    with its shift. One launch a call."""
    rng = np.random.default_rng(7 * B + R)
    data, origin, res, verts, nv = _chip_smoke()._walk_inputs(rng, B, R, dev)
    view = cmap.Costmap(data=data, origin=origin, resolution=res).replace(
        win_lo=torch.as_tensor(rng.integers(0, 25, (B, 2)),
                               dtype=torch.int32, device=dev), win_cells=40)
    v_origin, v_bounds, v_shift = fpm.kernel_map_arguments(view)
    for o, bounds, shift in ((origin, None, None),
                             (v_origin.contiguous(), v_bounds.contiguous(),
                              v_shift.contiguous())):
        args = (data, o, res, bounds, verts, nv, shift)
        before = fpm.footprint_walk_batch.launches
        got = fpm.footprint_walk_batch(*args)
        torch.cuda.synchronize()
        assert fpm.footprint_walk_batch.launches == before + 1
        assert got.is_cuda and got.shape == (B, R)
        assert torch.equal(got, fpm.footprint_walk_batch_plain(*args))


def test_exact_step_on_the_card_matches_the_cpu(dev):
    """One fleet controller step in exact footprint mode on the card (K3's
    walk mode) against the CPU (the plain walk): commands within 1e-3 on at
    least 99 % of lanes, lethal flags equal."""
    import neo_mpc_planner2_tpu_torch as tp
    from neo_mpc_planner2_tpu_torch.tree import tree_map

    cfg = tp.fleet_config().replace(max_plan_points=64, footprint_exact=True)
    sb = tp.make_scenario_batch(cfg, 64, seed=5, map_size=48, plan_points=32,
                                lethal_threshold=0.8, device=dev)
    step = tp.make_batched_controller_step(cfg)
    args = (sb.state, sb.plan, sb.robot_pose, sb.current_vel, sb.costmap,
            sb.footprint, sb.delta_t)
    before = fpm.footprint_walk_batch.launches
    gpu = step(*args)
    assert fpm.footprint_walk_batch.launches > before
    cpu = step(*tree_map(lambda t: t.cpu(), args))
    diff = (gpu.cmd_vel.cpu() - cpu.cmd_vel).abs().amax(-1)
    assert float((diff <= 1e-3).float().mean()) >= 0.99
    assert torch.equal(gpu.lethal.cpu(), cpu.lethal)


def test_serving_session_on_the_card_matches_the_cpu(dev):
    """A batch-1 OptimizerSession on the card (K1, K3) against one on the
    CPU: the same script of optimizer and tick requests gives the same
    response keys, output_vel within 1e-3 and equal flags; ping names the
    backend."""
    from neo_mpc_planner2_tpu_torch.serving import OptimizerSession

    chip_smoke = _chip_smoke()
    traffic = chip_smoke.serving_traffic(4, seed=2)
    script = [{"op": "configure", "params": chip_smoke._fleet_params()},
              traffic["costmap"], traffic["footprint"]]
    script += [{"op": "optimizer", **traffic["robots"][i % 2],
                "delta_t": 1 / 30} for i in range(4)]
    script += [{"op": "set_plan", "poses": traffic["plans"][0]}]
    script += [{"op": "tick", **traffic["ticks"][0], "delta_t": 1 / 30}] * 3
    card = OptimizerSession(device=dev)
    cpu = OptimizerSession(device="cpu")
    before = sqp.qp_admm.launches
    for msg in script:
        a, b = card.handle(msg), cpu.handle(msg)
        assert set(a) == set(b) and "error" not in a, (a, b)
        if "output_vel" in a:
            np.testing.assert_allclose(a["output_vel"], b["output_vel"],
                                       atol=1e-3)
            for k in ("collision", "collision_footprint", "lethal",
                      "plan_empty"):
                assert a.get(k) == b.get(k)
    assert sqp.qp_admm.launches > before
    assert card.handle({"op": "ping"})["backend"] == "gpu"


@pytest.mark.parametrize("native", [False, True])
def test_controller_on_the_card_matches_the_cpu(dev, native):
    """NeoMpcController on the card (fused: the whole tick; native: the C++
    host's geometry and the solve) against one on the CPU fed the same
    poses: every command of 10 closed-loop ticks within 1e-3; K1 and K3
    launched."""
    from neo_mpc_planner2_tpu_torch.ops import footprint as fpm

    chip_smoke = _chip_smoke()
    scene = chip_smoke.controller_scene(seed=1)
    before = (sqp.qp_admm.launches, fpm.footprint_cost_batch.launches)
    card, cpu, _, _ = chip_smoke.drive(
        chip_smoke.make_controller(scene, dev, native), scene["pose"],
        scene["vel"], 10,
        shadow=chip_smoke.make_controller(scene, "cpu", native))
    assert sqp.qp_admm.launches > before[0]
    assert fpm.footprint_cost_batch.launches > before[1]
    assert np.isfinite(card).all() and np.abs(card[:, 0]).max() > 0.05
    np.testing.assert_allclose(card, cpu, rtol=0, atol=1e-3)


def test_device_trace_reads_k1_and_k3_from_a_controller_tick(dev, tmp_path):
    """A traced controller tick on the card: device_module_durations_ms
    names K1's and K3's kernels (pooled over three one-tick traces, since
    the profiler may drop device records of a short trace), and
    host_call_counts counts the tick's launches and synchronizations."""
    from neo_mpc_planner2_tpu_torch.utils import profiling

    chip_smoke = _chip_smoke()
    scene = chip_smoke.controller_scene()
    ctrl = chip_smoke.make_controller(scene, dev, False)
    _, _, pose, vel = chip_smoke.drive(ctrl, scene["pose"], scene["vel"], 2)
    traced = chip_smoke.trace_ticks(ctrl, pose, vel, 3, str(tmp_path))
    names = list(traced["device_ms_by_kernel"])
    assert any("qp_admm_kernel" in n for n in names), names
    assert any("footprint_cost_kernel" in n for n in names), names
    assert min(traced["cuda_launches_per_tick"]) > 100
    assert min(traced["host_syncs_per_tick"]) >= 3
    assert profiling.device_module_durations_ms(str(tmp_path / "tick2"))


def test_bench_runs_every_pass_on_the_card(dev):
    """The port's benchmark at 64 lanes on the card, in a process of its
    own (its profiled passes get a fresh torch.profiler): one JSON line,
    every field set (both device p99s too), one card, K1 and K3 launched."""
    import json
    import subprocess

    proc = subprocess.run(
        [sys.executable, "-m", "neo_mpc_planner2_tpu_torch.bench",
         "--device", "cuda:0", "--batch", "64", "--ticks", "3",
         "--quality-ticks", "6", "--latency-reps", "4", "--trace-reps", "3"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 1, proc.stdout
    line = json.loads(lines[0])
    assert [k for k, v in line.items() if v is None] == [], proc.stderr
    assert line["devices"] == 1 and line["batch"] == 64
    assert line["device_p99_ms"] > 0 and line["device_p99_default_ms"] > 0
    tag = "[bench] kernel launches "
    (launches,) = [json.loads(ln[len(tag):])
                   for ln in proc.stderr.splitlines() if ln.startswith(tag)]
    assert launches["qp_admm"] > 0 and launches["footprint_cost"] > 0
