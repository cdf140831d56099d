"""The CUDA kernels K1 (qp_admm) and K2 (chol_inverse) at the widths of
every horizon (each design, and each kernel at its cap), K3
(footprint_cost_batch) on the card, one step of each slice against the
CPU, and the single-robot controller's ticks (both routes) against the
CPU, with K1 and K3 read from a traced tick.

Every test here needs an NVIDIA GPU: it carries the `cuda` marker and skips
where `torch.cuda.is_available()` is false (decided inside the `dev`
fixture). The file imports no JAX, so it runs on a machine with a card and
without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX). Kernel against plain
version: K1 and K2 at rtol 2e-4 / atol 2e-5, the gate of
tests/test_pallas.py; K3 exactly, since it returns picked map values.
"""

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


# K1's widths on the card: the slices' 6, 9 and 15; the horizons' 3 and 24
# (warp team) and 36 (block team).
K1_M = [3, 6, 9, 15, 24, 36]
# K2's: unrolled at 3, 6, 9, 15; the runtime-m kernel at 4, 24 and 36.
K2_M = [3, 4, 6, 9, 15, 24, 36]


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


@pytest.mark.parametrize("m", K1_M)
def test_qp_admm_is_one_launch(dev, m):
    """One qp_admm call on the card is one CUDA launch: the operands and
    outputs are batch-major, so the wrapper copies nothing."""
    args = _qp_inputs(np.random.default_rng(0), 512, m, dev)
    n = _chip_smoke().count_launches(
        lambda: sqp.qp_admm(*args, iters=60))
    assert n == {"launches": 1, "kernels": 1}


@pytest.mark.parametrize("B", [1, 131, 4096, 65536])
@pytest.mark.parametrize("m", K2_M)
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


def test_chol_inverse_ill_conditioned_matches_plain(dev):
    """tests/test_solver.py's ill-conditioned diagonal (1e4 down to 1e-3)."""
    d = torch.tensor([1e4, 1e3, 1e2, 10, 1, 1, 0.1, 0.01, 1e-3], device=dev)
    M = torch.diag(d)[None].contiguous()
    got = sqp.chol_inverse(M)
    torch.testing.assert_close(got, sqp.chol_inverse_plain(M), rtol=RTOL,
                               atol=ATOL)
    torch.testing.assert_close(torch.diagonal(got[0]), 1.0 / d, rtol=1e-4,
                               atol=0.0)


@pytest.mark.parametrize("m", K2_M)
def test_chol_inverse_is_one_launch(dev, m):
    """One chol_inverse call on the card is one CUDA launch: the kernel
    reads and writes (B, m, m) itself, so the wrapper copies nothing."""
    M = torch.as_tensor(_spd(np.random.default_rng(m), 4096, m), device=dev)
    n = _chip_smoke().count_launches(lambda: sqp.chol_inverse(M))
    assert n == {"launches": 1, "kernels": 1}


@pytest.mark.parametrize("m", K2_M)
def test_chol_inverse_lane_does_not_depend_on_its_block(dev, m):
    """A lane's inverse is bit-identical whatever lanes share its block and
    however many warps share the block's columns: the whole batch, its
    first 131 lanes, the batch shifted by one lane (a view that starts off
    a 16-byte boundary), each at every width K2 is built for, and inside a
    batch large enough for the narrow width. The upper triangle is never
    read."""
    from neo_mpc_planner2_tpu_torch.kernels import binding

    M = torch.as_tensor(_spd(np.random.default_rng(m), 4096, m), device=dev)
    full = sqp.chol_inverse(M)
    for warps in binding.K2_WIDTHS:
        at = lambda A: binding._launch_spd_inv_at(A, warps)
        assert torch.equal(at(M), full)
        assert torch.equal(at(M[:131].contiguous()), full[:131])
        assert torch.equal(at(M[1:]), full[1:])
    big = M.repeat(16, 1, 1)
    assert binding.k2_launch_shape(big.shape[0], dev) == 1
    assert torch.equal(sqp.chol_inverse(big)[-4096:], full)
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
    rng = np.random.default_rng(5)
    data, origin, res, verts, nv = _chip_smoke()._k3_inputs(rng, 4, 3, dev)
    t = fpm.edge_parameters(16, dev)
    ok = (data, origin, res, None, verts, nv, t)
    bad = [
        (TypeError, dict(data=data.double())),
        (TypeError, dict(n_valid=nv.long())),
        (ValueError, dict(verts=verts.transpose(0, 1))),     # not contiguous
        (ValueError, dict(n_valid=nv.cpu())),                # mixed devices
        (ValueError, dict(t=fpm.edge_parameters(65, dev))),  # S > 64
        (ValueError, dict(verts=torch.zeros(4, 3, 17, 2, device=dev))),
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
