"""The port's QP (K1), SPD-inverse (K2) and footprint-cost (K3) paths
against the JAX package.

On the CPU the wrappers run their plain PyTorch versions; these are held
against JAX's plain path and its Pallas kernels in interpret mode: K1 and K2
at rtol 2e-4 / atol 2e-5, the gate of tests/test_pallas.py; K3 exactly (its
outputs are picked map values). The CUDA kernels themselves run only on a
card: their tests are in test_torch_cuda.py, which imports no JAX so that it
runs on a machine with a card and no JAX."""

import ctypes
import functools
import pathlib
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neo_mpc_planner2_tpu as mpc
from neo_mpc_planner2_tpu import sqp as jsqp
from neo_mpc_planner2_tpu.ops import costmap as jcm
from neo_mpc_planner2_tpu.ops import footprint as jfp
from neo_mpc_planner2_tpu.ops.pallas_kernels import footprint_cost_batch_pallas

from neo_mpc_planner2_tpu_torch import sqp as tsqp
from neo_mpc_planner2_tpu_torch.kernels import binding, build
from neo_mpc_planner2_tpu_torch.ops import costmap as tcm
from neo_mpc_planner2_tpu_torch.ops import footprint as tfp

ROOT = pathlib.Path(__file__).resolve().parent.parent
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
@pytest.mark.parametrize("m", [3, 9, 15])
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


@pytest.mark.parametrize("m", [3, 4, 6, 9, 15, 24, 36])
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


def _chol_inverse_loop(M):
    """The JAX package's _chol_inverse_unrolled element by element over
    (B,) tensors, each sum a list through the same pairwise order: the
    loop that sqp.chol_inverse_plain computes a column or row at a time."""
    def tree_sum(terms):
        while len(terms) > 1:
            nxt = [terms[i] + terms[i + 1]
                   for i in range(0, len(terms) - 1, 2)]
            terms = nxt + ([terms[-1]] if len(terms) % 2 else [])
        return terms[0]

    m = M.shape[-1]
    L = [[None] * m for _ in range(m)]
    D = [None] * m
    for j in range(m):
        prods = [L[j][k] * L[j][k] for k in range(j)]
        s = M[:, j, j] - tree_sum(prods) if prods else M[:, j, j]
        s = torch.maximum(s, s.new_tensor(1e-20))
        D[j] = torch.rsqrt(s)
        for i in range(j + 1, m):
            prods = [L[i][k] * L[j][k] for k in range(j)]
            si = M[:, i, j] - tree_sum(prods) if prods else M[:, i, j]
            L[i][j] = si * D[j]
    Y = [[None] * (i + 1) for i in range(m)]
    for i in range(m):
        Y[i][i] = D[i]
        for c in range(i):
            Y[i][c] = -tree_sum([L[i][k] * Y[k][c]
                                 for k in range(c, i)]) * D[i]
    X = [[None] * m for _ in range(m)]
    for i in reversed(range(m)):
        for c in range(i + 1):
            prods = [L[k][i] * X[k][c] for k in range(i + 1, m)]
            acc = Y[i][c] - tree_sum(prods) if prods else Y[i][c]
            X[i][c] = X[c][i] = acc * D[i]
    return torch.stack([torch.stack(row, -1) for row in X], -2)


@pytest.mark.parametrize("m", [1, 2, 3, 4, 7, 9, 16, 24])
def test_chol_inverse_plain_equals_the_element_loop(m):
    """sqp.chol_inverse_plain does the element loop's arithmetic a column
    or row at a time (the forward substitution's ragged sums padded with
    zeros at their tail): bit-equal to it, on random SPD matrices and on a
    sparse one whose products are exact zeros."""
    rng = np.random.default_rng(100 + m)
    sparse = np.eye(m, dtype=np.float32)[None].repeat(3, 0) * 2.0
    if m > 1:
        sparse[:, 0, 1] = sparse[:, 1, 0] = 0.3
    for M in (T(_spd(rng, 7, m)), T(sparse)):
        assert torch.equal(tsqp.chol_inverse_plain(M), _chol_inverse_loop(M))


def _team_order_inverse(M):
    """The order of operations of csrc/spd_inverse.cuh's team_inverse (K1's
    runtime-m designs, K2's runtime-m kernel), a step at a time over whole
    tensors: a right-looking Cholesky (the pivot max(s, 1e-20), its
    reciprocal square root d, L[i][k] = S[i][k] d, the trailing entries
    less L[i][k] L[j][k], one term a step), a right-looking L^-1 (row k of
    Y final at step k, subtracted from the rows below it), and X = Y^T Y
    summed over k from 0 (the terms k < max(i, j) are exact zeros). The
    kernel fuses each multiply-subtract into one rounding; here it takes
    two."""
    B, m = M.shape[0], M.shape[-1]
    S = torch.tril(M).clone()
    D = M.new_zeros(B, m)
    for k in range(m):
        d = torch.rsqrt(torch.clamp_min(S[:, k, k], 1e-20))
        D[:, k] = d
        col = S[:, k + 1:, k] * d[:, None]
        S[:, k + 1:, k + 1:] -= col[:, :, None] * col[:, None, :]
        S[:, k + 1:, k] = col
    L = torch.tril(S, -1)
    Y = M.new_zeros(B, m, m)
    W = M.new_zeros(B, m, m)
    for k in range(m):
        yk = W[:, k, :k + 1] * D[:, k, None]
        yk[:, k] = D[:, k]
        Y[:, k, :k + 1] = yk
        W[:, k + 1:, :k + 1] -= L[:, k + 1:, k, None] * yk[:, None, :]
    X = M.new_zeros(B, m, m)
    for k in range(m):
        X += Y[:, k, :, None] * Y[:, k, None, :]
    return torch.tril(X) + torch.tril(X, -1).transpose(-1, -2)


@pytest.mark.parametrize("case", ["m4", "m24", "m36", "m240", "ill",
                                  "zero_pivot", "negative_pivot"])
def test_team_inverse_order_stays_in_the_gate(case):
    """The runtime-m kernels sum in their own order, not _tree_sum's: that
    order, on the CPU, within K1's and K2's gate (rtol 2e-4 / atol 2e-5) of
    sqp.chol_inverse_plain at m = 4, 24, 36 and K2's cap 240, on
    tests/test_solver.py's ill-conditioned diagonal, and where the 1e-20
    clamp catches a zero or a negative pivot (inverses of ~1e20)."""
    rng = np.random.default_rng(7)
    if case.startswith("m"):
        m = int(case[1:])
        M = T(_spd(rng, 4 if m > 36 else 32, m))
    elif case == "ill":
        M = T(np.diag([1e4, 1e3, 1e2, 10, 1, 1, 0.1, 0.01, 1e-3])
              .astype(np.float32)[None])
    else:
        off = 1.0 if case == "zero_pivot" else 2.0
        M = T(np.array([[[1.0, off, 0.0], [off, 1.0, 0.0],
                         [0.0, 0.0, 3.0]]], np.float32))
    got = _team_order_inverse(M)
    want = tsqp.chol_inverse_plain(M)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    if case.endswith("pivot"):
        assert float(want.abs().max()) > 1e19


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


# --- K3: footprint cost (exact) ---------------------------------------------

def _cm_pair(data, origin):
    B = data.shape[0]
    o = np.tile(np.asarray(origin, np.float32), (B, 1))
    r = np.full((B,), 0.05, np.float32)
    return (mpc.Costmap(data=jnp.asarray(data), origin=jnp.asarray(o),
                        resolution=jnp.asarray(r)),
            tcm.Costmap(data=T(data), origin=T(o), resolution=T(r)))


def _pallas_case(case):
    """The three cases of tests/test_pallas.py (the first with and without
    a lethal row): maps, placed polygons."""
    rng = np.random.default_rng({"plain": 3, "lethal": 4, "triangle": 7,
                                 "oob": 0}[case])
    B = {"triangle": 3, "oob": 2}.get(case, 4)
    data = rng.uniform(0, 0.9 if case == "triangle" else 0.95,
                       (B, 64, 128)).astype(np.float32)
    if case == "lethal":
        data[:, 32, :] = 1.0
    if case == "oob":
        data[:] = 0.0
    jc, tc = _cm_pair(data, (-1.6, -1.6))
    if case == "triangle":
        fp1 = mpc.Footprint.create([[0.21, 0.11], [-0.19, 0.11],
                                    [0.01, -0.16]], max_vertices=8)
    else:
        fp1 = mpc.Footprint.rectangle(*((0.6, 0.4) if case == "oob"
                                        else (0.63, 0.41)))
    fps = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), fp1)
    if case == "triangle":
        placed = fps
    else:
        poses = (np.asarray([[10.0, 10.0, 0.0], [0.0, 0.0, 0.0]], np.float32)
                 if case == "oob" else rng.uniform(-0.3, 0.3, (B, 3)))
        placed = jax.vmap(jfp.transform_footprint)(
            jnp.asarray(poses, jnp.float32), fps)
    return jc, tc, placed


@pytest.mark.parametrize("case", ["plain", "lethal", "triangle", "oob"])
def test_footprint_cost_plain_matches_pallas_interpret(case):
    jc, tc, placed = _pallas_case(case)
    want = footprint_cost_batch_pallas(jc, placed, samples=16, interpret=True)
    got = tfp.footprint_cost(tc, tfp.Footprint(T(placed.vertices),
                                               T(placed.n_valid)), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if case == "oob":
        assert got.tolist() == [1.0, 0.0]


def _polygons(case, rng, B, R, origin, res=0.05):
    """(B, R, 8, 2) placed polygons and (B, R) valid counts for one of the
    edge cases of the gather path."""
    o = np.asarray(origin, np.float32)
    nv = np.full((B, R), 4, np.int32)
    verts = np.zeros((B, R, 8, 2), np.float32)
    for b in range(B):
        for r in range(R):
            if case == "boundaries":
                # Grid-aligned rectangles: every sample of a vertical edge
                # lies on a cell boundary in x, of a horizontal one in y;
                # corners from below the grid to past it.
                k = rng.integers(-3, 36, 2)
                e = rng.integers(1, 6, 2)
                lo = o + k.astype(np.float32) * np.float32(res)
                hi = o + (k + e).astype(np.float32) * np.float32(res)
                quad = [[hi[0], hi[1]], [lo[0], hi[1]], [lo[0], lo[1]],
                        [hi[0], lo[1]]]
            elif case == "band":
                # Corners in the (origin - res, origin) band, which floors
                # to cell -1 (lethal), and just inside the grid.
                u = rng.uniform(0.01, 0.99, 4).astype(np.float32)
                v = rng.uniform(0.0, 0.3, 4).astype(np.float32)
                quad = [[o[0] - u[0] * res, o[1] + v[0]],
                        [o[0] + v[1], o[1] - u[1] * res],
                        [o[0] + v[2], o[1] + v[3]],
                        [o[0] - u[2] * res, o[1] - u[3] * res]]
                if (b + r) % 2:                   # just inside the grid
                    quad = o + rng.uniform(0.01, 0.15, (4, 2))
            elif (b + r) % 2:                     # "offmap" / "many"
                # Inside the grid, clear of the lethal row.
                quad = (rng.uniform(-0.45, -0.35, 2)
                        + rng.uniform(-0.25, 0.25, (4, 2)))
            else:                                 # mostly off the grid
                c = rng.uniform(-2.2, 2.2, 2).astype(np.float32)
                quad = c + rng.uniform(-0.4, 0.4, (4, 2))
            verts[b, r, :4] = np.asarray(quad, np.float32)
            if case == "many" and r % 3 == 0:
                nv[b, r] = 3                       # padded triangle
            # Padded slots hold garbage far off the map: no edge starts
            # there, and the closing edge wraps to vertex 0.
            verts[b, r, nv[b, r]:] = rng.uniform(50, 90, (8 - nv[b, r], 2))
    return verts, nv


@pytest.mark.parametrize("case,R,samples", [
    ("boundaries", 1, 16), ("band", 1, 8), ("offmap", 1, 16),
    ("many", 21, 16)])
def test_footprint_cost_plain_matches_jax_gather_path(case, R, samples):
    rng = np.random.default_rng(11)
    B = 5
    data = rng.uniform(0, 0.9, (B, 32, 32)).astype(np.float32)
    data[:, 20, :] = 1.0
    origin = (-0.8, -0.8)
    jc, tc = _cm_pair(data, origin)
    verts, nv = _polygons(case, rng, B, R, origin)
    per_map = jax.vmap(lambda c, v, n: jfp.footprint_cost(
        c, mpc.Footprint(vertices=v, n_valid=n), samples), (None, 0, 0))
    want = jax.vmap(per_map)(jc, jnp.asarray(verts), jnp.asarray(nv))
    tfp.footprint_cost_batch.launches = 0
    got = tfp.footprint_cost(tc, tfp.Footprint(T(verts), T(nv)), samples)
    assert got.shape == (B, R) and not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tfp.footprint_cost_batch.launches == 0     # the CPU dispatch
    vals = got.numpy()
    assert (vals == 1.0).any() and (vals < 1.0).any()


@pytest.mark.parametrize("extractor", ["extract_patch",
                                       "extract_patch_onehot"])
def test_footprint_cost_bounds_match_jax_patch_reads(extractor):
    """Bounds built from each patch extractor read what JAX reads through
    the patch (patch_cost_at_cells): map values inside map ∩ window, lethal
    elsewhere; centres inside, at the edges, in the band and off the map
    (the robot-off-map case of tests/test_patch.py)."""
    rng = np.random.default_rng(12)
    h, R, S = 9, 4, 16
    centres = np.asarray([[0.0, 0.0], [-0.95, -0.95], [0.97, 0.3],
                          [5.0, 5.0], [-1.02, 0.1], [0.4, -0.6]], np.float32)
    B = centres.shape[0]
    data = rng.uniform(0, 0.9, (B, 40, 40)).astype(np.float32)
    data[:, 25, :] = 1.0
    jc, tc = _cm_pair(data, (-1.0, -1.0))
    verts = np.zeros((B, R, 8, 2), np.float32)
    for b in range(B):
        for r in range(R):
            c = centres[b] + rng.uniform(-0.7, 0.7, 2)
            verts[b, r] = c + rng.uniform(-0.35, 0.35, (8, 2))
    nv = np.full((B, R), 5, np.int32)
    cx, cy = jnp.asarray(centres[:, 0]), jnp.asarray(centres[:, 1])
    extract = getattr(jcm, extractor)
    patch = jax.vmap(lambda c, x, y: extract(c, x, y, h))(jc, cx, cy)

    def lane(c, p, vs, ns):
        read = lambda wx, wy: jcm.patch_cost_at_cells(
            p, *jcm.world_to_map(c, wx.reshape(-1), wy.reshape(-1))
        ).reshape(wx.shape)
        return jax.vmap(lambda v, n: jfp.footprint_cost(
            c, mpc.Footprint(vertices=v, n_valid=n), S,
            sample_fn=read))(vs, ns)

    want = jax.vmap(lane)(jc, patch, jnp.asarray(verts), jnp.asarray(nv))
    make = (tcm.patch_bounds if extractor == "extract_patch"
            else tcm.product_patch_bounds)
    bounds = make(tc, T(centres[:, 0]), T(centres[:, 1]), h)
    got = tfp.footprint_cost(tc, tfp.Footprint(T(verts), T(nv)), S,
                             bounds=bounds)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[3] == 1.0).all()          # robot off the map


def test_footprint_cost_batch_refuses_other_devices():
    meta = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt,
                                                    device="meta")
    args = (meta(2, 8, 8), meta(2, 2), meta(2), None, meta(2, 1, 8, 2),
            meta(2, 1, dt=torch.int32), meta(16))
    with pytest.raises(ValueError, match="unsupported device"):
        tfp.footprint_cost_batch(*args)


def test_chip_smoke_kernels_line_covers_every_kernel():
    """chip_smoke.py's module-level KERNELS (the entries of its `kernels`
    line) name every launcher of kernels/binding.py, each with a source that
    exists and the `def` of the TPU kernel it replaces; every entry the line
    prints carries the time, the bound, the launches a tick and the library
    call's time."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    launchers = {n for n in binding.__all__ if n.startswith("launch_")}
    assert launchers <= {k["launcher"] for k in chip_smoke.KERNELS}
    assert {s for s in build.SOURCES} == {
        pathlib.Path(k["source"]).name for k in chip_smoke.KERNELS}
    for k in chip_smoke.KERNELS:
        assert k["route"] == "cuda" and (ROOT / k["source"]).is_file()
        path, line = k["replaces"].rsplit(":", 1)
        text = (ROOT / path).read_text().splitlines()[int(line) - 1]
        assert text.startswith("def _") and "kernel" in text, text
    slice_ = {"launches": {k["name"]: 40 for k in chip_smoke.KERNELS},
              "ticks": 20}
    measured = {k["name"]: dict(max_abs_err=0.0, ms=0.01, plain_ms=1.0,
                                bound_ms=0.002, bound_by="bytes",
                                library_ms=None)
                for k in chip_smoke.KERNELS}
    assert list(chip_smoke.SLICES) == ["fleet", "product", "prox", "rolling",
                                       "dynamic", "updates", "exact"]
    entries = chip_smoke.kernels_line(
        {name: slice_ for name in chip_smoke.SLICES}, measured)
    required = {"name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "share_of_bound", "launches_per_tick", "library_ms"}
    for e in entries:
        assert set(e) == set(chip_smoke.KERNEL_KEYS) >= required
        assert e["launches_per_tick"] == {name: 2.0
                                          for name in chip_smoke.SLICES}
        assert e["launches"] == 40 * len(chip_smoke.SLICES)
        assert e["share_of_bound"] == pytest.approx(0.2)


def test_chip_smoke_last_lines_name_the_card(monkeypatch, capsys):
    """chip_smoke.main's last two lines, with every phase stubbed: the
    card's name and power limit, then {"ok": true, "device": ...} whose
    kind is torch.cuda.get_device_name(0), not a slice's name."""
    import json

    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "Card X")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(chip_smoke, "_nvidia_smi", lambda: "Card X, 700 W")
    monkeypatch.setattr(build, "build_library", lambda: None)
    monkeypatch.setattr(build, "last_build",
                        {"built": False, "seconds": 0.0, "log": ""})
    one = dict(max_abs_err=0.0, ms=0.01, plain_ms=1.0, bound_ms=0.002,
               bound_by="bytes", share_of_bound=0.2)
    variant = lambda m: {"m": m, "ms": 0.01, "plain_ms": 1.0,
                         "bound_ms": 0.002, "bound_by": "operations",
                         "library_ms": None}
    monkeypatch.setattr(chip_smoke, "phase_launch_counts", lambda d: {})
    # The kernel phases run in child processes on the card; here in line.
    monkeypatch.setattr(chip_smoke, "isolated",
                        lambda name: getattr(chip_smoke, name)(None))
    monkeypatch.setattr(chip_smoke, "phase_kernels", lambda d: {
        "qp_admm_max_abs_err": 0.0, "qp_admm_m9_ms": 0.01,
        "qp_admm_plain_m9_ms": 1.0, "qp_admm_m9_bound_ms": 0.002,
        "qp_admm_m9_bound_by": "operations",
        "variants": [variant(9), variant(36), variant(237)]})
    monkeypatch.setattr(chip_smoke, "phase_k2", lambda d: {
        "spd_inv_max_abs_err": 0.0, "spd_inv_m9_ms": 0.01,
        "spd_inv_plain_m9_ms": 1.0, "spd_inv_m9_bound_ms": 0.002,
        "spd_inv_m9_bound_by": "bytes", "spd_inv_library_m9_ms": 0.05,
        "variants": [variant(4)]})
    horizons = {f"horizon_{s}": {
        "launches": {k["name"]: 20 for k in chip_smoke.KERNELS},
        "ticks": 20, "control_steps": s} for s, _ in chip_smoke.HORIZONS}
    monkeypatch.setattr(chip_smoke, "phase_horizons", lambda d, smi: horizons)
    monkeypatch.setattr(chip_smoke, "phase_k3", lambda d: {
        "footprint_cost_max_abs_err": 0.0, "plan_lane": one,
        "plan_split": one, "plans": {"measured": 3, "lane": 2, "split": 2}})
    monkeypatch.setattr(chip_smoke, "phase_k3_walk", lambda d: {
        "walk_V40": one, "plans": {"edges_a_thread": 2}})
    monkeypatch.setattr(chip_smoke, "phase_serving", lambda d, smi: {})
    monkeypatch.setattr(chip_smoke, "phase_slice", lambda *a, **kw: {
        "launches": {k["name"]: 40 for k in chip_smoke.KERNELS},
        "ticks": 20})
    monkeypatch.setattr(chip_smoke, "phase_card_vs_cpu",
                        lambda *a, **kw: None)
    monkeypatch.setattr(chip_smoke, "phase_k3_captured",
                        lambda *a, **kw: {"wave_R21": one, "walk_R1": one})
    monkeypatch.setattr(chip_smoke, "phase_map_refresh", lambda *a: {})
    monkeypatch.setattr(chip_smoke, "phase_launches_per_tick",
                        lambda d, s: {})
    monkeypatch.setattr(chip_smoke, "phase_controller", lambda d, smi: {
        f"controller_{route}": {
            "launches": {k["name"]: 30 for k in chip_smoke.KERNELS},
            "ticks": 30} for route in ("fused", "native")})
    monkeypatch.setattr(chip_smoke, "phase_adapter_and_cli",
                        lambda d, smi: {})
    wide = {"launches": {**{k["name"]: 10 for k in chip_smoke.KERNELS},
                         "footprint_cost:measured": 10}, "ticks": 10}
    monkeypatch.setattr(chip_smoke, "phase_wide_footprints", lambda d, smi: {
        "server_mpo500": wide, "controller_20gon": wide})
    monkeypatch.setattr(chip_smoke, "phase_arms", lambda d, smi, arms, label: {
        name: {"launches": {k["name"]: 20 for k in chip_smoke.KERNELS},
               "ticks": 40} for name in arms})
    monkeypatch.setattr(chip_smoke, "phase_oracle", lambda d, smi: {})
    monkeypatch.setattr(chip_smoke, "phase_sharded", lambda d, smi: {
        "launches": {k["name"]: 5 for k in chip_smoke.KERNELS}, "ticks": 5})
    monkeypatch.setattr(chip_smoke, "phase_server_shards",
                        lambda d, smi: {})
    monkeypatch.setattr(chip_smoke, "phase_arm_launches", lambda d, a: {})
    monkeypatch.setattr(chip_smoke, "phase_bench", lambda d, smi: {
        "launches": {k["name"]: 50 for k in chip_smoke.KERNELS},
        "control_steps": 3})
    for phase, n in (("phase_examples", 7), ("phase_studies", 6)):
        monkeypatch.setattr(chip_smoke, phase, lambda d, n=n: {
            "launches": {k["name"]: n for k in chip_smoke.KERNELS},
            "control_steps": 3})
    assert chip_smoke.main() == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "Card X, 700 W"
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "Card X", "count": 1}}
    kernels = json.loads(lines[-3])["kernels"]
    assert [k["name"] for k in kernels] == [k["name"]
                                            for k in chip_smoke.KERNELS]
    # The launches of the timed runs: the slices, the SQP schedules' arms,
    # the sharded engine, the controller routes, the wide footprints, the
    # bench, the examples and the studies (at control_steps 3; no tick
    # count, so no per-tick rate).
    arms = len(chip_smoke.COMPACT_ARMS) + len(chip_smoke.WAVE_ARMS)
    at_m9 = (40 * len(chip_smoke.SLICES) + 20 * arms + 5 + 60 + 20 + 50
             + 7 + 6)
    assert [k["launches"] for k in kernels] == [
        at_m9 + 20 * len(horizons)] * len(kernels)
    assert kernels[0]["launches_per_tick"]["controller_native"] == 1.0
    assert kernels[0]["launches_per_tick"]["compact_adaptive"] == 0.5
    assert kernels[0]["launches_per_tick"]["sharded"] == 1.0
    assert kernels[0]["launches_per_tick"]["horizon_12"] == 1.0
    assert "bench" not in kernels[0]["launches_per_tick"]
    # Each timed width gets the launches of the runs at that width.
    assert [(v["m"], v["launches"]) for v in kernels[0]["variants"]] == [
        (9, at_m9), (36, 20), (237, 0)]
    assert [(v["m"], v["launches"]) for v in kernels[1]["variants"]] == [
        (4, 0)]
    # K3's launch plans get the launches their counters counted.
    assert [(v["plan"], v["launches"], v["calls_in_k3_phase"])
            for v in kernels[2]["variants"]] == [
        ("measured", 20, 3), ("lane", 0, 2), ("split", 0, 2),
        ("edge_a_thread", 0, 0), ("edges_a_thread", 0, 2)]


def _bench_child(monkeypatch, stdout, returncode=0, launches=None):
    """chip_smoke.phase_bench with its child process stubbed: the child
    exits `returncode` with `stdout` and the launch line on stderr."""
    import json
    import subprocess

    import chip_smoke

    launches = ({"qp_admm": 40, "spd_inv": 0, "footprint_cost": 20}
                if launches is None else launches)
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(
            cmd, returncode, stdout,
            f"[bench] headline done\n{chip_smoke.BENCH_LAUNCHES}"
            f"{json.dumps(launches)}\n")

    monkeypatch.setattr(chip_smoke.subprocess, "run", run)
    return chip_smoke.phase_bench(None, "Card X, 700 W"), calls


def _bench_line(**over):
    import json

    line = {"metric": "m", "value": 1.0, "batch": 4096, "devices": 1,
            "device_p99_ms": 3.0, "goal_reached_frac": 0.5}
    line.update(over)
    return json.dumps(line) + "\n"


def test_chip_smoke_bench_phase_holds_the_child(monkeypatch, capsys):
    """phase_bench passes with one complete line from the child, and fails
    on a null field, a second stdout line, a non-zero exit, another batch
    or device count, or K1 never launched."""
    import json

    import chip_smoke

    got, calls = _bench_child(monkeypatch, _bench_line())
    assert calls[0][1:3] == ["-m", "neo_mpc_planner2_tpu_torch.bench"]
    assert "--device" in calls[0] and "4096" in calls[0]
    assert got == {"launches": {"qp_admm": 40, "spd_inv": 0,
                                "footprint_cost": 20}, "control_steps": 3}
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["phase"] == "bench" and printed["value"] == 1.0
    assert printed["nvidia_smi"] == "Card X, 700 W"
    for stdout, rc, launches, match in (
            (_bench_line(device_p99_ms=None), 0, None, "null"),
            (_bench_line(goal_reached_frac=None), 0, None, "null"),
            (_bench_line() + _bench_line(), 0, None, "2 stdout lines"),
            ("", 3, None, "exit 3"),
            (_bench_line(batch=64), 0, None, "4096"),
            (_bench_line(devices=2), 0, None, "1 card"),
            (_bench_line(), 0, {"qp_admm": 0, "footprint_cost": 3},
             "qp_admm was never launched")):
        with pytest.raises(AssertionError, match=match):
            _bench_child(monkeypatch, stdout, rc, launches)


def test_chip_smoke_isolated_phases_need_a_card():
    """The child side of chip_smoke.isolated runs only the kernel phases
    and the demos' and studies' phases, and only on a card: without one, or for any
    other name, it exits 2."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    assert chip_smoke.ISOLATED == ("phase_kernels", "phase_k2",
                                   "phase_examples", "phase_studies")
    for name in chip_smoke.ISOLATED + ("phase_serving",):
        assert chip_smoke.run_isolated(name) == 2


# --- the C interface, read against the sources -----------------------------

def _c_signature(name):
    """(type, parameter name) of each argument of the `extern "C"` function
    `name` in csrc/, from its source."""
    import re

    for src in sorted(build.CSRC.glob("*.cu")):
        text = src.read_text()
        hit = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
        if hit:
            out = []
            for arg in hit.group(1).split(","):
                words = arg.replace("*", " * ").split()
                kind = ("ptr" if "*" in words else words[0])
                out.append((kind, words[-1]))
            return out
    raise AssertionError(f"{name} not found in {build.CSRC}")


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_declared_signatures_match_the_sources(name):
    ctype = {"int": ctypes.c_int, "float": ctypes.c_float,
             "ptr": ctypes.c_void_p}
    restype, argtypes = build.SIGNATURES[name]
    assert restype is ctypes.c_int
    assert [ctype[k] for k, _ in _c_signature(name)] == list(argtypes)


class _StubLibrary:
    """Stands in for the built library: records each call's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def record(*args):
            self.calls.append((name, args))
            return 0
        return record


@pytest.fixture
def stub_library(monkeypatch):
    lib = _StubLibrary()
    monkeypatch.setattr(binding, "load_library", lambda: lib)
    monkeypatch.setattr(binding, "_stream", lambda device: 1234)
    monkeypatch.setattr(binding, "_sms", lambda device: 132)
    return lib


@pytest.mark.parametrize("m,warps", [(9, 0), (21, 1), (36, 1), (66, 3),
                                     (237, 28)])
def test_launch_qp_admm_packs_operands_in_c_order(stub_library, m, warps):
    """binding.launch_qp_admm hands m, B, the warps a lane, the scalars,
    the batch-major operands, then the outputs it allocates, in the order
    of neo_qp_admm_f32's parameters, at a width of each design (the warp
    team at m = 9, the warp lane at 21 and 36, the block lane at 66 and
    the cap)."""
    B = 5
    rows = binding.qp_rows(m)
    ins = [torch.zeros(B, rows[n]) for n in binding.QP_INPUTS]
    outs = binding.launch_qp_admm(ins, m, iters=7, rho=1.5, sigma=0.25)
    (name, args), = stub_library.calls
    assert name == "neo_qp_admm_f32"
    sig = _c_signature(name)
    assert len(args) == len(sig) == len(build.SIGNATURES[name][1])
    assert [n for _, n in sig[:7]] == ["m", "B", "warps_per_lane", "iters",
                                       "rho", "sigma", "sigma_plus_rho"]
    assert args[:7] == (m, B, warps, 7, 1.5, 0.25, 1.75)
    assert [n for _, n in sig[7:-1]] == list(binding.QP_INPUTS
                                           + binding.QP_OUTPUTS)
    assert list(args[7:19]) == [t.data_ptr() for t in ins]
    assert list(args[19:26]) == [t.data_ptr() for t in outs]
    assert args[-1] == 1234
    for n, t in zip(binding.QP_OUTPUTS, outs):
        assert t.shape == (B, rows[n]) and t.dtype == torch.float32


@pytest.mark.parametrize("m,warps", [(18, 1), (63, 4), (237, 32)])
def test_launch_qp_admm_takes_a_given_warps_per_lane(stub_library, m, warps):
    """launch_qp_admm(..., warps_per_lane=w) hands w to neo_qp_admm_f32 in
    place of k1_warps_per_lane(m): the launch shapes that
    scripts/torch_kernel_turns.py --runtime-shapes times."""
    assert binding.k1_warps_per_lane(m) != warps
    rows = binding.qp_rows(m)
    ins = [torch.zeros(3, rows[n]) for n in binding.QP_INPUTS]
    binding.launch_qp_admm(ins, m, iters=7, rho=1.5, sigma=0.25,
                           warps_per_lane=warps)
    (name, args), = stub_library.calls
    assert args[:3] == (m, 3, warps)


@pytest.mark.parametrize("m,shape", [(9, (4, 32)), (4, (4, 4)),
                                     (40, (4, 4)), (41, (4, 4)),
                                     (240, (23, 1)), (42, (2, 1))])
def test_launch_spd_inv_packs_operands_in_c_order(stub_library, m, shape):
    """binding.launch_spd_inv hands m, B, the warps and the matrices a
    block, the batch-major (B, m, m) operand and the output it allocates,
    at a width of each plan (unrolled at m = 9, a warp a matrix at 4, 40
    and 41, a block a matrix at 42 and the cap)."""
    M = torch.zeros(5, m, m)
    X = binding.launch_spd_inv(M)
    (name, args), = stub_library.calls
    assert name == "neo_spd_inv_f32"
    sig = _c_signature(name)
    assert len(args) == len(sig) == len(build.SIGNATURES[name][1])
    assert [n for _, n in sig[:4]] == ["m", "B", "warps_per_block",
                                       "matrices_per_block"]
    assert args[:4] == (m, 5, *shape)
    assert args[4:] == (M.data_ptr(), X.data_ptr(), 1234)
    assert X.shape == (5, m, m) and X.dtype == torch.float32
    binding.launch_spd_inv(torch.zeros(65536, 6, 6))
    assert stub_library.calls[-1][1][:4] == (6, 65536, 1, 32)


@pytest.mark.parametrize("m,variant,warps", [
    (3, "warp_team", 0), (18, "warp_team", 0), (21, "warp_lane", 1),
    (36, "warp_lane", 1), (63, "warp_lane", 1), (66, "block_lane", 3),
    (96, "block_lane", 5), (237, "block_lane", 28)])
def test_k1_launch_shape_boundaries(m, variant, warps):
    """K1's design and warps a lane at each boundary: the warp team up to
    m = 18, the warp lane (two rows of M^-1 a thread in registers, 64
    floats a row) up to 63, the block lane above with a warp per 30 rows,
    or per 2048 entries of M where that is more (at most 32); every block
    fits MAX_SMEM."""
    assert binding.qp_admm_variant(m) == variant
    assert binding.k1_warps_per_lane(m) == warps
    if variant == "block_lane":
        assert warps * binding.K1_BLOCK_LANE_ROWS_PER_WARP >= m
        assert warps <= 32
        assert binding.k1_block_smem_bytes(m) <= binding.MAX_SMEM
    if variant == "warp_lane":
        assert m <= 64


@pytest.mark.parametrize("m,shape", [
    (1, (4, 4)), (2, (4, 4)), (19, (4, 4)), (40, (4, 4)), (41, (4, 4)),
    (64, (2, 1)), (96, (4, 1)), (128, (7, 1)), (240, (23, 1)),
    (42, (2, 1))])
def test_k2_runtime_shape_boundaries(m, shape):
    """K2's runtime-m kernel takes a warp a matrix, K2_WARP_MATRICES a
    block, up to K2_WARP_MAX_M, and a block a matrix above, a warp per
    2560 entries (at least 2, at most 32); the block's shared memory fits
    MAX_SMEM at every m up to the cap."""
    assert binding.spd_inv_variant(m) == "runtime_m"
    assert binding.k2_runtime_shape(m) == shape
    warps, matrices = shape
    assert binding.k2_runtime_plan(shape) == (
        "warp" if m <= binding.K2_WARP_MAX_M else "block")
    assert matrices * binding.k2_block_smem_bytes(m) <= binding.MAX_SMEM
    assert binding.spd_inv_shape(m, 4096, "cuda") == shape


@pytest.mark.parametrize("sms,wide_up_to", [(132, 8448), (114, 7296)])
def test_k2_launch_shape_follows_the_card(monkeypatch, sms, wide_up_to):
    """Four warps a block of 32 matrices while the blocks are at most
    K2_WIDE_BLOCKS_PER_SM to an SM (the H100 SXM's 132 SMs, the PCIe
    card's 114), one above; both widths are built."""
    monkeypatch.setattr(binding, "_sms", lambda device: sms)
    assert wide_up_to == 32 * binding.K2_WIDE_BLOCKS_PER_SM * sms
    for B, warps in ((1, 4), (4096, 4), (wide_up_to, 4),
                     (wide_up_to + 1, 1), (65536, 1)):
        assert binding.k2_launch_shape(B, "cuda") == warps
        assert warps in binding.K2_WIDTHS


def test_launch_footprint_cost_packs_operands_in_c_order(stub_library):
    """binding.launch_footprint_cost hands the sizes, the launch shape, the
    operands (the optional bounds and the optional view shift as null
    pointers when absent) and the output it allocates, in the order of
    neo_footprint_cost_f32's parameters."""
    Bm, R, H, W, V, S = 3, 21, 16, 20, 8, 16
    data = torch.zeros(Bm, H, W)
    origin, res = torch.zeros(Bm, 2), torch.ones(Bm)
    bounds = torch.zeros(Bm, 4, dtype=torch.int32)
    shift = torch.zeros(Bm, 2, dtype=torch.int32)
    verts = torch.zeros(Bm, R, V, 2)
    nv = torch.zeros(Bm, R, dtype=torch.int32)
    t = torch.zeros(S)
    out = binding.launch_footprint_cost(data, origin, res, bounds, verts, nv,
                                        t, shift)
    (name, args), = stub_library.calls
    sig = _c_signature(name)
    assert len(args) == len(sig)
    assert [n for _, n in sig[9:-1]] == ["data", "origin", "res", "bounds",
                                         "shift", "verts", "n_valid", "t",
                                         "out"]
    # The measured plan: k3_launch_shape(R), the lane's R polygons a block.
    assert binding.k3_variant(R, V, S) == ("measured",
                                           (*binding.k3_launch_shape(R), R))
    assert args[:9] == (Bm, R, H, W, V, S, *binding.k3_launch_shape(R), R)
    assert list(args[9:-1]) == [a.data_ptr() for a in
                                (data, origin, res, bounds, shift, verts, nv,
                                 t, out)]
    assert out.shape == (Bm, R)
    binding.launch_footprint_cost(data, origin, res, None, verts, nv, t,
                                  shape=(2, 3))
    args = stub_library.calls[-1][1]
    assert args[6:9] == (2, 3, R) and args[12] is None and args[13] is None
    # Past one block a lane, the split plan: chunks of the polygons that
    # fit one block.
    R = 2000
    verts = torch.zeros(Bm, R, V, 2)
    nv = torch.zeros(Bm, R, dtype=torch.int32)
    binding.launch_footprint_cost(data, origin, res, None, verts, nv, t)
    chunk = (binding.MAX_SMEM - 4 * S) // (16 * V + 4)
    assert stub_library.calls[-1][1][:9] == (Bm, R, H, W, V, S, 1,
                                             binding.K3_WIDE_WARPS, chunk)


@pytest.mark.parametrize("fault", ["lane_minor", "float64", "strided",
                                   "mixed_rows"])
def test_qp_admm_kernel_operands_are_checked(fault):
    """What sqp.qp_admm checks before it launches K1: batch-major (B, rows)
    float32 contiguous operands; a lane-minor operand is refused."""
    m, B = 9, 6
    rows = binding.qp_rows(m)
    args = [torch.zeros(B, rows[n]) for n in binding.QP_INPUTS]
    tsqp._check_qp_operands(args, m)                  # batch-major: taken
    if fault == "lane_minor":
        args = [a.t().contiguous() for a in args]
        err = ValueError
    elif fault == "float64":
        args[3] = args[3].double()
        err = TypeError
    elif fault == "strided":
        args[1] = torch.zeros(rows["g"], B).t()
        err = ValueError
    else:
        args[9] = torch.zeros(B, rows["zc0"] + 1)
        err = ValueError
    with pytest.raises(err):
        tsqp._check_qp_operands(args, m)


@pytest.mark.parametrize("V,S", [(8, 16), (8, 68), (20, 32), (40, 12),
                                 (8, 101)])
def test_k3_variant_boundaries(V, S):
    """binding.k3_variant at its boundaries: the last R a block of the
    measured shape (two lanes of two warps) stages, the first R of the
    one-lane plan, its last, and the first split, whose chunks fill a block
    and cover the lane's polygons."""
    poly = 16 * V + 4
    two = (binding.MAX_SMEM - 4 * S) // (2 * poly)
    one = (binding.MAX_SMEM - 4 * S) // poly
    assert binding.k3_launch_shape(two) == (2, 2)
    assert binding.k3_variant(two, V, S) == ("measured", (2, 2, two))
    assert binding.k3_smem_bytes(two + 1, V, S, 2) > binding.MAX_SMEM
    assert binding.k3_variant(two + 1, V, S) == (
        "lane", (1, binding.K3_WIDE_WARPS, two + 1))
    assert binding.k3_variant(one, V, S) == (
        "lane", (1, binding.K3_WIDE_WARPS, one))
    name, (lanes, warps, chunk) = binding.k3_variant(one + 1, V, S)
    assert (name, lanes, warps, chunk) == ("split", 1,
                                           binding.K3_WIDE_WARPS, one)
    assert binding.k3_smem_bytes(chunk, V, S, 1) <= binding.MAX_SMEM
    assert binding.k3_smem_bytes(chunk + 1, V, S, 1) > binding.MAX_SMEM
    # The split's grid axis bounds R: K3_MAX_CHUNKS chunks.
    last = binding.K3_MAX_CHUNKS * chunk
    assert binding.k3_variant(last, V, S)[0] == "split"
    with pytest.raises(ValueError, match="chunks"):
        binding.k3_variant(last + 1, V, S)
    # The slices' shapes (R = 1, 3, control_steps, a wave's 21) stay
    # measured at the MPO-700's eight vertex slots.
    if V == 8 and S <= 101:
        for R in (1, 3, 5, 21, 35):
            assert binding.k3_variant(R, V, S) == (
                "measured", (*binding.k3_launch_shape(R), R))


def test_footprint_cost_kernel_limits_are_checked():
    """What K3 takes: any R, V and S whose one polygon fits a block; the
    plan that serves each (binding.k3_variant); a raise past the one cap
    left, the samples an edge (binding.k3_max_samples)."""
    meta = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt,
                                                    device="meta")
    ok = (meta(2, 8, 8), meta(2, 2), meta(2), None, meta(2, 21, 8, 2),
          meta(2, 21, dt=torch.int32), meta(16))
    assert tfp._check_kernel_inputs(*ok) == "measured"
    assert binding.k3_smem_bytes(21, 8, 16, 4) == 4 * 21 * (16 * 8 + 4) + 64
    many = (meta(2, 8, 8), meta(2, 2), meta(2), None,
            meta(2, 1000, 16, 2), meta(2, 1000, dt=torch.int32), meta(16))
    assert tfp._check_kernel_inputs(*many) == "split"
    # Above 16 vertices and 64 samples an edge: the measured plan still.
    wide = (meta(2, 8, 8), meta(2, 2), meta(2), None, meta(2, 1, 40, 2),
            meta(2, 1, dt=torch.int32), meta(101))
    assert tfp._check_kernel_inputs(*wide) == "measured"
    S_cap = binding.k3_max_samples(8)
    assert S_cap == (binding.MAX_SMEM - 16 * 8 - 4) // 4 == 58079
    at_cap = (meta(2, 8, 8), meta(2, 2), meta(2), None, meta(2, 1, 8, 2),
              meta(2, 1, dt=torch.int32), meta(S_cap))
    assert tfp._check_kernel_inputs(*at_cap) == "lane"
    with pytest.raises(ValueError, match="shared memory"):
        tfp._check_kernel_inputs(*at_cap[:6], meta(S_cap + 1))
    wide = (meta(2, 1, 2 ** 24), *ok[1:])
    with pytest.raises(ValueError, match="too large"):
        tfp._check_kernel_inputs(*wide)
    # A view's shift: (Bm, 2) int32 on the map's device.
    tfp._check_kernel_inputs(*ok, meta(2, 2, dt=torch.int32))
    with pytest.raises(TypeError, match="shift"):
        tfp._check_kernel_inputs(*ok, meta(2, 2))
    with pytest.raises(ValueError, match="shift"):
        tfp._check_kernel_inputs(*ok, meta(2, 4, dt=torch.int32))
    with pytest.raises(ValueError, match="devices"):
        tfp._check_kernel_inputs(*ok, torch.zeros(2, 2, dtype=torch.int32))


# --- the bound calculator ----------------------------------------------------

@pytest.mark.parametrize("kernel,m,ops_per_lane,bound_by", [
    ("qp_admm", 9, 18255, "operations"),
    ("qp_admm", 15, 43565, "operations"),
    ("spd_inv", 9, 873, "bytes"),
])
def test_bound_calculator_k1_k2(kernel, m, ops_per_lane, bound_by):
    """K1 at 60 ADMM iterations: ~1k operations for the inverse and ~280
    an iteration at m = 9; K2 reads each lower triangle and writes each
    inverse once."""
    from neo_mpc_planner2_tpu_torch.kernels import bounds

    B = 4096
    work = (bounds.qp_admm_work(B, m, 60) if kernel == "qp_admm"
            else bounds.spd_inv_work(B, m))
    assert work["ops"] == B * ops_per_lane
    assert work["bound_by"] == bound_by
    n = m // 3
    floats = (m * m + 11 * m + 8 * n if kernel == "qp_admm"
              else m * (m + 1) // 2 + m * m)
    assert work["bytes"] == 4 * B * floats
    assert work["bound_ms"] == pytest.approx(max(
        work["ops"] / 67e12, work["bytes"] / 3.35e12) * 1e3)
    if kernel == "qp_admm" and m == 9:
        assert bounds.inverse_ops(9) == 873
        assert work["bound_ms"] == pytest.approx(0.001116, rel=1e-3)


@pytest.mark.parametrize("B,m,nbytes,bound_ms", [
    (4096, 9, 2064384, 6.1623e-4),
    (65536, 9, 33030144, 9.8597e-3),
    (4096, 15, 5652480, 1.6873e-3),
])
def test_bound_calculator_k2_counts_the_lower_triangle(B, m, nbytes,
                                                       bound_ms):
    """K2's bytes: m(m + 1)/2 floats read and m² written a matrix (126 at
    m = 9, not 2m² = 162), so its bound at m = 9 is 0.62 µs at B = 4096
    and 9.9 µs at B = 65536."""
    from neo_mpc_planner2_tpu_torch.kernels import bounds

    work = bounds.spd_inv_work(B, m)
    assert work["bytes"] == nbytes
    assert work["bound_by"] == "bytes"
    assert work["bound_ms"] == pytest.approx(bound_ms, rel=1e-4)


def _k3_case(B, R, S, rng, bounded):
    """Placed rectangles (a wave's: poses along a short path) on a small
    map, some padded triangles, and a patch rectangle per lane."""
    H = W = 24
    data = torch.as_tensor(rng.uniform(0, 1, (B, H, W)).astype(np.float32))
    origin = torch.full((B, 2), -0.6)
    res = torch.full((B,), 0.05)
    base = np.asarray([[0.15, 0.1], [-0.15, 0.1], [-0.15, -0.1],
                       [0.15, -0.1]], np.float32)
    verts = np.zeros((B, R, 8, 2), np.float32)
    nv = np.full((B, R), 4, np.int32)
    for b in range(B):
        for r in range(R):
            c = rng.uniform(-0.5, 0.5, 2)
            yaw = rng.uniform(-np.pi, np.pi)
            rot = np.asarray([[np.cos(yaw), -np.sin(yaw)],
                              [np.sin(yaw), np.cos(yaw)]])
            verts[b, r, :4] = c + base @ rot.T
            verts[b, r, 4:] = rng.uniform(50, 90, (4, 2))
            if r % 3 == 2:
                nv[b, r] = 3
    bounds = None
    if bounded:
        lo = rng.integers(0, 8, (B, 2))
        bounds = torch.as_tensor(np.concatenate([lo, lo + 12], -1),
                                 dtype=torch.int32)
    t = tfp.edge_parameters(S, "cpu")
    return (data, origin, res, bounds, torch.as_tensor(verts),
            torch.as_tensor(nv), t)


@pytest.mark.parametrize("bounded", [False, True])
def test_k3_distinct_cells_match_a_brute_force_count(bounded):
    """The cells K3's samples read, counted by footprint_cells_touched,
    against a loop over every polygon, valid edge and sample in numpy
    float32 (the same rounding: p = s + (e - s)·t, floor((p - o) / res))."""
    from neo_mpc_planner2_tpu_torch.kernels import bounds as kb

    rng = np.random.default_rng(21)
    B, R, S = 3, 4, 8
    data, origin, res, bnd, verts, nv, t = _k3_case(B, R, S, rng, bounded)
    f = np.float32
    cells = set()
    for b in range(B):
        o, r_ = origin[b].numpy(), f(res[b])
        lo_x, lo_y, hi_x, hi_y = (0, 0, 24, 24) if bnd is None else \
            bnd[b].tolist()
        for p in range(R):
            n = int(nv[b, p])
            for v in range(n):
                s_ = verts[b, p, v].numpy()
                e_ = verts[b, p, (v + 1) % n].numpy()
                for tt in t.numpy():
                    pt = (s_ + (e_ - s_) * tt).astype(f)
                    mx, my = np.floor((pt - o).astype(f) / r_).astype(int)
                    if lo_x <= mx < hi_x and lo_y <= my < hi_y:
                        cells.add((b, my, mx))
    got = kb.footprint_cells_touched(data, origin, res, bnd, verts, nv, t)
    assert got == len(cells) > 0


def test_bound_calculator_k3_counts_the_inputs_work():
    """At the wave's shape (R = 21 polygons of 4 valid edges, S = 16) K3
    does 17 operations a sample, and moves the valid vertices, the counts,
    the output, t, the lanes' origin/resolution/bounds and the cells."""
    from neo_mpc_planner2_tpu_torch.kernels import bounds as kb

    rng = np.random.default_rng(22)
    B, R, S = 4, 21, 16
    args = _k3_case(B, R, S, rng, True)
    nv = args[5]
    work = kb.footprint_cost_work(*args)
    samples = int(nv.sum()) * S
    assert work["samples"] == samples
    assert work["ops"] == 17 * samples
    cells = kb.footprint_cells_touched(*args)
    assert work["cells"] == cells
    assert work["bytes"] == 4 * (2 * int(nv.sum()) + 2 * B * R + S + 3 * B
                                 + 4 * B + cells)
    assert work["bound_by"] == "bytes"
    # The main-path wave: 4096 lanes x 21 polygons x 4 edges x 16 samples.
    assert 4096 * 21 * 4 * 16 * kb.K3_OPS_PER_SAMPLE == 93585408


def test_bound_calculator_k3_counts_a_view_shift():
    """On a view K3 also reads the (Bm, 2) shift and adds it to both cells
    of a sample (two operations more); the cells it reads are the shifted
    ones inside the window, counted against a loop in numpy float32."""
    from neo_mpc_planner2_tpu_torch.kernels import bounds as kb

    rng = np.random.default_rng(23)
    B, R, S = 3, 4, 8
    data, origin, res, _, verts, nv, t = _k3_case(B, R, S, rng, False)
    shift = torch.as_tensor(rng.integers(0, 6, (B, 2)), dtype=torch.int32)
    win = torch.cat([shift, shift + 14], -1)
    args = (data, origin, res, win, verts, nv, t, shift)
    cells = set()
    f = np.float32
    for b in range(B):
        o, r_ = origin[b].numpy(), f(res[b])
        sx, sy = shift[b].tolist()
        for p in range(R):
            n = int(nv[b, p])
            for v in range(n):
                s_ = verts[b, p, v].numpy()
                e_ = verts[b, p, (v + 1) % n].numpy()
                for tt in t.numpy():
                    pt = (s_ + (e_ - s_) * tt).astype(f)
                    mx, my = np.floor((pt - o).astype(f) / r_).astype(int)
                    mx, my = mx + sx, my + sy
                    if sx <= mx < sx + 14 and sy <= my < sy + 14:
                        cells.add((b, my, mx))
    assert kb.footprint_cells_touched(*args) == len(cells) > 0
    work = kb.footprint_cost_work(*args)
    samples = int(nv.sum()) * S
    assert work["ops"] == (kb.K3_OPS_PER_SAMPLE + 2) * samples
    assert work["bytes"] == 4 * (2 * int(nv.sum()) + 2 * B * R + S + 3 * B
                                 + 4 * B + 2 * B + len(cells))


# --- K3's walk mode (exact footprint mode) -----------------------------------

def test_launch_footprint_walk_packs_operands_in_c_order(stub_library):
    """With t=None binding.launch_footprint_cost launches K3's walk mode:
    neo_footprint_walk_f32 takes the sizes, the threads a block, the map
    operands (the optional bounds and shift as null pointers when absent)
    and the output it allocates, in the order of its parameters."""
    Bm, R, H, W, V = 3, 5, 16, 20, 8
    data = torch.zeros(Bm, H, W)
    origin, res = torch.zeros(Bm, 2), torch.ones(Bm)
    shift = torch.zeros(Bm, 2, dtype=torch.int32)
    bounds = torch.zeros(Bm, 4, dtype=torch.int32)
    verts = torch.zeros(Bm, R, V, 2)
    nv = torch.zeros(Bm, R, dtype=torch.int32)
    out = binding.launch_footprint_cost(data, origin, res, bounds, verts, nv,
                                        None, shift)
    (name, args), = stub_library.calls
    assert name == "neo_footprint_walk_f32"
    sig = _c_signature(name)
    assert len(args) == len(sig) == len(build.SIGNATURES[name][1])
    assert [n for _, n in sig[6:-1]] == ["data", "origin", "res", "bounds",
                                         "shift", "verts", "n_valid", "out"]
    assert args[:6] == (Bm, R, H, W, V, binding.K3_WALK_THREADS)
    assert list(args[6:-1]) == [a.data_ptr() for a in
                                (data, origin, res, bounds, shift, verts, nv,
                                 out)]
    assert args[-1] == 1234 and out.shape == (Bm, R)
    binding.launch_footprint_cost(data, origin, res, None, verts, nv, None)
    args = stub_library.calls[-1][1]
    assert args[9] is None and args[10] is None


def test_footprint_walk_batch_checks_and_refuses_other_devices():
    meta = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt,
                                                    device="meta")
    args = (meta(2, 8, 8), meta(2, 2), meta(2), None, meta(2, 1, 8, 2),
            meta(2, 1, dt=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        tfp.footprint_walk_batch(*args)
    # The walk takes no t and no shared memory: any R a lane fits.
    tfp._check_kernel_inputs(meta(2, 8, 8), meta(2, 2), meta(2), None,
                             meta(2, 5000, 16, 2),
                             meta(2, 5000, dt=torch.int32), None)
    # Nor a vertex cap: above 32 vertices a thread walks every 32nd edge.
    for V, plan in ((32, "edge_a_thread"), (33, "edges_a_thread"),
                    (500, "edges_a_thread")):
        assert tfp._check_kernel_inputs(
            meta(2, 8, 8), meta(2, 2), meta(2), None, meta(2, 1, V, 2),
            meta(2, 1, dt=torch.int32), None) == plan


def test_k3_walk_cells_match_a_brute_force_count():
    """The cells the walks visit, as footprint_walk_work counts them,
    against a probe of every cell: a cell is visited by a polygon's walk
    when a 0.5 placed there (the rest of the map 0) raises its cost. The
    polygons lie inside the map, so no walk reads lethal."""
    from neo_mpc_planner2_tpu_torch.kernels import bounds as kb

    rng = np.random.default_rng(24)
    B, R, H, W = 2, 3, 9, 11
    origin = torch.tensor([[0.0, 0.0], [-0.2, 0.1]])
    res = torch.tensor([0.1, 0.1])
    verts = torch.as_tensor(rng.uniform(0.15, 0.85, (B, R, 8, 2)),
                            dtype=torch.float32)
    nv = torch.as_tensor(rng.integers(1, 6, (B, R)), dtype=torch.int32)
    want = set()
    for b in range(B):
        for c in range(H * W):
            data = torch.zeros(B, H, W)
            data[b].view(-1)[c] = 0.5
            hit = tfp.footprint_walk_batch_plain(data, origin, res, None,
                                                 verts, nv)
            if bool((hit[b] == 0.5).any()):
                want.add(b * H * W + c)
    work = kb.footprint_walk_work(torch.zeros(B, H, W), origin, res, None,
                                  verts, nv)
    assert work["cells"] == len(want) > 0
    assert work["edges"] == int(nv.clamp(0, 8).sum())


def test_bound_calculator_k3_walk_counts_steps_and_cells():
    """A 3 x 2 cell rectangle's walk: edges of 3, 2, 3 and 2 steps visit
    the rectangle's 10 rim cells once each."""
    from neo_mpc_planner2_tpu_torch.kernels import bounds as kb

    verts = torch.tensor([[[[1.5, 1.5], [4.5, 1.5], [4.5, 3.5],
                            [1.5, 3.5]]]])
    args = (torch.zeros(1, 10, 10), torch.zeros(1, 2), torch.ones(1), None,
            verts, torch.tensor([[4]], dtype=torch.int32))
    work = kb.footprint_walk_work(*args)
    assert (work["edges"], work["steps"], work["cells"]) == (4, 10, 10)
    assert work["bytes"] == 4 * (2 * 4 + 2 + 3 + 10)
    assert work["ops"] == (4 * kb.K3_WALK_OPS_PER_EDGE
                           + 10 * kb.K3_WALK_OPS_PER_STEP)
    assert work["bound_by"] == "bytes"
