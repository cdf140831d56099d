"""Batched SQP solver, the main path (port of `sqp.py`).

The same algorithm as the JAX package, the SLSQP twin of the reference's
scipy solve (mpc_optimization_server.py:363-364): per lane, a QP subproblem
over box bounds and the translational-speed cone solved by ADMM, an L1-merit
Armijo line search, a damped-BFGS update, and SLSQP-like termination.

JAX runs the lanes under `vmap` of `lax.while_loop`s. Here both loops (the
outer SQP iteration and the inner line search) are written out as masked
loops over the batch: each runs while any lane is alive, every carry update
is `torch.where(alive, new, old)` (what vmap's while batching rule does), and
a lane's result does not depend on when the other lanes finish. With
`parallel_line_search` the inner loop is one merit evaluation of all its
candidates at once (the fused wave); with `solver_ls_wave` = K > 1 it
evaluates K candidates a trip (the K-wide wave). Both take the alpha that
sequential backtracking takes. The batched front end can also finish the
slowest lanes as a sub-batch of their own (lockstep-tail compaction).

The QP goes through `qp_admm`, which launches the CUDA kernel K1 for CUDA
tensors and runs `qp_admm_plain` for CPU tensors. `chol_inverse` does the
same with K2 and `chol_inverse_plain`: it is the batched SPD inverse on its
own. K1 computes the QP's inverse itself, with a team inverse of its own,
so the solver never launches K2.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from .config import MpcConfig
from .kernels import binding
from .ops.costmap import ProductPatchSampler, _lane, make_point_sampler
from .ops.objective import parity_footprint_term
from .solver import SolveResult
from .tree import tree_map
from .utils.profiling import count, span

__all__ = ["qp_admm", "qp_admm_plain", "chol_inverse", "chol_inverse_plain",
           "sqp_solve", "make_sqp_solver", "make_sqp_solver_batched"]


def _cone_constraints(x: torch.Tensor, cfg: MpcConfig, max_vel_trans=None):
    """c_k(x) = max_vel_trans − ‖(vx, vy)_k‖ ≥ 0, (B, *cand, N), and the
    two nonzeros of each Jacobian row, dxy (B, *cand, 2N) = (dx_0, dy_0,
    dx_1, ...). At xy = 0 the row is zero (the constraint is inactive)."""
    n = cfg.control_steps
    xy = x.reshape(x.shape[:-1] + (n, 3))[..., :2]
    nrm = torch.sqrt((xy * xy).sum(-1))
    r = (cfg.max_vel_trans if max_vel_trans is None
         else _lane(max_vel_trans, nrm))
    c = r - nrm
    safe = nrm.clamp_min(1e-12)
    dxy = torch.where(nrm[..., None] > 1e-12, -xy / safe[..., None], 0.0)
    return c, dxy.reshape(x.shape[:-1] + (2 * n,))


def _cone_jacobian(dxy: torch.Tensor, m: int) -> torch.Tensor:
    """The dense cone Jacobian (B, N, 3N): row k holds (dx_k, dy_k) at
    columns 3k, 3k+1."""
    n = m // 3
    J = dxy.new_zeros(dxy.shape[0], n, m)
    k = torch.arange(n, device=dxy.device)
    J[:, k, 3 * k] = dxy[:, 0::2]
    J[:, k, 3 * k + 1] = dxy[:, 1::2]
    return J


def _tree_sum(p: torch.Tensor) -> torch.Tensor:
    """Pairwise summation over the last dim of p, in the order of the JAX
    package's _tree_sum (neighbours paired level by level, an odd tail
    carried up; the CUDA kernels sum in the same order)."""
    while p.shape[-1] > 1:
        n = p.shape[-1]
        pairs = p[..., 0:n - 1:2] + p[..., 1:n:2]
        p = torch.cat([pairs, p[..., n - 1:]], -1) if n % 2 else pairs
    return p[..., 0]


def chol_inverse_plain(M: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch SPD inverse of M (B, m, m), read from its lower
    triangle: the reference for K2. The arithmetic of the JAX package's
    _chol_inverse_unrolled, element for element: Cholesky with the diagonal
    carried as its reciprocal square root, forward substitution for L⁻¹,
    back substitution for the lower triangle of L⁻ᵀL⁻¹, mirrored; every
    inner product summed by _tree_sum. Each step computes a whole column or
    row of elements at once (the forward substitution's ragged sums padded
    with zeros at their tail, which the pairing leaves exact), so it takes
    O(m) tensor operations, not O(m³)."""
    B, m = M.shape[0], M.shape[-1]
    tiny = 1e-20
    L = M.new_zeros(B, m, m)
    D = M.new_zeros(B, m)
    for j in range(m):
        s = M[:, j, j]
        if j:
            s = s - _tree_sum(L[:, j, :j] * L[:, j, :j])
        s = torch.maximum(s, s.new_tensor(tiny))
        D[:, j] = torch.rsqrt(s)
        if j + 1 < m:
            si = M[:, j + 1:, j]
            if j:
                si = si - _tree_sum(L[:, j + 1:, :j] * L[:, j, None, :j])
            L[:, j + 1:, j] = si * D[:, j, None]
    # Row i of Y: Y[i][c], c < i, sums L[i][k] Y[k][c] over k = c + t,
    # t < i - c.
    Y = torch.diag_embed(D)
    idx = torch.arange(m, device=M.device)
    for i in range(1, m):
        c = idx[:i, None].expand(i, i)
        k = c + idx[None, :i]
        kc = k.clamp(max=i - 1)
        prods = L[:, i, :][:, kc] * Y[:, kc, c]
        prods = torch.where(k < i, prods, prods.new_zeros(()))
        Y[:, i, :i] = -_tree_sum(prods) * D[:, i, None]
    X = M.new_zeros(B, m, m)
    for i in reversed(range(m)):
        acc = Y[:, i, :i + 1]
        if i + 1 < m:
            prods = L[:, i + 1:, i, None] * X[:, i + 1:, :i + 1]
            acc = acc - _tree_sum(prods.transpose(1, 2))
        X[:, i, :i + 1] = acc * D[:, i, None]
        X[:, :i, i] = X[:, i, :i].clone()
    return X


def _check_kernel_inputs(tensors, m: int, what: str, variant) -> None:
    """What K1 and K2 take: float32, contiguous, on one device, at an m
    that `variant` (binding.qp_admm_variant or spd_inv_variant) maps to a
    kernel; it raises above the kernel's cap."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: operands on different devices")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: the kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: the kernel takes contiguous operands")
    variant(m)


def chol_inverse(M: torch.Tensor) -> torch.Tensor:
    """Batched SPD inverse of M (B, m, m), read from its lower triangle:
    kernel K2 for a CUDA float32 tensor at any m up to binding.K2_MAX_M
    (one launch, no copies), the plain version for a CPU tensor; anything
    else raises."""
    if M.device.type == "cpu":
        return chol_inverse_plain(M)
    if M.device.type != "cuda":
        raise ValueError(f"chol_inverse: unsupported device {M.device}")
    if M.dim() != 3 or M.shape[1] != M.shape[2]:
        raise ValueError(f"chol_inverse: M has shape {tuple(M.shape)}, "
                         "expected batch-major (B, m, m)")
    B, m = M.shape[0], M.shape[-1]
    _check_kernel_inputs([M], m, "chol_inverse",
                         binding.spd_inv_variant)
    if B == 0:
        return torch.empty_like(M)
    X = binding.launch_spd_inv(M)
    chol_inverse.launches += 1
    return X


chol_inverse.launches = 0


def qp_admm_plain(Bflat, g, x, c, J, lo, hi, d0, zb0, zc0, wb0, wc0, *,
                  iters: int, rho: float, sigma: float):
    """Plain PyTorch ADMM QP, batched over the leading dim: the reference for
    K1. Solves min ½dᵀBd + gᵀd s.t. lo−x ≤ d ≤ hi−x, Jd ≥ −c from the warm
    carry (d0, zb0, zc0, wb0, wc0). Returns (d_out, y_cone, d, zb, zc, wb,
    wc): the box-clipped step, the cone duals and the final carry."""
    B, m = x.shape
    dlo = lo - x
    dhi = hi - x
    Jt = J.transpose(-1, -2)
    eye = torch.eye(m, dtype=x.dtype, device=x.device)
    M = Bflat.reshape(B, m, m) + (sigma + rho) * eye + rho * (Jt @ J)
    Minv = chol_inverse_plain(M)
    mv = lambda A, v: (A @ v[..., None])[..., 0]
    clip = lambda v, a, b: torch.minimum(torch.maximum(v, a), b)
    d, zb, zc, wb, wc = d0, zb0, zc0, wb0, wc0
    for _ in range(iters):
        rhs = -g + sigma * d + rho * (zb - wb) + rho * mv(Jt, zc - wc)
        d = mv(Minv, rhs)
        zb = clip(d + wb, dlo, dhi)
        zc = torch.maximum(mv(J, d) + wc, -c)
        wb = wb + d - zb
        wc = wc + mv(J, d) - zc
    return clip(d, dlo, dhi), rho * wc, d, zb, zc, wb, wc


def _check_qp_operands(args, m: int) -> None:
    """What K1 takes: float32, contiguous, on one device, each operand
    batch-major (B, rows) in binding.QP_INPUTS order. A lane-minor
    (rows, B) operand is refused."""
    _check_kernel_inputs(list(args), m, "qp_admm",
                         binding.qp_admm_variant)
    B = args[0].shape[0]
    rows = binding.qp_rows(m)
    for name, a in zip(binding.QP_INPUTS, args):
        if tuple(a.shape) != (B, rows[name]):
            raise ValueError(f"qp_admm: {name} has shape {tuple(a.shape)}, "
                             f"expected batch-major {(B, rows[name])}")


def qp_admm(Bflat, g, x, c, dxy, lo, hi, d0, zb0, zc0, wb0, wc0, *,
            iters: int, rho: float = 1.0, sigma: float = 1e-6):
    """The ADMM QP of one SQP iteration for a batch of lanes, all operands
    (B, rows) with Bflat (B, m²) and dxy (B, 2N) the cone Jacobian's
    nonzeros. Kernel K1 for CUDA float32 tensors (any batch size, any
    m = 3N up to binding.K1_MAX_M, one launch, the outputs written
    batch-major by the kernel); the plain version for CPU tensors;
    anything else raises. Returns what
    qp_admm_plain returns."""
    args = (Bflat, g, x, c, dxy, lo, hi, d0, zb0, zc0, wb0, wc0)
    B, m = x.shape
    if x.device.type == "cpu":
        return qp_admm_plain(Bflat, g, x, c, _cone_jacobian(dxy, m), lo, hi,
                             d0, zb0, zc0, wb0, wc0, iters=iters, rho=rho,
                             sigma=sigma)
    if x.device.type != "cuda":
        raise ValueError(f"qp_admm: unsupported device {x.device}")
    _check_qp_operands(args, m)
    if B == 0:
        rows = binding.qp_rows(m)
        return tuple(x.new_empty(B, rows[name]) for name in
                     ("d_out", "y_cone", "d", "zb", "zc", "wb", "wc"))
    d_out, d, zb, zc, wb, wc, y_cone = binding.launch_qp_admm(
        args, m, iters, rho, sigma)
    qp_admm.launches += 1
    return d_out, y_cone, d, zb, zc, wb, wc


qp_admm.launches = 0


@dataclasses.dataclass
class _SqpState:
    x: torch.Tensor            # (B, m)
    f: torch.Tensor            # (B,)
    grad: torch.Tensor         # (B, m)
    B: torch.Tensor            # (B, m, m) BFGS curvature
    mu: torch.Tensor           # (B,)
    k: torch.Tensor            # (B,) int32
    small_count: torch.Tensor  # (B,) int32
    done: torch.Tensor         # (B,) bool
    ls_failed: torch.Tensor    # (B,) bool
    qp: tuple                  # ADMM warm carry (d, zb, zc, wb, wc)
    alpha0: torch.Tensor       # (B,) last accepted alpha (warm line search)


def _select(mask: torch.Tensor, new, old):
    """where(mask, new, old) lane-wise over every tensor of a state."""
    def pick(a, b):
        return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)),
                           a, b)
    out = {f.name: getattr(new, f.name) for f in dataclasses.fields(new)}
    for name, a in out.items():
        b = getattr(old, name)
        out[name] = (tuple(pick(u, v) for u, v in zip(a, b))
                     if isinstance(a, tuple) else pick(a, b))
    return _SqpState(**out)


def _make_sqp(f: Callable[[torch.Tensor], torch.Tensor], cfg: MpcConfig,
              batch: int, device, ftol: float | None = None,
              qp_iters: int | None = None,
              max_backtracks: int | None = None,
              parallel_ls: bool = False, ls_wave: int = 1,
              ls_backtrack: float | None = None, limits=None):
    """Build the SQP machinery for a batched objective f: (B, m) -> (B,).
    Returns (init, run, body): init(x0) evaluates the warm start,
    run(state, upto_k) iterates while any lane is not done and below upto_k,
    body(state, active) is one SQP iteration for the active lanes.

    parallel_ls: the fused candidate wave instead of sequential
    backtracking; f must then take (B, K, m) candidates, K the backtrack
    budget. ls_wave = K > 1 (without parallel_ls): K candidates a trip, f
    taking (B, K, m)."""
    ftol = cfg.opt_tolerance if ftol is None else ftol
    qp_iters = cfg.qp_iters if qp_iters is None else qp_iters
    max_backtracks = (cfg.solver_max_backtracks if max_backtracks is None
                      else max_backtracks)
    bt = float(cfg.solver_ls_backtrack if ls_backtrack is None
               else ls_backtrack)
    coarse_after = int(cfg.solver_ls_coarse_after)
    coarse = float(cfg.solver_ls_coarse_factor)
    warm_ls = bool(cfg.solver_ls_warm_alpha)
    quad_ls = bool(cfg.solver_ls_quad_interp)
    if quad_ls and (parallel_ls or ls_wave > 1):
        # Only the sequential branch interpolates; a candidate grid would
        # silently drop it (the JAX package refuses the same pair).
        raise ValueError(
            "solver_ls_quad_interp is only implemented for the sequential "
            "line search; disable it to use parallel_line_search/ls_wave")

    n = cfg.control_steps
    m = 3 * n
    f32 = dict(dtype=torch.float32, device=device)
    if limits is None:
        lo1 = torch.tensor([cfg.min_vel_x, cfg.min_vel_y, cfg.min_vel_theta],
                           **f32).repeat(n)
        hi1 = torch.tensor([cfg.max_vel_x, cfg.max_vel_y, cfg.max_vel_theta],
                           **f32).repeat(n)
        lo = lo1.expand(batch, m).contiguous()
        hi = hi1.expand(batch, m).contiguous()
        max_trans = None
    else:
        lo = limits.vel_lo.to(**f32).repeat(1, n).contiguous()
        hi = limits.vel_hi.to(**f32).repeat(1, n).contiguous()
        max_trans = limits.max_vel_trans.to(**f32)
    eye = torch.eye(m, **f32).expand(batch, m, m).contiguous()

    def val_grad(x):
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            fv = f(xr)
            (g,) = torch.autograd.grad(fv.sum(), xr)
        return fv.detach(), g.contiguous()

    def merit(x, mu):
        """(phi, f) at x (B, *cand, m): the L1 merit and the objective."""
        c, _ = _cone_constraints(x, cfg, max_trans)
        fv = f(x)
        return fv + _lane(mu, fv) * torch.clamp_min(-c, 0.0).sum(-1), fv

    def ls_factor(j):
        if coarse_after <= 0:
            return bt
        return torch.where(j < coarse_after, bt, coarse)

    # The candidate schedule: candidate j is bt^min(j, F) · coarse^max(j−F, 0)
    # (single-phase when F = coarse_after is 0), as float32 powers like the
    # JAX package's; at the product schedule (0.5, 0.0625) they are exact.
    # The K-wide wave's last trip may overhang the budget, so its schedule
    # runs on to a multiple of K (candidates past the budget are never
    # acceptable).
    n_sched = (max_backtracks if parallel_ls
               else -(-max_backtracks // ls_wave) * ls_wave)
    jf = torch.arange(n_sched, **f32)
    fine = jf if coarse_after <= 0 else jf.clamp(max=float(coarse_after))
    ls_alphas = (torch.pow(torch.tensor(bt, **f32), fine)
                 * torch.pow(torch.tensor(coarse, **f32), jf - fine))

    def body(s: _SqpState, active: torch.Tensor) -> _SqpState:
        count("sqp.trips")
        count("sqp.lane_slots", batch)
        c, dxy = _cone_constraints(s.x, cfg, max_trans)
        with span("sqp.qp"):
            d, y_cone, *qp = qp_admm(
                s.B.reshape(batch, m * m), s.grad, s.x, c, dxy, lo, hi,
                *s.qp, iters=qp_iters)

        # Exact-penalty weight: dominate the largest multiplier estimate.
        mu = torch.maximum(s.mu, 1.5 * y_cone.abs().amax(-1) + 1e-3)
        viol = torch.clamp_min(-c, 0.0).sum(-1)
        phi0 = s.f + mu * viol
        dphi = (s.grad * d).sum(-1) - mu * viol
        if warm_ls:
            alpha = torch.minimum(torch.ones_like(s.alpha0), 2.0 * s.alpha0)
        else:
            alpha = torch.ones_like(s.f)

        with span("sqp.ls"):
            if parallel_ls:
                # The fused wave: every candidate of the schedule in one
                # merit evaluation of (B, K, m); the first accepted one in
                # schedule order is the alpha sequential backtracking would
                # take.
                alphas = alpha[:, None] * ls_alphas               # (B, K)
                cands = s.x[:, None, :] + alphas[..., None] * d[:, None, :]
                phis, fs = merit(cands, mu)
                count("sqp.ls_evals")
                ok_mask = (phis <= phi0[:, None]
                           + 1e-4 * alphas * dphi[:, None] + 1e-12)
                ls_ok = ok_mask.any(-1)
                # argmax returns the first maximum; it takes no bool.
                sel = torch.argmax(ok_mask.to(torch.int32), dim=-1,
                                   keepdim=True)
                alpha = alphas.gather(-1, sel)[:, 0]
                f_ls = fs.gather(-1, sel)[:, 0]
            elif ls_wave > 1:
                # The K-wide wave: each trip evaluates K consecutive
                # candidates of the schedule in one merit call of (B, K, m)
                # and accepts the first one in schedule order, so it takes
                # the alpha sequential backtracking takes, in
                # ceil(trips / K) trips at the slowest lane. Done (and
                # inactive) lanes accept at once.
                K = ls_wave
                ok = s.done | ~active
                f_ls = s.f
                a_init = alpha
                j = 0
                while j < max_backtracks:
                    go = ~ok
                    if not bool(go.any()):
                        break
                    alphas = a_init[:, None] * ls_alphas[j:j + K]  # (B, K)
                    cands = (s.x[:, None, :]
                             + alphas[..., None] * d[:, None, :])
                    phis, fs = merit(cands, mu)
                    count("sqp.ls_evals")
                    okm = (phis <= phi0[:, None]
                           + 1e-4 * alphas * dphi[:, None] + 1e-12)
                    if j + K > max_backtracks:
                        okm[:, max_backtracks - j:] = False
                    hit = go & okm.any(-1)
                    sel = torch.argmax(okm.to(torch.int32), dim=-1,
                                       keepdim=True)
                    alpha = torch.where(hit, alphas.gather(-1, sel)[:, 0],
                                        alpha)
                    f_ls = torch.where(hit, fs.gather(-1, sel)[:, 0], f_ls)
                    ok = ok | hit
                    j += K
                ls_ok = ok
            else:
                # Sequential Armijo backtracking, masked per lane. Done (and
                # inactive) lanes accept at once, so they cost no merit
                # evaluation.
                j = torch.zeros_like(s.k)
                ok = s.done | ~active
                f_ls = s.f
                while True:
                    go = ~ok & (j < max_backtracks)
                    if not bool(go.any()):
                        break
                    phi, fv = merit(s.x + alpha[:, None] * d, mu)
                    count("sqp.ls_evals")
                    ok_new = phi <= phi0 + 1e-4 * alpha * dphi + 1e-12
                    if quad_ls:
                        # Minimizer of the quadratic through phi(0), phi'(0)
                        # and phi(alpha), safeguarded to [0.1, 0.5]·alpha
                        # (N&W §3.5).
                        denom = 2.0 * (phi - phi0 - dphi * alpha)
                        a_q = -dphi * alpha * alpha / torch.where(
                            denom.abs() > 1e-20, denom, 1e-20)
                        a_next = torch.minimum(
                            torch.maximum(a_q, 0.1 * alpha), 0.5 * alpha)
                    else:
                        a_next = alpha * ls_factor(j)
                    alpha = torch.where(go & ~ok_new, a_next, alpha)
                    f_ls = torch.where(go & ok_new, fv, f_ls)
                    j = torch.where(go, j + 1, j)
                    ok = torch.where(go, ok_new, ok)
                ls_ok = ok

        step_vec = torch.where(ls_ok[:, None], alpha[:, None] * d, 0.0)
        x_new = s.x + step_vec
        # f(x_new) is the accepted candidate's value; only the gradient is
        # new work.
        f_new = torch.where(ls_ok, f_ls, s.f)
        _, g_new = val_grad(x_new)

        # Damped BFGS (Powell) on the accepted step.
        sv = step_vec
        yv = g_new - s.grad
        Bs = (s.B @ sv[..., None])[..., 0]
        sBs = (sv * Bs).sum(-1)
        sy = (sv * yv).sum(-1)
        theta = torch.where(sy < 0.2 * sBs,
                            0.8 * sBs / torch.clamp_min(sBs - sy, 1e-16), 1.0)
        yv = theta[:, None] * yv + (1.0 - theta)[:, None] * Bs
        sy = (sv * yv).sum(-1)
        update_ok = ls_ok & (sBs > 1e-16) & (sy > 1e-16)
        outer = lambda u: u[:, :, None] * u[:, None, :]
        B_new = torch.where(
            update_ok[:, None, None],
            s.B - (outer(Bs) / torch.clamp_min(sBs, 1e-16)[:, None, None]
                   - outer(yv) / torch.clamp_min(sy, 1e-16)[:, None, None]),
            s.B)

        # Two consecutive sub-ftol improvements stop a lane; a sub-ftol step
        # with a vanishing QP direction counts double. The first line-search
        # failure resets B, the second stops the lane.
        improved = (s.f - f_new).abs()
        small = ls_ok & (improved < ftol)
        stationary = small & (d.abs().amax(-1) < 1e-6)
        small_count = torch.where(small, s.small_count + 1 + stationary.int(),
                                  0).to(torch.int32)
        B_new = torch.where(ls_ok[:, None, None], B_new, eye)
        done = (small_count >= 2) | (s.ls_failed & ~ls_ok)
        alpha0 = (torch.where(ls_ok, alpha, 1.0) if warm_ls else s.alpha0)
        return _SqpState(x=x_new, f=f_new, grad=g_new, B=B_new, mu=mu,
                         k=s.k + 1, small_count=small_count, done=done,
                         ls_failed=~ls_ok, qp=tuple(qp), alpha0=alpha0)

    def init(x0: torch.Tensor) -> _SqpState:
        # Start from the box-clipped warm start (scipy clips x0 into bounds).
        x0 = torch.minimum(torch.maximum(x0.to(**f32), lo), hi)
        f0, g0 = val_grad(x0)
        zm = torch.zeros(batch, m, **f32)
        zn = torch.zeros(batch, n, **f32)
        i32 = torch.zeros(batch, dtype=torch.int32, device=device)
        no = torch.zeros(batch, dtype=torch.bool, device=device)
        return _SqpState(x=x0, f=f0, grad=g0, B=eye, mu=torch.ones_like(f0),
                         k=i32, small_count=i32, done=no, ls_failed=no,
                         qp=(zm, zm, zn, zm, zn), alpha0=torch.ones_like(f0))

    def run(s: _SqpState, upto_k: int) -> _SqpState:
        while True:
            alive = ~s.done & (s.k < upto_k)
            if not bool(alive.any()):
                return s
            with span("sqp.iter", lanes=batch):
                s = _select(alive, body(s, alive), s)

    return init, run, body


def sqp_solve(f, x0: torch.Tensor, cfg: MpcConfig, ftol: float | None = None,
              max_iters: int | None = None, qp_iters: int | None = None,
              max_backtracks: int | None = None, parallel_ls: bool = False,
              limits=None) -> SolveResult:
    """Minimize the batched objective f over box ∩ cone from x0 (B, 3N)."""
    max_iters = cfg.solver_max_iters if max_iters is None else max_iters
    init, run, _ = _make_sqp(f, cfg, x0.shape[0], x0.device, ftol=ftol,
                             qp_iters=qp_iters, max_backtracks=max_backtracks,
                             parallel_ls=parallel_ls,
                             ls_wave=cfg.solver_ls_wave, limits=limits)
    with torch.no_grad():
        fin = run(init(x0), max_iters)
    return SolveResult(x=fin.x, fun=fin.f, converged=fin.done, iters=fin.k)


def _batch_hoist(cfg: MpcConfig, objective, scens):
    """The per-solve constant tensor the objective hoists out of the
    solver's loops: the parity footprint term (B,), or None in product
    mode. Computed once a solve, outside every loop, and indexed for a
    compact sub-batch."""
    if getattr(objective, "parity", True):
        with torch.no_grad():
            return parity_footprint_term(scens, cfg)
    return None


def _batch_fobj(cfg: MpcConfig, objective, scens, fp_term):
    """The per-solve objective over all lanes, with the per-solve constants
    hoisted: in parity mode the footprint term (`fp_term`, _batch_hoist's)
    and the point sampler; in product mode, with solver_costmap_patch > 0,
    the patch sampler around each lane's pose, except on a rolling-window
    view, which reads the whole map through its window as the JAX package
    does."""
    cx, cy = scens.current_pose[:, 0], scens.current_pose[:, 1]
    if getattr(objective, "parity", True):
        sampler = make_point_sampler(scens.costmap, cx, cy,
                                     cfg.solver_costmap_patch)
        return lambda u: objective(u, scens, fp_term, point_sampler=sampler)
    if cfg.solver_costmap_patch > 0 and scens.costmap.win_cells is None:
        sampler = ProductPatchSampler(scens.costmap, cx, cy,
                                      cfg.solver_costmap_patch)
        return lambda u: objective(u, scens, point_sampler=sampler)
    return lambda u: objective(u, scens)


def make_sqp_solver_batched(cfg: MpcConfig, objective,
                            ftol: float | None = None,
                            max_iters: int | None = None,
                            qp_iters: int | None = None,
                            parallel_ls: bool | None = None):
    """Batched SQP solve with the JAX package's lockstep-tail compaction:
    solve_batch(x0s (B, 3N), scens) -> SolveResult.

    With compact_n = ceil(B · solver_compact_frac), eligible when
    0 < compact_n < B and B >= solver_compact_min_batch:
    - adaptive (solver_compact_adaptive, max_iters > 1, no costmap patch):
      full-batch iterations while more than compact_n lanes are alive, then
      the alive lanes are gathered into a sub-batch, finished, and scattered
      back;
    - fixed (0 < solver_compact_after < max_iters): solver_compact_after
      full-batch iterations, then the same gather, finish and scatter when
      at most compact_n lanes are alive, else the full batch runs on;
    - otherwise the plain path: one masked solve of the whole batch.
    The sub-batch holds exactly the alive lanes (the JAX package pads it to
    compact_n with lane 0 for a static shape). A lane's iterations are the
    same in every grouping; only an `improved < ftol` tie within ~1 ulp of
    `fun` could move its termination by one iteration."""
    max_iters_ = cfg.solver_max_iters if max_iters is None else max_iters
    pls = cfg.parallel_line_search if parallel_ls is None else parallel_ls

    def machinery(scens, fp_term, batch, device):
        fobj = _batch_fobj(cfg, objective, scens, fp_term)
        return _make_sqp(fobj, cfg, batch, device, ftol=ftol,
                         qp_iters=qp_iters, parallel_ls=pls,
                         ls_wave=cfg.solver_ls_wave, limits=scens.limits)

    def finish(st, scens, fp_term, idx):
        """Gather the lanes `idx` of st and scens, run them to the end as
        their own batch, and scatter them back into st."""
        if idx.numel() == 0:
            return st
        pick = lambda t: t[idx]
        sub_fp = None if fp_term is None else fp_term[idx]
        _, run, _ = machinery(tree_map(pick, scens), sub_fp, idx.numel(),
                              st.x.device)
        fin = run(tree_map(pick, st), max_iters_)
        return tree_map(lambda full, sub: full.index_copy(0, idx, sub),
                        st, fin)

    def solve_batch(x0s, scens):
        batch = x0s.shape[0]
        count("sqp.solves")
        with span("sqp.solve", lanes=batch):
            return _solve_batch(x0s, scens, batch)

    def _solve_batch(x0s, scens, batch):
        k1 = cfg.solver_compact_after
        frac = cfg.solver_compact_frac
        compact_n = math.ceil(batch * frac) if frac > 0 else batch
        eligible = (0 < compact_n < batch
                    and batch >= cfg.solver_compact_min_batch)
        adaptive = (cfg.solver_compact_adaptive and eligible
                    and max_iters_ > 1 and cfg.solver_costmap_patch == 0)
        use = eligible and 0 < k1 < max_iters_
        fp_term = _batch_hoist(cfg, objective, scens)
        init, run, body = machinery(scens, fp_term, batch, x0s.device)
        with torch.no_grad():
            with span("sqp.init"):
                st = init(x0s)
            if adaptive:
                # Masked full-batch iterations while more than compact_n
                # lanes are alive: one host read a trip (the alive lanes'
                # indices), as the plain loop reads whether any is alive.
                while True:
                    alive = ~st.done & (st.k < max_iters_)
                    idx = alive.nonzero()[:, 0]
                    if idx.numel() <= compact_n:
                        break
                    with span("sqp.iter", lanes=batch):
                        st = _select(alive, body(st, alive), st)
                with span("sqp.compact"):
                    st = finish(st, scens, fp_term, idx)
            else:
                st = run(st, k1 if use else max_iters_)
                if use:
                    alive = ~st.done & (st.k < max_iters_)
                    idx = alive.nonzero()[:, 0]
                    if idx.numel() <= compact_n:
                        with span("sqp.compact"):
                            st = finish(st, scens, fp_term, idx)
                    else:
                        st = run(st, max_iters_)
        return SolveResult(x=st.x, fun=st.f, converged=st.done, iters=st.k)

    return solve_batch


def make_sqp_solver(cfg: MpcConfig, objective, ftol: float | None = None,
                    max_iters: int | None = None, qp_iters: int | None = None,
                    parallel_ls: bool | None = None):
    """Single-lane solve(x0 (3N,), scen) -> SolveResult, where every tensor
    of `scen` has no batch dim: runs the batched solve at batch 1."""
    solve_batch = make_sqp_solver_batched(cfg, objective, ftol=ftol,
                                          max_iters=max_iters,
                                          qp_iters=qp_iters,
                                          parallel_ls=parallel_ls)

    def solve(x0, scen):
        res = solve_batch(x0[None], tree_map(lambda t: t[None], scen))
        return tree_map(lambda t: t[0], res)

    return solve
