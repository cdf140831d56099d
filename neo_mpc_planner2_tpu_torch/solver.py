"""Batched proximal solver (port of `solver.py`): prox-FISTA, the second
solver of product mode and the independent cross-check of the SQP.

The objective splits as F(u) = f(u) + g(u):

- f: the smooth terms (tracking, costmap, footprint, terminal), with the
  gradient from autograd;
- g: the control-effort norm λ·Σ‖u_i − v‖ when the reference quirk
  `compat.unsquared_control_cost` is on (else nothing: the squared term is
  smooth and stays in f), plus the indicator of the feasible set box ∩
  speed disk. Its prox is the Dykstra cycle of a block soft-threshold toward
  the current velocity and the exact box ∩ disk projection.

The outer loop is monotone prox-FISTA with backtracking and function-value
restart; a lane stops when a productive iteration improves F by less than
ftol. JAX runs one lane under `vmap` of `lax.while_loop`s. Here the batch dim
is written out, as in `sqp.py`: the outer loop and the backtracking loop run
while any lane is alive, every carry update is `torch.where(alive, new,
old)`, and a lane's result does not depend on the other lanes.

On the card every footprint cost of the smooth objective goes through K3
(`ops.footprint.footprint_cost_batch`), as in the SQP.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .config import MpcConfig

__all__ = ["SolveResult", "project_feasible", "prox_g", "prox_fista",
           "make_solver", "make_solver_batched"]


class SolveResult(NamedTuple):
    x: torch.Tensor          # (B, 3N) solution
    fun: torch.Tensor        # (B,) final objective
    converged: torch.Tensor  # (B,) bool — scipy's x.success analogue
    iters: torch.Tensor      # (B,) int32


def _per_lane(v, batch: int, like: torch.Tensor) -> torch.Tensor:
    """A float or a per-lane tensor as a (B,) tensor like `like`."""
    return torch.as_tensor(v, dtype=like.dtype,
                           device=like.device).expand(batch)


class _FeasibleSet(NamedTuple):
    """A solve's per-lane feasible set box([lo, hi]) ∩ disk(r) in the
    shapes that (B, N, k) points broadcast against, with every piece of the
    exact projection that does not depend on the point: the projection runs
    `projection_iters` times a prox, and on the card each piece is a
    launch."""
    lo: torch.Tensor      # (B, 1, k): vx, vy (and theta when k = 3)
    hi: torch.Tensor      # (B, 1, k)
    r: torch.Tensor       # (B, 1, 1) the speed disk's radius
    r2: torch.Tensor      # (B, 1, 1) r² + 1e-12: a clipped point's test
    lo_eps: torch.Tensor  # (B, 1, 2) the (vx, vy) box widened by 1e-6
    hi_eps: torch.Tensor  # (B, 1, 2)
    cands: torch.Tensor   # (B, 8, 2) the circle–edge candidates
    pen: torch.Tensor     # (B, 1, 8) 0 for those on both sets, else inf


def _feasible_set(lo: torch.Tensor, hi: torch.Tensor,
                  r: torch.Tensor) -> _FeasibleSet:
    """lo, hi (B, k) with (vx, vy) first, k = 2 or 3; r (B,). The
    candidates are the circle's crossings of the box's edge lines. A
    candidate must lie on both sets: where a box bound exceeds the radius,
    sqrt(max(r² − coord², 0)) fabricates (coord, 0) off the disk, which the
    disk test drops."""
    eps = 1e-6
    r2 = r * r
    lo_eps, hi_eps = lo[:, None, :2] - eps, hi[:, None, :2] + eps

    def edge_pts(coord, axis):
        """The circle's two crossings of the line x = coord (axis 0) or
        y = coord (axis 1): (B, 2, 2)."""
        s = torch.sqrt(torch.clamp_min(r2 - coord * coord, 0.0))
        pts = ([(coord, s), (coord, -s)] if axis == 0
               else [(s, coord), (-s, coord)])
        return torch.stack([torch.stack(p, -1) for p in pts], 1)

    cands = torch.cat([edge_pts(lo[:, 0], 0), edge_pts(hi[:, 0], 0),
                       edge_pts(lo[:, 1], 1), edge_pts(hi[:, 1], 1)], 1)
    feas = ((cands >= lo_eps) & (cands <= hi_eps)).all(-1)
    feas = feas & ((cands * cands).sum(-1) <= r2[:, None] + 1e-6)
    return _FeasibleSet(lo=lo[:, None], hi=hi[:, None], r=r[:, None, None],
                        r2=(r2 + 1e-12)[:, None, None], lo_eps=lo_eps,
                        hi_eps=hi_eps, cands=cands,
                        pen=torch.where(feas, 0.0, torch.inf)[:, None])


def _project(u: torch.Tensor, s: _FeasibleSet) -> torch.Tensor:
    """Exact projection of (B, N, k) points onto the set, in closed form:
    every coordinate clipped to the box; (vx, vy) the clipped point if it
    lies in the disk, else the disk-scaled point if it lies in the box,
    else the nearest feasible candidate. Where every candidate is
    infeasible the first one is taken, as the reference does (its argmin
    over all-inf distances)."""
    pb = torch.clamp(u, s.lo, s.hi)
    xy, pb_xy = u[..., :2], pb[..., :2]
    pb_ok = (pb_xy * pb_xy).sum(-1, keepdim=True) <= s.r2

    # r / |xy| where |xy| > r, else 1 (no Python scalar in a select: on
    # the card that would be a copy to the device each time).
    norm = torch.sqrt((xy * xy).sum(-1, keepdim=True))
    pd = xy * torch.clamp_max(s.r / torch.clamp_min(norm, 1e-30), 1.0)
    pd_ok = ((pd >= s.lo_eps) & (pd <= s.hi_eps)).all(-1, keepdim=True)

    diff = xy[:, :, None, :] - s.cands[:, None]                # (B, N, 8, 2)
    d2 = (diff * diff).sum(-1) + s.pen
    pick = torch.argmin(d2, dim=-1)                            # (B, N)
    best = torch.gather(s.cands, 1, pick[..., None].expand(pick.shape + (2,)))
    out = torch.where(pb_ok, pb_xy, torch.where(pd_ok, pd, best))
    return out if u.shape[-1] == 2 else torch.cat([out, pb[..., 2:]], -1)


def _project_box_disk(xy: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                      r: torch.Tensor) -> torch.Tensor:
    """Exact projection of (B, N, 2) points onto box([lo, hi]) ∩ disk(r),
    lo/hi (B, 2), r (B,): see `_project`."""
    return _project(xy, _feasible_set(lo, hi, r))


def _feasible_set_of(cfg: MpcConfig, limits, batch: int,
                     like: torch.Tensor) -> _FeasibleSet:
    """The per-step feasible set [min_vel_x, max_vel_x] × [min_vel_y,
    max_vel_y] × [min_vel_theta, max_vel_theta] ∩ {‖(vx, vy)‖ ≤
    max_vel_trans}, from the config or from per-lane `limits`."""
    kw = dict(dtype=like.dtype, device=like.device)
    if limits is None:
        lo = torch.tensor([cfg.min_vel_x, cfg.min_vel_y, cfg.min_vel_theta],
                          **kw).expand(batch, 3)
        hi = torch.tensor([cfg.max_vel_x, cfg.max_vel_y, cfg.max_vel_theta],
                          **kw).expand(batch, 3)
        r = torch.tensor(cfg.max_vel_trans, **kw).expand(batch)
    else:
        lo, hi = limits.vel_lo.to(**kw), limits.vel_hi.to(**kw)
        r = limits.max_vel_trans.to(**kw)
    return _feasible_set(lo, hi, r)


def project_feasible(u_flat: torch.Tensor, cfg: MpcConfig,
                     limits=None) -> torch.Tensor:
    """Exact projection of u (B, 3N) onto the per-step feasible set
    [min_vel_x, max_vel_x] × [min_vel_y, max_vel_y] × [min_vel_theta,
    max_vel_theta] ∩ {‖(vx, vy)‖ ≤ max_vel_trans}: theta clamped, (vx, vy)
    by the exact box ∩ disk projection. `limits`: optional per-lane Limits
    overriding the config's bounds."""
    batch = u_flat.shape[0]
    s = _feasible_set_of(cfg, limits, batch, u_flat)
    return _project(u_flat.reshape(batch, -1, 3), s).reshape(batch, -1)


def _soft_threshold_to(u: torch.Tensor, v: torch.Tensor,
                       tau: torch.Tensor) -> torch.Tensor:
    """prox of tau·Σ_i‖u_i − v‖: per-step block soft-threshold toward v.
    u (B, N, 3), v (B, 3), tau (B,)."""
    d = u - v[:, None, :]
    nrm = torch.sqrt((d * d).sum(-1, keepdim=True))
    scale = torch.clamp_min(
        1.0 - tau[:, None, None] / torch.clamp_min(nrm, 1e-30), 0.0)
    return v[:, None, :] + scale * d


def _dykstra(z_flat: torch.Tensor, tau: torch.Tensor,
             current_vel: torch.Tensor, s: _FeasibleSet,
             cycles: int) -> torch.Tensor:
    """`cycles` cycles of Dykstra's splitting of the soft-threshold toward
    current_vel and the projection onto s, from z (B, 3N); tau (B,)."""
    batch = z_flat.shape[0]
    x = z_flat.reshape(batch, -1, 3)
    p1 = torch.zeros_like(x)
    p2 = torch.zeros_like(x)
    for _ in range(cycles):
        a = x + p1
        y1 = _soft_threshold_to(a, current_vel, tau)
        p1 = a - y1
        b = y1 + p2
        x = _project(b, s)
        p2 = b - x
    return x.reshape(batch, -1)


def prox_g(z_flat: torch.Tensor, tau, current_vel: torch.Tensor,
           cfg: MpcConfig, limits=None) -> torch.Tensor:
    """Prox of g(u) = tau·Σ_i‖u_i − v‖ + ind_box(u) + ind_disk(u_xy) for
    z (B, 3N), by `cfg.projection_iters` cycles of Dykstra's splitting of
    the soft-threshold and the feasible-set projection. tau: a float or
    (B,)."""
    batch = z_flat.shape[0]
    return _dykstra(z_flat, _per_lane(tau, batch, z_flat), current_vel,
                    _feasible_set_of(cfg, limits, batch, z_flat),
                    cfg.projection_iters)


def prox_fista(f_smooth: Callable[[torch.Tensor], torch.Tensor],
               g_ctrl: Callable[[torch.Tensor], torch.Tensor],
               ctrl_lambda, current_vel: torch.Tensor, x0: torch.Tensor,
               cfg: MpcConfig, ftol: float | None = None,
               max_iters: int | None = None, L0: float = 1.0,
               limits=None) -> SolveResult:
    """Minimize F = f_smooth + g_ctrl over the feasible set from the warm
    start x0 (B, 3N), lane by lane. f_smooth, g_ctrl: (B, 3N) -> (B,);
    g_ctrl must equal ctrl_lambda·Σ_i‖u_i − current_vel‖ (its value enters
    F; its prox is applied in closed form). ctrl_lambda: a float or (B,)."""
    ftol = cfg.opt_tolerance if ftol is None else ftol
    max_iters = cfg.solver_max_iters if max_iters is None else max_iters
    eta = 2.0
    max_backtracks = 30
    batch = x0.shape[0]
    lam = _per_lane(ctrl_lambda, batch, x0)
    feasible = _feasible_set_of(cfg, limits, batch, x0)

    def prox(z, L):
        return _dykstra(z, lam / L, current_vel, feasible,
                        cfg.projection_iters)

    if not torch.is_tensor(ctrl_lambda) and ctrl_lambda == 0:
        # λ = 0: the soft-threshold is the identity, and Dykstra's cycles
        # over the one set left return its projection (JAX's cycles agree
        # up to rounding).
        def prox(z, L):
            return _project(z.reshape(batch, -1, 3),
                            feasible).reshape(batch, -1)

    def val_grad(u):
        with torch.enable_grad():
            ur = u.detach().requires_grad_(True)
            fv = f_smooth(ur)
            (g,) = torch.autograd.grad(fv.sum(), ur)
        return fv.detach(), g

    with torch.no_grad():
        x = _project(x0.reshape(batch, -1, 3), feasible).reshape(batch, -1)
        F_x = f_smooth(x) + g_ctrl(x)
        y = x
        t = torch.ones_like(F_x)
        L = torch.full_like(F_x, L0)
        k = torch.zeros(batch, dtype=torch.int32, device=x0.device)
        done = torch.zeros(batch, dtype=torch.bool, device=x0.device)
        while True:
            alive = ~done & (k < max_iters)
            if not bool(alive.any()):
                break
            fy, gy = val_grad(y)

            # Backtracking on the smooth part: grow L until f(p) ≤ f(y) +
            # ⟨∇f(y), p − y⟩ + L/2‖p − y‖² at p = prox(y − ∇f/L, L). Only
            # alive lanes backtrack; f(p) is carried, so a trip evaluates
            # the objective once.
            Lb = L
            p = prox(y - gy / Lb[:, None], Lb)
            fp = f_smooth(p)
            j = torch.zeros_like(k)
            while True:
                d = p - y
                ub = fy + (gy * d).sum(-1) + 0.5 * Lb * (d * d).sum(-1)
                go = alive & (fp > ub + 1e-12) & (j < max_backtracks)
                if not bool(go.any()):
                    break
                Ln = Lb * eta
                pn = prox(y - gy / Ln[:, None], Ln)
                fn = f_smooth(pn)
                Lb = torch.where(go, Ln, Lb)
                p = torch.where(go[:, None], pn, p)
                fp = torch.where(go, fn, fp)
                j = torch.where(go, j + 1, j)
            Fp = fp + g_ctrl(p)

            # Monotone variant with adaptive restart: a step that increases
            # F is rejected and the momentum reset.
            restart = Fp > F_x
            x_new = torch.where(restart[:, None], x, p)
            F_new = torch.where(restart, F_x, Fp)
            t_new = torch.where(restart, 1.0,
                                0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t)))
            beta = torch.where(restart, 0.0, (t - 1.0) / t_new)
            y_new = x_new + beta[:, None] * (x_new - x)
            # A productive iteration that improves F by less than ftol stops
            # the lane (a restart leaves F unchanged and must not), as does
            # a step size driven to numerical zero.
            done_new = ((~restart) & ((F_x - F_new).abs() < ftol)) | (Lb > 1e8)

            a = alive[:, None]
            x = torch.where(a, x_new, x)
            y = torch.where(a, y_new, y)
            t = torch.where(alive, t_new, t)
            L = torch.where(alive, Lb * 0.9, L)
            F_x = torch.where(alive, F_new, F_x)
            k = torch.where(alive, k + 1, k)
            done = torch.where(alive, done_new, done)
    return SolveResult(x=x, fun=F_x, converged=done, iters=k)


def make_solver_batched(cfg: MpcConfig, objective, ftol: float | None = None,
                        max_iters: int | None = None):
    """objective: from ops.objective.make_objective. Returns
    solve_batch(x0s (B, 3N), scens) -> SolveResult, what
    `jax.vmap(make_solver(...))` computes in the JAX package.

    Splits the objective into the smooth part and the prox part: the
    control-effort norm goes to the prox only when
    `compat.unsquared_control_cost` (its block soft-threshold is the prox of
    the norm, not of the squared norm), with λ = w_control / N from each
    scenario's weights; otherwise the prox is the feasible-set projection
    alone. In parity mode the footprint term is hoisted out of the loop; in
    product mode, with solver_costmap_patch > 0, every read goes through a
    per-solve patch sampler around each lane's pose."""
    from .ops.costmap import ProductPatchSampler
    from .ops.objective import (control_cost, parity_footprint_term,
                                resolve_weights)

    parity = getattr(objective, "parity", True)
    prox_ctrl = cfg.compat.unsquared_control_cost

    def solve_batch(x0s, scens):
        batch = x0s.shape[0]
        with torch.no_grad():
            fp_term = parity_footprint_term(scens, cfg) if parity else None
        wc = resolve_weights(scens, cfg)["w_control"]
        lam = (_per_lane(wc, batch, x0s) / cfg.control_steps if prox_ctrl
               else 0.0)
        sampler = None
        if (not parity and cfg.solver_costmap_patch > 0
                and scens.costmap.win_cells is None):
            pose = scens.current_pose
            sampler = ProductPatchSampler(scens.costmap, pose[:, 0],
                                          pose[:, 1],
                                          cfg.solver_costmap_patch)

        def f_smooth(u):
            return objective(u, scens, fp_term, include_control=not prox_ctrl,
                             point_sampler=sampler)

        if prox_ctrl:
            def g_ctrl(u):
                return control_cost(u, scens.current_vel, cfg, wc)
        else:
            def g_ctrl(u):
                return u.new_zeros(u.shape[0])
        return prox_fista(f_smooth, g_ctrl, lam, scens.current_vel, x0s, cfg,
                          ftol=ftol, max_iters=max_iters,
                          limits=scens.limits)

    return solve_batch


def make_solver(cfg: MpcConfig, objective, ftol: float | None = None,
                max_iters: int | None = None):
    """Single-lane solve(x0 (3N,), scen) -> SolveResult, where every tensor
    of `scen` has no batch dim: the batched solve at batch 1."""
    from .tree import tree_map

    solve_batch = make_solver_batched(cfg, objective, ftol=ftol,
                                      max_iters=max_iters)

    def solve(x0, scen):
        res = solve_batch(x0[None], tree_map(lambda t: t[None], scen))
        return tree_map(lambda t: t[0], res)

    return solve
