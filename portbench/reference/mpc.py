"""Plain PyTorch reference of neobotix's neo_mpc_planner2 control tick.

One closed-loop FollowPath tick for a batch of independent robots, written
from the reference planner's semantics (the Nav2 plugin NeoMpcPlanner.cpp
and its SLSQP server mpc_optimization_server.py) and the engine's solver
program that the deployment file states (SQP with an ADMM QP, an Armijo
line search on the L1 merit, damped BFGS):

- pursuit: the plan's closest pose, the window inside half the map, the
  carrot at the lookahead distance, the slow-down hysteresis and the lethal
  footprint gate;
- the objective: parity (the reference's quirks kept, nearest-cell reads, a
  per-solve footprint term) or product (bilinear reads, the footprint cost
  at every predicted pose, wrapped angles);
- the SQP step: the QP over the box and the translational-speed cone by
  ADMM, the line search (sequential with quadratic interpolation, or the
  first accepted candidate of the two-phase schedule), the BFGS update and
  the SLSQP-like stop;
- post-processing: low-pass, predicted-collision and stuck latch,
  acceleration clamp, warm-start shift;
- the plant: the omni kinematic model integrated over the control interval;
- the dynamic-obstacle map of a tick.

It imports torch and nothing of the program under test. Every tensor has a
leading lane dim; `dtype` is the precision the whole tick runs in (float32
for the reference, bfloat16 for its lower-precision control).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

LETHAL = 1.0
SLOW_DOWN_GATE = 200.0 / 255.0
BLOB_SIGMA2 = 0.08


@dataclass
class Params:
    """The deployment's numbers, read from its configuration file."""

    p: dict

    def __getattr__(self, k):
        try:
            return self.p[k]
        except KeyError:
            raise AttributeError(k) from None

    @property
    def n(self) -> int:
        return int(self.p["control_steps"])

    @property
    def dt(self) -> float:
        return self.p["prediction_horizon"] / self.p["control_steps"]

    @property
    def parity(self) -> bool:
        return self.p["mode"] == "parity"


def params_from_config(cfg: dict) -> Params:
    """Flatten a configuration file (ros_params, engine, compat, mode)."""
    p = dict(cfg["ros_params"])
    p.update(cfg["engine"])
    p.update(cfg["compat"])
    p["mode"] = cfg["mode"]
    return Params(p)


# ---------------------------------------------------------------- geometry

def rollout(u, dt, pose):
    """u (..., N, 3), pose (..., 3) -> poses after each step (..., N, 3):
    yaw first, then the position with the new yaw."""
    x, y, th = pose[..., 0], pose[..., 1], pose[..., 2]
    out = []
    for i in range(u.shape[-2]):
        th = th + u[..., i, 2] * dt
        c, s = torch.cos(th), torch.sin(th)
        x = x + (u[..., i, 0] * c - u[..., i, 1] * s) * dt
        y = y + (u[..., i, 0] * s + u[..., i, 1] * c) * dt
        out.append(torch.stack([x, y, th], -1))
    return torch.stack(out, -2)


def place(pose, pts):
    """Points (..., 2) in the frame of pose (..., 3) -> world (..., 2)."""
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    return torch.stack([pose[..., 0] + pts[..., 0] * c - pts[..., 1] * s,
                        pose[..., 1] + pts[..., 0] * s + pts[..., 1] * c], -1)


def wrap(a):
    return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi


# ---------------------------------------------------------------- the map

class Grid:
    """Lane maps data (B, H, W), origin (B, 2), resolution (B,); cells
    outside the grid read lethal. `quant`: reads decoded from the map's
    uint8 copy (round(255 c) / 255), as a solver source of that kind."""

    def __init__(self, data, origin, res):
        self.data, self.origin, self.res = data, origin, res
        self.B, self.H, self.W = data.shape

    def _lane(self, v, like):
        return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))

    def cell(self, wx, wy):
        r = self._lane(self.res, wx)
        mx = torch.floor((wx - self._lane(self.origin[:, 0], wx)) / r)
        my = torch.floor((wy - self._lane(self.origin[:, 1], wy)) / r)
        return mx.long(), my.long()

    def at_cell(self, mx, my, quant=False):
        inb = (mx >= 0) & (mx < self.W) & (my >= 0) & (my < self.H)
        flat = self.data.reshape(self.B, -1)
        if quant:
            q = torch.round(flat.float() * 255.0).clamp(0, 255)
            flat = (q / 255.0).to(self.data.dtype)
        idx = (my.clamp(0, self.H - 1) * self.W
               + mx.clamp(0, self.W - 1)).reshape(self.B, -1)
        v = torch.gather(flat, 1, idx).reshape(mx.shape)
        return torch.where(inb, v, torch.ones_like(v) * LETHAL)

    def nearest(self, wx, wy, quant=False):
        return self.at_cell(*self.cell(wx, wy), quant=quant)

    def bilinear(self, wx, wy):
        """Cell-centre bilinear interpolation, smooth in (wx, wy)."""
        r = self._lane(self.res, wx)
        fx = (wx - self._lane(self.origin[:, 0], wx)) / r - 0.5
        fy = (wy - self._lane(self.origin[:, 1], wy)) / r - 0.5
        x0, y0 = torch.floor(fx), torch.floor(fy)
        tx, ty = fx - x0, fy - y0
        x0, y0 = x0.long(), y0.long()
        c00 = self.at_cell(x0, y0)
        c10 = self.at_cell(x0 + 1, y0)
        c01 = self.at_cell(x0, y0 + 1)
        c11 = self.at_cell(x0 + 1, y0 + 1)
        top = c00 * (1.0 - tx) + c10 * tx
        bot = c01 * (1.0 - tx) + c11 * tx
        return top * (1.0 - ty) + bot * ty


def edge_params(samples: int, dtype, device):
    """Sample positions along an edge: i · (1 / (S − 1)) and an exact 1."""
    recip = (torch.tensor(1.0, dtype=dtype, device=device)
             / torch.tensor(float(samples - 1), dtype=dtype, device=device))
    t = torch.arange(samples - 1, dtype=dtype, device=device) * recip
    return torch.cat([t, torch.ones(1, dtype=dtype, device=device)])


def footprint_cost(grid: Grid, poly, nv: int, samples: int):
    """The largest cell cost along the placed polygons' edges: poly
    (B, *k, V, 2) world vertices of which the first nv are valid; each edge
    sampled at `samples` points, nearest cell. -> (B, *k)."""
    v = poly[..., :nv, :]
    e = torch.roll(v, -1, dims=-2)
    t = edge_params(samples, poly.dtype, poly.device)
    pts = v[..., :, None, :] + (e - v)[..., :, None, :] * t[:, None]
    c = grid.nearest(pts[..., 0], pts[..., 1])
    return c.amax(dim=(-2, -1))


def blob_map(centers, amp, origin, cells: int, res: float):
    """The max of Gaussian blobs (B, O) on the (cells)² grid at origin
    (B, 2), clipped to [0, 1]."""
    dev, dt = amp.device, amp.dtype
    c = torch.arange(cells, dtype=dt, device=dev) * res + res / 2
    xw = origin[:, 0, None] + c[None]
    yw = origin[:, 1, None] + c[None]
    out = torch.zeros(amp.shape[0], cells, cells, dtype=dt, device=dev)
    for i in range(amp.shape[1]):
        dx = xw[:, None, :] - centers[:, i, 0, None, None]
        dy = yw[:, :, None] - centers[:, i, 1, None, None]
        out = torch.maximum(out, amp[:, i, None, None]
                            * torch.exp(-(dx * dx + dy * dy)
                                        / (2 * BLOB_SIGMA2)))
    return out.clamp(0.0, 1.0)


# ---------------------------------------------------------------- pursuit

def pursuit(P: Params, plan, n_valid, start, slow_down, pose, grid: Grid,
            fp_local, fp_nv: int):
    """The plugin's geometry (cpp:66-236): carrot (base frame), closer to
    goal, new slow-down, lethal, the footprint cost at the pose, the new
    plan start, an empty window."""
    Pn = plan.shape[1]
    idx = torch.arange(Pn, device=plan.device)
    alive = (idx >= start[:, None]) & (idx < n_valid[:, None])
    dx = plan[..., 0] - pose[:, 0:1]
    dy = plan[..., 1] - pose[:, 1:2]
    d = torch.sqrt(dx * dx + dy * dy)
    big = torch.full_like(d, 1e30)
    begin = torch.argmin(torch.where(alive, d, big), dim=-1)
    goal = plan[torch.arange(plan.shape[0]), n_valid - 1]
    g = goal[:, :2] - pose[:, :2]
    closer = torch.sqrt((g * g).sum(-1)) <= P.lookahead_dist_close_to_goal
    half = max(grid.H, grid.W) * grid.res / 2.0
    beyond = (d > half[:, None]) & (idx >= begin[:, None]) & alive
    end = torch.where(beyond, idx, n_valid[:, None]).amin(-1)
    window = ((idx >= begin[:, None]) & (idx < end[:, None])
              & (idx < n_valid[:, None]))
    empty = ~window.any(-1)
    # The plan in the robot's frame.
    c, s = torch.cos(pose[:, 2:3]), torch.sin(pose[:, 2:3])
    rx, ry = plan[..., 0] - pose[:, 0:1], plan[..., 1] - pose[:, 1:2]
    lx = rx * c + ry * s
    ly = -rx * s + ry * c
    lyaw = plan[..., 2] - pose[:, 2:3]
    la = torch.where(~slow_down | closer,
                     torch.where(closer,
                                 torch.full_like(d[:, 0],
                                                 P.lookahead_dist_close_to_goal),
                                 torch.full_like(d[:, 0],
                                                 P.lookahead_dist_max)),
                     torch.full_like(d[:, 0], P.lookahead_dist_min))
    far = window & (torch.sqrt(lx * lx + ly * ly) >= la[:, None])
    first = torch.where(far, idx, Pn).amin(-1)
    last = torch.where(window, idx, -1).amax(-1)
    ci = torch.where(first < Pn, first, last.clamp(min=0))
    pick = lambda a: a.gather(1, ci[:, None])[:, 0]
    carrot = torch.stack([pick(lx), pick(ly), pick(lyaw)], -1)
    fpc = footprint_cost(grid, place(pose[:, None, :], fp_local), fp_nv,
                         P.footprint_edge_samples)
    new_slow = (carrot[:, 2].abs() >= 1.0) & (fpc > SLOW_DOWN_GATE)
    return dict(carrot=carrot, closer=closer, slow_down=new_slow,
                lethal=fpc >= LETHAL, fp_cost=fpc, start=begin, empty=empty,
                goal=goal)


# ---------------------------------------------------------------- objective

def make_objective(P: Params, grid: Grid, fp_local, fp_nv: int, scen,
                   fp_cost_now, dtype):
    """f(u) for u (B, *cand, 3N) -> (B, *cand)."""
    n, dt = P.n, P.dt
    quant = P.solver_costmap_u8 is True or (
        P.solver_costmap_u8 == "auto" and grid.H * grid.W >= 128 * 128)
    pose, carrot, goal, vel = (scen["pose"], scen["carrot"], scen["goal"],
                               scen["vel"])
    fp_term = torch.where(fp_cost_now == 1.0,
                          fp_cost_now * fp_cost_now * P.w_footprint,
                          torch.zeros_like(fp_cost_now))

    def f(u):
        extra = u.dim() - 2
        L = lambda v: v.reshape(v.shape[:1] + (1,) * extra + v.shape[1:])
        cmd = u.reshape(u.shape[:-1] + (n, 3))
        zero = torch.zeros(u.shape[:-1] + (3,), dtype=u.dtype,
                           device=u.device)
        body = rollout(cmd, dt, zero)
        cp, gp, cr, cv = L(pose), L(goal), L(carrot), L(vel)
        if P.parity and P.buggy_odom_yaw:
            zc = torch.sin(cp[..., 2] * 0.5)
            wg = torch.cos(gp[..., 2] * 0.5)
            yaw0 = torch.atan2(2.0 * wg * zc, 1.0 - 2.0 * zc * zc)
        else:
            yaw0 = cp[..., 2]
        start = torch.stack([cp[..., 0], cp[..., 1], yaw0], -1)
        odom = rollout(cmd, dt, start.expand(body.shape[:-2] + (3,)))
        if P.parity:
            pc = grid.nearest(odom[..., 0].detach(), odom[..., 1].detach(),
                              quant=quant)
            fps = L(fp_term)[..., None].expand(pc.shape)
        else:
            pc = grid.bilinear(odom[..., 0], odom[..., 1])
            placed = place(odom.detach()[..., None, :],
                           fp_local.reshape((fp_local.shape[0],)
                                            + (1,) * (odom.dim() - 2)
                                            + fp_local.shape[1:]))
            fpc = footprint_cost(grid, placed, fp_nv,
                                 P.footprint_edge_samples)
            fps = fpc * fpc * P.w_footprint
        err = (lambda e: e) if (P.parity and P.no_angle_wrap) else wrap
        d2 = ((cr[..., None, :2] - body[..., :2]) ** 2).sum(-1)
        oe = err(cr[..., 2:3] - body[..., 2])
        cost = (P.w_trans * d2 + P.w_orient * oe * oe).sum(-1) / n
        diff = cv[..., None, :] - cmd
        dd = (diff * diff).sum(-1)
        if P.parity and P.unsquared_control_cost:
            z = dd == 0.0
            dv = torch.where(z, torch.zeros_like(dd),
                             torch.sqrt(torch.where(z, torch.ones_like(dd),
                                                    dd)))
            cost = cost + P.w_control * dv.sum(-1) / n
        else:
            cost = cost + P.w_control * dd.sum(-1) / n
        sq = pc * pc
        if P.parity and P.lethal_1000x:
            scale = torch.where(pc == 1.0, torch.full_like(sq, 1000.0),
                                torch.full_like(sq, P.w_costmap))
        else:
            scale = torch.full_like(sq, P.w_costmap)
        cost = cost + (scale * sq).sum(-1) / n + fps.sum(-1) / n
        to = err(gp[..., 2] - body[..., -1, 2])
        if P.parity and P.footprint_alias_noop:
            td = ((cr[..., :2] - gp[..., :2]) ** 2).sum(-1)
        else:
            td = ((odom[..., -1, :2] - gp[..., :2]) ** 2).sum(-1)
        return cost + (P.w_trans * td + P.w_orient * to * to) * P.w_terminal

    return f


# ---------------------------------------------------------------- the SQP

def cone(P: Params, x):
    """c = v_max − ‖(vx, vy)_k‖ (B, N) and its Jacobian rows (B, N, 3N)."""
    n = P.n
    xy = x.reshape(x.shape[0], n, 3)[..., :2]
    nrm = torch.sqrt((xy * xy).sum(-1))
    c = P.max_vel_trans - nrm
    g = torch.where(nrm[..., None] > 1e-12,
                    -xy / nrm.clamp_min(1e-12)[..., None],
                    torch.zeros_like(xy))
    J = torch.zeros(x.shape[0], n, 3 * n, dtype=x.dtype, device=x.device)
    for k in range(n):
        J[:, k, 3 * k] = g[:, k, 0]
        J[:, k, 3 * k + 1] = g[:, k, 1]
    return c, J


def qp(P: Params, Bm, g, x, c, J, lo, hi, carry, rho=1.0, sigma=1e-6):
    """ADMM on min ½dᵀBd + gᵀd, lo−x ≤ d ≤ hi−x, Jd ≥ −c, from the warm
    carry (d, zb, zc, wb, wc), `qp_iters` iterations."""
    m = x.shape[1]
    eye = torch.eye(m, dtype=x.dtype, device=x.device)
    Jt = J.transpose(1, 2)
    M = Bm + (sigma + rho) * eye + rho * (Jt @ J)
    Minv = torch.linalg.inv(M.float()).to(x.dtype)
    mv = lambda A, v: (A @ v[..., None])[..., 0]
    d, zb, zc, wb, wc = carry
    dlo, dhi = lo - x, hi - x
    for _ in range(int(P.qp_iters)):
        d = mv(Minv, -g + sigma * d + rho * (zb - wb) + rho * mv(Jt, zc - wc))
        zb = torch.minimum(torch.maximum(d + wb, dlo), dhi)
        Jd = mv(J, d)
        zc = torch.maximum(Jd + wc, -c)
        wb = wb + d - zb
        wc = wc + Jd - zc
    return (torch.minimum(torch.maximum(d, dlo), dhi), rho * wc,
            (d, zb, zc, wb, wc))


def schedule(P: Params, count: int, dtype, device):
    """Step j of the two-phase backtracking schedule."""
    bt, F = P.solver_ls_backtrack, int(P.solver_ls_coarse_after)
    j = torch.arange(count, dtype=dtype, device=device)
    fine = j if F <= 0 else j.clamp(max=float(F))
    return (torch.pow(torch.tensor(bt, dtype=dtype, device=device), fine)
            * torch.pow(torch.tensor(P.solver_ls_coarse_factor, dtype=dtype,
                                     device=device), j - fine))


def sqp(P: Params, f, x0, dtype):
    """Minimize f over box ∩ cone from x0 (B, 3N): -> (x, f, converged,
    iterations)."""
    B, m = x0.shape
    dev = x0.device
    n = P.n
    lo = torch.tensor([P.min_vel_x, P.min_vel_y, P.min_vel_theta], dtype=dtype,
                      device=dev).repeat(n).expand(B, m)
    hi = torch.tensor([P.max_vel_x, P.max_vel_y, P.max_vel_theta], dtype=dtype,
                      device=dev).repeat(n).expand(B, m)
    eye = torch.eye(m, dtype=dtype, device=dev).expand(B, m, m)

    def val_grad(x):
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            v = f(xr)
            (gr,) = torch.autograd.grad(v.sum(), xr)
        return v.detach(), gr.detach()

    def merit(x, mu):
        c, _ = cone(P, x.reshape(-1, m))
        viol = torch.clamp_min(-c, 0.0).sum(-1).reshape(x.shape[:-1])
        fv = f(x).detach()
        mu_ = mu.reshape(mu.shape + (1,) * (fv.dim() - 1))
        return fv + mu_ * viol, fv

    x = torch.minimum(torch.maximum(x0.to(dtype), lo), hi)
    fx, gx = val_grad(x)
    Bk = eye.clone()
    mu = torch.ones(B, dtype=dtype, device=dev)
    k = torch.zeros(B, dtype=torch.long, device=dev)
    small = torch.zeros(B, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    failed = torch.zeros(B, dtype=torch.bool, device=dev)
    zm = torch.zeros(B, m, dtype=dtype, device=dev)
    zn = torch.zeros(B, n, dtype=dtype, device=dev)
    carry = (zm, zm, zn, zm, zn)
    ftol = P.opt_tolerance
    nb = int(P.solver_max_backtracks)
    sched = schedule(P, nb, dtype, dev)
    sel = lambda msk, a, b: torch.where(
        msk.reshape(msk.shape + (1,) * (a.dim() - 1)), a, b)
    while True:
        act = ~done & (k < int(P.solver_max_iters))
        if not bool(act.any()):
            break
        c, J = cone(P, x)
        d, ycone, carry_n = qp(P, Bk, gx, x, c, J, lo, hi, carry)
        mu_n = torch.maximum(mu, 1.5 * ycone.abs().amax(-1) + 1e-3)
        viol = torch.clamp_min(-c, 0.0).sum(-1)
        phi0 = fx + mu_n * viol
        dphi = (gx * d).sum(-1) - mu_n * viol
        ok = done | ~act
        alpha = torch.ones(B, dtype=dtype, device=dev)
        f_ls = fx.clone()
        if P.parallel_line_search:
            # The first accepted candidate of the schedule, in order.
            cand = x[:, None] + sched[None, :, None] * d[:, None]
            phis, fs = merit(cand, mu_n)
            okm = phis <= phi0[:, None] + 1e-4 * sched[None] * dphi[:, None] \
                + 1e-12
            hit = okm.any(-1)
            j = torch.argmax(okm.to(torch.int32), -1, keepdim=True)
            alpha = torch.where(hit, sched[j[:, 0]], alpha)
            f_ls = torch.where(hit, fs.gather(1, j)[:, 0], f_ls)
            ok = ok | hit
        else:
            j = torch.zeros(B, dtype=torch.long, device=dev)
            while True:
                go = ~ok & (j < nb)
                if not bool(go.any()):
                    break
                phi, fv = merit(x + alpha[:, None] * d, mu_n)
                acc = phi <= phi0 + 1e-4 * alpha * dphi + 1e-12
                if P.solver_ls_quad_interp:
                    den = 2.0 * (phi - phi0 - dphi * alpha)
                    aq = -dphi * alpha * alpha / torch.where(
                        den.abs() > 1e-20, den, torch.full_like(den, 1e-20))
                    nxt = torch.minimum(torch.maximum(aq, 0.1 * alpha),
                                        0.5 * alpha)
                else:
                    F = int(P.solver_ls_coarse_after)
                    fac = torch.where(
                        j < F if F > 0 else torch.ones_like(go),
                        torch.full_like(alpha, P.solver_ls_backtrack),
                        torch.full_like(alpha, P.solver_ls_coarse_factor))
                    nxt = alpha * fac
                alpha = torch.where(go & ~acc, nxt, alpha)
                f_ls = torch.where(go & acc, fv, f_ls)
                j = torch.where(go, j + 1, j)
                ok = torch.where(go, acc, ok)
        ls_ok = ok
        step = torch.where(ls_ok[:, None], alpha[:, None] * d,
                           torch.zeros_like(d))
        xn = x + step
        fn = torch.where(ls_ok, f_ls, fx)
        _, gn = val_grad(xn)
        y = gn - gx
        Bs = (Bk @ step[..., None])[..., 0]
        sBs = (step * Bs).sum(-1)
        sy = (step * y).sum(-1)
        th = torch.where(sy < 0.2 * sBs,
                         0.8 * sBs / torch.clamp_min(sBs - sy, 1e-16),
                         torch.ones_like(sy))
        y = th[:, None] * y + (1.0 - th)[:, None] * Bs
        sy = (step * y).sum(-1)
        upd = ls_ok & (sBs > 1e-16) & (sy > 1e-16)
        outer = lambda u: u[:, :, None] * u[:, None, :]
        Bn = torch.where(upd[:, None, None],
                         Bk - (outer(Bs) / torch.clamp_min(sBs, 1e-16)[:, None,
                                                                       None]
                               - outer(y) / torch.clamp_min(sy, 1e-16)[:, None,
                                                                       None]),
                         Bk)
        imp = (fx - fn).abs()
        sm = ls_ok & (imp < ftol)
        stat = sm & (d.abs().amax(-1) < 1e-6)
        small_n = torch.where(sm, small + 1 + stat.long(),
                              torch.zeros_like(small))
        Bn = torch.where(ls_ok[:, None, None], Bn, eye)
        done_n = (small_n >= 2) | (failed & ~ls_ok)
        x, fx, gx = sel(act, xn, x), sel(act, fn, fx), sel(act, gn, gx)
        Bk, mu = sel(act, Bn, Bk), sel(act, mu_n, mu)
        k = torch.where(act, k + 1, k)
        small = sel(act, small_n, small)
        done = sel(act, done_n, done)
        failed = sel(act, ~ls_ok, failed)
        carry = tuple(sel(act, a, b) for a, b in zip(carry_n, carry))
    return x, fx, done, k


# ---------------------------------------------------------------- the tick

def init_state(P: Params, B: int, dtype, device):
    z = lambda *s: torch.zeros((B,) + s, dtype=dtype, device=device)
    return dict(guess=z(3 * P.n), last=z(3), wait=z(),
                collision=torch.zeros(B, dtype=torch.bool, device=device),
                old_goal=z(3),
                has_old=torch.zeros(B, dtype=torch.bool, device=device),
                slow_down=torch.ones(B, dtype=torch.bool, device=device),
                start=torch.zeros(B, dtype=torch.long, device=device))


def serve_request(P: Params, state, grid: Grid, fp_local, fp_nv: int, pose,
                  carrot, goal, vel, switch_opt, control_interval, delta_t,
                  fp_cost_now, dtype):
    """The server's half of a tick (py:349-403) on a batch of requests:
    -> (cmd, new state, raw solution, converged)."""
    del switch_opt  # the reference server reads it and changes nothing
    n, B = P.n, pose.shape[0]
    same = state["has_old"] & (state["old_goal"] == goal).all(-1)
    guess = torch.where(same[:, None], state["guess"],
                        torch.zeros_like(state["guess"]))
    last = torch.where(same[:, None], state["last"],
                       torch.zeros_like(state["last"]))
    wait = torch.where(same, state["wait"], torch.zeros_like(state["wait"]))
    scen = dict(pose=pose, carrot=carrot, goal=goal, vel=vel)
    f = make_objective(P, grid, fp_local, fp_nv, scen, fp_cost_now, dtype)
    x, _, conv, _ = sqp(P, f, guess, dtype)
    g = P.low_pass_gain
    first = x[:, :3] * g + last * (1.0 - g)
    xl = torch.cat([first, x[:, 3:]], -1)
    odom = rollout(xl.reshape(B, n, 3), P.dt, pose)
    pcs = grid.nearest(odom[..., 0], odom[..., 1])
    collision = state["collision"] | (pcs >= 0.99).any(-1)
    col_fp = fp_cost_now == 1.0
    blocked = collision | col_fp
    wait = torch.where(blocked, wait + delta_t, wait)
    thresh = 3.0 if P.hardcoded_stuck_wait else P.waiting_time
    expire = blocked & (wait >= thresh)
    collision = collision & ~expire
    wait = torch.where(expire, torch.zeros_like(wait), wait)
    acc = torch.tensor([P.acc_x_limit, P.acc_y_limit, P.acc_theta_limit],
                       dtype=dtype, device=pose.device) * control_interval[:,
                                                                            None]
    clamped = torch.fmax(torch.fmin(xl[:, :3], last + acc), last - acc)
    cmd = torch.where(blocked[:, None], torch.zeros_like(clamped), clamped)
    xs = xl.reshape(B, n, 3)
    shifted = torch.cat([xs[:, 1:], xs[:, :1]], 1).reshape(B, 3 * n)
    new = dict(state)
    new.update(guess=torch.where(conv[:, None], shifted, xl), last=cmd,
               wait=wait, collision=collision, old_goal=goal,
               has_old=torch.ones_like(collision))
    return cmd, new, x, conv


def tick(P: Params, state, plan, n_valid, pose, vel, grid: Grid, fp_local,
         fp_nv: int, dtype):
    """One full FollowPath tick: pursuit, the server's solve and
    post-processing, the plugin's gates. -> (cmd, new state, skipped: the
    lanes whose plugin threw before the server ran)."""
    pr = pursuit(P, plan, n_valid, state["start"], state["slow_down"], pose,
                 grid, fp_local, fp_nv)
    st2 = dict(state)
    st2["slow_down"] = torch.where(pr["empty"], state["slow_down"],
                                   pr["slow_down"])
    st2["start"] = pr["start"]
    B = pose.shape[0]
    ci = torch.full((B,), 1.0 / P.controller_frequency, dtype=dtype,
                    device=pose.device)
    cmd, new, _, _ = serve_request(P, st2, grid, fp_local, fp_nv, pose,
                                   pr["carrot"], pr["goal"], vel,
                                   pr["closer"], ci, ci, pr["fp_cost"], dtype)
    skip = pr["lethal"] | pr["empty"]
    out = {}
    for key, a in new.items():
        b = st2[key]
        out[key] = torch.where(skip.reshape(skip.shape + (1,) * (a.dim() - 1)),
                               b, a)
    cmd = torch.where(skip[:, None], torch.zeros_like(cmd), cmd)
    return cmd, out, skip


def plant(P: Params, pose, cmd):
    """The robot: the command held over one control interval."""
    return rollout(cmd[:, None, :], 1.0 / P.controller_frequency, pose)[:, 0]
