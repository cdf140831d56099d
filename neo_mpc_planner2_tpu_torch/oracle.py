"""CPU oracle (a copy of the JAX package's `oracle.py`, pointed at the
port's config): a behavior-faithful numpy/scipy re-implementation of the
reference optimization server, used ONLY as ground truth.

This is *not* the device path: it is numpy and scipy on the host, and
imports nothing of JAX. It exists so the solver can be validated
"bit-tolerantly" against the exact scipy SLSQP pipeline the reference runs
(mpc_optimization_server.py:349-403), including every quirk in SURVEY.md §2.3.
Written from behavioral analysis of the reference, with the same costmap /
footprint conventions as ops/costmap.py and ops/footprint.py (nearest-cell
lookup, lethal out-of-bounds, uniform edge sampling) so that oracle↔device
differences isolate the *solver*, not the environment model.

Scenario fields are plain numpy; poses are [x, y, yaw].
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
from scipy.optimize import minimize

from .config import MpcConfig

__all__ = ["NpCostmap", "NpScenario", "OracleServer", "oracle_objective"]


@dataclasses.dataclass
class NpCostmap:
    data: np.ndarray          # (H, W) normalized [0, 1]
    origin: np.ndarray        # (2,)
    resolution: float

    def world_to_map(self, wx, wy):
        # Floor, as nav2 Costmap2D::worldToMap (its wx < origin_x guard makes
        # the below-origin band out of bounds; floor to -1 reproduces that).
        mx = int(np.floor((wx - self.origin[0]) / self.resolution))
        my = int(np.floor((wy - self.origin[1]) / self.resolution))
        return mx, my

    def get_cost(self, mx, my):
        h, w = self.data.shape
        if 0 <= mx < w and 0 <= my < h:
            return float(self.data[my, mx])
        return 1.0

    def get_cost_world(self, wx, wy):
        return self.get_cost(*self.world_to_map(wx, wy))

    def line_cost_exact(self, x0, y0, x1, y1) -> float:
        """Exact Amanatides-Woo walk — mirror of the native host's line_cost
        (neo_mpc_host.cpp:105-150) and ops.footprint.line_cost_exact."""
        res = self.resolution
        mx = int(np.floor((x0 - self.origin[0]) / res))
        my = int(np.floor((y0 - self.origin[1]) / res))
        ex = int(np.floor((x1 - self.origin[0]) / res))
        ey = int(np.floor((y1 - self.origin[1]) / res))
        dx, dy = x1 - x0, y1 - y0
        step_x = 1 if dx > 0 else -1
        step_y = 1 if dy > 0 else -1
        inf = float("inf")
        t_max_x = ((self.origin[0] + (mx + (1 if dx > 0 else 0)) * res) - x0) / dx if dx != 0 else inf
        t_max_y = ((self.origin[1] + (my + (1 if dy > 0 else 0)) * res) - y0) / dy if dy != 0 else inf
        t_delta_x = res / abs(dx) if dx != 0 else inf
        t_delta_y = res / abs(dy) if dy != 0 else inf
        best = self.get_cost(mx, my)
        max_steps = abs(ex - mx) + abs(ey - my) + 2
        for _ in range(max_steps):
            if mx == ex and my == ey:
                break
            if t_max_x < t_max_y:
                t = t_max_x
                t_max_x += t_delta_x
                mx += step_x
            else:
                t = t_max_y
                t_max_y += t_delta_y
                my += step_y
            if t > 1.0:
                break
            best = max(best, self.get_cost(mx, my))
        return best

    def footprint_cost(self, vertices: np.ndarray, samples: int,
                       exact: bool = False) -> float:
        """Max cost along the closed polygon boundary: uniform edge sampling
        (same scheme as ops/footprint.footprint_cost) or the exact cell walk
        (exact=True, matching cfg.footprint_exact)."""
        n = len(vertices)
        best = -np.inf
        for i in range(n):
            a = vertices[i]
            b = vertices[(i + 1) % n]
            if exact:
                best = max(best, self.line_cost_exact(a[0], a[1], b[0], b[1]))
                continue
            for t in np.linspace(0.0, 1.0, samples):
                p = a + (b - a) * t
                best = max(best, self.get_cost_world(p[0], p[1]))
        return best


@dataclasses.dataclass
class NpScenario:
    current_pose: np.ndarray   # (3,) world frame
    carrot_pose: np.ndarray    # (3,) base frame
    goal_pose: np.ndarray      # (3,) map frame
    current_vel: np.ndarray    # (3,)
    footprint: np.ndarray      # (V, 2) BASE-frame polygon
    costmap: NpCostmap
    switch_opt: bool = False
    control_interval: float | None = None  # request field (py:355); None -> cfg


def _rollout_np(cmd: np.ndarray, dt: float, init: np.ndarray) -> np.ndarray:
    """Yaw-first omni integration (mpc_optimization_server.py:230-236)."""
    pose = init.astype(np.float64).copy()
    out = np.zeros((len(cmd), 3))
    for i, (vx, vy, w) in enumerate(cmd):
        pose[2] += w * dt
        pose[0] += (vx * np.cos(pose[2]) - vy * np.sin(pose[2])) * dt
        pose[1] += (vx * np.sin(pose[2]) + vy * np.cos(pose[2])) * dt
        out[i] = pose
    return out


def _buggy_yaw(current_yaw: float, goal_yaw: float) -> float:
    """py:213 — current quaternion xyz with the goal quaternion's w."""
    zc = np.sin(current_yaw * 0.5)
    wg = np.cos(goal_yaw * 0.5)
    return float(np.arctan2(2.0 * wg * zc, 1.0 - 2.0 * zc * zc))


def _placed_footprint(scen: NpScenario) -> np.ndarray:
    """Base-frame footprint posed at current_pose (what the reference receives
    on /local_costmap/published_footprint)."""
    c, s = np.cos(scen.current_pose[2]), np.sin(scen.current_pose[2])
    R = np.array([[c, -s], [s, c]])
    return scen.footprint @ R.T + scen.current_pose[:2]


def oracle_objective(cmd_flat: np.ndarray, scen: NpScenario, cfg: MpcConfig,
                     fp_cost: Optional[float] = None) -> float:
    """Quirk-faithful objective (mpc_optimization_server.py:204-269).

    fp_cost: optional precomputed current-footprint cost — it is constant per
    solve (the aliasing no-op), so callers may hoist it out of the SLSQP loop.
    """
    n = cfg.control_steps
    dt = cfg.dt
    cmd = np.asarray(cmd_flat, dtype=np.float64).reshape(n, 3)

    body = _rollout_np(cmd, dt, np.zeros(3))
    yaw0 = (
        _buggy_yaw(scen.current_pose[2], scen.goal_pose[2])
        if cfg.compat.buggy_odom_yaw
        else scen.current_pose[2]
    )
    odom = _rollout_np(cmd, dt, np.array([scen.current_pose[0], scen.current_pose[1], yaw0]))

    carrot_xy = scen.carrot_pose[:2]
    target_yaw = scen.carrot_pose[2]
    final_yaw = scen.goal_pose[2]

    # Footprint-aliasing no-op (py:227/238-244): evaluated once, untransformed.
    if fp_cost is None:
        fp_cost = scen.costmap.footprint_cost(
            _placed_footprint(scen), cfg.footprint_edge_samples,
            exact=cfg.footprint_exact)

    cost = 0.0
    for i in range(n):
        pc = scen.costmap.get_cost_world(odom[i, 0], odom[i, 1])
        costmap_cost = pc**2

        d = np.linalg.norm(carrot_xy - body[i, :2])
        oe = target_yaw - body[i, 2]
        cost += (cfg.w_trans * d**2 + cfg.w_orient * oe**2) / n
        cost += cfg.w_control * np.linalg.norm(scen.current_vel - cmd[i]) / n

        if pc == 1.0:
            cost += costmap_cost * 1000.0 / n
        else:
            cost += cfg.w_costmap * costmap_cost / n

        if fp_cost == 1.0:
            cost += (fp_cost**2) * cfg.w_footprint / n

    term_d = np.linalg.norm(carrot_xy - scen.goal_pose[:2])
    term_o = final_yaw - body[-1, 2]
    cost += (cfg.w_trans * term_d**2 + cfg.w_orient * term_o**2) * cfg.w_terminal
    return float(cost)


class OracleServer:
    """State machine mirroring MpcOptimizationServer.optimizer (py:349-403):
    SLSQP solve → low-pass (first control only) → collision / stuck-wait →
    acceleration clamp → warm-start shift. Wall-clock is an explicit input."""

    def __init__(self, cfg: MpcConfig):
        # The oracle IS the reference: every §2.3 quirk except buggy_odom_yaw
        # is hardcoded here (lethal ×1000, unsquared control norm, unwrapped
        # angles, carrot-aliased terminal, 3.0 s stuck threshold). Validating
        # a config that disables any of those against this oracle would
        # silently assert against the wrong ground truth — reject up front
        # (round-5 review). Product-mode configs cross-check through
        # solver.make_solver / the quality gates instead, never the oracle.
        c = cfg.compat
        unsupported = [name for name, ref_val in (
            ("footprint_alias_noop", True), ("lethal_1000x", True),
            ("unsquared_control_cost", True), ("no_angle_wrap", True),
            ("hardcoded_stuck_wait", True)) if getattr(c, name) is not ref_val]
        if unsupported:
            raise ValueError(
                "OracleServer reproduces the reference exactly; it cannot "
                f"model compat overrides {unsupported} — use the engine's "
                "product-mode gates for non-parity configs")
        self.cfg = cfg
        n = cfg.control_steps
        self.bnds = []
        self.cons = []
        for i in range(n):
            self.bnds.append((cfg.min_vel_x, cfg.max_vel_x))
            self.bnds.append((cfg.min_vel_y, cfg.max_vel_y))
            self.bnds.append((cfg.min_vel_theta, cfg.max_vel_theta))
            # per-step translational-speed cone (py:157-158, :134)
            self.cons.append(
                {
                    "type": "ineq",
                    "fun": (lambda x, idx=i: cfg.max_vel_trans
                            - np.sqrt(x[idx * 3] ** 2 + x[idx * 3 + 1] ** 2)),
                }
            )
        self.initial_guess = np.zeros(n * 3)
        self.last_control = np.zeros(3)
        self.waiting_time = 0.0
        self.collision = False
        self.collision_footprint = False
        self.old_goal: Optional[np.ndarray] = None

    def _collision_check(self, x: np.ndarray, scen: NpScenario):
        """py:312-347 — correct-yaw odom rollout, point cost >= 0.99 =>
        collision (sticky); current footprint == 1.0 => collision_footprint."""
        odom = _rollout_np(x.reshape(-1, 3), self.cfg.dt, scen.current_pose.copy())
        for i in range(self.cfg.control_steps):
            if scen.costmap.get_cost_world(odom[i, 0], odom[i, 1]) >= 0.99:
                self.collision = True
                break
        fp = scen.costmap.footprint_cost(
            _placed_footprint(scen), self.cfg.footprint_edge_samples,
            exact=self.cfg.footprint_exact
        )
        self.collision_footprint = fp == 1.0

    def solve(self, scen: NpScenario, delta_t: float):
        cfg = self.cfg
        n = cfg.control_steps

        # New-goal reset (py:357-361).
        if self.old_goal is None or not np.array_equal(self.old_goal, scen.goal_pose):
            self.initial_guess = np.zeros(n * 3)
            self.last_control = np.zeros(3)
            self.waiting_time = 0.0

        fp_cost = scen.costmap.footprint_cost(
            _placed_footprint(scen), cfg.footprint_edge_samples,
            exact=cfg.footprint_exact
        )
        res = minimize(
            oracle_objective,
            self.initial_guess,
            args=(scen, cfg, fp_cost),
            method="SLSQP",
            bounds=self.bnds,
            constraints=self.cons,
            options={"ftol": cfg.opt_tolerance, "disp": False},
        )
        x = res.x.copy()

        # Low-pass on the first control only (py:366-367).
        for i in range(3):
            x[i] = x[i] * cfg.low_pass_gain + self.last_control[i] * (1 - cfg.low_pass_gain)

        self._collision_check(x, scen)

        out = np.zeros(3)
        if self.collision or self.collision_footprint:
            self.waiting_time += delta_t
            if self.waiting_time >= 3.0:  # hardcoded threshold (py:380)
                self.collision = False
                self.waiting_time = 0.0
        else:
            # Acceleration clamp around last_control (py:384-391) using the
            # REQUEST's control interval (py:355).
            ci = (scen.control_interval if scen.control_interval is not None
                  else cfg.control_interval)
            lim = np.array([cfg.acc_x_limit, cfg.acc_y_limit, cfg.acc_theta_limit]) * ci
            out = np.fmax(np.fmin(x[:3], self.last_control + lim), self.last_control - lim)

        self.last_control = out.copy()

        # Warm start (py:397-400): shift-left on success (first entry is the
        # LOW-PASSED first control, wrapped to the back), else the raw solution.
        if res.success:
            g = self.initial_guess
            for i in range(n - 1):
                g[3 * i : 3 * i + 3] = x[3 * (i + 1) : 3 * (i + 1) + 3]
            g[3 * (n - 1) :] = x[0:3]
        else:
            self.initial_guess = x.copy()

        self.old_goal = scen.goal_pose.copy()
        return out, {
            "raw": res.x,
            "filtered_first": x[:3].copy(),
            "success": bool(res.success),
            "collision": self.collision,
            "collision_footprint": self.collision_footprint,
            "waiting_time": self.waiting_time,
            "fun": float(res.fun),
            "nit": int(res.nit),
        }
