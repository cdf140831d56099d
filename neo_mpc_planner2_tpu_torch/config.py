"""Configuration of the MPC engine (PyTorch port).

A copy of the JAX package's `config.py`, not an import of it: importing any
module of `neo_mpc_planner2_tpu` initializes JAX, and the port must run where
JAX is not installed. Field names, defaults and presets are held equal to the
reference by `tests/test_torch_config.py`.

Field names match the reference ROS parameters:

- the 22 optimization-server parameters (mpc_optimization_server.py:49-75);
- the 3 plugin lookahead parameters + controller_frequency
  (NeoMpcPlanner.cpp:311-323).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

__all__ = ["CompatConfig", "MpcConfig", "default_config", "fleet_config",
           "product_config", "config_from_ros_params"]


@dataclasses.dataclass(frozen=True)
class CompatConfig:
    """Flags reproducing reference quirks for oracle parity; every flag
    defaults to the reference-faithful behaviour."""

    # py:213 — current-pose yaw computed with the GOAL pose's quaternion w.
    buggy_odom_yaw: bool = True
    # py:227,238-244 — footprint term evaluated on the untransformed current
    # footprint (a per-solve constant).
    footprint_alias_noop: bool = True
    # py:257-260 — an exactly-lethal point cost is scaled by 1000.
    lethal_1000x: bool = True
    # py:253-254 — control cost uses the norm, not the squared norm.
    unsquared_control_cost: bool = True
    # py:251,267 — orientation errors are not wrapped.
    no_angle_wrap: bool = True
    # py:380 — stuck-wait threshold is the literal 3.0 s.
    hardcoded_stuck_wait: bool = True


@dataclasses.dataclass(frozen=True)
class MpcConfig:
    """All tunables of the engine. Field names match the reference ROS params.

    The engine-only solver knobs are documented in the JAX package's
    `config.py`; the port accepts the same values and raises
    NotImplementedError for the ones whose code paths it does not carry yet
    (see ROADMAP.md)."""

    # --- acceleration limits (py:49-51) ---
    acc_x_limit: float = 0.5
    acc_y_limit: float = 0.5
    acc_theta_limit: float = 0.5

    # --- velocity bounds (py:53-61) ---
    min_vel_x: float = -0.5
    min_vel_y: float = -0.5
    min_vel_trans: float = 0.5  # declared but unused by the reference (py:55)
    min_vel_theta: float = -0.5
    max_vel_x: float = 0.5
    max_vel_y: float = 0.5
    max_vel_trans: float = 0.5
    max_vel_theta: float = 0.5

    # --- cost weights (py:63-68) ---
    w_trans: float = 0.5
    w_orient: float = 0.5
    w_control: float = 0.5
    w_terminal: float = 0.5
    w_costmap: float = 0.5
    w_footprint: float = 2000.0

    # --- control post-processing (py:70-72) ---
    waiting_time: float = 3.0
    low_pass_gain: float = 0.5
    opt_tolerance: float = 1e-5

    # --- horizon (py:73-75) ---
    prediction_horizon: float = 0.5
    control_steps: int = 3

    # --- plugin params (cpp:311-323) ---
    lookahead_dist_min: float = 0.5
    lookahead_dist_max: float = 0.5
    lookahead_dist_close_to_goal: float = 0.5
    controller_frequency: float = 30.0

    # --- engine-only knobs (no reference equivalent) ---
    solver_max_iters: int = 40
    qp_iters: int = 60
    parallel_line_search: bool = False
    projection_iters: int = 20
    max_footprint_vertices: int = 8
    footprint_edge_samples: int = 32
    max_plan_points: int = 128
    # "gather" or "onehot"; both are one nearest-cell gather in the port.
    costmap_sampling: str = "gather"
    footprint_exact: bool = False
    solver_costmap_patch: int = 0
    solver_patch_exact_picks: bool = True
    solver_costmap_u8: "bool | str" = False
    solver_compact_after: int = 0
    solver_compact_frac: float = 0.0625
    solver_compact_min_batch: int = 256
    solver_compact_adaptive: bool = False
    solver_ls_wave: int = 1
    solver_ls_backtrack: float = 0.5
    solver_max_backtracks: int = 16
    solver_ls_coarse_after: int = 0
    solver_ls_coarse_factor: float = 0.25
    solver_ls_warm_alpha: bool = False
    solver_ls_quad_interp: bool = False
    compat: CompatConfig = dataclasses.field(default_factory=CompatConfig)

    @property
    def dt(self) -> float:
        """Integration interval (py:137)."""
        return self.prediction_horizon / self.control_steps

    @property
    def control_interval(self) -> float:
        """Service-request control interval (cpp:246)."""
        return 1.0 / self.controller_frequency

    @property
    def footprint_mode(self) -> str:
        """Sampling mode string for ops.footprint.footprint_cost."""
        return "exact" if self.footprint_exact else self.costmap_sampling

    def replace(self, **kw: Any) -> "MpcConfig":
        return dataclasses.replace(self, **kw)


_ROS_ALIASES = {
    "control_steps": "control_steps",
    "w_costmap": "w_costmap",
    "w_footprint": "w_footprint",
}


def default_config() -> MpcConfig:
    """Library default: the reference's parameter defaults with full solver
    fidelity (max_iters=40, single-phase Armijo)."""
    return MpcConfig()


def fleet_config() -> MpcConfig:
    """The fleet operating point: iteration cap 8, two-phase Armijo
    (max_backtracks=7, coarse_after=2, factor 1/16), u8 gather source for
    maps of at least 128² cells, quadratic-interpolation backtracking."""
    return MpcConfig(
        solver_max_iters=8,
        solver_max_backtracks=7,
        solver_ls_coarse_after=2,
        solver_ls_coarse_factor=0.0625,
        solver_costmap_u8="auto",
        solver_ls_quad_interp=True,
    )


def product_config() -> MpcConfig:
    """The product-mode operating point: every reference quirk off, on the
    fleet preset, with the parallel candidate-wave line search. The port does
    not run product mode yet (ROADMAP.md); the preset is carried so configs
    round-trip."""
    base = fleet_config()
    return base.replace(
        parallel_line_search=True,
        solver_ls_quad_interp=False,
        solver_patch_exact_picks=False,
        compat=dataclasses.replace(
            base.compat, buggy_odom_yaw=False, footprint_alias_noop=False,
            lethal_1000x=False, unsquared_control_cost=False,
            no_angle_wrap=False),
    )


def config_from_ros_params(params: Mapping[str, Any],
                           base: "MpcConfig | None" = None) -> MpcConfig:
    """Build a config from a flat dict using the reference's ROS parameter
    names. Unknown keys are ignored. With `base`, only the named parameters
    are replaced (cb_params semantics, py:405-439)."""
    field_types = {f.name: f.type for f in dataclasses.fields(MpcConfig)}
    kw = {}
    for key, value in params.items():
        name = _ROS_ALIASES.get(key, key)
        if name in field_types and name != "compat":
            # YAML 1.1 parses "1e-3" as a string; rclpy coerces it, so do we.
            t = str(field_types[name])
            if isinstance(value, str) and "float" in t:
                value = float(value)
            elif isinstance(value, str) and "int" in t:
                value = int(float(value))
            kw[name] = value
    if base is not None:
        return dataclasses.replace(base, **kw)
    return MpcConfig(**kw)
