"""neo_mpc_planner2_tpu_torch — the MPC engine in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (H100).

A port of `neo_mpc_planner2_tpu` (JAX/Pallas), which stays the reference.
This package imports no JAX. It runs the closed loop
(`simulation.batch_simulate` through `engine.make_batched_controller_step`
and the batched SQP solver) in both modes: the parity objective
(`fleet_config`) and the smooth product objective with the candidate-wave
line search (`product_config`, parity=False), and with the prox-FISTA
solver of `solver.py` in its place (`make_solver_batched`, passed as
`solver_batch`); on a static map or a live one: a rolling window
(`rolling_view`), dynamic obstacles, or incremental map updates; with
sampled footprint edges or the exact cell walk (`footprint_exact`). One
robot's tick is `controller_step` / `solve_step`, and `NeoMpcController`
its nav2_core::Controller lifecycle in-process (the whole tick on the
device, or with `native_geometry=True` the C++ host's pursuit and the solve
on the device); `serving` is the JSON optimization server (`cli` its
console script, `ros_adapter` its rclpy node) and `checkpoint` saves and
loads the control state.
On the card the QP runs in the CUDA kernel `csrc/qp_admm.cu`, every
footprint cost in `csrc/footprint_cost.cu` (its sampled or its walk mode),
and `sqp.chol_inverse` in `csrc/spd_inv.cu`.
"""

import torch as _torch

# The reference computes its exact picks at Precision.HIGHEST: no TF32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .config import (CompatConfig, MpcConfig, config_from_ros_params,
                     default_config, fleet_config, product_config)
from .controller import ControllerException, NeoMpcController
from .engine import (ControlState, MpcEngine, StepResult, controller_step,
                     init_state, make_batched_controller_step, solve_step)
from .ops.costmap import Costmap, cost_at_world, cost_at_world_bilinear
from .ops.footprint import (Footprint, footprint_cost, footprint_cost_at_pose,
                            transform_footprint)
from .ops.objective import (Scenario, Weights, make_objective,
                            objective_parity, objective_product)
from .ops.pursuit import Plan, PursuitResult, pursuit_tick
from .ops.rollout import rollout
from .scenarios import ScenarioBatch, make_scenario_batch
from .simulation import (SimResult, batch_simulate, rolling_view,
                         rolling_window, simulate_follow_path)
from .solver import (SolveResult, make_solver, make_solver_batched,
                     project_feasible, prox_fista, prox_g)
from .sqp import (chol_inverse, make_sqp_solver, make_sqp_solver_batched,
                  qp_admm, sqp_solve)

__all__ = [
    "CompatConfig", "MpcConfig", "config_from_ros_params", "default_config",
    "fleet_config", "product_config",
    "ControllerException", "NeoMpcController",
    "ControlState", "MpcEngine", "StepResult", "controller_step",
    "init_state", "make_batched_controller_step", "solve_step",
    "Costmap", "cost_at_world", "cost_at_world_bilinear", "Footprint",
    "footprint_cost", "footprint_cost_at_pose", "transform_footprint",
    "Scenario", "Weights", "make_objective", "objective_parity",
    "objective_product",
    "Plan", "PursuitResult", "pursuit_tick", "rollout",
    "ScenarioBatch", "make_scenario_batch", "SimResult", "batch_simulate",
    "rolling_view", "rolling_window", "simulate_follow_path",
    "SolveResult", "make_solver", "make_solver_batched", "project_feasible",
    "prox_fista", "prox_g", "chol_inverse", "make_sqp_solver",
    "make_sqp_solver_batched", "qp_admm", "sqp_solve",
]
