"""neo_mpc_planner2_tpu_torch — the MPC engine in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (H100).

A port of `neo_mpc_planner2_tpu` (JAX/Pallas), which stays the reference.
This package imports no JAX. Its first slice is the fleet closed-loop tick:
`simulation.batch_simulate` on a static map through
`engine.make_batched_controller_step` and the parity SQP solver, whose QP
runs in the CUDA kernel `csrc/qp_admm.cu` on the card.
"""

import torch as _torch

# The reference computes its exact picks at Precision.HIGHEST: no TF32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .config import (CompatConfig, MpcConfig, config_from_ros_params,
                     default_config, fleet_config, product_config)
from .engine import (ControlState, MpcEngine, StepResult, init_state,
                     make_batched_controller_step)
from .ops.costmap import Costmap, cost_at_world
from .ops.footprint import Footprint, footprint_cost, transform_footprint
from .ops.objective import Scenario, make_objective, objective_parity
from .ops.pursuit import Plan, PursuitResult, pursuit_tick
from .ops.rollout import rollout
from .scenarios import ScenarioBatch, make_scenario_batch
from .simulation import SimResult, batch_simulate
from .solver import SolveResult
from .sqp import (chol_inverse, make_sqp_solver, make_sqp_solver_batched,
                  qp_admm, sqp_solve)

__all__ = [
    "CompatConfig", "MpcConfig", "config_from_ros_params", "default_config",
    "fleet_config", "product_config",
    "ControlState", "MpcEngine", "StepResult", "init_state",
    "make_batched_controller_step",
    "Costmap", "cost_at_world", "Footprint", "footprint_cost",
    "transform_footprint", "Scenario", "make_objective", "objective_parity",
    "Plan", "PursuitResult", "pursuit_tick", "rollout",
    "ScenarioBatch", "make_scenario_batch", "SimResult", "batch_simulate",
    "SolveResult", "chol_inverse", "make_sqp_solver",
    "make_sqp_solver_batched", "qp_admm", "sqp_solve",
]
