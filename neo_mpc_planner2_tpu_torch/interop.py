"""Carry the JAX package's inputs and state over to the port.

The engine has no learned weights: its configuration, maps, plans,
footprints and warm-start state are its parameters. Each function here takes
a container of numpy leaves — a dict, or any object with the same attribute
names, such as the JAX package's dataclass after
`jax.tree.map(np.asarray, ...)` — and returns the port's tensors on
`device`: the card unless the caller asks for the CPU (device="cpu").
This module imports no JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .engine import ControlState
from .ops.costmap import Costmap
from .ops.footprint import Footprint
from .ops.objective import Limits, Weights
from .ops.pursuit import Plan
from .scenarios import ScenarioBatch

__all__ = ["costmap_from_numpy", "plan_from_numpy", "footprint_from_numpy",
           "control_state_from_numpy", "scenario_batch_from_numpy",
           "weights_from_numpy", "limits_from_numpy"]


def _get(src, name):
    if isinstance(src, Mapping):
        return src.get(name)
    return getattr(src, name, None)


def _t(a, device):
    if a is None:
        return None
    return torch.as_tensor(np.array(a, copy=True), device=device)


def costmap_from_numpy(src, device="cuda") -> Costmap:
    """data, origin, resolution (+ optional flat, flat_u8, and a
    rolling-window view's win_lo and win_cells)."""
    win_cells = _get(src, "win_cells")
    return Costmap(data=_t(_get(src, "data"), device),
                   origin=_t(_get(src, "origin"), device),
                   resolution=_t(_get(src, "resolution"), device),
                   flat=_t(_get(src, "flat"), device),
                   flat_u8=_t(_get(src, "flat_u8"), device),
                   win_lo=_t(_get(src, "win_lo"), device),
                   win_cells=None if win_cells is None else int(win_cells))


def plan_from_numpy(src, device="cuda") -> Plan:
    return Plan(px=_t(_get(src, "px"), device), py=_t(_get(src, "py"), device),
                pyaw=_t(_get(src, "pyaw"), device),
                n_valid=_t(_get(src, "n_valid"), device))


def footprint_from_numpy(src, device="cuda") -> Footprint:
    return Footprint(vertices=_t(_get(src, "vertices"), device),
                     n_valid=_t(_get(src, "n_valid"), device))


def control_state_from_numpy(src, device="cuda") -> ControlState:
    return ControlState(**{name: _t(_get(src, name), device)
                           for name in ControlState.__dataclass_fields__})


def scenario_batch_from_numpy(src, device="cuda") -> ScenarioBatch:
    return ScenarioBatch(
        state=control_state_from_numpy(_get(src, "state"), device),
        plan=plan_from_numpy(_get(src, "plan"), device),
        robot_pose=_t(_get(src, "robot_pose"), device),
        current_vel=_t(_get(src, "current_vel"), device),
        costmap=costmap_from_numpy(_get(src, "costmap"), device),
        footprint=footprint_from_numpy(_get(src, "footprint"), device),
        delta_t=_t(_get(src, "delta_t"), device))


def weights_from_numpy(src, device="cuda") -> Weights:
    """w_trans, w_orient, w_control, w_terminal, w_costmap, w_footprint
    (e.g. a JAX Weights.grid): each () or (B,)."""
    return Weights(**{name: _t(_get(src, name), device)
                      for name in Weights.__dataclass_fields__})


def limits_from_numpy(src, device="cuda") -> Limits:
    """vel_lo, vel_hi, max_vel_trans, acc (e.g. a JAX Limits.scaled)."""
    return Limits(**{name: _t(_get(src, name), device)
                     for name in Limits.__dataclass_fields__})
