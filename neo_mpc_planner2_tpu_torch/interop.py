"""Carry the JAX package's inputs and state over to the port.

The engine has no learned weights: its configuration, maps, plans,
footprints and warm-start state are its parameters. Each function here takes
a container of numpy leaves — a dict, or any object with the same attribute
names, such as the JAX package's dataclass after
`jax.tree.map(np.asarray, ...)` — and returns the port's tensors on
`device`. This module imports no JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .engine import ControlState
from .ops.costmap import Costmap
from .ops.footprint import Footprint
from .ops.pursuit import Plan
from .scenarios import ScenarioBatch

__all__ = ["costmap_from_numpy", "plan_from_numpy", "footprint_from_numpy",
           "control_state_from_numpy", "scenario_batch_from_numpy"]


def _get(src, name):
    if isinstance(src, Mapping):
        return src.get(name)
    return getattr(src, name, None)


def _t(a, device):
    if a is None:
        return None
    return torch.as_tensor(np.array(a, copy=True), device=device)


def costmap_from_numpy(src, device=None) -> Costmap:
    """data, origin, resolution (+ optional flat, flat_u8). A rolling-window
    view (win_cells set) is refused: the port has no such regime yet."""
    if _get(src, "win_cells") is not None:
        raise NotImplementedError("rolling-window views are not ported yet")
    return Costmap(data=_t(_get(src, "data"), device),
                   origin=_t(_get(src, "origin"), device),
                   resolution=_t(_get(src, "resolution"), device),
                   flat=_t(_get(src, "flat"), device),
                   flat_u8=_t(_get(src, "flat_u8"), device))


def plan_from_numpy(src, device=None) -> Plan:
    return Plan(px=_t(_get(src, "px"), device), py=_t(_get(src, "py"), device),
                pyaw=_t(_get(src, "pyaw"), device),
                n_valid=_t(_get(src, "n_valid"), device))


def footprint_from_numpy(src, device=None) -> Footprint:
    return Footprint(vertices=_t(_get(src, "vertices"), device),
                     n_valid=_t(_get(src, "n_valid"), device))


def control_state_from_numpy(src, device=None) -> ControlState:
    return ControlState(**{name: _t(_get(src, name), device)
                           for name in ControlState.__dataclass_fields__})


def scenario_batch_from_numpy(src, device=None) -> ScenarioBatch:
    return ScenarioBatch(
        state=control_state_from_numpy(_get(src, "state"), device),
        plan=plan_from_numpy(_get(src, "plan"), device),
        robot_pose=_t(_get(src, "robot_pose"), device),
        current_vel=_t(_get(src, "current_vel"), device),
        costmap=costmap_from_numpy(_get(src, "costmap"), device),
        footprint=footprint_from_numpy(_get(src, "footprint"), device),
        delta_t=_t(_get(src, "delta_t"), device))
