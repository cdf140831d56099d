"""Checkpoint / resume of the control state (port of `checkpoint.py`).

The reference's control-loop memory (initial_guess py:136, last_control
py:117, waiting_time py:361, old_goal py:146) is lost on restart. Here a
`ControlState`, one lane or a batch of lanes, round-trips through one .npz
file whose arrays are named by its fields, the layout the JAX package
writes: a checkpoint saved by either package loads into the other. The JAX
package's orbax path (a directory) is JAX-only and is refused here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .engine import ControlState

__all__ = ["save_state", "load_state"]

# Derived, not hand-listed, so that a new ControlState field round-trips.
_FIELDS = [f.name for f in dataclasses.fields(ControlState)]


def _npz(path: str) -> str:
    path = str(path)
    if not path.endswith(".npz"):
        raise ValueError(f"checkpoint path {path!r} must name a .npz file "
                         "(the JAX package's orbax directories are JAX-only)")
    return path


def save_state(path: str, state: ControlState) -> None:
    """Write `state` to the .npz file `path`, one array a field."""
    np.savez(_npz(path), **{f: getattr(state, f).detach().cpu().numpy()
                            for f in _FIELDS})


def load_state(path: str, template=None, device="cuda") -> ControlState:
    """Inverse of save_state: the state in the .npz file `path`, on
    `device` (the card unless the caller asks for the CPU). template:
    accepted for the JAX package's signature; an .npz load needs none."""
    del template
    with np.load(_npz(path)) as z:
        return ControlState(**{f: torch.as_tensor(z[f], device=device)
                               for f in _FIELDS})
