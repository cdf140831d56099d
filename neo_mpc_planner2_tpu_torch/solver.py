"""Solver result type (port of `solver.py`'s SolveResult; the prox-FISTA
solver of product mode is not ported yet)."""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["SolveResult"]


class SolveResult(NamedTuple):
    x: torch.Tensor          # (B, 3N) solution
    fun: torch.Tensor        # (B,) final objective
    converged: torch.Tensor  # (B,) bool — scipy's x.success analogue
    iters: torch.Tensor      # (B,) int32
