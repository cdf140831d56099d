"""Footprint polygon collision cost, sampled modes (port of `ops/footprint.py`).

Every polygon edge, the closing edge included, is sampled at `samples`
equally spaced points; the max nearest-cell cost over the valid edges is the
footprint cost (Costmap2d.getFootprintCost / footprintCostAtPose). The
polygon is padded to a fixed vertex count with a valid count, so footprints
of different robots batch together. Exact (cell-walk) mode is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from .costmap import Costmap, cost_at_world
from .se2 import se2_apply

__all__ = ["Footprint", "transform_footprint", "edge_parameters",
           "footprint_cost", "footprint_cost_at_pose"]


@dataclasses.dataclass
class Footprint:
    """Padded polygon. vertices: (*lead, V, 2); n_valid: (*lead,) int32."""

    vertices: torch.Tensor
    n_valid: torch.Tensor

    def replace(self, **kw) -> "Footprint":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def create(points, max_vertices: int = 8, device=None) -> "Footprint":
        pts = torch.as_tensor(points, dtype=torch.float32, device=device)
        n = pts.shape[0]
        if n > max_vertices:
            raise ValueError(f"footprint has {n} vertices > max {max_vertices}")
        pad = pts[-1:].expand(max_vertices - n, 2)
        return Footprint(vertices=torch.cat([pts, pad], dim=0),
                         n_valid=torch.tensor(n, dtype=torch.int32,
                                              device=device))

    @staticmethod
    def rectangle(length: float, width: float, max_vertices: int = 8,
                  device=None) -> "Footprint":
        """Axis-aligned rectangle centered on base_link."""
        hl, hw = length / 2.0, width / 2.0
        return Footprint.create([[hl, hw], [-hl, hw], [-hl, -hw], [hl, -hw]],
                                max_vertices, device)


def transform_footprint(pose: torch.Tensor, fp: Footprint) -> Footprint:
    """Place the footprint at pose (*lead, 3)."""
    return fp.replace(vertices=se2_apply(pose[..., None, :], fp.vertices))


def edge_parameters(samples: int, device=None) -> torch.Tensor:
    """The sample positions along an edge, bit-equal to the JAX package's
    `jnp.linspace(0, 1, samples)`: XLA computes i / (samples - 1) as
    i * f32(1 / (samples - 1)), then appends an exact 1. `torch.linspace`
    builds the second half from the end; either rounding differs in the
    last ulp, which moves samples across cell boundaries."""
    f32 = dict(dtype=torch.float32, device=device)
    if samples == 1:
        return torch.zeros(1, **f32)
    recip = torch.tensor(1.0, **f32) / torch.tensor(float(samples - 1), **f32)
    t = torch.arange(samples - 1, **f32) * recip
    return torch.cat([t, torch.ones(1, **f32)])


def footprint_cost(cm: Costmap, fp: Footprint, samples: int = 32,
                   mode: str = "gather", sample_fn=None) -> torch.Tensor:
    """Max cost along the polygon boundary, (*lead,). Edges run
    i -> (i + 1) mod n_valid; padded vertices start no edge."""
    if mode == "exact":
        raise NotImplementedError(
            "footprint_exact (cell walk) is not ported yet (ROADMAP.md)")
    if mode not in ("gather", "onehot"):
        raise ValueError(f"unknown footprint sampling mode {mode!r}")
    verts = fp.vertices
    V = verts.shape[-2]
    idx = torch.arange(V, dtype=torch.int32, device=verts.device)
    nv = fp.n_valid[..., None]
    nxt = torch.remainder(idx + 1, nv).long()                 # (*lead, V)
    ends = torch.gather(verts, -2, nxt[..., None].expand(verts.shape))
    edge_valid = idx < nv                                     # (*lead, V)
    t = edge_parameters(samples, verts.device)
    pts = (verts[..., :, None, :]
           + (ends - verts)[..., :, None, :] * t[:, None])    # (*lead, V, S, 2)
    sample = sample_fn if sample_fn is not None else (
        lambda wx, wy: cost_at_world(cm, wx, wy))
    costs = sample(pts[..., 0], pts[..., 1])                  # (*lead, V, S)
    costs = torch.where(edge_valid[..., None], costs, -torch.inf)
    return costs.amax(dim=(-2, -1))


def footprint_cost_at_pose(cm: Costmap, fp: Footprint, pose: torch.Tensor,
                           samples: int = 32, mode: str = "gather"):
    """footprintCostAtPose (NeoMpcPlanner.cpp:218-219), normalized scale."""
    return footprint_cost(cm, transform_footprint(pose, fp), samples, mode)
