"""Footprint polygon collision cost, sampled modes (port of `ops/footprint.py`).

Every polygon edge, the closing edge included, is sampled at `samples`
equally spaced points; the max nearest-cell cost over the valid edges is the
footprint cost (Costmap2d.getFootprintCost / footprintCostAtPose). The
polygon is padded to a fixed vertex count with a valid count, so footprints
of different robots batch together. Exact (cell-walk) mode is not ported yet.
On a rolling-window view the samples read the world map through the window,
as world_to_map and cost_at_cell do there.

The batched cost is `footprint_cost_batch`: the CUDA kernel K3
(`csrc/footprint_cost.cu`) for CUDA tensors, `footprint_cost_batch_plain`
for CPU tensors. The cost is piecewise constant in the pose (integer cell
indices), so its gradient is zero, as in JAX: it is computed on detached
inputs and never requires grad.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from ..kernels import binding
from .costmap import Costmap, _lane, cost_at_cell, grid_origin, world_to_map
from .se2 import se2_apply

__all__ = ["Footprint", "transform_footprint", "edge_parameters",
           "footprint_cost_batch", "footprint_cost_batch_plain",
           "footprint_cost", "kernel_map_arguments", "footprint_cost_at_pose"]


@dataclasses.dataclass
class Footprint:
    """Padded polygon. vertices: (*lead, V, 2); n_valid: (*lead,) int32."""

    vertices: torch.Tensor
    n_valid: torch.Tensor

    def replace(self, **kw) -> "Footprint":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def create(points, max_vertices: int = 8,
               device="cuda") -> "Footprint":
        pts = torch.as_tensor(points, dtype=torch.float32, device=device)
        n = pts.shape[0]
        if n > max_vertices:
            raise ValueError(f"footprint has {n} vertices > max {max_vertices}")
        pad = pts[-1:].expand(max_vertices - n, 2)
        return Footprint(vertices=torch.cat([pts, pad], dim=0),
                         n_valid=torch.tensor(n, dtype=torch.int32,
                                              device=pts.device))

    @staticmethod
    def rectangle(length: float, width: float, max_vertices: int = 8,
                  device="cuda") -> "Footprint":
        """Axis-aligned rectangle centered on base_link."""
        hl, hw = length / 2.0, width / 2.0
        return Footprint.create([[hl, hw], [-hl, hw], [-hl, -hw], [hl, -hw]],
                                max_vertices, device)


def transform_footprint(pose: torch.Tensor, fp: Footprint) -> Footprint:
    """Place the footprint at pose (*lead, 3)."""
    return fp.replace(vertices=se2_apply(pose[..., None, :], fp.vertices))


def edge_parameters(samples: int, device="cuda") -> torch.Tensor:
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


@functools.lru_cache(maxsize=None)
def _edge_parameters_on(samples: int, device: torch.device) -> torch.Tensor:
    """edge_parameters built once on the CPU and kept on `device`, so that
    a call on the card copies nothing from the host. Read-only."""
    return edge_parameters(samples, "cpu").to(device)


# The widths K3 is built and tested for (vertices a polygon, samples an
# edge); its shared memory also bounds R·V a lane (binding.k3_smem_bytes).
K3_MAX_VERTICES = 16
K3_MAX_SAMPLES = 64


def footprint_cost_batch_plain(data, origin, res, bounds, verts, n_valid, t,
                               shift=None):
    """Plain PyTorch version of K3, the reference the kernel is held to.

    data (Bm, H, W), origin (Bm, 2), res (Bm,), bounds (Bm, 4) int32
    (lo_x, lo_y, hi_x, hi_y) inside the grid or None for the whole grid,
    verts (Bm, R, V, 2) placed polygons, n_valid (Bm, R) int32, t (S,) edge
    parameters, shift (Bm, 2) int32 (col, row) cells or None -> (Bm, R):
    per polygon, the max over the valid edges of the nearest-cell cost at
    p = s + (e - s)·t, cell floor((p - o) / res) + shift, lethal outside
    the bounds. A view passes its window's origin, its window as bounds and
    win_lo as shift."""
    V = verts.shape[-2]
    idx = torch.arange(V, dtype=torch.int32, device=verts.device)
    nv = n_valid[..., None]                                    # (Bm, R, 1)
    nxt = torch.remainder(idx + 1, nv).long()                  # (Bm, R, V)
    ends = torch.gather(verts, -2, nxt[..., None].expand(verts.shape))
    pts = (verts[..., :, None, :]
           + (ends - verts)[..., :, None, :] * t[:, None])     # (Bm,R,V,S,2)
    cm = Costmap(data=data, origin=origin, resolution=res)
    mx, my = world_to_map(cm, pts[..., 0], pts[..., 1])
    if shift is not None:
        mx = mx + _lane(shift[:, 0], mx)
        my = my + _lane(shift[:, 1], my)
    costs = cost_at_cell(cm, mx, my, bounds)
    costs = torch.where((idx < nv)[..., None], costs, -torch.inf)
    return costs.amax(dim=(-2, -1))


def _check_kernel_inputs(data, origin, res, bounds, verts, n_valid, t,
                         shift=None):
    Bm, H, W = data.shape
    R, V = verts.shape[1], verts.shape[2]
    named = dict(data=data, origin=origin, res=res, bounds=bounds,
                 shift=shift, verts=verts, n_valid=n_valid, t=t)
    shapes = dict(data=(Bm, H, W), origin=(Bm, 2), res=(Bm,), bounds=(Bm, 4),
                  shift=(Bm, 2), verts=(Bm, R, V, 2), n_valid=(Bm, R),
                  t=(t.shape[0],))
    for name, a in named.items():
        if a is None:
            continue
        want = (torch.int32 if name in ("bounds", "shift", "n_valid")
                else torch.float32)
        if a.device != data.device:
            raise ValueError("footprint_cost_batch: operands on different "
                             "devices")
        if a.dtype != want:
            raise TypeError(f"footprint_cost_batch: {name} must be {want}, "
                            f"got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"footprint_cost_batch: {name} must be "
                             "contiguous")
        if tuple(a.shape) != shapes[name]:
            raise ValueError(f"footprint_cost_batch: {name} has shape "
                             f"{tuple(a.shape)}, expected {shapes[name]}")
    if V > K3_MAX_VERTICES or t.shape[0] > K3_MAX_SAMPLES:
        raise ValueError(f"footprint_cost_batch: the kernel takes at most "
                         f"{K3_MAX_VERTICES} vertices and {K3_MAX_SAMPLES} "
                         f"samples, got {V} and {t.shape[0]}")
    if H * W >= 2 ** 31 or max(H, W) >= 2 ** 24:
        raise ValueError("footprint_cost_batch: map too large for int32 "
                         "cell indices or float32 cell bounds")
    lanes, _ = binding.k3_launch_shape(R)
    if binding.k3_smem_bytes(R, V, t.shape[0], lanes) > binding.K3_MAX_SMEM:
        raise ValueError(f"footprint_cost_batch: {R} polygons of {V} "
                         "vertices a lane do not fit a block's shared memory")


def footprint_cost_batch(data, origin, res, bounds, verts, n_valid, t,
                         shift=None):
    """Batched footprint boundary max-cost (arguments as in
    footprint_cost_batch_plain): kernel K3 for CUDA tensors, the plain
    version for CPU tensors; anything else raises. R polygons of a lane
    share its map, which is read in place."""
    if data.device.type == "cpu":
        return footprint_cost_batch_plain(data, origin, res, bounds, verts,
                                          n_valid, t, shift)
    if data.device.type != "cuda":
        raise ValueError(f"footprint_cost_batch: unsupported device "
                         f"{data.device}")
    _check_kernel_inputs(data, origin, res, bounds, verts, n_valid, t, shift)
    if verts.shape[0] * verts.shape[1] == 0:
        return verts.new_empty(verts.shape[:2])
    out = binding.launch_footprint_cost(data, origin, res, bounds, verts,
                                        n_valid, t, shift)
    footprint_cost_batch.launches += 1
    return out


footprint_cost_batch.launches = 0


def footprint_cost(cm: Costmap, fp: Footprint, samples: int = 32,
                   mode: str = "gather",
                   bounds: "torch.Tensor | None" = None) -> torch.Tensor:
    """Max cost along the polygon boundary. Edges run i -> (i + 1) mod
    n_valid; padded vertices start no edge.

    The polygons' leading dims start with the map's (*lead) and may carry
    more after them (a wave's candidates and steps): each polygon reads its
    lane's map. bounds: optional (*lead, 4) int32 rectangle inside the grid
    (a ProductPatchSampler's); samples outside it read lethal. On a view
    the samples read through its window (K3 with the window's origin, the
    window as bounds and win_lo as shift); a view takes no bounds, as no
    patch sampler is built on one. Returns the polygons' leading shape,
    without gradient."""
    if mode == "exact":
        raise NotImplementedError(
            "footprint_exact (cell walk) is not ported yet (ROADMAP.md)")
    if mode not in ("gather", "onehot"):
        raise ValueError(f"unknown footprint sampling mode {mode!r}")
    lead = cm.data.shape[:-2]
    verts = fp.vertices.detach()
    poly = verts.shape[:-2]
    if poly[:len(lead)] != lead:
        raise ValueError(f"footprint_cost: polygons {tuple(poly)} do not "
                         f"start with the map's lead dims {tuple(lead)}")
    Bm = math.prod(lead)
    H, W, V = cm.data.shape[-2], cm.data.shape[-1], verts.shape[-2]
    origin, bounds, shift = kernel_map_arguments(cm, bounds)
    flat = lambda a, *tail: (None if a is None else a.expand(
        lead + tail).reshape((Bm,) + tail).contiguous())
    out = footprint_cost_batch(
        cm.data.reshape(Bm, H, W), flat(origin, 2), flat(cm.resolution),
        flat(bounds, 4), verts.reshape(Bm, -1, V, 2).contiguous(),
        torch.broadcast_to(fp.n_valid, poly).reshape(Bm, -1).to(
            torch.int32).contiguous(),
        _edge_parameters_on(samples, verts.device), flat(shift, 2))
    return out.reshape(poly)


def kernel_map_arguments(cm: Costmap, bounds=None):
    """K3's per-lane map arguments for `cm`: (origin (*lead, 2), bounds
    (*lead, 4) int32 or None, shift (*lead, 2) int32 or None). For a view:
    the window's origin (grid_origin), the window's rectangle in
    world-frame cells, and win_lo; a view takes no other bounds."""
    if cm.win_cells is None:
        return cm.origin, bounds, None
    if bounds is not None:
        raise ValueError("footprint_cost: a rolling-window view takes no "
                         "bounds rectangle")
    shift = cm.win_lo.to(torch.int32)
    return (torch.stack(grid_origin(cm), dim=-1),
            torch.cat([shift, shift + cm.win_cells], dim=-1), shift)


def footprint_cost_at_pose(cm: Costmap, fp: Footprint, pose: torch.Tensor,
                           samples: int = 32, mode: str = "gather"):
    """footprintCostAtPose (NeoMpcPlanner.cpp:218-219), normalized scale."""
    return footprint_cost(cm, transform_footprint(pose, fp), samples, mode)
