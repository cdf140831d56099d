"""Device-resident 2-D costmap, main-path half (port of `ops/costmap.py`).

Costs are normalized to [0, 1] with 1.0 = lethal. Out-of-bounds queries read
lethal. `world_to_map` divides by the resolution and floors, as nav2's
Costmap2D::worldToMap does behind its wx >= origin guard: the band
(origin - resolution, origin) maps to index -1 and reads lethal.

Batching is written out: a costmap's `data` is (*lead, H, W) with `origin`
(*lead, 2) and `resolution` (*lead,); every query tensor starts with the same
`lead` dims and may carry any number of sample dims after them. The JAX
package's one-hot samplers exist because a TPU has no vector gather; on the
GPU both sampling modes are the same flat gather.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Costmap", "LETHAL_COST", "U8_AUTO_MIN_CELLS", "u8_source_enabled",
           "grid_bounds", "grid_origin", "world_to_map", "cost_at_cell",
           "cost_at_world", "cost_at_world_onehot", "make_point_sampler"]

LETHAL_COST = 1.0
# solver_costmap_u8="auto" turns the u8 source on from this many cells up
# (the JAX package's crossover; not yet measured on the GPU).
U8_AUTO_MIN_CELLS = 128 * 128


def u8_source_enabled(solver_costmap_u8, cells: int) -> bool:
    """Resolve cfg.solver_costmap_u8 against the gather source's cell count."""
    if solver_costmap_u8 == "auto":
        return int(cells) >= U8_AUTO_MIN_CELLS
    return bool(solver_costmap_u8)


def _lane(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Append singleton dims so a per-lane value broadcasts against `like`,
    whose leading dims are the lane dims of `v`."""
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


@dataclasses.dataclass
class Costmap:
    """Normalized costmap grid.

    data: (*lead, H, W) float32; row = y cell, col = x cell.
    origin: (*lead, 2) world coordinates of the (0, 0) cell corner.
    resolution: (*lead,) meters per cell.
    flat / flat_u8: optional cached (*lead, H*W) views (with_flat).
    win_lo / win_cells: the rolling-window view of the JAX package; the port
    does not run that regime yet and keeps both None.
    """

    data: torch.Tensor
    origin: torch.Tensor
    resolution: torch.Tensor
    flat: "torch.Tensor | None" = None
    flat_u8: "torch.Tensor | None" = None
    win_lo: "torch.Tensor | None" = None
    win_cells: "int | None" = None

    def replace(self, **kw) -> "Costmap":
        return dataclasses.replace(self, **kw)

    def with_flat(self, u8: bool = False) -> "Costmap":
        """Cache the flat view, and with u8=True its raw-scale uint8
        companion (decoded as u8/255.0 by the solver's sampler)."""
        h, w = self.data.shape[-2], self.data.shape[-1]
        flat = self.data.reshape(self.data.shape[:-2] + (h * w,))
        flat_u8 = None
        if u8:
            flat_u8 = torch.round(flat * 255.0).clamp(0.0, 255.0).to(
                torch.uint8)
        return self.replace(flat=flat, flat_u8=flat_u8)

    @staticmethod
    def create(data, origin=(0.0, 0.0), resolution=0.05,
               device=None) -> "Costmap":
        if isinstance(resolution, (int, float)) and resolution <= 0:
            raise ValueError(f"resolution must be positive: {resolution}")
        f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
        return Costmap(data=f(data), origin=f(origin), resolution=f(resolution))

    @property
    def shape(self):
        return self.data.shape

    def extent_world(self) -> torch.Tensor:
        """Half extent used by plan pruning (NeoMpcPlanner.cpp:80-82)."""
        if self.win_cells is not None:
            raise NotImplementedError(
                "rolling-window views are not ported yet (ROADMAP.md)")
        h, w = self.data.shape[-2], self.data.shape[-1]
        return max(h, w) * self.resolution / 2.0

    def _flat(self) -> torch.Tensor:
        if self.flat is not None:
            return self.flat
        h, w = self.data.shape[-2], self.data.shape[-1]
        return self.data.reshape(self.data.shape[:-2] + (h * w,))


def grid_bounds(cm: Costmap):
    """The in-bounds cell rectangle [lo_x, hi_x) x [lo_y, hi_y)."""
    if cm.win_cells is not None:
        raise NotImplementedError(
            "rolling-window views are not ported yet (ROADMAP.md)")
    h, w = cm.data.shape[-2], cm.data.shape[-1]
    return 0, 0, w, h


def grid_origin(cm: Costmap):
    """(ox, oy) grid origin for index math, each (*lead,)."""
    if cm.win_cells is not None:
        raise NotImplementedError(
            "rolling-window views are not ported yet (ROADMAP.md)")
    return cm.origin[..., 0], cm.origin[..., 1]


def world_to_map(cm: Costmap, wx: torch.Tensor, wy: torch.Tensor):
    """World -> int32 cell indices: floor((w - origin) / resolution).
    Raw (possibly out-of-range) indices; cost_at_cell applies the bounds."""
    ox, oy = grid_origin(cm)
    res = _lane(cm.resolution, wx)
    mx = torch.floor((wx - _lane(ox, wx)) / res).to(torch.int32)
    my = torch.floor((wy - _lane(oy, wy)) / res).to(torch.int32)
    return mx, my


def _gather_flat(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat[(*lead), idx[(*lead), ...]] as one gather over the lane's row."""
    lead = flat.dim() - 1
    got = torch.gather(flat, -1, idx.long().flatten(lead))
    return got.reshape(idx.shape)


def _in_bounds_clipped(cm: Costmap, mx, my):
    h, w = cm.data.shape[-2], cm.data.shape[-1]
    lo_x, lo_y, hi_x, hi_y = grid_bounds(cm)
    inb = (mx >= lo_x) & (mx < hi_x) & (my >= lo_y) & (my < hi_y)
    return inb, mx.clamp(0, w - 1), my.clamp(0, h - 1)


def cost_at_cell(cm: Costmap, mx: torch.Tensor, my: torch.Tensor):
    """Cell cost with lethal out-of-bounds (Costmap2d.getCost, py:247)."""
    w = cm.data.shape[-1]
    inb, mxc, myc = _in_bounds_clipped(cm, mx, my)
    val = _gather_flat(cm._flat(), myc * w + mxc)
    return torch.where(inb, val, LETHAL_COST)


def cost_at_world(cm: Costmap, wx: torch.Tensor, wy: torch.Tensor):
    """Nearest-cell world lookup (getWorldToMap + getCost, py:246-247)."""
    mx, my = world_to_map(cm, wx, wy)
    return cost_at_cell(cm, mx, my)


# The JAX package's one-hot sampler computes the same picks with matrix
# contractions; on the GPU it is the gather.
cost_at_world_onehot = cost_at_world


def make_point_sampler(cm: Costmap, cx=None, cy=None,
                       patch_halfwidth: int = 0):
    """The solver-loop point sampler: one gather from the cached flat map,
    or from its uint8 companion decoded as u8/255.0 when one is cached.
    (cx, cy) centre the patch sampler of the JAX package, not ported yet."""
    if patch_halfwidth > 0:
        raise NotImplementedError(
            "solver_costmap_patch is not ported yet (ROADMAP.md)")
    flat = cm._flat()
    flat_q = cm.flat_u8
    w = cm.data.shape[-1]
    inv255 = flat.new_tensor(255.0)

    def sample(wx, wy):
        mx, my = world_to_map(cm, wx, wy)
        inb, mxc, myc = _in_bounds_clipped(cm, mx, my)
        idx = myc * w + mxc
        if flat_q is not None:
            # A tensor divisor: CUDA turns division by a Python scalar
            # into a multiply by its reciprocal, which is not bit-exact.
            val = _gather_flat(flat_q, idx).to(torch.float32) / inv255
        else:
            val = _gather_flat(flat, idx)
        return torch.where(inb, val, LETHAL_COST)

    return sample
