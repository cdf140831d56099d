"""Device-resident 2-D costmap (port of `ops/costmap.py`).

Costs are normalized to [0, 1] with 1.0 = lethal. Out-of-bounds queries read
lethal. `world_to_map` divides by the resolution and floors, as nav2's
Costmap2D::worldToMap does behind its wx >= origin guard: the band
(origin - resolution, origin) maps to index -1 and reads lethal.

Batching is written out: a costmap's `data` is (*lead, H, W) with `origin`
(*lead, 2) and `resolution` (*lead,); every query tensor starts with the same
`lead` dims and may carry any number of sample dims after them. The JAX
package's one-hot samplers exist because a TPU has no vector gather; on the
GPU both sampling modes are the same flat gather.

The JAX package's per-solve patches (`extract_patch`, `extract_patch_onehot`)
copy a window of the map so that its TPU loops contract over the window.
Their values are the contract: a read inside map ∩ window returns the map
value, any other read is lethal. Here a patch is that rectangle, per lane,
as int32 `bounds` (lo_x, lo_y, hi_x, hi_y) with hi exclusive, and a read is
the gather from the full map masked by it. No window is copied. The JAX
package's patch values themselves (`CostmapPatch`, `extract_patch`,
`extract_patch_onehot`, `patch_cost_at_*`) are here too, as gathers, for
callers of its public names; the port's own paths never build one.

A rolling-window view (nav2's rolling local costmap) is the world map with
`win_lo` (*lead, 2) int32 and `win_cells` set: every sampler reads the
world map in place, and a cell outside the (win_cells)² rectangle at
`win_lo` reads lethal. The index math runs against the window's origin,
origin + f32(win_lo)·resolution, and shifts back by win_lo, so that a view
samples bit for bit what the materialized window (simulation.rolling_window)
samples. The JAX package's window reads and writes are one-hot matrix
products (`extract_window_onehot`, the canvas of `update_window`) because a
TPU has no vector gather and its scatters serialize; here they are a gather
and an indexed write of the same values.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["Costmap", "CostmapPatch", "LETHAL_COST", "U8_AUTO_MIN_CELLS",
           "occupancy_to_cost",
           "u8_source_enabled", "grid_bounds", "grid_origin", "world_to_map",
           "cost_at_cell", "cost_at_cells_onehot", "extract_window",
           "extract_window_onehot", "write_window_", "cost_at_world",
           "cost_at_world_onehot", "extract_patch", "extract_patch_onehot",
           "patch_cost_at_cells", "patch_cost_at_world",
           "patch_cost_at_world_bilinear", "patch_bounds",
           "product_patch_bounds", "make_point_sampler",
           "cost_at_world_bilinear",
           "required_patch_halfwidth", "required_product_patch_halfwidth",
           "ProductPatchSampler"]

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
    flat / flat_u8: optional cached (*lead, H*W) views (with_flat). `flat`
    is a view of `data` (a reshape shares its storage), so an in-place
    write to one is a write to the other; `flat_u8` is a copy.
    win_lo / win_cells: a rolling-window view (simulation.rolling_view):
    the (*lead, 2) int32 (col, row) corner of the window and its side in
    cells, or both None for the whole grid.
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

    def update_window(self, cells, lo) -> "Costmap":
        """A new costmap with the (h, w) block `cells` (*lead, h, w) written
        at the lower cell corner lo = (col, row) (*lead, 2) of each lane,
        and the cached flat views refreshed over the written cells. NaN and
        +Inf cells are written as 1.0 (lethal), -Inf as 0.0; the corner is
        clamped so the block lies on the grid; a block larger than the map
        raises ValueError. This map's tensors are left as they were. A view
        writes its world map in world-frame cells."""
        data = self.data.clone()
        out = self.replace(
            data=data,
            flat=None if self.flat is None else data.reshape(
                data.shape[:-2] + (-1,)),
            flat_u8=None if self.flat_u8 is None else self.flat_u8.clone())
        write_window_(out, cells, lo)
        return out

    @staticmethod
    def create(data, origin=(0.0, 0.0), resolution=0.05,
               device="cuda") -> "Costmap":
        if isinstance(resolution, (int, float)) and resolution <= 0:
            raise ValueError(f"resolution must be positive: {resolution}")
        # Contiguous, as K3 reads it: a transposed grid arrives as a view.
        f = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                      device=device).contiguous()
        return Costmap(data=f(data), origin=f(origin), resolution=f(resolution))

    @staticmethod
    def from_nav2_costmap(raw, origin=(0.0, 0.0), resolution=0.05,
                          inscribed_is_lethal: bool = False,
                          device="cuda") -> "Costmap":
        """From the raw nav2 Costmap2D 0-255 scale (the C++ plugin's world,
        NeoMpcPlanner.cpp:218/234): each value over 255, so only 255
        (LETHAL_OBSTACLE / NO_INFORMATION) is exactly 1.0. Raw 254
        (INSCRIBED_INFLATED) maps to 254/255: it trips the predicted-
        collision latch (>= 0.99, py:338) but not the lethal gates (== 1.0,
        py:257/262, cpp:234), as in the reference. inscribed_is_lethal=True
        folds 254 into 1.0 too (the conservative choice)."""
        raw = torch.as_tensor(raw, device=device)
        norm = raw.to(torch.float32) / 255.0
        if inscribed_is_lethal:
            norm = torch.where(raw >= 254, 1.0, norm)
        return Costmap.create(norm, origin, resolution, device)

    @staticmethod
    def from_occupancy_grid(grid, origin=(0.0, 0.0), resolution=0.05,
                            unknown_is_lethal: bool = True,
                            device="cuda") -> "Costmap":
        """From a nav_msgs/OccupancyGrid payload (int8: 0..100 occupancy,
        -1 unknown), by occupancy_to_cost: 100 -> 1.0 lethal, unknown
        lethal by default (nav2's conservative convention) or free."""
        return Costmap.create(occupancy_to_cost(grid, unknown_is_lethal),
                              origin, resolution, device)

    @property
    def shape(self):
        return self.data.shape

    def extent_world(self) -> torch.Tensor:
        """Half extent used by plan pruning (NeoMpcPlanner.cpp:80-82); for a
        view, the window's."""
        if self.win_cells is not None:
            return self.win_cells * self.resolution / 2.0
        h, w = self.data.shape[-2], self.data.shape[-1]
        return max(h, w) * self.resolution / 2.0

    def _flat(self) -> torch.Tensor:
        if self.flat is not None:
            return self.flat
        h, w = self.data.shape[-2], self.data.shape[-1]
        return self.data.reshape(self.data.shape[:-2] + (h * w,))


def occupancy_to_cost(grid, unknown_is_lethal: bool = True):
    """OccupancyGrid values (-1 unknown, 0..100 occupancy) as a float32
    numpy array of normalized cost: occupancy / 100 clipped to [0, 1],
    unknown 1.0 (lethal) or 0.0. The one conversion of the port: the
    costmap constructor and the ROS adapter's topic callback both use it."""
    import numpy as np

    g = np.asarray(grid, dtype=np.float32)
    return np.where(g < 0, np.float32(1.0 if unknown_is_lethal else 0.0),
                    np.clip(g / 100.0, 0.0, 1.0)).astype(np.float32)


def grid_bounds(cm: Costmap):
    """The in-bounds cell rectangle [lo_x, hi_x) x [lo_y, hi_y) in
    world-frame cells: Python ints for the whole grid, (*lead,) int32
    tensors for a view's window."""
    if cm.win_cells is None:
        h, w = cm.data.shape[-2], cm.data.shape[-1]
        return 0, 0, w, h
    lo_x, lo_y = cm.win_lo[..., 0], cm.win_lo[..., 1]
    return lo_x, lo_y, lo_x + cm.win_cells, lo_y + cm.win_cells


def grid_origin(cm: Costmap):
    """(ox, oy) grid origin for index math, each (*lead,): for a view the
    window's, origin + f32(win_lo)·resolution (a multiply, then an add: the
    expression a materialized window's origin carries)."""
    ox, oy = cm.origin[..., 0], cm.origin[..., 1]
    if cm.win_cells is not None:
        lo = cm.win_lo.to(torch.float32)
        ox = ox + lo[..., 0] * cm.resolution
        oy = oy + lo[..., 1] * cm.resolution
    return ox, oy


def world_to_map(cm: Costmap, wx: torch.Tensor, wy: torch.Tensor):
    """World -> int32 cell indices: floor((w - origin) / resolution), for a
    view against the window's origin and shifted back by win_lo. Raw
    (possibly out-of-range) world-frame indices; cost_at_cell applies the
    bounds."""
    ox, oy = grid_origin(cm)
    res = _lane(cm.resolution, wx)
    mx = torch.floor((wx - _lane(ox, wx)) / res).to(torch.int32)
    my = torch.floor((wy - _lane(oy, wy)) / res).to(torch.int32)
    if cm.win_cells is not None:
        mx = mx + _lane(cm.win_lo[..., 0], mx)
        my = my + _lane(cm.win_lo[..., 1], my)
    return mx, my


def _gather_flat(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat[(*lead), idx[(*lead), ...]] as one gather over the lane's row."""
    lead = flat.dim() - 1
    got = torch.gather(flat, -1, idx.long().flatten(lead))
    return got.reshape(idx.shape)


def _in_bounds_clipped(cm: Costmap, mx, my, bounds=None):
    """In-bounds mask of cells (mx, my) against the grid (a view's window),
    or against a bounds rectangle (*lead, 4) inside it, and the cells
    clamped onto the grid."""
    h, w = cm.data.shape[-2], cm.data.shape[-1]
    rect = grid_bounds(cm) if bounds is None else bounds.unbind(-1)
    lo_x, lo_y, hi_x, hi_y = (_lane(v, mx) if torch.is_tensor(v) else v
                              for v in rect)
    inb = (mx >= lo_x) & (mx < hi_x) & (my >= lo_y) & (my < hi_y)
    return inb, mx.clamp(0, w - 1), my.clamp(0, h - 1)


def cost_at_cell(cm: Costmap, mx: torch.Tensor, my: torch.Tensor,
                 bounds: "torch.Tensor | None" = None):
    """Cell cost with lethal out-of-bounds (Costmap2d.getCost, py:247).
    bounds: optional (*lead, 4) rectangle inside the grid (a patch); cells
    outside it read lethal too."""
    w = cm.data.shape[-1]
    inb, mxc, myc = _in_bounds_clipped(cm, mx, my, bounds)
    val = _gather_flat(cm._flat(), myc * w + mxc)
    return torch.where(inb, val, LETHAL_COST)


def cost_at_world(cm: Costmap, wx: torch.Tensor, wy: torch.Tensor):
    """Nearest-cell world lookup (getWorldToMap + getCost, py:246-247)."""
    mx, my = world_to_map(cm, wx, wy)
    return cost_at_cell(cm, mx, my)


# The JAX package's one-hot samplers compute the same picks with matrix
# contractions; on the GPU they are the gathers.
cost_at_world_onehot = cost_at_world
cost_at_cells_onehot = cost_at_cell


def _window_index(row, col, hc: int, wc: int, w: int) -> torch.Tensor:
    """Flat indices (*lead, hc * wc) of the (hc, wc) block at (row, col)
    of a grid w cells wide, row-major."""
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=row.device)
    idx = ((row.long()[..., None] + ar(hc))[..., :, None] * w
           + (col.long()[..., None] + ar(wc))[..., None, :])
    return idx.flatten(-2)


def extract_window(data: torch.Tensor, row, col, hc: int,
                   wc: int) -> torch.Tensor:
    """The (hc, wc) window of `data` (*lead, H, W) whose corner is
    (row, col), each (*lead,): (*lead, hc, wc). The JAX package's
    `extract_window_onehot`, as one gather, with lax.dynamic_slice's
    semantics: a negative index wraps from the end, then the corner is
    clamped to [0, dim - size]."""
    hh, ww = data.shape[-2], data.shape[-1]
    lead = data.shape[:-2]
    as_idx = lambda v: torch.as_tensor(v, dtype=torch.int32,
                                       device=data.device).expand(lead)
    row, col = as_idx(row), as_idx(col)
    row = torch.where(row < 0, row + hh, row).clamp(0, hh - hc)
    col = torch.where(col < 0, col + ww, col).clamp(0, ww - wc)
    flat = data.reshape(lead + (hh * ww,))
    got = torch.gather(flat, -1, _window_index(row, col, hc, wc, ww))
    return got.reshape(lead + (hc, wc))


# The JAX package's gather-free window read; here the gather.
extract_window_onehot = extract_window


def write_window_(cm: Costmap, cells, lo) -> None:
    """Write the block `cells` (*lead, h, w) at each lane's corner
    lo = (col, row) (*lead, 2) into `cm` IN PLACE: its data (and so its
    flat view, which must be a view of data as with_flat makes it) and its
    flat_u8, encoded round(x·255) clamped to [0, 255] over the written
    cells only. NaN and +Inf cells are written as 1.0, -Inf as 0.0; the
    corner is clamped once so that every view takes the same cells; a block
    larger than the map raises ValueError. Costmap.update_window is the
    form that leaves its map as it was."""
    hh, ww = cm.data.shape[-2], cm.data.shape[-1]
    lead = cm.data.shape[:-2]
    cells = torch.as_tensor(cells, dtype=cm.data.dtype, device=cm.data.device)
    hc, wc = cells.shape[-2], cells.shape[-1]
    if hc > hh or wc > ww:
        raise ValueError(f"update block {(hc, wc)} exceeds the map "
                         f"{(hh, ww)}")
    cells = torch.nan_to_num(cells, nan=1.0, posinf=1.0, neginf=0.0)
    cells = cells.expand(lead + (hc, wc)).reshape(lead + (hc * wc,))
    lo = torch.as_tensor(lo, dtype=torch.int32,
                         device=cm.data.device).expand(lead + (2,))
    col = lo[..., 0].clamp(0, ww - wc)
    row = lo[..., 1].clamp(0, hh - hc)
    idx = _window_index(row, col, hc, wc, ww)
    cm.data.view(lead + (hh * ww,)).scatter_(-1, idx, cells)
    if cm.flat_u8 is not None:
        enc = torch.round(cells * 255.0).clamp(0.0, 255.0).to(torch.uint8)
        cm.flat_u8.scatter_(-1, idx, enc)


def _window_bounds(cm: Costmap, c0x, c0y, size: int) -> torch.Tensor:
    """map ∩ [c0x, c0x + size) x [c0y, c0y + size), (*lead, 4) int32. An
    empty intersection has lo >= hi, and every read through it is lethal."""
    h, w = cm.data.shape[-2], cm.data.shape[-1]
    return torch.stack([c0x.clamp_min(0), c0y.clamp_min(0),
                        (c0x + size).clamp_max(w), (c0y + size).clamp_max(h)],
                       dim=-1).to(torch.int32)


def patch_bounds(cm: Costmap, cx, cy, halfwidth: int) -> torch.Tensor:
    """The parity patch of the JAX package's `extract_patch`: the window
    [s - h, s + h]² around the centre cell s clamped onto the map."""
    h, w = cm.data.shape[-2], cm.data.shape[-1]
    mx0, my0 = world_to_map(cm, cx, cy)
    return _window_bounds(cm, mx0.clamp(0, w - 1) - halfwidth,
                          my0.clamp(0, h - 1) - halfwidth, 2 * halfwidth + 1)


def product_patch_bounds(cm: Costmap, cx, cy, halfwidth: int) -> torch.Tensor:
    """The product patch of the JAX package's `extract_patch_onehot`: the
    window [c - h, c + h]² around the centre cell c, unclamped."""
    mx0, my0 = world_to_map(cm, cx, cy)
    return _window_bounds(cm, mx0 - halfwidth, my0 - halfwidth,
                          2 * halfwidth + 1)


def make_point_sampler(cm: Costmap, cx=None, cy=None,
                       patch_halfwidth: int = 0):
    """The solver-loop point sampler: one gather from the cached flat map,
    or from its uint8 companion decoded as u8/255.0 when one is cached.
    patch_halfwidth > 0 reads through the parity patch around (cx, cy)
    instead, from the float32 map as the JAX package's patch does; a view
    refuses it, as in the JAX package."""
    if patch_halfwidth > 0:
        if cm.win_cells is not None:
            raise ValueError(
                "solver_costmap_patch is not supported on a rolling-window "
                "VIEW costmap (the patch would read world cells outside the "
                "window without the lethal out-of-window policy); use the "
                "materializing rolling_window slice instead")
        bounds = patch_bounds(cm, cx, cy, patch_halfwidth)

        def sample_patch(wx, wy):
            mx, my = world_to_map(cm, wx, wy)
            return cost_at_cell(cm, mx, my, bounds)

        return sample_patch
    flat = cm._flat()
    flat_q = cm.flat_u8
    w = cm.data.shape[-1]
    inv255 = flat.new_full((), 255.0)

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


def _bilinear_setup(cm: Costmap, wx: torch.Tensor, wy: torch.Tensor):
    """World point -> the int32 cell of its lower-left neighbour and the
    fractional weights (cell-centre sampling), in the JAX package's float
    order; for a view, against the window's origin, then shifted back to
    world-frame cells. floor has a zero gradient; tx and ty carry it."""
    ox, oy = grid_origin(cm)
    res = _lane(cm.resolution, wx)
    fx = (wx - _lane(ox, wx)) / res - 0.5
    fy = (wy - _lane(oy, wy)) / res - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    x0i, y0i = x0.to(torch.int32), y0.to(torch.int32)
    if cm.win_cells is not None:
        x0i = x0i + _lane(cm.win_lo[..., 0], x0i)
        y0i = y0i + _lane(cm.win_lo[..., 1], y0i)
    return x0i, y0i, fx - x0, fy - y0


def cost_at_world_bilinear(cm: Costmap, wx: torch.Tensor, wy: torch.Tensor,
                           bounds: "torch.Tensor | None" = None):
    """Bilinear world-coordinate sampling (product mode), smooth in (wx, wy).
    The four neighbours are one gather; with `bounds`, through that
    rectangle (ProductPatchSampler)."""
    x0, y0, tx, ty = _bilinear_setup(cm, wx, wy)
    mx = torch.stack([x0, x0 + 1, x0, x0 + 1], dim=-1)
    my = torch.stack([y0, y0, y0 + 1, y0 + 1], dim=-1)
    c = cost_at_cell(cm, mx, my, bounds)
    c00, c10, c01, c11 = c.unbind(-1)
    top = c00 * (1.0 - tx) + c10 * tx
    bot = c01 * (1.0 - tx) + c11 * tx
    return top * (1.0 - ty) + bot * ty


@dataclasses.dataclass
class CostmapPatch:
    """The JAX package's per-solve window of a costmap.

    data: (*lead, P, P), P = 2·halfwidth + 1, the map's values inside the
    grid and lethal outside it. cell0: (*lead, 2) int32, the full-map
    (col, row) cell of data[..., 0, 0] (negative near the map's low edge).
    """

    data: torch.Tensor
    cell0: torch.Tensor

    def replace(self, **kw) -> "CostmapPatch":
        return dataclasses.replace(self, **kw)


def _patch_at(cm: Costmap, c0x, c0y, size: int) -> CostmapPatch:
    """The (size, size) window whose corner cell is (c0x, c0y), each
    (*lead,), as one gather: map values inside the grid of `data`, lethal
    outside (the JAX package's patches index `data`, a view's world map
    included, without the view's window)."""
    h, w = cm.data.shape[-2], cm.data.shape[-1]
    lead = cm.data.shape[:-2]
    ar = torch.arange(size, dtype=torch.int32, device=cm.data.device)
    rows = c0y[..., None] + ar
    cols = c0x[..., None] + ar
    valid = (((rows >= 0) & (rows < h))[..., :, None]
             & ((cols >= 0) & (cols < w))[..., None, :])
    idx = (rows.clamp(0, h - 1).long()[..., :, None] * w
           + cols.clamp(0, w - 1).long()[..., None, :])
    vals = torch.gather(cm.data.reshape(lead + (h * w,)), -1,
                        idx.flatten(-2)).reshape(lead + (size, size))
    return CostmapPatch(data=torch.where(valid, vals, LETHAL_COST),
                        cell0=torch.stack([c0x, c0y], -1).to(torch.int32))


def extract_patch(cm: Costmap, cx, cy, halfwidth: int) -> CostmapPatch:
    """The JAX package's `extract_patch`: the (2h+1)² window around the
    world point (cx, cy), each (*lead,), its centre cell clamped onto the
    map (the slice of the map padded with a lethal ring of width h)."""
    h, w = cm.data.shape[-2], cm.data.shape[-1]
    mx0, my0 = world_to_map(cm, cx, cy)
    return _patch_at(cm, mx0.clamp(0, w - 1) - halfwidth,
                     my0.clamp(0, h - 1) - halfwidth, 2 * halfwidth + 1)


def extract_patch_onehot(cm: Costmap, cx, cy, halfwidth: int) -> CostmapPatch:
    """The JAX package's `extract_patch_onehot`: the (2h+1)² window around
    the centre cell of (cx, cy), unclamped, lethal outside the grid."""
    mx0, my0 = world_to_map(cm, cx, cy)
    return _patch_at(cm, mx0 - halfwidth, my0 - halfwidth,
                     2 * halfwidth + 1)


def patch_cost_at_cells(patch: CostmapPatch, mx, my,
                        exact: bool = True) -> torch.Tensor:
    """Nearest-cell read by full-map cell indices (*lead, ...) through a
    patch, lethal outside it. `exact` is the JAX package's switch to a
    single bf16 matmul pass on a TPU; a gather picks the value itself
    either way, as the JAX package's CPU path does."""
    del exact
    size = patch.data.shape[-1]
    lead = patch.data.shape[:-2]
    ix = mx - _lane(patch.cell0[..., 0], mx)
    iy = my - _lane(patch.cell0[..., 1], my)
    inb = (ix >= 0) & (ix < size) & (iy >= 0) & (iy < size)
    idx = iy.clamp(0, size - 1) * size + ix.clamp(0, size - 1)
    val = _gather_flat(patch.data.reshape(lead + (size * size,)), idx)
    return torch.where(inb, val, LETHAL_COST)


def patch_cost_at_world(cm: Costmap, patch: CostmapPatch, wx, wy):
    """Nearest-cell world lookup through a patch: world_to_map, then
    patch_cost_at_cells."""
    mx, my = world_to_map(cm, wx, wy)
    return patch_cost_at_cells(patch, mx, my)


def patch_cost_at_world_bilinear(cm: Costmap, patch: CostmapPatch, wx, wy,
                                 exact: bool = True):
    """cost_at_world_bilinear through a patch: the same index and weight
    math, the four neighbours read by patch_cost_at_cells."""
    x0, y0, tx, ty = _bilinear_setup(cm, wx, wy)
    mx = torch.stack([x0, x0 + 1, x0, x0 + 1], dim=-1)
    my = torch.stack([y0, y0, y0 + 1, y0 + 1], dim=-1)
    c00, c10, c01, c11 = patch_cost_at_cells(patch, mx, my, exact).unbind(-1)
    top = c00 * (1.0 - tx) + c10 * tx
    bot = c01 * (1.0 - tx) + c11 * tx
    return top * (1.0 - ty) + bot * ty


def required_patch_halfwidth(cfg, resolution: float) -> int:
    """Cells the rollout can traverse from the start cell: the box-bound
    translational speed times the horizon, in cells, plus one for the
    floor-boundary crossing."""
    vx = max(abs(cfg.min_vel_x), abs(cfg.max_vel_x))
    vy = max(abs(cfg.min_vel_y), abs(cfg.max_vel_y))
    v = math.sqrt(vx * vx + vy * vy)
    return int(math.ceil(v * cfg.prediction_horizon / float(resolution))) + 1


def required_product_patch_halfwidth(cfg, resolution: float,
                                     footprint_radius_m: float) -> int:
    """Patch halfwidth for the product objective's sampler: the rollout
    reach, plus the footprint's circumradius in cells, plus one cell for the
    bilinear +1 neighbour."""
    return (required_patch_halfwidth(cfg, resolution)
            + int(math.ceil(footprint_radius_m / float(resolution))) + 1)


class ProductPatchSampler:
    """Per-solve sampler of the product objective: every bilinear point cost
    and every footprint boundary sample of one solve reads the map through
    the window of `halfwidth` cells around the lane's centre (cx, cy),
    lethal outside it. `bounds` (*lead, 4) is that window ∩ the grid, which
    footprint_cost takes as is. exact: the JAX package's pick precision
    for its one-hot contractions (solver_patch_exact_picks); accepted and
    without effect, as the port's reads are exact gathers."""

    def __init__(self, cm: Costmap, cx, cy, halfwidth: int,
                 exact: bool = True):
        self.exact = exact
        if cm.win_cells is not None:
            raise ValueError(
                "product patch sampling is not supported on a rolling-window "
                "view costmap; leave solver_costmap_patch=0 for views")
        self.cm = cm
        self.bounds = product_patch_bounds(cm, cx, cy, halfwidth)

    def bilinear(self, wx, wy):
        return cost_at_world_bilinear(self.cm, wx, wy, self.bounds)

    def nearest(self, wx, wy):
        mx, my = world_to_map(self.cm, wx, wy)
        return cost_at_cell(self.cm, mx, my, self.bounds)
