"""Footprint polygon collision cost (port of `ops/footprint.py`).

The footprint cost is the max cell cost along the polygon's valid edges,
the closing edge included (Costmap2d.getFootprintCost /
footprintCostAtPose). Two ways to read an edge:

- sampled ("gather"/"onehot"): `samples` equally spaced points an edge, the
  nearest cell of each;
- exact: an Amanatides-Woo walk that visits every cell the edge crosses
  (`line_cost_exact`, the JAX package's fixed-length scan as a loop that
  stops once every edge is done).

The polygon is padded to a fixed vertex count with a valid count, so
footprints of different robots batch together. On a rolling-window view
both read the world map through the window, as world_to_map and
cost_at_cell do there.

The batched costs are `footprint_cost_batch` (sampled) and
`footprint_walk_batch` (exact): the CUDA kernel K3 (`csrc/footprint_cost.cu`,
its sampled or its walk mode) for CUDA tensors, the plain versions for CPU
tensors. The cost is piecewise constant in the pose (integer cell indices),
so its gradient is zero, as in JAX: it is computed on detached inputs and
never requires grad.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from ..kernels import binding
from .costmap import (LETHAL_COST, Costmap, _gather_flat, _lane, cost_at_cell,
                      grid_origin, world_to_map)
from .se2 import se2_apply

__all__ = ["Footprint", "transform_footprint", "edge_parameters",
           "required_edge_samples", "footprint_cost_batch",
           "footprint_cost_batch_plain", "line_cost_exact",
           "footprint_walk_batch", "footprint_walk_batch_plain",
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


def required_edge_samples(points, resolution: float, minimum: int = 8) -> int:
    """Samples an edge so that the sampled modes' spacing stays at or below
    the map resolution on every edge of the (host-side) polygon: the safe
    count for footprint_cost's sampled modes (a fixed count under-samples
    long edges and skips cells the reference's LineIterator visits)."""
    import numpy as np

    pts = np.asarray(points, float)
    edges = np.roll(pts, -1, axis=0) - pts
    max_edge = float(np.max(np.linalg.norm(edges, axis=-1)))
    return max(minimum, int(np.ceil(max_edge / float(resolution))) + 2)


# The widths K3 is built and tested for (vertices a polygon, samples an
# edge); its shared memory also bounds R·V a lane (binding.k3_smem_bytes).
# The walk mode takes the same vertex limit.
K3_MAX_VERTICES = 16
K3_MAX_SAMPLES = 64


def _edges(verts, n_valid):
    """Each polygon's edge ends (verts rolled by one within its n_valid
    vertices) and the valid-edge mask, (Bm, R, V)."""
    V = verts.shape[-2]
    idx = torch.arange(V, dtype=torch.int32, device=verts.device)
    nv = n_valid[..., None]
    nxt = torch.remainder(idx + 1, nv).long()
    ends = torch.gather(verts, -2, nxt[..., None].expand(verts.shape))
    return ends, idx < nv


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
    ends, valid = _edges(verts, n_valid)                      # (Bm, R, V)
    pts = (verts[..., :, None, :]
           + (ends - verts)[..., :, None, :] * t[:, None])     # (Bm,R,V,S,2)
    cm = Costmap(data=data, origin=origin, resolution=res)
    mx, my = world_to_map(cm, pts[..., 0], pts[..., 1])
    if shift is not None:
        mx = mx + _lane(shift[:, 0], mx)
        my = my + _lane(shift[:, 1], my)
    costs = cost_at_cell(cm, mx, my, bounds)
    costs = torch.where(valid[..., None], costs, -torch.inf)
    return costs.amax(dim=(-2, -1))


def _walk(data, origin, res, bounds, shift, x0, y0, x1, y1, live=None,
          record=None):
    """The Amanatides-Woo walk of segments (x0, y0) -> (x1, y1), each
    (Bm, *seg), segment of lane b on the map data[b] (Bm, H, W): the max
    cost over every cell the segment crosses, lethal outside the bounds
    rectangle (bounds (Bm, 4) int32 or None for the grid) and 1.0 folded in
    when the end cell lies outside it. origin (Bm, 2) is the origin the
    cells are floored against and shift (Bm, 2) int32 or None the cells
    added to them (a view's window origin and win_lo, as K3 takes them).

    The float arithmetic is the JAX package's line_cost_exact op for op:
    the boundary o + f32(local cell + (d > 0))·res, t_max = (edge - p0)/d,
    t_delta = res/|d|, a tie takes the y step, a crossing at t > 1 is not
    taken. JAX scans H + W steps; this loop stops after H + W steps or once
    every segment is done, which leaves every result as the scan's.
    live: optional bool mask of the segments to walk (the others return
    garbage); record: optional dict whose list "cells" receives the flat
    indices (b·H·W + cell) of the in-bounds cells the live segments visit
    and whose "steps" counts the steps they take."""
    Bm, H, W = data.shape
    flat = data.reshape(Bm, H * W)
    L = lambda v: _lane(v, x0)
    ox, oy, rs = L(origin[:, 0]), L(origin[:, 1]), L(res)
    shx, shy = ((0, 0) if shift is None
                else (L(shift[:, 0]), L(shift[:, 1])))
    lo_x, lo_y, hi_x, hi_y = ((0, 0, W, H) if bounds is None
                              else (L(bounds[:, k]) for k in range(4)))
    lane = L(torch.arange(Bm, device=data.device) * (H * W))

    def local_cell(p, o):
        return torch.floor((p - o) / rs).to(torch.int32)

    def inside(cx, cy):
        wx, wy = cx + shx, cy + shy
        return (wx >= lo_x) & (wx < hi_x) & (wy >= lo_y) & (wy < hi_y), wx, wy

    def cost(cx, cy, keep):
        inb, wx, wy = inside(cx, cy)
        idx = wy.clamp(0, H - 1) * W + wx.clamp(0, W - 1)
        if record is not None:
            record["cells"].append((lane + idx)[inb & keep])
        return torch.where(inb, _gather_flat(flat, idx), LETHAL_COST)

    mx, my = local_cell(x0, ox), local_cell(y0, oy)
    ex, ey = local_cell(x1, ox), local_cell(y1, oy)
    dx, dy = x1 - x0, y1 - y0
    step_x = torch.where(dx > 0, 1, -1).to(torch.int32)
    step_y = torch.where(dy > 0, 1, -1).to(torch.int32)
    edge_x = ox + (mx + (dx > 0).to(torch.int32)).to(torch.float32) * rs
    edge_y = oy + (my + (dy > 0).to(torch.int32)).to(torch.float32) * rs
    inf = torch.full_like(dx, torch.inf)
    t_max_x = torch.where(dx != 0.0, (edge_x - x0) / dx, inf)
    t_max_y = torch.where(dy != 0.0, (edge_y - y0) / dy, inf)
    t_delta_x = torch.where(dx != 0.0, rs / dx.abs(), inf)
    t_delta_y = torch.where(dy != 0.0, rs / dy.abs(), inf)

    done = (torch.zeros_like(mx, dtype=torch.bool) if live is None
            else ~live)
    best = cost(mx, my, ~done)
    end_in, _, _ = inside(ex, ey)
    best = torch.where(end_in, best,
                       torch.maximum(best, torch.ones_like(best)))
    for _ in range(H + W):
        done = done | ((mx == ex) & (my == ey))
        take_x = t_max_x < t_max_y
        t = torch.where(take_x, t_max_x, t_max_y)
        past_end = t > 1.0
        advance = ~done & ~past_end
        done = done | past_end
        if not bool(advance.any()):
            break
        if record is not None:
            record["steps"] += int(advance.sum())
        ax, ay = advance & take_x, advance & ~take_x
        mx = torch.where(ax, mx + step_x, mx)
        my = torch.where(ay, my + step_y, my)
        t_max_x = torch.where(ax, t_max_x + t_delta_x, t_max_x)
        t_max_y = torch.where(ay, t_max_y + t_delta_y, t_max_y)
        best = torch.where(advance,
                           torch.maximum(best, cost(mx, my, advance)), best)
    return best


def line_cost_exact(cm: Costmap, x0, y0, x1, y1) -> torch.Tensor:
    """Max cell cost along segments by the exact cell walk (the JAX
    package's line_cost_exact; the native host's line_cost). The endpoints
    broadcast together to (*lead, ...), the map's lead dims first; on a
    view the walk reads through its window, world-frame cells."""
    f = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                  device=cm.data.device)
    x0, y0, x1, y1 = torch.broadcast_tensors(f(x0), f(y0), f(x1), f(y1))
    data, origin, res, bounds, shift = _lane_map_arguments(cm)
    seg = lambda a: a.reshape(data.shape[0], -1)
    out = _walk(data, origin, res, bounds, shift, seg(x0), seg(y0), seg(x1),
                seg(y1))
    return out.reshape(x0.shape)


def footprint_walk_batch_plain(data, origin, res, bounds, verts, n_valid,
                               shift=None, record=None):
    """Plain PyTorch version of K3's walk mode, the reference the kernel is
    held to. Arguments as in footprint_cost_batch_plain, without t; bounds
    (Bm, 4) is the grid's rectangle of in-bounds cells (a view's window) or
    None. -> (Bm, R): per polygon, the max over its valid edges of the cell
    walk's cost. record: see _walk."""
    ends, valid = _edges(verts, n_valid)
    costs = _walk(data, origin, res, bounds, shift, verts[..., 0],
                  verts[..., 1], ends[..., 0], ends[..., 1], live=valid,
                  record=record)
    return torch.where(valid, costs, -torch.inf).amax(-1)


def _check_kernel_inputs(data, origin, res, bounds, verts, n_valid, t,
                         shift=None):
    """What K3 takes; t None for the walk mode. Raises on anything else."""
    what = "footprint_cost_batch" if t is not None else "footprint_walk_batch"
    Bm, H, W = data.shape
    R, V = verts.shape[1], verts.shape[2]
    named = dict(data=data, origin=origin, res=res, bounds=bounds,
                 shift=shift, verts=verts, n_valid=n_valid, t=t)
    shapes = dict(data=(Bm, H, W), origin=(Bm, 2), res=(Bm,), bounds=(Bm, 4),
                  shift=(Bm, 2), verts=(Bm, R, V, 2), n_valid=(Bm, R),
                  t=None if t is None else (t.shape[0],))
    for name, a in named.items():
        if a is None:
            continue
        want = (torch.int32 if name in ("bounds", "shift", "n_valid")
                else torch.float32)
        if a.device != data.device:
            raise ValueError(f"{what}: operands on different devices")
        if a.dtype != want:
            raise TypeError(f"{what}: {name} must be {want}, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if tuple(a.shape) != shapes[name]:
            raise ValueError(f"{what}: {name} has shape "
                             f"{tuple(a.shape)}, expected {shapes[name]}")
    S = 0 if t is None else t.shape[0]
    if V > K3_MAX_VERTICES or S > K3_MAX_SAMPLES:
        raise ValueError(f"{what}: the kernel takes at most "
                         f"{K3_MAX_VERTICES} vertices and {K3_MAX_SAMPLES} "
                         f"samples, got {V} and {S}")
    if H * W >= 2 ** 31 or max(H, W) >= 2 ** 24:
        raise ValueError(f"{what}: map too large for int32 cell indices or "
                         "float32 cell bounds")
    if t is None:
        return
    lanes, _ = binding.k3_launch_shape(R)
    if binding.k3_smem_bytes(R, V, S, lanes) > binding.MAX_SMEM:
        raise ValueError(f"{what}: {R} polygons of {V} vertices a lane do "
                         "not fit a block's shared memory")


def _device_of(data, what: str) -> str:
    """"cpu" or "cuda" for the wrappers; any other device raises."""
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {data.device}")
    return data.device.type


def footprint_cost_batch(data, origin, res, bounds, verts, n_valid, t,
                         shift=None):
    """Batched footprint boundary max-cost (arguments as in
    footprint_cost_batch_plain): kernel K3 for CUDA tensors, the plain
    version for CPU tensors; anything else raises. R polygons of a lane
    share its map, which is read in place."""
    if _device_of(data, "footprint_cost_batch") == "cpu":
        return footprint_cost_batch_plain(data, origin, res, bounds, verts,
                                          n_valid, t, shift)
    _check_kernel_inputs(data, origin, res, bounds, verts, n_valid, t, shift)
    if verts.shape[0] * verts.shape[1] == 0:
        return verts.new_empty(verts.shape[:2])
    out = binding.launch_footprint_cost(data, origin, res, bounds, verts,
                                        n_valid, t, shift)
    footprint_cost_batch.launches += 1
    return out


footprint_cost_batch.launches = 0


def footprint_walk_batch(data, origin, res, bounds, verts, n_valid,
                         shift=None):
    """Batched exact footprint cost (arguments as in
    footprint_walk_batch_plain): K3's walk mode for CUDA tensors, the plain
    walk for CPU tensors; anything else raises."""
    if _device_of(data, "footprint_walk_batch") == "cpu":
        return footprint_walk_batch_plain(data, origin, res, bounds, verts,
                                          n_valid, shift)
    _check_kernel_inputs(data, origin, res, bounds, verts, n_valid, None,
                         shift)
    if verts.shape[0] * verts.shape[1] == 0:
        return verts.new_empty(verts.shape[:2])
    out = binding.launch_footprint_cost(data, origin, res, bounds, verts,
                                        n_valid, None, shift)
    footprint_walk_batch.launches += 1
    return out


footprint_walk_batch.launches = 0


def footprint_cost(cm: Costmap, fp: Footprint, samples: int = 32,
                   mode: str = "gather",
                   bounds: "torch.Tensor | None" = None) -> torch.Tensor:
    """Max cost along the polygon boundary. Edges run i -> (i + 1) mod
    n_valid; padded vertices start no edge.

    The polygons' leading dims start with the map's (*lead) and may carry
    more after them (a wave's candidates and steps): each polygon reads its
    lane's map. mode: "gather"/"onehot" sample each edge at `samples`
    points (footprint_cost_batch); "exact" walks every cell an edge
    crosses (footprint_walk_batch) and ignores `samples`. bounds: optional
    (*lead, 4) int32 rectangle inside the grid (a ProductPatchSampler's);
    samples outside it read lethal. The exact walk reads the whole map, as
    the JAX package's does, and takes no bounds. On a view every read goes
    through its window (K3 with the window's origin, the window as bounds
    and win_lo as shift); a view takes no bounds, as no patch sampler is
    built on one. Returns the polygons' leading shape, without gradient."""
    if mode not in ("gather", "onehot", "exact"):
        raise ValueError(f"unknown footprint sampling mode {mode!r}")
    if mode == "exact" and bounds is not None:
        raise ValueError("footprint_cost: the exact walk reads the whole "
                         "map and takes no bounds rectangle")
    lead = cm.data.shape[:-2]
    verts = fp.vertices.detach()
    poly = verts.shape[:-2]
    if poly[:len(lead)] != lead:
        raise ValueError(f"footprint_cost: polygons {tuple(poly)} do not "
                         f"start with the map's lead dims {tuple(lead)}")
    data, origin, res, bounds, shift = _lane_map_arguments(cm, bounds)
    Bm, V = data.shape[0], verts.shape[-2]
    polygons = (verts.reshape(Bm, -1, V, 2).contiguous(),
                torch.broadcast_to(fp.n_valid, poly).reshape(Bm, -1).to(
                    torch.int32).contiguous())
    if mode == "exact":
        out = footprint_walk_batch(data, origin, res, bounds, *polygons,
                                   shift)
    else:
        out = footprint_cost_batch(
            data, origin, res, bounds, *polygons,
            _edge_parameters_on(samples, verts.device), shift)
    return out.reshape(poly)


def _lane_map_arguments(cm: Costmap, bounds=None):
    """kernel_map_arguments with the map's lead dims flattened into Bm
    lanes, each contiguous: (data (Bm, H, W), origin (Bm, 2), res (Bm,),
    bounds (Bm, 4) or None, shift (Bm, 2) or None)."""
    lead = cm.data.shape[:-2]
    Bm = math.prod(lead)
    origin, bounds, shift = kernel_map_arguments(cm, bounds)
    flat = lambda a, *tail: (None if a is None else a.expand(
        lead + tail).reshape((Bm,) + tail).contiguous())
    return (cm.data.reshape((Bm,) + cm.data.shape[-2:]), flat(origin, 2),
            flat(cm.resolution), flat(bounds, 4), flat(shift, 2))


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
