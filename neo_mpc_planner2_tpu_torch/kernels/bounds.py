"""The least time an H100 could take for each kernel's work.

A kernel's bound is the larger of two times: the bytes it must move (each
input read once, each output written once) over the card's memory rate, and
the operations it must do over the card's float32 rate outside the tensor
cores (NVIDIA's data sheet, H100 SXM at 700 W). The operation counts follow
the plain versions' arithmetic; where the work depends on the data (K3's
valid edges, the map cells its samples touch, the steps and cells of its
walks) the count is taken from the inputs. Nothing here times anything or needs a card.
"""

from __future__ import annotations

import torch

from ..ops.costmap import Costmap, _in_bounds_clipped, _lane, world_to_map
from ..ops.footprint import footprint_walk_batch_plain

__all__ = ["H100_BYTES_PER_S", "H100_F32_OPS_PER_S", "bound",
           "inverse_ops", "qp_admm_work", "spd_inv_work",
           "K3_OPS_PER_SAMPLE", "footprint_cost_work",
           "footprint_cells_touched", "K3_WALK_OPS_PER_EDGE",
           "K3_WALK_OPS_PER_STEP", "footprint_walk_work",
           "PARITY_LS_OPS_PER_STEP", "PARITY_LS_OPS_PER_EVAL",
           "PARITY_LS_OPS_PER_LANE", "parity_line_search_work"]

H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12
F32 = 4


def bound(ops: float, nbytes: float) -> dict:
    """{"ops", "bytes", "bound_ms", "bound_by"}: bound_by names the larger
    of the two times, "operations" or "bytes"."""
    ms_ops = ops / H100_F32_OPS_PER_S * 1e3
    ms_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return {"ops": ops, "bytes": nbytes, "bound_ms": max(ms_ops, ms_bytes),
            "bound_by": "operations" if ms_ops >= ms_bytes else "bytes"}


def inverse_ops(m: int) -> int:
    """Operations of the unrolled Cholesky inverse of one m x m matrix
    (sqp.chol_inverse_plain): per dot product of n terms n multiplies
    and n - 1 adds, plus the subtraction, the reciprocal square root or the
    scaling around it."""
    ops = 0
    for j in range(m):
        ops += 2 * j + 3                          # pivot: dot, sub, rsqrt, mul
        ops += (m - 1 - j) * (2 * j + 1)          # column j below the pivot
    for i in range(m):
        ops += 1                                  # Y[i][i] = D[i]
        ops += sum(2 * (i - c) + 1 for c in range(i))
    for i in range(m):
        n = m - 1 - i
        ops += (i + 1) * ((2 * n if n else 0) + 1)
    return ops


def qp_admm_work(B: int, m: int, iters: int) -> dict:
    """K1 on B lanes: M = B + (σ+ρ)I + ρJᵀJ, its inverse, `iters` ADMM
    iterations, the clipped step and y_cone."""
    n = m // 3
    build = m * (m + 1) // 2 + m + 9 * n
    per_iter = (5 * m + 4 * 2 * n           # rhs
                + 2 * m * m - m             # M⁻¹ rhs
                + 3 * m                     # box clip of d + wb
                + 7 * n                     # cone: J d, max, dual
                + 2 * m)                    # wb
    ops = B * (build + inverse_ops(m) + iters * per_iter + 2 * m + n)
    floats = B * ((m * m + 7 * m + 5 * n)   # Bflat, 7 rows of m, c/zc/wc/dxy
                  + (4 * m + 3 * n))        # d_out, d, zb, wb; zc, wc, y_cone
    return bound(ops, floats * F32)


def spd_inv_work(B: int, m: int) -> dict:
    """K2 on B matrices: read each lower triangle once (the function reads
    nothing else), write each whole inverse once."""
    return bound(B * inverse_ops(m), B * (m * (m + 1) // 2 + m * m) * F32)


# A sample: p = s + (e - s)t in x and y (4: the difference is staged), the
# cell (sub, div, floor, range test) in x and y (8), the bounds test (4)
# and the max (1).
K3_OPS_PER_SAMPLE = 17


def footprint_cells_touched(data, origin, res, bounds, verts, n_valid, t,
                            shift=None) -> int:
    """The distinct map cells that K3's samples read (arguments as in
    footprint_cost_batch): samples of valid edges inside the bounds
    rectangle (or the grid), counted once per (lane, cell)."""
    Bm, H, W = data.shape
    V = verts.shape[-2]
    idx = torch.arange(V, dtype=torch.int32, device=verts.device)
    nv = n_valid[..., None]
    nxt = torch.remainder(idx + 1, nv).long()
    ends = torch.gather(verts, -2, nxt[..., None].expand(verts.shape))
    pts = (verts[..., :, None, :]
           + (ends - verts)[..., :, None, :] * t[:, None])  # (Bm,R,V,S,2)
    cm = Costmap(data=data, origin=origin, resolution=res)
    mx, my = world_to_map(cm, pts[..., 0], pts[..., 1])
    if shift is not None:
        mx = mx + _lane(shift[:, 0], mx)
        my = my + _lane(shift[:, 1], my)
    inb, mxc, myc = _in_bounds_clipped(cm, mx, my, bounds)
    read = inb & (idx < nv)[..., None]
    lane = torch.arange(Bm, device=data.device).reshape(
        (Bm,) + (1,) * (read.dim() - 1))
    cells = (lane * (H * W) + myc.long() * W + mxc.long())[read]
    return int(torch.unique(cells).numel())


def footprint_cost_work(data, origin, res, bounds, verts, n_valid, t,
                        shift=None) -> dict:
    """K3 on these inputs: the valid edges' samples, the valid vertices,
    the counts, the output, the per-lane origin, resolution, bounds and
    shift, and the distinct cells the samples read. A shift adds two
    operations a sample (one add in x and y)."""
    Bm, R, V = verts.shape[0], verts.shape[1], verts.shape[2]
    S = t.shape[0]
    nv = n_valid.clamp(0, V).long()
    samples = int(nv.sum()) * S
    cells = footprint_cells_touched(data, origin, res, bounds, verts,
                                    n_valid, t, shift)
    nbytes = F32 * (2 * int(nv.sum())         # valid vertices
                    + 2 * Bm * R              # n_valid, out
                    + S                       # t
                    + 3 * Bm                  # origin, res
                    + (4 * Bm if bounds is not None else 0)
                    + (2 * Bm if shift is not None else 0)
                    + cells)
    ops = K3_OPS_PER_SAMPLE + (2 if shift is not None else 0)
    out = bound(samples * ops, nbytes)
    out.update(samples=samples, cells=cells)
    return out


# A walk's set-up: the start and end cells (sub, div, floor in x and y: 12),
# the direction (2), the boundaries and t_max (4 in x and y: 8), t_delta
# (2 in x and y: 4), the start cell's and the end cell's bounds tests (8)
# and the first max (1).
K3_WALK_OPS_PER_EDGE = 35
# A step: the end-cell test (2), the t_max compare and pick (2), the
# threshold (1), the cell and t_max updates (2), the bounds test (4) and
# the max (1).
K3_WALK_OPS_PER_STEP = 12


def footprint_walk_work(data, origin, res, bounds, verts, n_valid,
                        shift=None) -> dict:
    """K3's walk mode on these inputs: the valid vertices, the counts, the
    output, the per-lane origin, resolution, bounds and shift, and the
    distinct cells the walks visit (read once); the operations of each
    valid edge's set-up and of the steps the walks take (from the plain
    walk on the same inputs)."""
    Bm, R, V = verts.shape[0], verts.shape[1], verts.shape[2]
    record = {"cells": [], "steps": 0}
    footprint_walk_batch_plain(data, origin, res, bounds, verts, n_valid,
                               shift, record=record)
    cells = int(torch.unique(torch.cat(record["cells"])).numel())
    edges = int(n_valid.clamp(0, V).sum())
    nbytes = F32 * (2 * edges                  # valid vertices
                    + 2 * Bm * R               # n_valid, out
                    + 3 * Bm                   # origin, res
                    + (4 * Bm if bounds is not None else 0)
                    + (2 * Bm if shift is not None else 0)
                    + cells)
    ops = (edges * K3_WALK_OPS_PER_EDGE
           + record["steps"] * K3_WALK_OPS_PER_STEP)
    out = bound(ops, nbytes)
    out.update(edges=edges, steps=record["steps"], cells=cells)
    return out


# A step of one merit evaluation of the parity line search: the candidate
# (3 multiplies, 3 adds), the yaw increment (1), the body and the odom
# rollouts (13 each: the yaw, its cosine and sine, 5 in x and 5 in y), the
# tracking terms (10), the control term (10: 3 differences, 3 squares, 2
# adds, the test and the square root), the map read (15: 2 differences, 2
# divisions, 2 floors, the 4 bounds tests, the index, the square, the
# lethal test and the weight), the cone (6) and the five sums' adds (5).
# A transcendental counts as one operation.
PARITY_LS_OPS_PER_STEP = 82
# An evaluation's own: the five means, the control weight, the terminal
# term (9), the merit (2), the Armijo test (4) and the next alpha (8).
PARITY_LS_OPS_PER_EVAL = 29
# A lane's set-up: the buggy odom yaw (8).
PARITY_LS_OPS_PER_LANE = 8


def parity_line_search_work(B: int, n: int, evals: int,
                            u8: bool = False) -> dict:
    """The parity line search on B lanes of n steps that take `evals` merit
    evaluations in all (the masked loop's count on the same operands,
    _masked_armijo's `record`): the operations above; the bytes of each
    lane's iterate and step (2 x 3n floats), its table row (22 floats),
    its alpha, phi0, dphi, mu and f, its done and active flags, its three
    outputs (9 bytes), and one map read a step of each evaluation (4 bytes,
    1 from the u8 companion)."""
    ops = (evals * (n * PARITY_LS_OPS_PER_STEP + PARITY_LS_OPS_PER_EVAL)
           + B * PARITY_LS_OPS_PER_LANE)
    nbytes = (B * (F32 * (6 * n + 22 + 5) + 2 + 9)
              + evals * n * (1 if u8 else F32))
    out = bound(ops, nbytes)
    out.update(evals=evals)
    return out
