"""The least time an H100 could take for a kernel's work: the larger of
its bytes over the memory rate and its operations over the float32 rate
outside the tensor cores (NVIDIA's data sheet, H100 SXM at 700 W).

K1's count follows the ADMM QP's arithmetic at its shapes (B lanes,
m = 3·control_steps, `iters` iterations), so it holds whatever implements
K1. Copied from the port's kernels/bounds.py, frozen here as the
benchmark's yardstick.
"""

from __future__ import annotations

H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12
F32 = 4


def bound(ops: float, nbytes: float) -> dict:
    """{"ops", "bytes", "bound_ms", "bound_by"}."""
    ms_ops = ops / H100_F32_OPS_PER_S * 1e3
    ms_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return {"ops": ops, "bytes": nbytes, "bound_ms": max(ms_ops, ms_bytes),
            "bound_by": "operations" if ms_ops >= ms_bytes else "bytes"}


def inverse_ops(m: int) -> int:
    """Operations of the Cholesky inverse of one m x m matrix: per dot
    product of n terms n multiplies and n - 1 adds, plus the subtraction,
    the reciprocal square root or the scaling around it."""
    ops = 0
    for j in range(m):
        ops += 2 * j + 3
        ops += (m - 1 - j) * (2 * j + 1)
    for i in range(m):
        ops += 1
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
    per_iter = (5 * m + 4 * 2 * n
                + 2 * m * m - m
                + 3 * m
                + 7 * n
                + 2 * m)
    ops = B * (build + inverse_ops(m) + iters * per_iter + 2 * m + n)
    floats = B * ((m * m + 7 * m + 5 * n)
                  + (4 * m + 3 * n))
    return bound(ops, floats * F32)
