"""Launch the CUDA kernels on contiguous CUDA tensors.

Every kernel takes its operands batch-major, as `sqp.qp_admm`,
`sqp.chol_inverse` and `footprint_cost_batch` document them. Each function
allocates its outputs with torch.empty, launches on the current stream
without synchronising, and raises if the launch reports an error. The argument order of each call is that of the C function named
in `build.SIGNATURES`.
"""

from __future__ import annotations

import torch

from .build import load_library

__all__ = ["SUPPORTED_M", "QP_INPUTS", "QP_OUTPUTS", "qp_rows",
           "K3_MAX_SMEM", "K3_WALK_THREADS", "k3_launch_shape",
           "k3_smem_bytes",
           "K2_WIDTHS", "K2_WIDE_BLOCKS_PER_SM", "k2_launch_shape",
           "launch_qp_admm", "launch_spd_inv", "launch_footprint_cost"]

SUPPORTED_M = (6, 9, 15)

# K1's operands and outputs, in the order of neo_qp_admm_f32's arguments.
QP_INPUTS = ("Bflat", "g", "x", "c", "dxy", "lo", "hi", "d0", "zb0", "zc0",
             "wb0", "wc0")
QP_OUTPUTS = ("d_out", "d", "zb", "zc", "wb", "wc", "y_cone")


def qp_rows(m: int) -> dict:
    """The row count of each K1 operand and output (each is (B, rows))."""
    n = m // 3
    return dict(Bflat=m * m, g=m, x=m, c=n, dxy=2 * n, lo=m, hi=m, d0=m,
                zb0=m, zc0=n, wb0=m, wc0=n, d_out=m, d=m, zb=m, zc=n, wb=m,
                wc=n, y_cone=n)


# The most shared memory a block may take on an H100 (227 KB).
K3_MAX_SMEM = 232448


def k3_launch_shape(R: int) -> tuple[int, int]:
    """K3's launch shape for R polygons a lane: (lanes_per_block,
    warps_per_lane), four warps a block. Measured on the product slice's own
    calls on an H100 (scripts/torch_kernel_turns.py --shapes; PERF.md): one
    warp a lane was fastest for the gate (R = 1) and the gradient calls
    (R = 3), two warps a lane for the wave (R = 21); more warps a lane
    split a polygon's few samples further and ran slower."""
    warps = 1 if R <= 3 else 2
    return 4 // warps, warps


# Threads a block of K3's walk mode (one an edge; a polygon's edges on
# adjacent threads of one warp).
K3_WALK_THREADS = 128


def k3_smem_bytes(R: int, V: int, S: int, lanes_per_block: int) -> int:
    """Dynamic shared memory of one K3 block: a lane's R·V staged edges (16
    bytes each) and R valid counts, for each lane of the block, and the S
    edge parameters."""
    return lanes_per_block * R * (16 * V + 4) + 4 * S


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch_qp_admm(ins, m: int, iters: int, rho: float, sigma: float):
    """ins: the 12 batch-major operands of QP_INPUTS, each (B, rows).
    Returns the 7 batch-major outputs of QP_OUTPUTS."""
    lib = load_library()
    B = ins[0].shape[0]
    rows = qp_rows(m)
    outs = [torch.empty((B, rows[name]), dtype=torch.float32,
                        device=ins[0].device) for name in QP_OUTPUTS]
    rc = lib.neo_qp_admm_f32(m, B, int(iters), float(rho), float(sigma),
                             float(sigma + rho),
                             *(t.data_ptr() for t in ins),
                             *(t.data_ptr() for t in outs),
                             _stream(ins[0].device))
    _check(rc, "qp_admm")
    return outs


# K2's widths (warps a block of 32 matrices) that csrc/spd_inv.cu builds.
K2_WIDTHS = (1, 4)
# K2 takes four warps a block while its blocks are at most this many to an
# SM, one above.
K2_WIDE_BLOCKS_PER_SM = 2


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def k2_launch_shape(B: int, device) -> int:
    """K2's warps a block of 32 matrices on `device`: four (each warp
    factoring and taking a quarter of the columns: shorter chains) while
    the B / 32 blocks are at most K2_WIDE_BLOCKS_PER_SM to an SM, one
    above (no repeated factoring where bytes bound). Measured on an H100
    (scripts/torch_kernel_turns.py --k2-shapes; PERF.md): four warps were
    fastest or within 4 % at B <= 8192, and one within 4 % of the fastest
    width from B = 16384 on, where four ran up to 32 % slower (m = 15)."""
    blocks = -(-B // 32)
    return 4 if blocks <= K2_WIDE_BLOCKS_PER_SM * _sms(device) else 1


def _launch_spd_inv_at(M: torch.Tensor, warps: int) -> torch.Tensor:
    lib = load_library()
    X = torch.empty_like(M)
    rc = lib.neo_spd_inv_f32(M.shape[-1], M.shape[0], warps, M.data_ptr(),
                             X.data_ptr(), _stream(M.device))
    _check(rc, "spd_inv")
    return X


def launch_spd_inv(M: torch.Tensor) -> torch.Tensor:
    """M: batch-major (B, m, m). Returns the inverses, (B, m, m), at
    k2_launch_shape's width."""
    return _launch_spd_inv_at(M, k2_launch_shape(M.shape[0], M.device))


def launch_footprint_cost(data, origin, res, bounds, verts, n_valid, t,
                          shift=None, shape: tuple[int, int] | None = None):
    """data (Bm, H, W), origin (Bm, 2), res (Bm,), bounds (Bm, 4) int32 or
    None (the whole grid), verts (Bm, R, V, 2), n_valid (Bm, R) int32,
    t (S,) or None, shift (Bm, 2) int32 or None (a view's win_lo).
    With t, K3's sampled mode (neo_footprint_cost_f32) at shape =
    (lanes_per_block, warps_per_lane), k3_launch_shape(R) by default;
    with t None, its walk mode (neo_footprint_walk_f32) at K3_WALK_THREADS
    a block. Returns the (Bm, R) costs."""
    lib = load_library()
    Bm, H, W = data.shape
    R, V = verts.shape[1], verts.shape[2]
    out = torch.empty((Bm, R), dtype=torch.float32, device=data.device)
    maps = (data.data_ptr(), origin.data_ptr(), res.data_ptr(),
            None if bounds is None else bounds.data_ptr(),
            None if shift is None else shift.data_ptr(), verts.data_ptr(),
            n_valid.data_ptr())
    if t is None:
        rc = lib.neo_footprint_walk_f32(Bm, R, H, W, V, K3_WALK_THREADS,
                                        *maps, out.data_ptr(),
                                        _stream(data.device))
        _check(rc, "footprint_cost (walk)")
        return out
    lanes, warps = k3_launch_shape(R) if shape is None else shape
    rc = lib.neo_footprint_cost_f32(
        Bm, R, H, W, V, t.shape[0], lanes, warps, *maps, t.data_ptr(),
        out.data_ptr(), _stream(data.device))
    _check(rc, "footprint_cost")
    return out
