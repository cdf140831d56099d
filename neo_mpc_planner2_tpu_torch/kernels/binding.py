"""Launch the CUDA kernels on contiguous CUDA tensors.

K1 and K2 take float32 operands laid out lane-minor, (rows, B); K3 takes
its operands batch-major as `footprint_cost_batch` documents them. Each
function allocates its outputs with torch.empty, launches on the current
stream without synchronising, and raises if the launch reports an error.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load_library

__all__ = ["SUPPORTED_M", "launch_qp_admm", "launch_spd_inv",
           "launch_footprint_cost"]

SUPPORTED_M = (6, 9, 15)


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def launch_qp_admm(ins, m: int, iters: int, rho: float, sigma: float):
    """ins: the 12 lane-minor operands (Bflat, g, x, c, dxy, lo, hi, d0, zb0,
    zc0, wb0, wc0). Returns lane-minor (d_out, d, zb, zc, wb, wc)."""
    lib = load_library()
    B = ins[1].shape[1]
    n = m // 3
    outs = [torch.empty((r, B), dtype=torch.float32, device=ins[0].device)
            for r in (m, m, m, n, m, n)]
    stream = torch.cuda.current_stream(ins[0].device).cuda_stream
    rc = lib.neo_qp_admm_f32(m, B, int(iters), float(rho), float(sigma),
                             float(sigma + rho), _ptrs(ins), _ptrs(outs),
                             stream)
    _check(rc, "qp_admm")
    return outs


def launch_spd_inv(A: torch.Tensor, m: int) -> torch.Tensor:
    """A: lane-minor (m*m, B). Returns the inverses, lane-minor."""
    lib = load_library()
    X = torch.empty_like(A)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    rc = lib.neo_spd_inv_f32(m, A.shape[1], A.data_ptr(), X.data_ptr(), stream)
    _check(rc, "spd_inv")
    return X


def launch_footprint_cost(data, origin, res, bounds, verts, n_valid, t):
    """data (Bm, H, W), origin (Bm, 2), res (Bm,), bounds (Bm, 4) int32 or
    None (the whole grid), verts (Bm, R, V, 2), n_valid (Bm, R) int32,
    t (S,). Returns the (Bm, R) costs."""
    lib = load_library()
    Bm, H, W = data.shape
    R, V = verts.shape[1], verts.shape[2]
    out = torch.empty((Bm, R), dtype=torch.float32, device=data.device)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    rc = lib.neo_footprint_cost_f32(
        Bm, R, H, W, V, t.shape[0], data.data_ptr(), origin.data_ptr(),
        res.data_ptr(), None if bounds is None else bounds.data_ptr(),
        verts.data_ptr(), n_valid.data_ptr(), t.data_ptr(), out.data_ptr(),
        stream)
    _check(rc, "footprint_cost")
    return out
