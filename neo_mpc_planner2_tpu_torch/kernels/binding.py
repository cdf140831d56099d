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

__all__ = ["MAX_SMEM", "team_ld", "K1_WARP_TEAM_MAX_M", "K1_WARP_LANE_MAX_M",
           "K1_BLOCK_LANE_ROWS_PER_WARP", "K1_BLOCK_LANE_ENTRIES_PER_WARP",
           "k1_block_smem_bytes", "K1_MAX_M", "qp_admm_variant",
           "k1_warps_per_lane", "K2_UNROLLED_M", "K2_UNROLLED_MATRICES",
           "K2_WARP_MAX_M", "K2_WARP_MATRICES", "K2_BLOCK_ENTRIES_PER_WARP",
           "k2_block_smem_bytes", "K2_MAX_M", "spd_inv_variant",
           "k2_runtime_shape", "k2_runtime_plan", "spd_inv_shape",
           "QP_INPUTS", "QP_OUTPUTS", "qp_rows", "K3_WALK_THREADS",
           "k3_launch_shape", "k3_smem_bytes", "K3_WIDE_WARPS",
           "K3_MAX_CHUNKS", "k3_max_samples", "k3_variant",
           "K3_WALK_WARP_VERTICES", "k3_walk_variant",
           "K2_WIDTHS", "K2_WIDE_BLOCKS_PER_SM", "k2_launch_shape",
           "launch_qp_admm", "launch_spd_inv", "launch_footprint_cost"]

# The most shared memory a block may take on an H100 (227 KB).
MAX_SMEM = 232448


def team_ld(m: int) -> int:
    """Row stride of a team's matrix in shared memory in the runtime-m
    designs: m rounded up to odd (spd_inverse.cuh: team_ld)."""
    return m | 1


# K1's designs (csrc/qp_admm.cu): the warp team (qp_admm_kernel<M>, several
# lanes a warp, built at every m = 3N <= K1_WARP_TEAM_MAX_M) serves m up to
# K1_WARP_TEAM_MAX_M; the warp lane (qp_admm_kernel_warp_lane, a warp a
# lane, its rows of M^-1 in registers) up to K1_WARP_LANE_MAX_M; the block
# lane (qp_admm_kernel_block_lane, a block a lane) above, up to K1_MAX_M.
# Measured on an H100 (PERF.md, scripts/torch_kernel_turns.py --old and
# --runtime-shapes): the warp team ran 2 % ahead of the warp lane at
# m = 18; the warp lane ran ahead of the team from m = 21 on (against an
# earlier build whose team served m = 21-30) and 25-35 % ahead of the
# block lane at 48 and 63 (its last width: a thread holds two rows of at
# most 64 floats).
K1_WARP_TEAM_MAX_M = 18
K1_WARP_LANE_MAX_M = 63
# Rows a warp owns in the block lane: ten whole cone triples.
K1_BLOCK_LANE_ROWS_PER_WARP = 30
# The block lane's warps: one per 30 rows, and more at large m, one per
# K1_BLOCK_LANE_ENTRIES_PER_WARP entries of M, up to 32: 3 at m = 66, 5 at
# 96, 28 at 237 (each fastest or within 2 % of it on an H100,
# scripts/torch_kernel_turns.py --runtime-shapes, PERF.md).
K1_BLOCK_LANE_ENTRIES_PER_WARP = 2048


def k1_block_smem_bytes(m: int) -> int:
    """Shared memory of one block of K1's block-lane design: two rhs
    buffers of m rounded up to whole float4s, the matrix at stride
    team_ld(m) and its reciprocal diagonal."""
    return 4 * (2 * (-(-m // 4) * 4) + m * team_ld(m) + m)


# The largest m whose block-lane block fits MAX_SMEM: 237 (control_steps 79).
K1_MAX_M = max(m for m in range(3, 400, 3)
               if k1_block_smem_bytes(m) <= MAX_SMEM)


def qp_admm_variant(m: int) -> str:
    """The K1 design that serves m: "warp_team" (m = 3N <=
    K1_WARP_TEAM_MAX_M), "warp_lane" (<= K1_WARP_LANE_MAX_M) or
    "block_lane" (<= K1_MAX_M). Raises ValueError for any other m."""
    if m < 3 or m % 3:
        raise ValueError(f"qp_admm: m={m} is not 3 x control_steps")
    if m <= K1_WARP_TEAM_MAX_M:
        return "warp_team"
    if m <= K1_WARP_LANE_MAX_M:
        return "warp_lane"
    if m <= K1_MAX_M:
        return "block_lane"
    raise ValueError(
        f"qp_admm: m={m} is above K1's cap m={K1_MAX_M} (control_steps "
        f"{K1_MAX_M // 3}): its block would need {k1_block_smem_bytes(m)} "
        f"bytes of shared memory, a block may take {MAX_SMEM}")


def k1_warps_per_lane(m: int) -> int:
    """neo_qp_admm_f32's warps_per_lane for m: 0 (the warp team: a lane a
    team inside a warp), 1 (the warp lane) or the block lane's warps, one
    per K1_BLOCK_LANE_ROWS_PER_WARP rows or one per
    K1_BLOCK_LANE_ENTRIES_PER_WARP entries of M (at most 32), whichever is
    more."""
    variant = qp_admm_variant(m)
    if variant == "warp_team":
        return 0
    if variant == "warp_lane":
        return 1
    return max(-(-m // K1_BLOCK_LANE_ROWS_PER_WARP),
               min(32, -(-m * m // K1_BLOCK_LANE_ENTRIES_PER_WARP)))


# K2's unrolled design (csrc/spd_inv.cu: spd_inv_kernel<M, T>) is built at
# these m, in blocks of K2_UNROLLED_MATRICES; its runtime-m kernel takes
# every other m up to K2_MAX_M.
K2_UNROLLED_M = (3, 6, 9, 12, 15, 18)
K2_UNROLLED_MATRICES = 32
# The runtime-m kernel takes a warp a matrix, K2_WARP_MATRICES matrices (and
# warps) a block, up to K2_WARP_MAX_M (spd_inv_kernel_runtime_warp); a
# block a matrix above (spd_inv_kernel_runtime_block), one warp per
# K2_BLOCK_ENTRIES_PER_WARP entries of the matrix, at least 2 and at most
# 32. Measured on an H100 at B = 4096 (scripts/torch_kernel_turns.py
# --runtime-shapes; PERF.md): a warp a matrix ran ahead of a block of 2 or
# 4 warps a matrix up to m = 41 (4 % at 41), a block of 2 from m = 42 (5 %
# at 42); the block's warps by this rule were fastest or within 3.5 % of
# the fastest at m = 64, 96, 128 and 240.
K2_WARP_MAX_M = 41
K2_WARP_MATRICES = 4
K2_BLOCK_ENTRIES_PER_WARP = 2560


def k2_block_smem_bytes(m: int) -> int:
    """Shared memory of one matrix of K2's runtime-m kernel (a block's, in
    its block plan): the matrix at stride team_ld(m) and its reciprocal
    diagonal."""
    return 4 * (m * team_ld(m) + m)


# The largest m whose runtime-m block fits MAX_SMEM: 240.
K2_MAX_M = max(m for m in range(1, 400)
               if k2_block_smem_bytes(m) <= MAX_SMEM)


def spd_inv_variant(m: int) -> str:
    """The K2 design that serves m: "unrolled" (m in K2_UNROLLED_M) or
    "runtime_m" (any other 1 <= m <= K2_MAX_M). Raises ValueError for any
    other m."""
    if m in K2_UNROLLED_M:
        return "unrolled"
    if 1 <= m <= K2_MAX_M:
        return "runtime_m"
    raise ValueError(
        f"chol_inverse: m={m} is outside K2's range 1..{K2_MAX_M} (its "
        f"cap): a block would need {k2_block_smem_bytes(m)} bytes of shared "
        f"memory, a block may take {MAX_SMEM}")


def k2_runtime_shape(m: int) -> tuple[int, int]:
    """The runtime-m kernel's launch shape at m, (warps_per_block,
    matrices_per_block): (K2_WARP_MATRICES, K2_WARP_MATRICES), a warp a
    matrix, up to K2_WARP_MAX_M; (warps, 1), a block a matrix, above, one
    warp per K2_BLOCK_ENTRIES_PER_WARP entries (2 to 32)."""
    if m <= K2_WARP_MAX_M:
        return K2_WARP_MATRICES, K2_WARP_MATRICES
    return min(32, max(2, -(-m * m // K2_BLOCK_ENTRIES_PER_WARP))), 1


def k2_runtime_plan(shape: tuple[int, int]) -> str:
    """"warp" (a warp a matrix) or "block" (a block a matrix) for a
    runtime-m launch shape."""
    warps, matrices = shape
    return "warp" if matrices == warps else "block"


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
    edge parameters. R: the polygons a block takes of each lane (a chunk's
    in the split plan)."""
    return lanes_per_block * R * (16 * V + 4) + 4 * S


# Warps of a one-lane block in K3's "lane" and "split" plans: a block of
# four warps, as the measured shapes have.
K3_WIDE_WARPS = 4
# The most chunks of a lane in the split plan (a grid's second axis).
K3_MAX_CHUNKS = 65535


def k3_max_samples(V: int) -> int:
    """The most samples an edge K3 takes at V vertices a polygon: one
    polygon's staged edges and count and the S edge parameters fill one
    block (16 V + 4 + 4 S <= MAX_SMEM): 58,079 at V = 8. Its one cap."""
    return (MAX_SMEM - (16 * V + 4)) // 4


def k3_variant(R: int, V: int, S: int) -> tuple[str, tuple[int, int, int]]:
    """K3's launch plan for R polygons of V vertices a lane and S samples
    an edge: (name, (lanes_per_block, warps_per_lane, chunk)), a block
    taking `chunk` polygons of each of its lanes.

    - "measured": k3_launch_shape(R), the whole of each lane's R polygons
      in one block, where that block fits MAX_SMEM (every shape of the
      slices: R <= 880 at V = 8, S = 16);
    - "lane": one lane a block of K3_WIDE_WARPS warps, where that fits
      (R <= 1,760 at V = 8, S = 16);
    - "split": one lane a block, its R polygons in chunks of as many as
      fit one block, over a second grid axis of at most K3_MAX_CHUNKS.

    Raises ValueError where one polygon does not fit a block
    (S > k3_max_samples(V)) or the chunks exceed K3_MAX_CHUNKS."""
    if R < 1 or V < 1 or S < 1:
        raise ValueError(f"footprint_cost: R={R}, V={V}, S={S} must be >= 1")
    lanes, warps = k3_launch_shape(R)
    if k3_smem_bytes(R, V, S, lanes) <= MAX_SMEM:
        return "measured", (lanes, warps, R)
    if k3_smem_bytes(R, V, S, 1) <= MAX_SMEM:
        return "lane", (1, K3_WIDE_WARPS, R)
    if S > k3_max_samples(V):
        raise ValueError(
            f"footprint_cost: one polygon of {V} vertices with {S} samples "
            f"an edge needs {k3_smem_bytes(1, V, S, 1)} bytes of shared "
            f"memory, a block may take {MAX_SMEM} (K3 takes at most "
            f"{k3_max_samples(V)} samples an edge at {V} vertices)")
    chunk = (MAX_SMEM - 4 * S) // (16 * V + 4)
    if -(-R // chunk) > K3_MAX_CHUNKS:
        raise ValueError(
            f"footprint_cost: {R} polygons a lane need more than "
            f"{K3_MAX_CHUNKS} chunks of {chunk}")
    return "split", (1, K3_WIDE_WARPS, chunk)


# Above this many vertices a polygon of K3's walk mode takes a whole warp,
# each thread walking every 32nd edge; up to it, a thread an edge.
K3_WALK_WARP_VERTICES = 32


def k3_walk_variant(V: int) -> str:
    """K3's walk-mode plan at V vertices a polygon: "edge_a_thread"
    (V <= K3_WALK_WARP_VERTICES, every earlier launch) or
    "edges_a_thread" (above). The walk has no cap: it stages nothing."""
    if V < 1:
        raise ValueError(f"footprint_walk: V={V} must be >= 1")
    return "edge_a_thread" if V <= K3_WALK_WARP_VERTICES else "edges_a_thread"


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch_qp_admm(ins, m: int, iters: int, rho: float, sigma: float,
                   warps_per_lane: int | None = None):
    """ins: the 12 batch-major operands of QP_INPUTS, each (B, rows).
    Returns the 7 batch-major outputs of QP_OUTPUTS, from the design of
    k1_warps_per_lane(m), or of `warps_per_lane` where given (to time the
    designs against each other)."""
    if warps_per_lane is None:
        warps_per_lane = k1_warps_per_lane(m)
    lib = load_library()
    B = ins[0].shape[0]
    rows = qp_rows(m)
    outs = [torch.empty((B, rows[name]), dtype=torch.float32,
                        device=ins[0].device) for name in QP_OUTPUTS]
    rc = lib.neo_qp_admm_f32(m, B, warps_per_lane, int(iters), float(rho),
                             float(sigma),
                             float(sigma + rho),
                             *(t.data_ptr() for t in ins),
                             *(t.data_ptr() for t in outs),
                             _stream(ins[0].device))
    _check(rc, "qp_admm")
    return outs


# K2's widths (warps a block of 32 matrices) that csrc/spd_inv.cu builds
# for its unrolled design (the runtime-m kernel's shape is
# k2_runtime_shape's).
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


def spd_inv_shape(m: int, B: int, device) -> tuple[int, int]:
    """K2's launch shape for B matrices of m x m on `device`,
    (warps_per_block, matrices_per_block): the unrolled design's
    (k2_launch_shape(B, device), K2_UNROLLED_MATRICES), or the runtime-m
    kernel's k2_runtime_shape(m)."""
    if spd_inv_variant(m) == "unrolled":
        return k2_launch_shape(B, device), K2_UNROLLED_MATRICES
    return k2_runtime_shape(m)


def _launch_spd_inv_at(M: torch.Tensor,
                       shape: tuple[int, int]) -> torch.Tensor:
    spd_inv_variant(M.shape[-1])
    lib = load_library()
    X = torch.empty_like(M)
    rc = lib.neo_spd_inv_f32(M.shape[-1], M.shape[0], *shape, M.data_ptr(),
                             X.data_ptr(), _stream(M.device))
    _check(rc, "spd_inv")
    return X


def launch_spd_inv(M: torch.Tensor) -> torch.Tensor:
    """M: batch-major (B, m, m). Returns the inverses, (B, m, m), at
    spd_inv_shape's launch shape."""
    return _launch_spd_inv_at(
        M, spd_inv_shape(M.shape[-1], M.shape[0], M.device))


def launch_footprint_cost(data, origin, res, bounds, verts, n_valid, t,
                          shift=None, shape: tuple[int, int] | None = None):
    """data (Bm, H, W), origin (Bm, 2), res (Bm,), bounds (Bm, 4) int32 or
    None (the whole grid), verts (Bm, R, V, 2), n_valid (Bm, R) int32,
    t (S,) or None, shift (Bm, 2) int32 or None (a view's win_lo).
    With t, K3's sampled mode (neo_footprint_cost_f32) at k3_variant's
    plan, or at shape = (lanes_per_block, warps_per_lane) with a lane's R
    polygons in one block when a shape is given; with t None, its walk
    mode (neo_footprint_walk_f32) at K3_WALK_THREADS a block. Returns the
    (Bm, R) costs."""
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
    if shape is None:
        _, (lanes, warps, chunk) = k3_variant(R, V, t.shape[0])
    else:
        (lanes, warps), chunk = shape, R
    rc = lib.neo_footprint_cost_f32(
        Bm, R, H, W, V, t.shape[0], lanes, warps, chunk, *maps, t.data_ptr(),
        out.data_ptr(), _stream(data.device))
    _check(rc, "footprint_cost")
    return out
