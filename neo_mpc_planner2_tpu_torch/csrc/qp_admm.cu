// K1: the whole ADMM QP subproblem of one SQP iteration, a team of threads
// per lane, at every m = 3N up to K1's cap (kernels/binding.py:
// qp_admm_variant): the warp-team design up to m = 18, the warp-lane design
// up to m = 63, the block-lane design above.
//
// Replaces the TPU kernel neo_mpc_planner2_tpu/sqp.py::_qp_admm_kernel
// (launched by _qp_admm_pallas_batched). Per lane it solves
//     min 1/2 d'Bd + g'd   s.t.  lo - x <= d <= hi - x,  J d >= -c
// where J, the cone Jacobian, has two nonzeros per row (dx_k, dy_k at
// columns 3k, 3k+1):
//   1. M = B + (sigma + rho) I + rho J'J, built from dx/dy alone;
//   2. M^-1 by this kernel's own team version of the division-free
//      Cholesky (rsqrt diagonal), forward and back substitution, inner
//      products summed by spd_inverse.cuh's tree_sum in sqp._tree_sum's
//      pairwise order (the one exception is below);
//   3. `iters` ADMM iterations: d = M^-1 rhs, box clip -> zb, cone max -> zc,
//      dual updates (all of them: no early exit, as the TPU kernel);
//   4. the box-clipped d, the warm-start carry (d, zb, zc, wb, wc) and the
//      cone duals y_cone = rho * wc.
//
// What bounds it on an H100: arithmetic latency. A lane does ~1k
// operations for the inverse and ~280 per ADMM iteration on 211 floats of
// input and output, so at 60 iterations it is compute-bound, and on one
// thread a lane each iteration is a serial chain of ~m^2 dependent
// operations. The design splits every lane over a team of m threads,
// packed 32 / m teams to a warp (three at m = 9): thread i owns row i.
//   - Inverse: thread i builds row i of M and of the Cholesky factor L,
//     reading pivot rows from shared memory; thread c then computes column
//     c of L^-1 and of X = L^-T L^-1, the column that is row c of the
//     symmetric X. The sums keep the serial order (tree_sum), except the
//     forward substitution's, whose range starts at the thread's own
//     column: there a multiply-add chain over the whole range, zeros
//     included, keeps every register index a compile-time constant (the
//     pairwise order from a runtime start cost ~10x the instructions).
//   - ADMM: thread i keeps row i of M^-1 in registers and computes d[i] as
//     a dot product of m multiply-adds in two interleaved chains; rhs goes
//     through shared memory (one store, one __syncwarp, m/4 vector loads;
//     two buffers in turn, so one barrier an iteration), the box clip and
//     wb stay with row i, and the cone pair (zc_k, wc_k) with rows 3k and
//     3k + 1, which trade d through one shuffle. Each iteration's
//     dependent chain is ~m, not ~m^2. With 4096 lanes the card holds ~10
//     warps an SM, and the iterations are bound by instruction issue, so
//     the loop is written for few instructions: the cone's weight in rhs
//     is one precomputed coefficient a row, and the dot product is
//     multiply-adds, not the serial version's products and pairwise sum
//     (the two differ by float32 rounding only). Measured and dropped: rhs
//     exchanged by m shuffles in teams of 16 (the shuffle pipe and the
//     idle rows made it slower than one thread a lane), and the cone rows
//     forming J_k d from a kept row of J M^-1 (more instructions).
//   - A thread holds one row (m floats) instead of the 2 m^2 of one thread
//     a lane, so registers no longer cap m or occupancy; at m = 9, 4096
//     lanes make 1366 warps over all 132 SMs.
//   - Operands are batch-major, (B, rows), as the JAX package's public
//     functions take them: a block's lanes are contiguous rows, read with
//     coalesced loads, and written back the same way, so the wrapper is
//     one launch with no transposes.
// The warp-team design is instantiated at every m = 3N <= 18
// (binding.K1_WARP_TEAM_MAX_M; at m = 3 ten teams a warp, at 18 one team a
// warp with idle threads): from m = 21 on the warp lane below ran faster
// on an H100, and from 24 on a team's rows of m floats (five of them, and
// the Cholesky's scratch) spilled 536-1,156 bytes.
//
// The runtime-m designs (binding.qp_admm_variant: from m = 21, where the
// warp lane ran ahead of the warp team on an H100, to the cap). What
// bounds them: the lane's inverse, ~m^3 operations on a matrix in shared
// memory, then `iters` matrix-vector products of ~2m^2 operations. Both
// invert M with spd_inverse.cuh's team_inverse, whose every step is spread
// over the team (a right-looking Cholesky and L^-1, a panel of pivots a
// pass, then X = L^-T L^-1 as independent dot products; ~m/2 syncs of the
// team in all), so no thread runs an O(m^2) chain; its sums run in their
// own order, within float32 rounding of the serial version.
//   - The warp lane (qp_admm_kernel_warp_lane<CAP>, m <= 63): a warp a
//     lane, four lanes a block, rows i and i + 32 a thread. The warp's
//     inverse syncs by __syncwarp; the thread keeps its rows of M^-1 in
//     registers (CAP floats a row, compile-time indices: CAP = 32, 48 and
//     64 serve m up to each; no instance spills); rhs goes through a
//     per-warp buffer (two in turn, so one __syncwarp an iteration) read
//     back as float4 broadcasts, and the cone pair trades d by a shuffle.
//     No block barrier.
//   - The block lane (qp_admm_kernel_block_lane, 63 < m <= 237): a block
//     a lane, warp w owning rows 30w .. 30w + 29 (whole cone triples, so a
//     pair still trades d by a shuffle), every thread of the block sharing
//     the inverse; M^-1 stays in shared memory (mirrored, read as column i),
//     rhs in one of two buffers in turn: one block barrier an iteration. Its
//     shared memory, (m team_ld(m) + m + 2 ceil4(m)) floats, caps m at 237
//     (227,544 of the 232,448 bytes a block may have).
//
// TMA and wgmma do not fit: every lane has its own m x m matrix and one
// matrix-vector product per iteration, with no operand shared between
// lanes to tile, and a block's operands are a few KB of contiguous rows
// that plain coalesced loads bring in.
#include <cuda_runtime.h>

#include "spd_inverse.cuh"

namespace neo_mpc {

constexpr int kQpThreads = 128;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float clip_nan(float v, float lo, float hi) {
  // min(max(v, lo), hi) with NaN propagation, like jnp.clip.
  v = (v < lo) ? lo : v;
  return (v > hi) ? hi : v;
}

template <int M>
__global__ void __launch_bounds__(kQpThreads) qp_admm_kernel(
    const float* __restrict__ Bf, const float* __restrict__ g,
    const float* __restrict__ x, const float* __restrict__ c,
    const float* __restrict__ dxy, const float* __restrict__ lo,
    const float* __restrict__ hi, const float* __restrict__ d0,
    const float* __restrict__ zb0, const float* __restrict__ zc0,
    const float* __restrict__ wb0, const float* __restrict__ wc0,
    float* __restrict__ dout, float* __restrict__ dN, float* __restrict__ zbN,
    float* __restrict__ zcN, float* __restrict__ wbN, float* __restrict__ wcN,
    float* __restrict__ ycone, int B, int iters, float rho, float sigma,
    float sigma_plus_rho) {
  constexpr int N = M / 3;
  constexpr int WARPS = kQpThreads / 32;
  constexpr int LPW = 32 / M;           // lanes (teams) a warp
  constexpr int LANES = WARPS * LPW;    // lanes a block
  constexpr int SLOTS = WARPS * (LPW + 1);
  constexpr int MP = (M + 3) / 4 * 4;   // rhs row, padded for float4 reads
  static_assert(M >= 3 && M <= 18 && M % 3 == 0, "m = 3 N, N <= 6");
  // Per team slot: M (in its lower triangle: E, overwritten by L, then X),
  // the reciprocal diagonal of L, and two rhs buffers. Each warp has one
  // slot more than it has lanes: its last 32 - LPW * M threads form a
  // team that runs every step on zeros and stores nothing, so that each
  // shuffle and __syncwarp sees the whole warp.
  __shared__ float Ms[SLOTS * M * M];
  __shared__ float Ds[SLOTS * M];
  __shared__ __align__(16) float Rs[2][SLOTS * MP];

  const int warp = threadIdx.x >> 5;
  const int l = threadIdx.x & 31;
  const int t = l / M;                   // team in the warp; LPW: idle
  const int i = l - t * M;               // the row this thread owns
  const int slot = warp * (LPW + 1) + t;
  const long long b0 = static_cast<long long>(blockIdx.x) * LANES;
  const long long b = b0 + warp * LPW + t;
  const bool row = t < LPW && b < B;
  float* S = Ms + slot * M * M;
  float* D = Ds + slot * M;

  // The block's lanes are contiguous rows of Bf: one coalesced sweep.
  for (int k = threadIdx.x; k < LANES * M * M; k += kQpThreads) {
    const long long idx = b0 * M * M + k;
    const int lane = k / (M * M);
    const int to = (lane / LPW) * (LPW + 1) + lane % LPW;
    Ms[to * M * M + k - lane * M * M] =
        idx < static_cast<long long>(B) * M * M ? __ldg(Bf + idx) : 0.0f;
  }
  const int k3 = i / 3, a = i - 3 * (i / 3);
  // This row's entry of a batch-major operand with `rows` rows a lane.
  const long long bl = row ? b : 0;
#define NEO_ROW(p, rows, r) (row ? __ldg((p) + bl * (rows) + (r)) : 0.0f)
  const float dx = NEO_ROW(dxy, 2 * N, 2 * k3);
  const float dy = NEO_ROW(dxy, 2 * N, 2 * k3 + 1);
  const float cc = NEO_ROW(c, N, k3);
  __syncthreads();

  // 1. Row i of M (entries j <= i).
  float Er[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    float e = (row && j <= i) ? S[i * M + j] : 0.0f;
    const int kj = j / 3, bj = j % 3;
    if (kj == k3 && a < 2 && bj < 2)
      e = e + rho * ((a == 0 ? dx : dy) * (bj == 0 ? dx : dy));
    if (j == i) e = e + sigma_plus_rho;
    Er[j] = e;
  }

  // 2a. Cholesky, column by column: thread j takes the pivot, then every
  // row below it its entry of column j. Row i of L stays in Lr and goes to
  // S for the rows below.
  const float tiny = 1e-20f;
  float Lr[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    float p[M];
    Lr[j] = 0.0f;
    if (i == j) {
      float s = Er[j];
      if (j > 0) {
#pragma unroll
        for (int k = 0; k < j; ++k) p[k] = Lr[k] * Lr[k];
        s = s - tree_sum(p, j);
      }
      s = max_nan(s, tiny);
      const float dj = rsqrtf(s);
      Lr[j] = s * dj;
      D[j] = dj;
    }
    __syncwarp();
    if (i > j) {
      float si = Er[j];
      if (j > 0) {
#pragma unroll
        for (int k = 0; k < j; ++k) p[k] = Lr[k] * S[j * M + k];
        si = si - tree_sum(p, j);
      }
      Lr[j] = si * D[j];
      S[i * M + j] = Lr[j];
    }
  }
  __syncwarp();

  // 2b. Forward: column i of Y = L^-1, Y[r][i] for r >= i. The column's
  // entries above row i are 0, so the dot product over k < r runs from
  // k = 0 with every index a compile-time constant: a multiply-add chain
  // in k order (the serial version sums L[r][k] Y[k][i] for k in [i, r)
  // pairwise; the two differ by float32 rounding only).
  float Yc[M];
#pragma unroll
  for (int r = 0; r < M; ++r) {
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < r; ++k) sum = fmaf(S[r * M + k], Yc[k], sum);
    Yc[r] = (r == i) ? D[r] : ((r > i) ? -sum * D[r] : 0.0f);
  }

  // 2c. Backward: column i of X = L^-T Y, X[r][i] for r >= i.
  float Xc[M];
#pragma unroll
  for (int r = M - 1; r >= 0; --r) {
    float acc = Yc[r];
    if (r + 1 < M) {
      float p[M];
#pragma unroll
      for (int k = r + 1; k < M; ++k) p[k - r - 1] = S[k * M + r] * Xc[k];
      acc = acc - tree_sum(p, M - 1 - r);
    }
    Xc[r] = acc * D[r];
  }

  // Row i of the symmetric X: X[i][j] is column j's entry at row i for
  // j < i, this thread's own column entry for j >= i.
  __syncwarp();
#pragma unroll
  for (int r = 0; r < M; ++r)
    if (r >= i) S[r * M + i] = Xc[r];
  __syncwarp();
  float Xr[M];
#pragma unroll
  for (int j = 0; j < M; ++j) Xr[j] = (j < i) ? S[i * M + j] : Xc[j];

  // 3. ADMM.
  const float gi = NEO_ROW(g, M, i);
  const float xi = NEO_ROW(x, M, i);
  const float dlo = NEO_ROW(lo, M, i) - xi, dhi = NEO_ROW(hi, M, i) - xi;
  float d = NEO_ROW(d0, M, i), zb = NEO_ROW(zb0, M, i);
  float wb = NEO_ROW(wb0, M, i);
  float zc = NEO_ROW(zc0, N, k3), wc = NEO_ROW(wc0, N, k3);
#undef NEO_ROW
  // Row i's weight of the cone dual in rhs (J' (zc - wc))_i: dx or dy of
  // its pair, 0 for rows 3k + 2.
  const float cone = (a == 0) ? rho * dx : ((a == 1) ? rho * dy : 0.0f);
  // The other row of the cone pair: 3k + 1 for row 3k, 3k for row 3k + 1.
  const int pair = (a == 0) ? l + 1 : ((a == 1) ? l - 1 : l);
  for (int it = 0; it < iters; ++it) {
    float* rs = Rs[it & 1] + slot * MP;
    rs[i] = -gi + sigma * d + rho * (zb - wb) + cone * (zc - wc);
    __syncwarp();
    // d[i] = X[i] . rhs, as two interleaved multiply-add chains.
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int q = 0; q < MP / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(rs)[q];
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * q + e;
        if (j < M) {
          if (j % 2 == 0) s0 = fmaf(Xr[j], vs[e], s0);
          else s1 = fmaf(Xr[j], vs[e], s1);
        }
      }
    }
    d = s0 + s1;
    zb = clip_nan(d + wb, dlo, dhi);
    // Rows 3k and 3k + 1 both form J_k d = dx d[3k] + dy d[3k+1], by the
    // same instructions, so their copies of (zc_k, wc_k) stay equal.
    const float dq = __shfl_sync(kFullMask, d, pair);
    const float da = (a == 0) ? d : dq;
    const float db = (a == 0) ? dq : d;
    const float jd = dx * da + dy * db;
    const float z = jd + wc;
    zc = (z < -cc) ? -cc : z;
    wc = wc + jd - zc;
    wb = wb + d - zb;
  }

  // 4. Outputs, batch-major.
  if (row) {
    dout[b * M + i] = clip_nan(d, dlo, dhi);
    dN[b * M + i] = d;
    zbN[b * M + i] = zb;
    wbN[b * M + i] = wb;
    if (a == 0) {
      zcN[b * N + k3] = zc;
      wcN[b * N + k3] = wc;
      ycone[b * N + k3] = rho * wc;
    }
  }
}

template <int M>
cudaError_t launch_qp(const float* const* in, float* const* out, int B,
                      int iters, float rho, float sigma, float sigma_plus_rho,
                      cudaStream_t stream) {
  constexpr int LANES = (kQpThreads / 32) * (32 / M);
  const int blocks = (B + LANES - 1) / LANES;
  qp_admm_kernel<M><<<blocks, kQpThreads, 0, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9],
      in[10], in[11], out[0], out[1], out[2], out[3], out[4], out[5], out[6],
      B, iters, rho, sigma, sigma_plus_rho);
  return cudaGetLastError();
}

// One row i of a lane in K1's runtime-m designs: its box, its share of the
// ADMM carry, and its cone pair's (zc_k, wc_k), which rows 3k and 3k + 1
// both carry and update by the same instructions (rows 3k + 2 carry a copy
// they never use). The arithmetic of the warp-team design, step for step.
struct QpRow {
  float gi, dlo, dhi, d, zb, wb, zc, wc, dx, dy, cc, cone;
  int k3, a;

  // Loads row i of lane b (every operand batch-major), zeros where !live.
  __device__ __forceinline__ void load(const float* const* in, long long b,
                                       int m, int i, bool live, float rho) {
    const int N = m / 3;
    k3 = i / 3;
    a = i - 3 * k3;
#define NEO_ROW(p, rows, r) (live ? __ldg((p) + b * (rows) + (r)) : 0.0f)
    dx = NEO_ROW(in[4], 2 * N, 2 * k3);
    dy = NEO_ROW(in[4], 2 * N, 2 * k3 + 1);
    cc = NEO_ROW(in[3], N, k3);
    gi = NEO_ROW(in[1], m, i);
    const float xi = NEO_ROW(in[2], m, i);
    dlo = NEO_ROW(in[5], m, i) - xi;
    dhi = NEO_ROW(in[6], m, i) - xi;
    d = NEO_ROW(in[7], m, i);
    zb = NEO_ROW(in[8], m, i);
    wb = NEO_ROW(in[10], m, i);
    zc = NEO_ROW(in[9], N, k3);
    wc = NEO_ROW(in[11], N, k3);
#undef NEO_ROW
    cone = (a == 0) ? rho * dx : ((a == 1) ? rho * dy : 0.0f);
  }

  // Row i of M = B + (sigma + rho) I + rho J'J in S (entries j <= i): only
  // the entries of row i's own cone pair take a J'J term.
  __device__ __forceinline__ void build(float* S, int ld, int i, float rho,
                                        float sigma_plus_rho) const {
    for (int j = 3 * k3; j <= i; ++j) {
      float e = S[i * ld + j];
      const int bj = j - 3 * k3;
      if (a < 2 && bj < 2)
        e = e + rho * ((a == 0 ? dx : dy) * (bj == 0 ? dx : dy));
      if (j == i) e = e + sigma_plus_rho;
      S[i * ld + j] = e;
    }
  }

  __device__ __forceinline__ float rhs(float rho, float sigma) const {
    return -gi + sigma * d + rho * (zb - wb) + cone * (zc - wc);
  }

  // The rest of an iteration from d[i] = dn and its cone pair's d, dq.
  __device__ __forceinline__ void update(float dn, float dq) {
    d = dn;
    zb = clip_nan(d + wb, dlo, dhi);
    const float da = (a == 0) ? d : dq;
    const float db = (a == 0) ? dq : d;
    const float jd = dx * da + dy * db;
    const float z = jd + wc;
    zc = (z < -cc) ? -cc : z;
    wc = wc + jd - zc;
    wb = wb + d - zb;
  }

  // The lane-minor offset of row i's cone pair: +1 for row 3k, -1 for row
  // 3k + 1, 0 for row 3k + 2.
  __device__ __forceinline__ int pair() const {
    return (a == 0) ? 1 : ((a == 1) ? -1 : 0);
  }

  __device__ __forceinline__ void store(float* const* out, long long b,
                                        int m, int i, float rho) const {
    const int N = m / 3;
    out[0][b * m + i] = clip_nan(d, dlo, dhi);
    out[1][b * m + i] = d;
    out[2][b * m + i] = zb;
    out[4][b * m + i] = wb;
    if (a == 0) {
      out[3][b * N + k3] = zc;
      out[5][b * N + k3] = wc;
      out[6][b * N + k3] = rho * wc;
    }
  }
};

struct QpArgs {
  const float* in[12];
  float* out[7];
};

// Lanes a block of the warp-lane design.
constexpr int kWarpLanes = 4;
// Pivots a pass of the warp lane's inverse at row capacity CAP: from CAP =
// 48 on the threads hold 96-128 floats of M^-1 in registers anyway, and
// eight pivots ran faster than four there; at CAP = 32 four ran faster.
__host__ __device__ constexpr int warp_lane_panel(int cap) {
  return cap > 32 ? 8 : kPanel;
}

// Blocks an SM that the warp lane's register budget allows at row capacity
// CAP (__launch_bounds__): at 32, 64 registers a thread, as many as the
// smallest budget ptxas chose; at 48, 168, where it chose 168 and nothing
// spilled; at 64 one block, 222 registers, where ptxas chose 168 and
// spilled when left to itself (a 68-register CAP = 32 instance ran ~15 %
// slower than a 64-register one on an H100).
__host__ __device__ constexpr int warp_lane_min_blocks(int cap) {
  return cap <= 32 ? 8 : (cap <= 48 ? 3 : 1);
}

// Floats of shared memory of one lane of the warp-lane design at row
// capacity CAP: two rhs buffers of CAP floats, the matrix at stride
// team_ld(m) and its reciprocal diagonal, rounded up to whole float4s.
__host__ __device__ constexpr long long warp_lane_floats(int m, int cap) {
  return (2LL * cap + static_cast<long long>(m) * team_ld(m) + m + 3) / 4 *
         4;
}

// The warp-lane design: one lane a warp, kWarpLanes lanes a block, m at
// run time up to CAP (32: a row a thread; 48, 64: rows i and i + 32). The
// warp stages its lane's M, builds it, inverts it (team_inverse, synchronised
// by __syncwarp) and keeps its rows of M^-1 in registers (CAP floats a
// row, every index a compile-time constant); each ADMM iteration writes
// rhs to the lane's buffer (two in turn), takes one __syncwarp, and reads
// rhs back as float4 broadcasts. A cone pair's rows 3k and 3k + 1 sit on
// neighbouring threads (rows 31 and 32 are in no pair), which trade d by
// one shuffle. No block barrier anywhere.
template <int CAP>
__global__ void __launch_bounds__(32 * kWarpLanes, warp_lane_min_blocks(CAP))
    qp_admm_kernel_warp_lane(
    QpArgs args, int B, int m, int iters, float rho, float sigma,
    float sigma_plus_rho) {
  constexpr bool TWO = CAP > 32;
  extern __shared__ __align__(16) float qp_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * kWarpLanes + warp;
  if (b >= B) return;
  const int ld = team_ld(m);
  float* R = qp_smem + warp * warp_lane_floats(m, CAP);
  float* S = R + 2 * CAP;
  float* D = S + m * ld;
  const WarpTeam team{lane};
  stage_matrix(S, ld, args.in[0] + b * m * m, m, team);
  for (int j = m + lane; j < CAP; j += 32) R[j] = R[CAP + j] = 0.0f;
  const int i0 = lane, i1 = lane + 32;
  const bool live0 = i0 < m, live1 = TWO && i1 < m;
  QpRow r0, r1;
  r0.load(args.in, b, m, i0, live0, rho);
  if constexpr (TWO) r1.load(args.in, b, m, i1, live1, rho);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  team.sync();
  if (live0) r0.build(S, ld, i0, rho, sigma_plus_rho);
  if (live1) r1.build(S, ld, i1, rho, sigma_plus_rho);
  team.sync();
  team_inverse<warp_lane_panel(CAP)>(S, D, m, ld, team);

  float X0[CAP], X1[TWO ? CAP : 1];
#pragma unroll
  for (int j = 0; j < CAP; ++j) {
    X0[j] = (live0 && j < m) ? inverse_at(S, ld, i0, j) : 0.0f;
    if constexpr (TWO)
      X1[j] = (live1 && j < m) ? inverse_at(S, ld, i1, j) : 0.0f;
  }
  const int pair0 = lane + r0.pair(), pair1 = lane + (TWO ? r1.pair() : 0);
  for (int it = 0; it < iters; ++it) {
    float* rs = R + (it & 1) * CAP;
    if (live0) rs[i0] = r0.rhs(rho, sigma);
    if (live1) rs[i1] = r1.rhs(rho, sigma);
    team.sync();
    // d[i] = X[i] . rhs, as two interleaved multiply-add chains a row.
    float s0 = 0.0f, s1 = 0.0f, t0 = 0.0f, t1 = 0.0f;
#pragma unroll
    for (int q = 0; q < CAP / 4; ++q) {
      if (4 * q >= m) break;
      const float4 v = reinterpret_cast<const float4*>(rs)[q];
      s0 = fmaf(X0[4 * q], v.x, s0);
      s1 = fmaf(X0[4 * q + 1], v.y, s1);
      s0 = fmaf(X0[4 * q + 2], v.z, s0);
      s1 = fmaf(X0[4 * q + 3], v.w, s1);
      if constexpr (TWO) {
        t0 = fmaf(X1[4 * q], v.x, t0);
        t1 = fmaf(X1[4 * q + 1], v.y, t1);
        t0 = fmaf(X1[4 * q + 2], v.z, t0);
        t1 = fmaf(X1[4 * q + 3], v.w, t1);
      }
    }
    const float d0 = s0 + s1;
    r0.update(d0, __shfl_sync(kFullMask, d0, pair0));
    if constexpr (TWO) {
      const float d1 = t0 + t1;
      r1.update(d1, __shfl_sync(kFullMask, d1, pair1));
    }
  }
  if (live0) r0.store(args.out, b, m, i0, rho);
  if (live1) r1.store(args.out, b, m, i1, rho);
}

// Copies the strict lower triangle of S to the upper, a team's threads a
// share of its entries each, then syncs the team.
template <class Team>
__device__ __forceinline__ void mirror_lower(float* S, int m, int ld,
                                             const Team& team) {
  const int n = m - 1, total = n * (n + 1) / 2;
  if (team.rank < total) {
    GridWalk g(team.rank, team.size, n + 1);
    for (int e = team.rank; e < total; e += team.size, g.next()) {
      int a, b;
      fold(g, n, a, b);
      S[b * ld + a + 1] = S[(a + 1) * ld + b];
    }
  }
  team.sync();
}

// Floats of shared memory of the block-lane design: two rhs buffers of m
// rounded up to whole float4s, the matrix at stride team_ld(m) and its
// reciprocal diagonal.
__host__ __device__ constexpr long long block_lane_floats(int m) {
  return 2LL * ((m + 3) / 4 * 4) + static_cast<long long>(m) * team_ld(m) +
         m;
}

// The block-lane design: one lane a block, for lanes too wide for a warp.
// Warp w owns rows 30 w .. 30 w + 29 (ten whole cone triples, so a pair's
// rows trade d by a shuffle; lanes 30 and 31 idle in the iterations), and
// every thread of the block shares the inverse's steps. After the inverse
// the lower triangle is mirrored, so thread i reads row i of M^-1 as
// column i (S[j][i]: consecutive threads, consecutive words); each ADMM
// iteration writes rhs to one of two buffers in turn and takes one block
// barrier.
__global__ void __launch_bounds__(1024) qp_admm_kernel_block_lane(
    QpArgs args, int m, int iters, float rho, float sigma,
    float sigma_plus_rho) {
  extern __shared__ __align__(16) float qp_smem[];
  const int ld = team_ld(m), mp = (m + 3) / 4 * 4;
  float* R = qp_smem;
  float* S = R + 2 * mp;
  float* D = S + m * ld;
  const long long b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int i = 30 * (threadIdx.x >> 5) + lane;
  const bool live = lane < 30 && i < m;
  const BlockTeam team{static_cast<int>(threadIdx.x),
                       static_cast<int>(blockDim.x)};
  stage_matrix(S, ld, args.in[0] + b * m * m, m, team);
  for (int j = m + threadIdx.x; j < mp; j += blockDim.x)
    R[j] = R[mp + j] = 0.0f;
  QpRow r;
  r.load(args.in, b, m, i, live, rho);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  team.sync();
  if (live) r.build(S, ld, i, rho, sigma_plus_rho);
  team.sync();
  team_inverse<kPanel>(S, D, m, ld, team);
  mirror_lower(S, m, ld, team);

  const int pair = lane + r.pair();
  for (int it = 0; it < iters; ++it) {
    float* rs = R + (it & 1) * mp;
    if (live) rs[i] = r.rhs(rho, sigma);
    team.sync();
    float s0 = 0.0f, s1 = 0.0f;
    if (live) {
      int j = 0;
      for (; j + 3 < m; j += 4) {
        const float4 v = reinterpret_cast<const float4*>(rs)[j / 4];
        s0 = fmaf(S[j * ld + i], v.x, s0);
        s1 = fmaf(S[(j + 1) * ld + i], v.y, s1);
        s0 = fmaf(S[(j + 2) * ld + i], v.z, s0);
        s1 = fmaf(S[(j + 3) * ld + i], v.w, s1);
      }
      for (; j < m; ++j) {
        if (j % 2 == 0)
          s0 = fmaf(S[j * ld + i], rs[j], s0);
        else
          s1 = fmaf(S[j * ld + i], rs[j], s1);
      }
    }
    const float dn = s0 + s1;
    r.update(dn, __shfl_sync(kFullMask, dn, pair));
  }
  if (live) r.store(args.out, b, m, i, rho);
}

template <int CAP>
cudaError_t launch_qp_warp_lane_at(const QpArgs& args, int m, int B,
                                   int iters, float rho, float sigma,
                                   float sigma_plus_rho,
                                   cudaStream_t stream) {
  const long long smem = 4 * kWarpLanes * warp_lane_floats(m, CAP);
  const cudaError_t err = set_smem(
      reinterpret_cast<const void*>(qp_admm_kernel_warp_lane<CAP>), smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (static_cast<long long>(B) + kWarpLanes - 1) / kWarpLanes;
  qp_admm_kernel_warp_lane<CAP><<<static_cast<unsigned>(blocks),
                                  32 * kWarpLanes, static_cast<size_t>(smem),
                                  stream>>>(args, B, m, iters, rho, sigma,
                                            sigma_plus_rho);
  return cudaGetLastError();
}

static cudaError_t launch_qp_runtime(const QpArgs& args, int m, int B,
                                     int warps_per_lane, int iters,
                                     float rho, float sigma,
                                     float sigma_plus_rho,
                                     cudaStream_t stream) {
  if (m < 3 || m % 3 != 0) return cudaErrorInvalidValue;
  if (warps_per_lane == 1) {
    if (m <= 32)
      return launch_qp_warp_lane_at<32>(args, m, B, iters, rho, sigma,
                                        sigma_plus_rho, stream);
    if (m <= 48)
      return launch_qp_warp_lane_at<48>(args, m, B, iters, rho, sigma,
                                        sigma_plus_rho, stream);
    if (m <= 64)
      return launch_qp_warp_lane_at<64>(args, m, B, iters, rho, sigma,
                                        sigma_plus_rho, stream);
    return cudaErrorInvalidValue;
  }
  if (warps_per_lane < (m + 29) / 30 || warps_per_lane > 32)
    return cudaErrorInvalidValue;
  const long long smem = 4 * block_lane_floats(m);
  const cudaError_t err = set_smem(
      reinterpret_cast<const void*>(qp_admm_kernel_block_lane), smem);
  if (err != cudaSuccess) return err;
  qp_admm_kernel_block_lane<<<static_cast<unsigned>(B), 32 * warps_per_lane,
                              static_cast<size_t>(smem), stream>>>(
      args, m, iters, rho, sigma, sigma_plus_rho);
  return cudaGetLastError();
}

}  // namespace neo_mpc

// Every operand batch-major and contiguous: Bflat (B, m*m); g, x, lo, hi,
// d0, zb0, wb0 (B, m); c, zc0, wc0 (B, m/3); dxy (B, 2m/3). Outputs d_out,
// d, zb, wb (B, m); zc, wc, y_cone (B, m/3). warps_per_lane picks the
// design: 0 the warp team (m <= 18, several lanes a warp), 1 the warp lane
// (m <= 64), 2 or more the block lane (at least one warp per 30 rows).
// Returns cudaGetLastError().
extern "C" int neo_qp_admm_f32(
    int m, int B, int warps_per_lane, int iters, float rho, float sigma,
    float sigma_plus_rho, const void* Bflat, const void* g, const void* x,
    const void* c, const void* dxy, const void* lo, const void* hi,
    const void* d0, const void* zb0, const void* zc0, const void* wb0,
    const void* wc0, void* d_out, void* d, void* zb, void* zc, void* wb,
    void* wc, void* y_cone, void* stream) {
  if (B <= 0 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  neo_mpc::QpArgs args = {
      {static_cast<const float*>(Bflat), static_cast<const float*>(g),
       static_cast<const float*>(x),     static_cast<const float*>(c),
       static_cast<const float*>(dxy),   static_cast<const float*>(lo),
       static_cast<const float*>(hi),    static_cast<const float*>(d0),
       static_cast<const float*>(zb0),   static_cast<const float*>(zc0),
       static_cast<const float*>(wb0),   static_cast<const float*>(wc0)},
      {static_cast<float*>(d_out), static_cast<float*>(d),
       static_cast<float*>(zb),    static_cast<float*>(zc),
       static_cast<float*>(wb),    static_cast<float*>(wc),
       static_cast<float*>(y_cone)}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (warps_per_lane != 0)
    return static_cast<int>(neo_mpc::launch_qp_runtime(
        args, m, B, warps_per_lane, iters, rho, sigma, sigma_plus_rho, s));
#define NEO_QP_CASE(M)                                                       \
  case M:                                                                    \
    return neo_mpc::launch_qp<M>(args.in, args.out, B, iters, rho, sigma,    \
                                 sigma_plus_rho, s);
  switch (m) {
    NEO_QP_CASE(3) NEO_QP_CASE(6) NEO_QP_CASE(9) NEO_QP_CASE(12)
    NEO_QP_CASE(15) NEO_QP_CASE(18)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NEO_QP_CASE
}
