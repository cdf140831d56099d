// K1: the whole ADMM QP subproblem of one SQP iteration, a team of threads
// per lane, at every m = 3N up to K1's cap (kernels/binding.py:
// qp_admm_variant): the warp-team design at m <= 30, the block-team design
// above.
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
// The warp-team design is instantiated at every m = 3N <= 30 (N <= 10; at
// m = 3 ten teams a warp, from m = 18 on one team a warp with idle threads).
// Above m = 30 a team no longer fits a warp, and a thread's rows of m floats
// (five of them, and the Cholesky's scratch) no longer fit its registers.
//
// The block-team design (qp_admm_kernel_block_team), m > 30, m at run time:
// one lane a block, a thread a row, m rounded up to whole warps. What bounds
// it on an H100: shared memory and the dependent chain. The block's matrix
// lives in dynamic shared memory, (m team_ld(m) + 3m) floats with the
// reciprocal diagonal, rhs and d (m = 36: 5.8 KB; K1's cap m = 237 takes
// 227,520 of the 232,448 bytes a block may have, above 48 KB only after the
// launcher raises the kernel's limit); the inverse is spd_inverse.cuh's
// team_inverse (every sum in _tree_sum's order, the forward substitution's
// too), with a barrier for each of the factor's m columns; each ADMM iteration
// takes two barriers: rhs goes through shared memory as in the warp-team
// design, and so does d, since the cone pair's rows 3k and 3k + 1 straddle a
// warp boundary from k = 21 on (rows 63 and 64), where a shuffle no longer
// reaches. Thread i reads row i of the symmetric M^-1 as column i (S[j][i]:
// consecutive threads, consecutive words) and the rhs as a broadcast, in the
// warp-team design's two interleaved multiply-add chains.
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
  static_assert(M >= 3 && M <= 30 && M % 3 == 0, "m = 3 N, N <= 10");
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

// The block-team design: one lane a block, thread i < m owns row i (the
// threads from m on only meet the barriers), m at run time.
__global__ void __launch_bounds__(256) qp_admm_kernel_block_team(
    const float* __restrict__ Bf, const float* __restrict__ g,
    const float* __restrict__ x, const float* __restrict__ c,
    const float* __restrict__ dxy, const float* __restrict__ lo,
    const float* __restrict__ hi, const float* __restrict__ d0,
    const float* __restrict__ zb0, const float* __restrict__ zc0,
    const float* __restrict__ wb0, const float* __restrict__ wc0,
    float* __restrict__ dout, float* __restrict__ dN, float* __restrict__ zbN,
    float* __restrict__ zcN, float* __restrict__ wbN, float* __restrict__ wcN,
    float* __restrict__ ycone, int m, int iters, float rho, float sigma,
    float sigma_plus_rho) {
  extern __shared__ float qp_smem[];
  const int ld = team_ld(m), N = m / 3;
  float* S = qp_smem;        // M (lower triangle), then M^-1 (whole)
  float* D = S + m * ld;     // reciprocal diagonal of L
  float* Rs = D + m;         // rhs
  float* Ds = Rs + m;        // d
  const long long b = blockIdx.x;
  const int i = threadIdx.x;
  const bool row = i < m;
  for (int k = threadIdx.x; k < m * m; k += blockDim.x)
    S[(k / m) * ld + k % m] = __ldg(Bf + b * m * m + k);
  const int k3 = i / 3, a = i - 3 * (i / 3);
#define NEO_ROW(p, rows, r) (row ? __ldg((p) + b * (rows) + (r)) : 0.0f)
  const float dx = NEO_ROW(dxy, 2 * N, 2 * k3);
  const float dy = NEO_ROW(dxy, 2 * N, 2 * k3 + 1);
  const float cc = NEO_ROW(c, N, k3);
  __syncthreads();

  // 1. Row i of M (entries j <= i), as the warp-team design builds it: only
  // the entries of row i's own cone pair take a J'J term.
  if (row) {
    for (int j = 3 * k3; j <= i; ++j) {
      float e = S[i * ld + j];
      const int bj = j - 3 * k3;
      if (a < 2 && bj < 2)
        e = e + rho * ((a == 0 ? dx : dy) * (bj == 0 ? dx : dy));
      if (j == i) e = e + sigma_plus_rho;
      S[i * ld + j] = e;
    }
  }
  __syncthreads();

  // 2. M^-1, whole and symmetric, in S.
  team_inverse(S, D, m, i);

  // 3. ADMM.
  const float gi = NEO_ROW(g, m, i);
  const float xi = NEO_ROW(x, m, i);
  const float dlo = NEO_ROW(lo, m, i) - xi, dhi = NEO_ROW(hi, m, i) - xi;
  float d = NEO_ROW(d0, m, i), zb = NEO_ROW(zb0, m, i);
  float wb = NEO_ROW(wb0, m, i);
  float zc = NEO_ROW(zc0, N, k3), wc = NEO_ROW(wc0, N, k3);
#undef NEO_ROW
  const float cone = (a == 0) ? rho * dx : ((a == 1) ? rho * dy : 0.0f);
  const int pair = (a == 0) ? i + 1 : ((a == 1) ? i - 1 : i);
  for (int it = 0; it < iters; ++it) {
    // Rs and Ds are rewritten only after the barrier that follows their
    // last reads, so one buffer each serves.
    if (row) Rs[i] = -gi + sigma * d + rho * (zb - wb) + cone * (zc - wc);
    __syncthreads();
    if (row) {
      float s0 = 0.0f, s1 = 0.0f;
      int j = 0;
      for (; j + 1 < m; j += 2) {
        s0 = fmaf(S[j * ld + i], Rs[j], s0);
        s1 = fmaf(S[(j + 1) * ld + i], Rs[j + 1], s1);
      }
      if (j < m) s0 = fmaf(S[j * ld + i], Rs[j], s0);
      d = s0 + s1;
      zb = clip_nan(d + wb, dlo, dhi);
      Ds[i] = d;
    }
    __syncthreads();
    if (row) {
      const float dq = Ds[pair];
      const float da = (a == 0) ? d : dq;
      const float db = (a == 0) ? dq : d;
      const float jd = dx * da + dy * db;
      const float z = jd + wc;
      zc = (z < -cc) ? -cc : z;
      wc = wc + jd - zc;
      wb = wb + d - zb;
    }
  }

  // 4. Outputs, batch-major.
  if (row) {
    dout[b * m + i] = clip_nan(d, dlo, dhi);
    dN[b * m + i] = d;
    zbN[b * m + i] = zb;
    wbN[b * m + i] = wb;
    if (a == 0) {
      zcN[b * N + k3] = zc;
      wcN[b * N + k3] = wc;
      ycone[b * N + k3] = rho * wc;
    }
  }
}

static long long qp_block_smem(int m) {
  return 4LL * (static_cast<long long>(m) * team_ld(m) + 3 * m);
}

static cudaError_t launch_qp_block(const float* const* in, float* const* out,
                                   int m, int B, int iters, float rho,
                                   float sigma, float sigma_plus_rho,
                                   cudaStream_t stream) {
  const long long smem = qp_block_smem(m);
  if (m % 3 != 0 || m <= 30 || smem > kMaxBlockSmem)
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        qp_admm_kernel_block_team,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int threads = (m + 31) / 32 * 32;
  qp_admm_kernel_block_team<<<static_cast<unsigned>(B), threads,
                              static_cast<size_t>(smem), stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9],
      in[10], in[11], out[0], out[1], out[2], out[3], out[4], out[5], out[6],
      m, iters, rho, sigma, sigma_plus_rho);
  return cudaGetLastError();
}

}  // namespace neo_mpc

// Every operand batch-major and contiguous: Bflat (B, m*m); g, x, lo, hi,
// d0, zb0, wb0 (B, m); c, zc0, wc0 (B, m/3); dxy (B, 2m/3). Outputs d_out,
// d, zb, wb (B, m); zc, wc, y_cone (B, m/3). Returns cudaGetLastError().
extern "C" int neo_qp_admm_f32(
    int m, int B, int iters, float rho, float sigma, float sigma_plus_rho,
    const void* Bflat, const void* g, const void* x, const void* c,
    const void* dxy, const void* lo, const void* hi, const void* d0,
    const void* zb0, const void* zc0, const void* wb0, const void* wc0,
    void* d_out, void* d, void* zb, void* zc, void* wb, void* wc,
    void* y_cone, void* stream) {
  if (B <= 0 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* in[12] = {
      static_cast<const float*>(Bflat), static_cast<const float*>(g),
      static_cast<const float*>(x),     static_cast<const float*>(c),
      static_cast<const float*>(dxy),   static_cast<const float*>(lo),
      static_cast<const float*>(hi),    static_cast<const float*>(d0),
      static_cast<const float*>(zb0),   static_cast<const float*>(zc0),
      static_cast<const float*>(wb0),   static_cast<const float*>(wc0)};
  float* out[7] = {static_cast<float*>(d_out), static_cast<float*>(d),
                   static_cast<float*>(zb),    static_cast<float*>(zc),
                   static_cast<float*>(wb),    static_cast<float*>(wc),
                   static_cast<float*>(y_cone)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NEO_QP_CASE(M)                                                       \
  case M:                                                                    \
    return neo_mpc::launch_qp<M>(in, out, B, iters, rho, sigma,              \
                                 sigma_plus_rho, s);
  switch (m) {
    NEO_QP_CASE(3) NEO_QP_CASE(6) NEO_QP_CASE(9) NEO_QP_CASE(12)
    NEO_QP_CASE(15) NEO_QP_CASE(18) NEO_QP_CASE(21) NEO_QP_CASE(24)
    NEO_QP_CASE(27) NEO_QP_CASE(30)
    default:
      return static_cast<int>(neo_mpc::launch_qp_block(
          in, out, m, B, iters, rho, sigma, sigma_plus_rho, s));
  }
#undef NEO_QP_CASE
}
