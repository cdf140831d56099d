// Device functions of the SPD inverse, shared by K1 (qp_admm.cu) and K2
// (spd_inv.cu).
//
// The unrolled functions (tree_sum, cholesky, inverse_column: K2's unrolled
// design; K1's warp team takes tree_sum and max_nan) mirror
// neo_mpc_planner2_tpu/sqp.py::_chol_inverse_unrolled: Cholesky with the
// diagonal carried as its reciprocal square root (rsqrtf, so neither the
// factorization nor the substitutions divide), forward substitution for
// Y = L^-1 (lower triangular), back substitution for the lower triangle of
// X = L^-T Y, mirrored to the upper, every inner dot product summed
// pairwise in the order of the reference's _tree_sum. They are fully
// unrolled: every index is a compile-time constant, so ptxas keeps the
// arrays in registers.
//
// team_inverse takes m at run time and spreads each step over a team of
// threads (a warp or a block): K1's warp-lane and block-lane designs and
// K2's runtime-m kernel.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace neo_mpc {

// Pairwise sum of p[0..n) in the order of sqp.py::_tree_sum:
// [p0+p1, p2+p3, ...] then the odd tail, repeated. Destroys p.
template <int CAP>
__device__ __forceinline__ float tree_sum(float (&p)[CAP], int n) {
#pragma unroll
  for (int len = CAP; len > 1; len = (len + 1) / 2) {
    if (n > 1) {
      const int half = n / 2;
#pragma unroll
      for (int i = 0; i < CAP / 2; ++i)
        if (i < half) p[i] = p[2 * i] + p[2 * i + 1];
      if (n & 1) p[half] = p[n - 1];
      n = (n + 1) / 2;
    }
  }
  return p[0];
}

// Propagates NaN like jnp.maximum(s, tiny).
__device__ __forceinline__ float max_nan(float s, float lo) {
  return (s < lo) ? lo : s;
}

// E: the lower triangle (i >= j) of the SPD matrix; it is overwritten with
// the Cholesky factor L, and D[j] = 1 / L[j][j].
template <int M>
__device__ __forceinline__ void cholesky(float (&E)[M][M], float (&D)[M]) {
  const float tiny = 1e-20f;
  float p[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    float s = E[j][j];
    if (j > 0) {
#pragma unroll
      for (int k = 0; k < M; ++k)
        if (k < j) p[k] = E[j][k] * E[j][k];
      s = s - tree_sum(p, j);
    }
    s = max_nan(s, tiny);
    D[j] = rsqrtf(s);
    E[j][j] = s * D[j];  // == sqrt(s)
#pragma unroll
    for (int i = j + 1; i < M; ++i) {
      float si = E[i][j];
      if (j > 0) {
#pragma unroll
        for (int k = 0; k < M; ++k)
          if (k < j) p[k] = E[i][k] * E[j][k];
        si = si - tree_sum(p, j);
      }
      E[i][j] = si * D[j];
    }
  }
}

// Column C of the inverse from the factor L (lower triangle) and D: column
// C of Y = L^-1 by forward substitution, then X[i][C] for i >= C by back
// substitution. Columns are independent given L, so any set of them can be
// computed apart with the same rounding. Returns X[i][C] in Xc[i], i >= C.
template <int M, int C>
__device__ __forceinline__ void inverse_column(const float (&L)[M][M],
                                               const float (&D)[M],
                                               float (&Xc)[M]) {
  float p[M];
  float Y[M];
  Y[C] = D[C];
#pragma unroll
  for (int i = C + 1; i < M; ++i) {
#pragma unroll
    for (int k = 0; k < M; ++k)
      if (k >= C && k < i) p[k - C] = L[i][k] * Y[k];
    Y[i] = -tree_sum(p, i - C) * D[i];
  }
#pragma unroll
  for (int i = M - 1; i >= C; --i) {
    float acc = Y[i];
    if (i + 1 < M) {
#pragma unroll
      for (int k = 0; k < M; ++k)
        if (k > i) p[k - i - 1] = L[k][i] * Xc[k];
      acc = acc - tree_sum(p, M - 1 - i);
    }
    Xc[i] = acc * D[i];
  }
}


// The most shared memory a block may take on an H100 (227 KB).
constexpr long long kMaxBlockSmem = 232448;

// Lets a kernel take `smem` bytes of dynamic shared memory: above 48 KB
// the kernel's limit must be raised first; above kMaxBlockSmem it cannot.
static inline cudaError_t set_smem(const void* kernel, long long smem) {
  if (smem > kMaxBlockSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Row stride of a team's matrix in shared memory: m rounded up to odd, so
// that threads reading one column of consecutive rows hit distinct banks.
__host__ __device__ constexpr int team_ld(int m) { return m | 1; }

// The threads that share one matrix: a warp (its lanes synchronised by
// __syncwarp) or a whole block (by __syncthreads).
struct WarpTeam {
  int rank;
  static constexpr int size = 32;
  __device__ __forceinline__ void sync() const { __syncwarp(); }
};

struct BlockTeam {
  int rank;
  int size;
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

// floor(a / w) for 0 <= a < 2^21 and 1 <= w < 2^21: (a + 1/2) / w lies at
// least 1/(2w) from an integer, further than the float32 rounding of the
// reciprocal and the product can move it, so truncation is exact; a few
// instructions where an integer division takes ~20 (on an H100 the
// runtime-m kernels ran 4-6 % faster with it; PERF.md).
__device__ __forceinline__ int div_small(int a, int w) {
  return __float2int_rz((static_cast<float>(a) + 0.5f) *
                        __frcp_rn(static_cast<float>(w)));
}

// Walks the indices first, first + step, ... of a row-major grid w wide as
// (q, r) = (e / w, e % w), with two divisions in all, not two a step.
struct GridWalk {
  int q, r, dq, dr, w;
  __device__ __forceinline__ GridWalk(int first, int step, int width)
      : w(width) {
    q = div_small(first, w);
    r = first - q * w;
    dq = div_small(step, w);
    dr = step - dq * w;
  }
  __device__ __forceinline__ void next() {
    r += dr;
    q += dq;
    if (r >= w) {
      r -= w;
      ++q;
    }
  }
};

// The lower triangle of an n x n matrix, its n (n + 1) / 2 entries (a, b),
// b <= a, folded onto a grid n + 1 wide: grid row q holds row q (b = 0..q)
// and then row n - 1 - q, so consecutive indices take consecutive entries
// of one row.
__device__ __forceinline__ void fold(const GridWalk& g, int n, int& a,
                                     int& b) {
  if (g.r <= g.q) {
    a = g.q;
    b = g.r;
  } else {
    a = n - 1 - g.q;
    b = g.r - g.q - 1;
  }
}

// Pivots a pass of team_inverse where a thread may take 64 registers (a
// block of up to 1024 threads); wider panels spilled there.
constexpr int kPanel = 4;

// The SPD inverse of one m x m matrix by a team of threads, m at run time
// (K1's warp-lane and block-lane designs, K2's runtime-m kernel). S holds
// the matrix at row stride ld in shared memory, of which only the lower
// triangle (i >= j) is read; D is m floats of shared memory. On return
// (after team.sync()) the lower triangle of S holds that of the inverse X
// (X[i][j] = X[j][i] at S[i][j], i >= j) and D the reciprocal diagonal of
// the Cholesky factor L. The semantics of
// sqp.py::_chol_inverse_unrolled: Cholesky with the pivot max_nan(s,
// 1e-20) carried as its reciprocal square root, Y = L^-1, and X = L^-T Y
// (here Y^T Y). Each sum runs in its own order, one multiply-add a term in
// the order of a right-looking sweep (not _tree_sum's pairs); the two
// differ by float32 rounding only.
//
// Both sweeps go PANEL pivots a pass, two team.sync()s a pass, every part
// of a pass spread over the whole team, so the depth is ~m/2 syncs of
// parallel work:
//   1. Cholesky, right-looking. (a) Every thread factors the pass's
//      PANEL x PANEL diagonal block itself (the same values everywhere:
//      no barrier for it), then the team computes the panel below it, a
//      thread a row: L[i][k+p] = (S[i][k+p] - sum_{r<p} L[i][k+r]
//      L[k+p][k+r]) D[k+p]. (b) The team updates the trailing triangle,
//      S[i][j] -= sum_p L[i][k+p] L[j][k+p], a thread a share of its
//      entries, PANEL terms an entry for one load and one store of it.
//   2. Y = L^-1, right-looking: W[r][c] = [r == c] - sum_{j<k} L[r][j]
//      Y[j][c] is row r's partial sum. (a) The team finishes the pass's
//      PANEL rows of Y, a thread a column c: Y[k+q][c] = (W[k+q][c] -
//      sum_{p<q} L[k+q][k+p] Y[k+p][c]) D[k+q], Y[k][k] = D[k]. (b) It
//      subtracts sum_p L[r][k+p] Y[k+p][c] from every W[r][c] below, a
//      thread a share of the entries. W[r][c], then Y[r][c], lies at
//      S[c][r], in the strict upper triangle; the first update of each
//      entry (the pass of pivot c) writes it without reading it, so the
//      input's upper triangle is never read.
//   3. X[i][j] = sum_{k >= i} Y[k][i] Y[k][j], i >= j: independent dot
//      products, a thread a share of them, written over L.
// A pass adds its PANEL terms to each entry in the order the one-pivot
// sweep would, so the result does not depend on PANEL or on the team's
// size. Consecutive threads take consecutive entries of a row (or of a
// column stored as a row of S) and read a column of S at the odd stride
// ld, so no step meets a bank conflict beyond its broadcasts.
template <int PANEL, class Team>
__device__ __forceinline__ void team_inverse(float* S, float* D, int m,
                                             int ld, const Team& team) {
  const float tiny = 1e-20f;
  const int t = team.rank, P = team.size;
  for (int k = 0; k < m; k += PANEL) {
    const int kb = min(PANEL, m - k);
    // The diagonal block's factor: Lb[q][p] = L[k+q][k+p], p < q; dq.
    float Lb[PANEL][PANEL], dq[PANEL];
#pragma unroll
    for (int q = 0; q < PANEL; ++q) {
      if (q < kb) {
#pragma unroll
        for (int p = 0; p < q; ++p) {
          float v = S[(k + q) * ld + k + p];
#pragma unroll
          for (int r = 0; r < p; ++r) v = fmaf(-Lb[q][r], Lb[p][r], v);
          Lb[q][p] = v * dq[p];
        }
        float v = S[(k + q) * ld + k + q];
#pragma unroll
        for (int r = 0; r < q; ++r) v = fmaf(-Lb[q][r], Lb[q][r], v);
        dq[q] = rsqrtf(max_nan(v, tiny));
      }
    }
    // The panel, a thread a row.
    for (int i = k + kb + t; i < m; i += P) {
      float li[PANEL];
#pragma unroll
      for (int p = 0; p < PANEL; ++p) {
        if (p < kb) {
          float v = S[i * ld + k + p];
#pragma unroll
          for (int r = 0; r < p; ++r) v = fmaf(-li[r], Lb[p][r], v);
          li[p] = v * dq[p];
          S[i * ld + k + p] = li[p];
        }
      }
    }
    team.sync();
    if (t == 0) {
#pragma unroll
      for (int q = 0; q < PANEL; ++q) {
        if (q < kb) {
          D[k + q] = dq[q];
#pragma unroll
          for (int p = 0; p < q; ++p) S[(k + q) * ld + k + p] = Lb[q][p];
        }
      }
    }
    const int j0 = k + kb, n = m - j0, total = n * (n + 1) / 2;
    if (t < total) {
      GridWalk g(t, P, n + 1);
      for (int e = t; e < total; e += P, g.next()) {
        int a, b;
        fold(g, n, a, b);
        const int i = j0 + a, j = j0 + b;
        float v = S[i * ld + j];
#pragma unroll
        for (int p = 0; p < PANEL; ++p)
          if (p < kb) v = fmaf(-S[i * ld + k + p], S[j * ld + k + p], v);
        S[i * ld + j] = v;
      }
    }
    team.sync();
  }
  for (int k = 0; k < m; k += PANEL) {
    const int kb = min(PANEL, m - k);
    float Lb[PANEL][PANEL], dq[PANEL];
#pragma unroll
    for (int q = 0; q < PANEL; ++q) {
      if (q < kb) {
        dq[q] = D[k + q];
#pragma unroll
        for (int p = 0; p < q; ++p) Lb[q][p] = S[(k + q) * ld + k + p];
      }
    }
    // Rows k .. k + kb - 1 of Y, a thread a column c < k + kb.
    for (int c = t; c < k + kb; c += P) {
      float y[PANEL];
#pragma unroll
      for (int q = 0; q < PANEL; ++q) {
        if (q < kb && c < k + q) {
          // p0 >= 0: c is the block's column k + p0 (< k + q), whose
          // first term -L[k+q][c] D[c] starts the sum.
          const int p0 = c - k;
          float w = p0 >= 0 ? 0.0f : S[c * ld + k + q];
#pragma unroll
          for (int r = 0; r < PANEL; ++r) {
            if (r < q && r == p0)
              w = -(Lb[q][r] * dq[r]);
            else if (r < q && r > p0)
              w = fmaf(-Lb[q][r], y[r], w);
          }
          y[q] = w * dq[q];
          S[c * ld + k + q] = y[q];
        } else {
          y[q] = (q < kb && c == k + q) ? dq[q] : 0.0f;
        }
      }
    }
    team.sync();
    // W[r][c] -= sum_p L[r][k+p] Y[k+p][c], r >= k + kb, c < k + kb.
    const int r0 = k + kb, n = m - r0, total = n * (k + kb);
    if (t < total) {
      GridWalk g(t, P, n);  // q: the column c, r: the row below the pass
      for (int e = t; e < total; e += P, g.next()) {
        const int c = g.q, r = r0 + g.r;
        const int p0 = c - k;  // the block's own column if >= 0
        float w;
        if (p0 >= 0)
          w = -(S[r * ld + c] * D[c]);
        else
          w = S[c * ld + r];
#pragma unroll
        for (int p = 0; p < PANEL; ++p)
          if (p < kb && p > p0)
            w = fmaf(-S[r * ld + k + p], S[c * ld + k + p], w);
        S[c * ld + r] = w;
      }
    }
    team.sync();
  }
  const int total = m * (m + 1) / 2;
  if (t < total) {
    GridWalk g(t, P, m + 1);
    for (int e = t; e < total; e += P, g.next()) {
      int i, j;
      fold(g, m, i, j);
      float acc = D[i] * (i == j ? D[i] : S[j * ld + i]);
#pragma unroll 4
      for (int k = i + 1; k < m; ++k)
        acc = fmaf(S[i * ld + k], S[j * ld + k], acc);
      S[i * ld + j] = acc;
    }
  }
  team.sync();
}

// Stages one matrix's m*m contiguous floats from global src into shared S
// at row stride ld: each thread of the team copies every team.size-th
// float as an asynchronous 4-byte copy (cp.async: the global side is
// coalesced, and no copy passes through a register). 16-byte copies would
// need rows on 16-byte boundaries, and the odd stride that keeps the
// inverse's column reads free of bank conflicts rules those out. The
// caller commits the copies and waits for them.
template <class Team>
__device__ __forceinline__ void stage_matrix(float* S, int ld,
                                             const float* src, int m,
                                             const Team& team) {
  const int n = m * m;
  if (team.rank >= n) return;
  GridWalk g(team.rank, team.size, m);
  for (int e = team.rank; e < n; e += team.size, g.next())
    __pipeline_memcpy_async(S + g.q * ld + g.r, src + e, sizeof(float));
}

// X[r][c] after team_inverse: the lower triangle holds both halves.
__device__ __forceinline__ float inverse_at(const float* S, int ld, int r,
                                            int c) {
  return r >= c ? S[r * ld + c] : S[c * ld + r];
}

}  // namespace neo_mpc
