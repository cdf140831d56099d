// Device functions of the SPD inverse (K2, spd_inv.cu) and the pairwise sum
// both kernels share. K1's warp-team design (qp_admm.cu) has its own team
// inverse and takes only tree_sum and max_nan from here; K1's block-team
// design and K2's runtime-m kernel share team_inverse below.
//
// Mirrors neo_mpc_planner2_tpu/sqp.py::_chol_inverse_unrolled: Cholesky with
// the diagonal carried as its reciprocal square root (rsqrtf, so neither the
// factorization nor the substitutions divide), forward substitution for
// Y = L^-1 (lower triangular), back substitution for the lower triangle of
// X = L^-T Y, mirrored to the upper. Every inner dot product is summed
// pairwise in the order of the reference's _tree_sum.
//
// The unrolled functions (tree_sum, cholesky, inverse_column) are fully
// unrolled: every index is a compile-time constant, so ptxas keeps the
// arrays in registers. TreeSum and team_inverse take m at run time.
#pragma once

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

// The pairwise sum of sqp.py::_tree_sum over terms fed one at a time, for
// up to 2^kTreeLevels - 1 terms. _tree_sum pairs neighbours level by level
// and carries an odd tail up, so its result is the sum of the aligned
// power-of-two blocks of the terms: block[l] holds the pending block of
// 2^l terms when bit l of the count is set; a new term merges with the
// pending blocks of the count's trailing ones (left operand first), and at
// the end the pending blocks combine from the smallest (rightmost) up.
// Every index of `block` is a compile-time constant (the loops unroll and
// the count only selects), so it stays in registers.
constexpr int kTreeLevels = 8;

struct TreeSum {
  float block[kTreeLevels];
  int count = 0;

  __device__ __forceinline__ void add(float v) {
    bool placed = false;
#pragma unroll
    for (int l = 0; l < kTreeLevels; ++l) {
      if (!placed) {
        if ((count >> l) & 1) {
          v = block[l] + v;
        } else {
          block[l] = v;
          placed = true;
        }
      }
    }
    ++count;
  }

  // The sum of the terms added; 0 if none.
  __device__ __forceinline__ float sum() const {
    float s = 0.0f;
    bool any = false;
#pragma unroll
    for (int l = 0; l < kTreeLevels; ++l) {
      if ((count >> l) & 1) {
        s = any ? block[l] + s : block[l];
        any = true;
      }
    }
    return s;
  }
};

// The most shared memory a block may take on an H100 (227 KB).
constexpr long long kMaxBlockSmem = 232448;

// Row stride of a team's matrix in shared memory: m rounded up to odd, so
// that threads reading one column each of consecutive rows hit distinct
// banks.
__host__ __device__ constexpr int team_ld(int m) { return m | 1; }

// The SPD inverse of one m x m matrix by the threads of a block, m at run
// time: thread i < m owns row i (threads from m on only meet the barriers).
// S holds the matrix at row stride team_ld(m) in shared memory, of which
// only the lower triangle (i >= j) is read; D is m floats of shared memory.
// On return (after a barrier) S holds the whole symmetric inverse and D the
// reciprocal diagonal of the Cholesky factor. The same arithmetic as
// sqp.py::_chol_inverse_unrolled, every inner product summed in its
// _tree_sum order (TreeSum):
//   - Cholesky, column by column: thread j takes the pivot, then every row
//     below it its entry of column j, each row of L written over the row of
//     the matrix by its own thread;
//   - thread c then computes column c of Y = L^-1 (forward substitution)
//     into the strict upper part of row c, Y[r][c] at S[c][r], which no
//     thread reads as L, and column c of X = L^-T Y (back substitution)
//     over it, X[c][c] on the diagonal (whose L entry nothing reads after
//     the factorization: the substitutions scale by D);
//   - each row i then mirrors X[i][j], j < i, from S[j][i] into its lower
//     part.
// The strict upper triangle is written before it is read, so garbage there
// never reaches the result.
__device__ __forceinline__ void team_inverse(float* S, float* D, int m,
                                             int i) {
  const int ld = team_ld(m);
  const bool row = i < m;
  const float tiny = 1e-20f;
  for (int j = 0; j < m; ++j) {
    if (i == j) {
      float s = S[j * ld + j];
      if (j > 0) {
        TreeSum t;
        for (int k = 0; k < j; ++k) t.add(S[j * ld + k] * S[j * ld + k]);
        s = s - t.sum();
      }
      s = max_nan(s, tiny);
      D[j] = rsqrtf(s);
    }
    __syncthreads();
    if (row && i > j) {
      float si = S[i * ld + j];
      if (j > 0) {
        TreeSum t;
        for (int k = 0; k < j; ++k) t.add(S[i * ld + k] * S[j * ld + k]);
        si = si - t.sum();
      }
      S[i * ld + j] = si * D[j];
    }
  }
  __syncthreads();
  if (row) {
    const int c = i;
    // Forward: Y[r][c] = -sum_{k in [c, r)} L[r][k] Y[k][c] * D[r], with
    // Y[c][c] = D[c].
    for (int r = c + 1; r < m; ++r) {
      TreeSum t;
      t.add(S[r * ld + c] * D[c]);
      for (int k = c + 1; k < r; ++k) t.add(S[r * ld + k] * S[c * ld + k]);
      S[c * ld + r] = -t.sum() * D[r];
    }
    // Backward: X[r][c] = (Y[r][c] - sum_{k > r} L[k][r] X[k][c]) * D[r].
    for (int r = m - 1; r >= c; --r) {
      float acc = (r == c) ? D[c] : S[c * ld + r];
      if (r + 1 < m) {
        TreeSum t;
        for (int k = r + 1; k < m; ++k)
          t.add(S[k * ld + r] * S[c * ld + k]);
        acc = acc - t.sum();
      }
      S[c * ld + r] = acc * D[r];
    }
  }
  __syncthreads();
  if (row)
    for (int j = 0; j < i; ++j) S[i * ld + j] = S[j * ld + i];
  __syncthreads();
}

}  // namespace neo_mpc
