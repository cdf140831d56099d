// Device functions of the SPD inverse (K2, spd_inv.cu) and the pairwise sum
// both kernels share; K1 (qp_admm.cu) has its own team inverse and takes
// only tree_sum and max_nan from here.
//
// Mirrors neo_mpc_planner2_tpu/sqp.py::_chol_inverse_unrolled: Cholesky with
// the diagonal carried as its reciprocal square root (rsqrtf, so neither the
// factorization nor the substitutions divide), forward substitution for
// Y = L^-1 (lower triangular), back substitution for the lower triangle of
// X = L^-T Y, mirrored to the upper. Every inner dot product is summed
// pairwise in the order of the reference's _tree_sum.
//
// Fully unrolled, every index is a compile-time constant, so ptxas keeps the
// arrays in registers.
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

}  // namespace neo_mpc
