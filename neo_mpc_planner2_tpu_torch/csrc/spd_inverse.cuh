// Unrolled SPD inverse shared by the QP kernel (qp_admm.cu) and the batched
// inverse kernel (spd_inv.cu).
//
// Mirrors neo_mpc_planner2_tpu/sqp.py::_chol_inverse_unrolled: Cholesky with
// the diagonal carried as its reciprocal square root (rsqrtf, so neither the
// factorization nor the substitutions divide), forward substitution for
// Y = L^-1 (lower triangular), back substitution for the lower triangle of
// X = L^-T Y, mirrored to the upper. Every inner dot product is summed
// pairwise in the order of the reference's _tree_sum.
//
// One thread owns one matrix; the arrays below live in registers when they
// fit. Fully unrolled, every index is a compile-time constant, so ptxas can
// keep only the live entries: at m = 15 the batched inverse needs 168
// registers and the fused QP 255, the most a thread may have (CUDA 12.8,
// no spill). A larger m would not fit and would spill.
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
// the Cholesky factor L. X receives the full symmetric inverse.
template <int M>
__device__ __forceinline__ void spd_inverse(float (&E)[M][M], float (&X)[M][M]) {
  const float tiny = 1e-20f;
  float D[M];  // 1 / L[j][j]
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

  // Forward: Y = L^-1, entries (i, c) with c <= i.
  float Y[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    Y[i][i] = D[i];
#pragma unroll
    for (int c = 0; c < i; ++c) {
#pragma unroll
      for (int k = 0; k < M; ++k)
        if (k >= c && k < i) p[k - c] = E[i][k] * Y[k][c];
      Y[i][c] = -tree_sum(p, i - c) * D[i];
    }
  }

  // Backward: X = L^-T Y, lower triangle, mirrored.
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
#pragma unroll
    for (int c = 0; c <= i; ++c) {
      float acc = Y[i][c];
      if (i + 1 < M) {
#pragma unroll
        for (int k = 0; k < M; ++k)
          if (k > i) p[k - i - 1] = E[k][i] * X[k][c];
        acc = acc - tree_sum(p, M - 1 - i);
      }
      X[i][c] = acc * D[i];
      X[c][i] = X[i][c];
    }
  }
}

}  // namespace neo_mpc
