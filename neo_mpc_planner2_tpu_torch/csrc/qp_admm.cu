// K1: the whole ADMM QP subproblem of one SQP iteration, one thread per lane.
//
// Replaces the TPU kernel neo_mpc_planner2_tpu/sqp.py::_qp_admm_kernel
// (launched by _qp_admm_pallas_batched). Per lane it solves
//     min 1/2 d'Bd + g'd   s.t.  lo - x <= d <= hi - x,  J d >= -c
// where J, the cone Jacobian, has two nonzeros per row (dx_k, dy_k at
// columns 3k, 3k+1):
//   1. M = B + (sigma + rho) I + rho J'J, built from dx/dy alone;
//   2. M^-1 by the unrolled, division-free Cholesky (spd_inverse.cuh);
//   3. `iters` ADMM iterations: d = M^-1 rhs, box clip -> zb, cone max -> zc,
//      dual updates;
//   4. the box-clipped d and the warm-start carry (d, zb, zc, wb, wc).
// The caller forms y_cone = rho * wc.
//
// What bounds it on an H100: at m = 9 a lane does about m^3/2 operations for
// the inverse and about iters * (m^2 + 6m) for the iterations (some 8k
// flops at iters = 60) on about 160 floats of input and output, so the
// kernel is bound by the latency of each thread's serial chain, not by
// memory. Layout: every operand is lane-minor (rows, B), so neighbouring
// threads read neighbouring addresses. Registers are the scarce resource:
// the per-thread working set (the lower triangle of M, its inverse, the
// substitution scratch and five vectors) grows as m^2. ptxas (CUDA 12.8)
// gives the m = 15 instance all 255 registers a thread may have, without
// spilling; a larger m would not fit. With 128 threads a block, a
// 4096-lane batch fills 32 blocks, one on each of 32 of the 132 SMs: the
// launch shape and the register pressure are the first things to attack
// when this kernel is made fast.
#include <cuda_runtime.h>

#include "spd_inverse.cuh"

namespace neo_mpc {

__device__ __forceinline__ float clip_nan(float v, float lo, float hi) {
  // min(max(v, lo), hi) with NaN propagation, like jnp.clip.
  v = (v < lo) ? lo : v;
  return (v > hi) ? hi : v;
}

template <int M>
__global__ void qp_admm_kernel(
    const float* __restrict__ Bf, const float* __restrict__ g,
    const float* __restrict__ x, const float* __restrict__ c,
    const float* __restrict__ dxy, const float* __restrict__ lo,
    const float* __restrict__ hi, const float* __restrict__ d0,
    const float* __restrict__ zb0, const float* __restrict__ zc0,
    const float* __restrict__ wb0, const float* __restrict__ wc0,
    float* __restrict__ dout, float* __restrict__ dN, float* __restrict__ zbN,
    float* __restrict__ zcN, float* __restrict__ wbN, float* __restrict__ wcN,
    int B, int iters, float rho, float sigma, float sigma_plus_rho) {
  constexpr int N = M / 3;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  auto at = [&](const float* p, int r) { return p[(size_t)r * B + b]; };

  float dx[N], dy[N], cc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    dx[k] = at(dxy, 2 * k);
    dy[k] = at(dxy, 2 * k + 1);
    cc[k] = at(c, k);
  }

  // 1. The lower triangle of M.
  float E[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float e = at(Bf, i * M + j);
      const int ki = i / 3, a = i % 3, kj = j / 3, bb = j % 3;
      if (ki == kj && a < 2 && bb < 2)
        e = e + rho * ((a == 0 ? dx[ki] : dy[ki]) * (bb == 0 ? dx[kj] : dy[kj]));
      if (i == j) e = e + sigma_plus_rho;
      E[i][j] = e;
    }
  }

  // 2. Its inverse.
  float X[M][M];
  spd_inverse<M>(E, X);

  // 3. ADMM.
  float gg[M], dlo[M], dhi[M], d[M], zb[M], wb[M], zc[N], wc[N];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    gg[i] = at(g, i);
    const float xi = at(x, i);
    dlo[i] = at(lo, i) - xi;
    dhi[i] = at(hi, i) - xi;
    d[i] = at(d0, i);
    zb[i] = at(zb0, i);
    wb[i] = at(wb0, i);
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    zc[k] = at(zc0, k);
    wc[k] = at(wc0, k);
  }
  float rhs[M], p[M];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const int k = i / 3, a = i % 3;
      float r = -gg[i] + sigma * d[i] + rho * (zb[i] - wb[i]);
      if (a == 0) r = r + rho * (dx[k] * (zc[k] - wc[k]));
      if (a == 1) r = r + rho * (dy[k] * (zc[k] - wc[k]));
      rhs[i] = r;
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = 0; j < M; ++j) p[j] = X[i][j] * rhs[j];
      d[i] = tree_sum(p, M);
    }
#pragma unroll
    for (int i = 0; i < M; ++i) zb[i] = clip_nan(d[i] + wb[i], dlo[i], dhi[i]);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float jd = dx[k] * d[3 * k] + dy[k] * d[3 * k + 1];
      const float z = jd + wc[k];
      zc[k] = (z < -cc[k]) ? -cc[k] : z;
      wc[k] = wc[k] + jd - zc[k];
    }
#pragma unroll
    for (int i = 0; i < M; ++i) wb[i] = wb[i] + d[i] - zb[i];
  }

  // 4. Outputs, lane-minor.
  auto put = [&](float* q, int r, float v) { q[(size_t)r * B + b] = v; };
#pragma unroll
  for (int i = 0; i < M; ++i) {
    put(dout, i, clip_nan(d[i], dlo[i], dhi[i]));
    put(dN, i, d[i]);
    put(zbN, i, zb[i]);
    put(wbN, i, wb[i]);
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    put(zcN, k, zc[k]);
    put(wcN, k, wc[k]);
  }
}

template <int M>
cudaError_t launch_qp(const void* const* in, void* const* out, int B, int iters,
                      float rho, float sigma, float sigma_plus_rho,
                      cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  const float* const* i = reinterpret_cast<const float* const*>(in);
  float* const* o = reinterpret_cast<float* const*>(out);
  qp_admm_kernel<M><<<blocks, threads, 0, stream>>>(
      i[0], i[1], i[2], i[3], i[4], i[5], i[6], i[7], i[8], i[9], i[10], i[11],
      o[0], o[1], o[2], o[3], o[4], o[5], B, iters, rho, sigma, sigma_plus_rho);
  return cudaGetLastError();
}

}  // namespace neo_mpc

// in: 12 lane-minor operands (Bflat, g, x, c, dxy, lo, hi, d0, zb0, zc0, wb0,
// wc0); out: 6 (d_out, d, zb, zc, wb, wc). Returns cudaGetLastError().
extern "C" int neo_qp_admm_f32(int m, int B, int iters, float rho, float sigma,
                               float sigma_plus_rho, const void* const* in,
                               void* const* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 6: return neo_mpc::launch_qp<6>(in, out, B, iters, rho, sigma, sigma_plus_rho, s);
    case 9: return neo_mpc::launch_qp<9>(in, out, B, iters, rho, sigma, sigma_plus_rho, s);
    case 15: return neo_mpc::launch_qp<15>(in, out, B, iters, rho, sigma, sigma_plus_rho, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
