// K2: batched inverse of SPD matrices, one thread per matrix.
//
// Replaces the TPU kernel neo_mpc_planner2_tpu/sqp.py::_spd_inv_kernel
// (launched by _chol_inverse_pallas_batched): the unrolled Cholesky, forward
// and back substitution, lower triangle mirrored to the upper
// (spd_inverse.cuh, the same device function the QP kernel fuses).
//
// What bounds it on an H100: about m^3/2 dependent operations per matrix on
// 2 m^2 floats of traffic, so it is latency-bound per thread. Operands are
// lane-minor (m*m, B): element (i, j) of matrix b sits at (i*m + j)*B + b,
// so neighbouring threads read neighbouring addresses. Register use grows as
// m^2 (see spd_inverse.cuh).
#include <cuda_runtime.h>

#include "spd_inverse.cuh"

namespace neo_mpc {

template <int M>
__global__ void spd_inv_kernel(const float* __restrict__ A,
                               float* __restrict__ Xout, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float E[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) E[i][j] = A[(size_t)(i * M + j) * B + b];
  float X[M][M];
  spd_inverse<M>(E, X);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) Xout[(size_t)(i * M + j) * B + b] = X[i][j];
}

template <int M>
cudaError_t launch_inv(const void* A, void* X, int B, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  spd_inv_kernel<M><<<blocks, threads, 0, stream>>>(
      static_cast<const float*>(A), static_cast<float*>(X), B);
  return cudaGetLastError();
}

}  // namespace neo_mpc

// A, X: lane-minor (m*m, B) float32. Returns cudaGetLastError().
extern "C" int neo_spd_inv_f32(int m, int B, const void* A, void* X,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 6: return neo_mpc::launch_inv<6>(A, X, B, s);
    case 9: return neo_mpc::launch_inv<9>(A, X, B, s);
    case 15: return neo_mpc::launch_inv<15>(A, X, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
