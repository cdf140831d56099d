// K2: batched inverse of SPD matrices, batch-major (B, m, m) in and out.
//
// Replaces the TPU kernel neo_mpc_planner2_tpu/sqp.py::_spd_inv_kernel
// (launched by _chol_inverse_pallas_batched): the unrolled Cholesky, forward
// and back substitution, lower triangle mirrored to the upper, with the
// device functions of spd_inverse.cuh. Like the TPU kernel it takes any m:
// an unrolled design at m = 3, 6, .., 18 and a runtime-m design for every
// other m up to K2's cap (kernels/binding.py: spd_inv_variant).
//
// The unrolled design (spd_inv_kernel<M, T>). What bounds it on an H100:
//   - At B = 4096 (m = 9: 2.1 MB to move, the lower triangles in and the
//     inverses out, ~3.6 M operations; bound 0.62 us by bytes) the launch
//     and one matrix's dependent chain: a thread's ~900 operations issue
//     one after another in its warp, and the 128 warps of one thread a
//     matrix leave three of every four warp schedulers idle.
//   - At B = 65536 (33 MB; bound 9.9 us) the bytes. The kernel reads whole
//     matrices (2 m^2 floats moved a matrix, 42 MB), so it can reach at
//     most 78 % of that bound; and as every block fits in one wave, the
//     blocks stage, compute and write back in step, not overlapped.
// What the design does:
//   - A block takes 32 consecutive matrices, one a lane. Their m*m floats
//     are contiguous in A, so the block stages them into shared memory with
//     one sweep of 16-byte asynchronous copies (cp.async; 4-byte copies
//     where the view is not 16-byte aligned) and writes the inverses back
//     the same way with 16-byte stores: every global access is coalesced,
//     and the wrapper is one launch with no transposing copies.
//   - T warps (4 or 1, `warps_per_block`) share the block's matrices. Each
//     factors its lane's matrix (Cholesky, a third of the work) and then
//     computes every T-th column of the inverse, dealt in snake order to
//     balance their ~2 (m - c)^2 operations. Columns are independent given
//     the factor, so the result is bit-identical for every T, and a warp's
//     chain is ~1/3 + 2/(3T) of one thread's whole inverse. The role is
//     the same across a warp, so nothing diverges. Small batches take
//     T = 4 (more warps, shorter chains); large ones T = 1 (no repeated
//     Cholesky where bytes bound): binding.k2_launch_shape.
//   - Only the lower triangle is read from shared memory.
// It stops at m = 18: a block's 32 matrices take 41 KB of the 48 KB of
// static shared memory there (56 KB at m = 21), and a thread's factor,
// m (m + 1) / 2 floats, fills its 255 registers (231 at m = 21).
//
// The runtime-m design (spd_inv_kernel_runtime_m), every other m: one matrix a
// block, a thread a row (m rounded up to whole warps), the matrix in dynamic
// shared memory at an odd row stride, inverted in place by spd_inverse.cuh's
// team_inverse, whose sums keep the unrolled design's _tree_sum order. Its
// shared memory, (m team_ld(m) + m) floats, caps m at 240 (m = 241 would take
// 233,288 bytes of the 232,448 a block may have); from 48 KB on the launcher
// raises the kernel's dynamic shared memory limit. Its bound is its dependent
// chain: thread 0 computes the longest column, ~m^2 terms through TreeSum's
// merges, with a barrier for each of the factor's m columns.
// TMA and wgmma do not fit: each matrix is its own small problem with no
// operand shared between matrices, and a block's 10 KB (m = 9) of
// contiguous floats is one sweep of cp.async.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "spd_inverse.cuh"

namespace neo_mpc {

// Copies n floats from global src to shared dst with every thread of the
// block, as asynchronous copies (cp.async: no register round trip, all in
// flight at once): 16 bytes a copy where both ends allow, else 4.
template <int NT>
__device__ __forceinline__ void stage_in(float* dst, const float* src,
                                         int n) {
  if (n % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int c = threadIdx.x; c < n / 4; c += NT)
      __pipeline_memcpy_async(dst + 4 * c, src + 4 * c, 16);
  } else {
    for (int k = threadIdx.x; k < n; k += NT)
      __pipeline_memcpy_async(dst + k, src + k, sizeof(float));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// Copies n floats from shared src to global dst, 16 bytes a store where
// both ends allow.
template <int NT>
__device__ __forceinline__ void stage_out(float* dst, const float* src,
                                          int n) {
  if (n % 4 == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    for (int c = threadIdx.x; c < n / 4; c += NT)
      reinterpret_cast<float4*>(dst)[c] =
          reinterpret_cast<const float4*>(src)[c];
  } else {
    for (int k = threadIdx.x; k < n; k += NT) dst[k] = src[k];
  }
}

// The role that computes column c when T roles share a matrix: columns
// dealt in snake order (0, 1, .., T-1, T-1, .., 0, 0, ..), which balances
// their cost, ~2 (m - c)^2 operations each.
__host__ __device__ constexpr int column_role(int c, int T) {
  return ((c / T) % 2 == 0) ? c % T : T - 1 - c % T;
}

template <int M, int T, int R, int C = 0>
__device__ __forceinline__ void role_columns(const float (&L)[M][M],
                                             const float (&D)[M], float* s) {
  if constexpr (C < M) {
    if constexpr (column_role(C, T) == R) {
      float Xc[M];
      inverse_column<M, C>(L, D, Xc);
#pragma unroll
      for (int i = C; i < M; ++i) {
        s[i * M + C] = Xc[i];
        s[C * M + i] = Xc[i];
      }
    }
    role_columns<M, T, R, C + 1>(L, D, s);
  }
}

template <int M, int T, int R = 0>
__device__ __forceinline__ void columns_of_role(int role,
                                                const float (&L)[M][M],
                                                const float (&D)[M],
                                                float* s) {
  if constexpr (R < T) {
    if (role == R)
      role_columns<M, T, R>(L, D, s);
    else
      columns_of_role<M, T, R + 1>(role, L, D, s);
  }
}

constexpr int kMatricesPerBlock = 32;

template <int M, int T>
__global__ void __launch_bounds__(32 * T) spd_inv_kernel(
    const float* __restrict__ A, float* __restrict__ Xout, int B) {
  constexpr int MM = M * M;
  constexpr int P = kMatricesPerBlock;
  __shared__ __align__(16) float S[P * MM];
  const long long b0 = static_cast<long long>(blockIdx.x) * P;
  const long long here = static_cast<long long>(B) - b0;
  const int n = static_cast<int>((here < P ? here : P) * MM);
  stage_in<32 * T>(S, A + b0 * MM, n);

  const int lane = threadIdx.x & 31;
  const int role = threadIdx.x >> 5;  // the same in a whole warp
  const bool live = lane < here;
  float* s = S + lane * MM;
  float L[M][M];
  float D[M];
  if (live) {
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) L[i][j] = s[i * M + j];
  }
  __syncthreads();  // every role has its copy before any writes the inverse
  if (live) {
    cholesky<M>(L, D);
    columns_of_role<M, T>(role, L, D, s);
  }
  __syncthreads();
  stage_out<32 * T>(Xout + b0 * MM, S, n);
}

template <int M, int T>
cudaError_t launch_inv_t(const float* A, float* X, int B, cudaStream_t s) {
  const long long blocks =
      (static_cast<long long>(B) + kMatricesPerBlock - 1) / kMatricesPerBlock;
  spd_inv_kernel<M, T><<<static_cast<unsigned>(blocks), 32 * T, 0, s>>>(
      A, X, B);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_inv(const void* Av, void* Xv, int B, int warps,
                       cudaStream_t s) {
  const float* A = static_cast<const float*>(Av);
  float* X = static_cast<float*>(Xv);
  switch (warps) {
    case 1: return launch_inv_t<M, 1>(A, X, B, s);
    case 4: return launch_inv_t<M, 4>(A, X, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// One matrix a block: staged whole (coalesced), inverted by team_inverse,
// written back whole.
__global__ void __launch_bounds__(256) spd_inv_kernel_runtime_m(
    const float* __restrict__ A, float* __restrict__ Xout, int m) {
  extern __shared__ float spd_smem[];
  const int ld = team_ld(m);
  float* S = spd_smem;
  float* D = S + m * ld;
  const long long base = static_cast<long long>(blockIdx.x) * m * m;
  for (int k = threadIdx.x; k < m * m; k += blockDim.x)
    S[(k / m) * ld + k % m] = __ldg(A + base + k);
  __syncthreads();
  team_inverse(S, D, m, threadIdx.x);
  for (int k = threadIdx.x; k < m * m; k += blockDim.x)
    Xout[base + k] = S[(k / m) * ld + k % m];
}

static long long spd_block_smem(int m) {
  return 4LL * (static_cast<long long>(m) * team_ld(m) + m);
}

static cudaError_t launch_inv_block(const void* A, void* X, int B, int m,
                                    cudaStream_t s) {
  const long long smem = spd_block_smem(m);
  if (m < 1 || smem > kMaxBlockSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spd_inv_kernel_runtime_m,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int threads = (m + 31) / 32 * 32;
  spd_inv_kernel_runtime_m<<<static_cast<unsigned>(B), threads,
                             static_cast<size_t>(smem), s>>>(
      static_cast<const float*>(A), static_cast<float*>(X), m);
  return cudaGetLastError();
}

}  // namespace neo_mpc

// A, X: batch-major (B, m, m) float32; warps_per_block 1 or 4 (read by the
// unrolled design only). Returns cudaGetLastError().
extern "C" int neo_spd_inv_f32(int m, int B, int warps_per_block,
                               const void* A, void* X, void* stream) {
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 3: return neo_mpc::launch_inv<3>(A, X, B, warps_per_block, s);
    case 6: return neo_mpc::launch_inv<6>(A, X, B, warps_per_block, s);
    case 9: return neo_mpc::launch_inv<9>(A, X, B, warps_per_block, s);
    case 12: return neo_mpc::launch_inv<12>(A, X, B, warps_per_block, s);
    case 15: return neo_mpc::launch_inv<15>(A, X, B, warps_per_block, s);
    case 18: return neo_mpc::launch_inv<18>(A, X, B, warps_per_block, s);
    default:
      return static_cast<int>(neo_mpc::launch_inv_block(A, X, B, m, s));
  }
}
