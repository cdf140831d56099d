// K3: batched footprint-boundary max cost, one warp per placed polygon.
//
// Replaces the TPU kernel neo_mpc_planner2_tpu/ops/pallas_kernels.py::_kernel
// (launched by footprint_cost_batch_pallas): per polygon, the max
// nearest-cell cost over S samples along each edge, the closing edge
// (v + 1) mod n_valid included, padded edges (v >= n_valid) excluded,
// samples outside the bounds rectangle lethal. The TPU kernel samples the
// map with one-hot matrix products because the TPU has no vector gather;
// here each sample is one load.
//
// It computes what the port's plain version (footprint_cost_batch_plain,
// the JAX package's gather path) computes, bit for bit: p = s + (e - s) * t
// rounded op by op (no FMA contraction), cell = floor((p - o) / res) with an
// IEEE division, then the bounds test, a clamp and the gather. (The Pallas
// kernel multiplies by 1/res and truncates instead; it agrees with the
// gather path off cell boundaries and above the origin only.)
//
// What bounds it on an H100: about V*S scattered 4-byte reads per polygon
// and no arithmetic to speak of. At 4096 lanes x 21 polygons x 128 samples
// that is ~11 M reads from 67 MB of 64x64 maps, so it is latency- and
// L2-bound. The R polygons of a lane read the same map in place (no copy
// per polygon); the lane's samples cluster within the robot's reach, so the
// lines they touch stay in L2. A warp takes one polygon and its lanes
// stride over the V*S samples; reads go through the read-only cache
// (__ldg); the max is reduced with warp shuffles.
#include <cuda_runtime.h>
#include <math.h>

namespace neo_mpc {

constexpr int kWarpsPerBlock = 8;
constexpr float kLethal = 1.0f;

// floor((p - o) / res) as an int; false if it is NaN or beyond int32 (the
// sample then reads lethal, as an index far off the grid does).
__device__ __forceinline__ bool cell_of(float p, float o, float res, int* c) {
  const float f = floorf(__fdiv_rn(__fsub_rn(p, o), res));
  if (!(f >= -2147483648.0f && f < 2147483648.0f)) return false;
  *c = static_cast<int>(f);
  return true;
}

__global__ void footprint_cost_kernel(
    const float* __restrict__ data, const float* __restrict__ origin,
    const float* __restrict__ res, const int* __restrict__ bounds,
    const float* __restrict__ verts, const int* __restrict__ n_valid,
    const float* __restrict__ t, float* __restrict__ out, int Bm, int R,
    int H, int W, int V, int S) {
  const int lane = threadIdx.x & 31;
  const long long poly =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  // Uniform across the warp: the shuffles below see all 32 lanes.
  if (poly >= static_cast<long long>(Bm) * R) return;
  const int b = static_cast<int>(poly / R);
  const float ox = __ldg(origin + 2 * b);
  const float oy = __ldg(origin + 2 * b + 1);
  const float rs = __ldg(res + b);
  int lo_x = 0, lo_y = 0, hi_x = W, hi_y = H;
  if (bounds != nullptr) {
    lo_x = __ldg(bounds + 4 * b);
    lo_y = __ldg(bounds + 4 * b + 1);
    hi_x = __ldg(bounds + 4 * b + 2);
    hi_y = __ldg(bounds + 4 * b + 3);
  }
  const int nv = min(__ldg(n_valid + poly), V);
  const float* vp = verts + poly * V * 2;
  const float* map = data + static_cast<size_t>(b) * H * W;

  float best = -INFINITY;
  for (int k = lane; k < nv * S; k += 32) {
    const int v = k / S;
    const int s = k - v * S;
    const int e = (v + 1 < nv) ? v + 1 : 0;
    const float sx = __ldg(vp + 2 * v), sy = __ldg(vp + 2 * v + 1);
    const float ex = __ldg(vp + 2 * e), ey = __ldg(vp + 2 * e + 1);
    const float tt = __ldg(t + s);
    const float px = __fadd_rn(sx, __fmul_rn(__fsub_rn(ex, sx), tt));
    const float py = __fadd_rn(sy, __fmul_rn(__fsub_rn(ey, sy), tt));
    int mx, my;
    float c = kLethal;
    if (cell_of(px, ox, rs, &mx) && cell_of(py, oy, rs, &my) && mx >= lo_x &&
        mx < hi_x && my >= lo_y && my < hi_y) {
      const int cx = min(max(mx, 0), W - 1);
      const int cy = min(max(my, 0), H - 1);
      c = __ldg(map + static_cast<size_t>(cy) * W + cx);
    }
    best = fmaxf(best, c);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, off));
  if (lane == 0) out[poly] = best;
}

}  // namespace neo_mpc

// data (Bm, H, W), origin (Bm, 2), res (Bm,), bounds (Bm, 4) int32 or null
// (the whole grid), verts (Bm, R, V, 2), n_valid (Bm, R) int32, t (S,);
// out (Bm, R). All contiguous. Returns cudaGetLastError().
extern "C" int neo_footprint_cost_f32(int Bm, int R, int H, int W, int V,
                                      int S, const void* data,
                                      const void* origin, const void* res,
                                      const void* bounds, const void* verts,
                                      const void* n_valid, const void* t,
                                      void* out, void* stream) {
  const long long polys = static_cast<long long>(Bm) * R;
  if (polys == 0) return 0;
  const long long blocks =
      (polys + neo_mpc::kWarpsPerBlock - 1) / neo_mpc::kWarpsPerBlock;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  neo_mpc::footprint_cost_kernel<<<static_cast<unsigned>(blocks),
                                   32 * neo_mpc::kWarpsPerBlock, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const float*>(origin),
      static_cast<const float*>(res), static_cast<const int*>(bounds),
      static_cast<const float*>(verts), static_cast<const int*>(n_valid),
      static_cast<const float*>(t), static_cast<float*>(out), Bm, R, H, W, V,
      S);
  return static_cast<int>(cudaGetLastError());
}
