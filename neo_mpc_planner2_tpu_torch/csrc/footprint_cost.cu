// K3: batched footprint-boundary max cost, all polygons of a map lane on one SM.
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
// IEEE division, then the bounds test and the gather. (The Pallas kernel
// multiplies by 1/res and truncates instead; it agrees with the gather path
// off cell boundaries and above the origin only.) The bounds rectangle lies
// inside the grid, as the plain version documents, so a cell inside it
// needs no clamp; it is tested in floats (exact below 2^24 cells a side,
// and a NaN or infinite cell fails the test as an out-of-range one did).
//
// A rolling-window view (the port's Costmap with win_lo set) reads the
// world map through its window: the caller passes the window's origin
// (origin + win_lo * res, rounded as the port rounds it), the window as the
// bounds and win_lo as a per-lane cell `shift`, and the kernel adds the
// shift to both cells before the bounds test and the address, as the JAX
// package's world_to_map does on a view. The shift is a template switch
// (kShift): a static map's launch (shift null) runs the same code as
// before it existed.
//
// What bounds it on an H100: the bytes it must move are the valid vertices,
// the output and the distinct map cells the samples read (on the product
// slice's wave, 4096 lanes x 21 polygons x 4 edges x 16 samples: 5.5 MB),
// ~1.7 us at 3.35 TB/s; its ~17 operations a sample take 1.4 us. The
// kernel is far from that: each sample is ~40 instructions (two IEEE
// divisions, floors, the bounds test, the address) and a dependent,
// scattered read. The design:
//   - A block holds `lanes_per_block` map lanes with `warps_per_lane`
//     warps each; warp w of a lane takes its polygons w, w +
//     warps_per_lane, ... So a lane's polygons run on one SM and share its
//     L1 lines of the lane's map. Measured: four lanes of one warp for
//     R <= 3 (the gate, the gradient calls), two lanes of two warps for the
//     wave (kernels/binding.py::k3_launch_shape).
//   - The block stages each polygon's valid edges once in shared memory as
//     (start x, start y, dx, dy), with dx = e - s rounded as the plain
//     version rounds it, and the S edge parameters beside them; the sample
//     loop reads no vertex from device memory (the earlier design, a warp
//     a polygon, read five values from device memory a sample).
//   - A warp walks kGroup polygons at once, kUnroll samples of each a lane
//     and step: it computes all their cells, then issues all their reads,
//     then takes the maxima, so several reads of a lane are in flight.
//     Larger groups (4, 8 or 16 polygons, 4 samples) were slower: the
//     registers they hold cost more warps than the reads in flight gain.
//   - S is a template parameter for 8, 16, 32 and 64 (any other S takes a
//     general instance): each lane steps its (edge, sample) pair by
//     (32 / S, 32 % S) with one carry, so no sample divides (for S up to
//     32 a lane's sample index never changes). The step holds for any
//     S >= 1: after it the sample index is below 2S, so one carry ends it.
//   - Where a block of the measured shape cannot stage its lanes' R
//     polygons (kernels/binding.py::k3_variant), a block takes one lane;
//     where one lane's R polygons do not fit either, a second grid axis
//     splits them into chunks of `chunk` polygons, each block staging
//     only its chunk's edges. The polygons are independent, so every plan
//     computes the same costs; the measured plan (chunk = R, one chunk) is
//     the launch every earlier shape had. What remains is one polygon's
//     16 V + 4 bytes and the S parameters' 4 S bytes in one block.
//   - The map is read in place through the read-only path (__ldg), not
//     staged: a wave touches fewer cells than its patch holds.
//
// The walk mode (footprint_walk_kernel, neo_footprint_walk_f32) computes
// the exact footprint cost: per polygon, the max over its valid edges of
// the cost of every cell the edge crosses, an Amanatides-Woo walk. It
// replaces no TPU kernel: the JAX package runs its walk as an XLA scan of
// H + W steps (neo_mpc_planner2_tpu/ops/footprint.py::line_cost_exact). It
// computes what the port's plain walk (footprint_walk_batch_plain)
// computes, bit for bit: every boundary expression rounded op by op
// (o + f32(cell + (d > 0)) * res, (edge - p0) / d, res / |d|, the t_max
// sums), the cell floor((p - o) / res) of an IEEE division, a tie taking
// the y step, a crossing at t > 1 not taken, 1.0 folded in where the end
// cell is outside the bounds. On a view the cells are counted from the
// window's origin and shifted by win_lo, as in the sampled mode.
//
// What bounds it: the bytes it must move are the valid vertices, the
// output and the distinct cells the walks visit; on an MPO-700 footprint
// at 0.05 m an edge crosses ~15-25 cells, each a dependent step of ~12
// instructions and a scattered read. The design: one thread walks one
// (polygon, edge) with early exit at its end cell or past t = 1, and a
// polygon's edges sit on 2^k adjacent threads of one warp, whose maximum
// is a shuffle reduction; no shared memory. The steps of a warp's walks
// run in lockstep to its longest walk. Above 32 vertices a polygon takes
// a whole warp, and thread v walks its edges v, v + 32, ...; at most 32
// vertices each thread walks one edge, as before.
#include <cuda_runtime.h>
#include <math.h>

namespace neo_mpc {

constexpr float kLethal = 1.0f;
constexpr int kGroup = 2;   // polygons a warp walks at once
constexpr int kUnroll = 2;  // samples of each a lane takes per step

// floor((p - o) / res), rounded as the plain version rounds it (an IEEE
// division, no FMA contraction). NaN stays NaN.
__device__ __forceinline__ float cell_of(float p, float o, float res) {
  return floorf(__fdiv_rn(__fsub_rn(p, o), res));
}

// S: the samples an edge, a compile-time constant for 8, 16, 32 and 64
// (so a lane's sample index and parameter stay in registers), or 0 for
// any other count, taken from S_rt.
//
// Block (x, y) takes lanes x * lanes_per_block, ... and of each the
// polygons y * chunk, ... (at most chunk of them; chunk = R: all).
// Shared memory: for each of the block's lanes, chunk * V edges of 4
// floats (sx, sy, dx, dy) and chunk valid counts; then the S edge
// parameters.
template <int kS, bool kShift>
__global__ void footprint_cost_kernel(
    const float* __restrict__ data, const float* __restrict__ origin,
    const float* __restrict__ res, const int* __restrict__ bounds,
    const int* __restrict__ shift, const float* __restrict__ verts,
    const int* __restrict__ n_valid,
    const float* __restrict__ t, float* __restrict__ out, int Bm, int R,
    int H, int W, int V, int S_rt, int lanes_per_block, int warps_per_lane,
    int chunk) {
  const int S = kS ? kS : S_rt;
  extern __shared__ float4 smem[];
  const size_t edges_per_lane = static_cast<size_t>(chunk) * V;
  float4* edges = smem;
  int* nv_s = reinterpret_cast<int*>(edges + lanes_per_block * edges_per_lane);
  float* t_s = reinterpret_cast<float*>(nv_s + lanes_per_block * chunk);
  const int lane0 = blockIdx.x * lanes_per_block;
  const int p_first = blockIdx.y * chunk;   // this block's first polygon
  const int Rc = min(chunk, R - p_first);   // and its polygons a lane

  // Stage, a thread a polygon: its valid count and valid edges.
  for (int k = threadIdx.x; k < S; k += blockDim.x) t_s[k] = __ldg(t + k);
  for (int q = threadIdx.x; q < lanes_per_block * Rc; q += blockDim.x) {
    const int li = q / Rc;
    const int p = q - li * Rc;
    const int b = lane0 + li;
    const size_t poly = static_cast<size_t>(b) * R + p_first + p;
    const int nv = b < Bm ? min(__ldg(n_valid + poly), V) : 0;
    const size_t slot = static_cast<size_t>(li) * chunk + p;
    nv_s[slot] = nv;
    const float* vp = verts + poly * V * 2;
    float4* ep = edges + slot * V;
    for (int v = 0; v < nv; ++v) {
      const int e = (v + 1 < nv) ? v + 1 : 0;
      const float sx = __ldg(vp + 2 * v), sy = __ldg(vp + 2 * v + 1);
      const float ex = __ldg(vp + 2 * e), ey = __ldg(vp + 2 * e + 1);
      ep[v] = make_float4(sx, sy, __fsub_rn(ex, sx), __fsub_rn(ey, sy));
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int li = warp / warps_per_lane;
  const int w = warp - li * warps_per_lane;
  const int b = lane0 + li;
  // Uniform across the warp: the shuffles below see all 32 lanes.
  if (li >= lanes_per_block || b >= Bm) return;

  const float ox = __ldg(origin + 2 * b);
  const float oy = __ldg(origin + 2 * b + 1);
  const float rs = __ldg(res + b);
  // The bounds rectangle (inside the grid) as floats: a cell in it is on
  // the grid, so it needs no clamp, and a NaN or infinite cell fails the
  // test. Exact: the kernel takes grids under 2^24 cells a side.
  float lo_x = 0.0f, lo_y = 0.0f, hi_x = W, hi_y = H;
  if (bounds != nullptr) {
    lo_x = max(__ldg(bounds + 4 * b), 0);
    lo_y = max(__ldg(bounds + 4 * b + 1), 0);
    hi_x = min(__ldg(bounds + 4 * b + 2), W);
    hi_y = min(__ldg(bounds + 4 * b + 3), H);
  }
  // The view's cell shift, exact as a float below 2^24 cells.
  float sh_x = 0.0f, sh_y = 0.0f;
  if (kShift) {
    sh_x = static_cast<float>(__ldg(shift + 2 * b));
    sh_y = static_cast<float>(__ldg(shift + 2 * b + 1));
  }
  const float* map = data + static_cast<size_t>(b) * H * W;
  // Each lane's (edge, sample) pair advances by 32 samples a step.
  const int dv = 32 / S, ds = 32 - dv * S;
  auto step = [&](int& v, int& s) {
    v += dv;
    s += ds;
    if (s >= S) {
      s -= S;
      ++v;
    }
  };

  const size_t lane_slot = static_cast<size_t>(li) * chunk;
  for (int p0 = w; p0 < Rc; p0 += kGroup * warps_per_lane) {
    int n[kGroup];
    const float4* pe[kGroup];
    float best[kGroup];
    int most = 0;
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int p = p0 + g * warps_per_lane;
      n[g] = p < Rc ? nv_s[lane_slot + p] * S : 0;
      pe[g] = edges + (lane_slot + (p < Rc ? p : 0)) * V;
      best[g] = -INFINITY;
      most = max(most, n[g]);
    }
    int v = lane / S, s = lane - (lane / S) * S;
    for (int k = lane; k < most; k += 32 * kUnroll) {
      // Cells first: a map offset, -1 for lethal, -2 for no sample.
      int cell[kUnroll][kGroup];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float tt = t_s[s];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          int off = -2;
          if (k + 32 * u < n[g]) {
            const float4 ed = pe[g][v];
            float fx = cell_of(__fadd_rn(ed.x, __fmul_rn(ed.z, tt)), ox, rs);
            float fy = cell_of(__fadd_rn(ed.y, __fmul_rn(ed.w, tt)), oy, rs);
            if (kShift) {
              fx = __fadd_rn(fx, sh_x);
              fy = __fadd_rn(fy, sh_y);
            }
            off = (fx >= lo_x && fx < hi_x && fy >= lo_y && fy < hi_y)
                      ? static_cast<int>(fy) * W + static_cast<int>(fx)
                      : -1;
          }
          cell[u][g] = off;
        }
        step(v, s);
      }
      // Then every read, then the maxima.
      float c[kUnroll][kGroup];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
          c[u][g] = cell[u][g] >= 0 ? __ldg(map + cell[u][g])
                                    : (cell[u][g] == -1 ? kLethal : -INFINITY);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int g = 0; g < kGroup; ++g) best[g] = fmaxf(best[g], c[u][g]);
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        best[g] = fmaxf(best[g], __shfl_xor_sync(0xffffffffu, best[g], off));
      const int p = p0 + g * warps_per_lane;
      if (lane == 0 && p < Rc)
        out[static_cast<size_t>(b) * R + p_first + p] = best[g];
    }
  }
}

template <int kS, bool kShift>
cudaError_t launch_footprint(dim3 blocks, int threads, long long smem,
                             cudaStream_t stream, const float* data,
                             const float* origin, const float* res,
                             const int* bounds, const int* shift,
                             const float* verts, const int* n_valid,
                             const float* t, float* out, int Bm, int R, int H,
                             int W, int V, int S, int lanes_per_block,
                             int warps_per_lane, int chunk) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        footprint_cost_kernel<kS, kShift>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  footprint_cost_kernel<kS, kShift>
      <<<blocks, threads, static_cast<size_t>(smem), stream>>>(
          data, origin, res, bounds, shift, verts, n_valid, t, out, Bm, R, H,
          W, V, S, lanes_per_block, warps_per_lane, chunk);
  return cudaGetLastError();
}

// The instance for S samples an edge, with or without a shift.
template <bool kShift>
cudaError_t launch_footprint_s(dim3 blocks, int threads, long long smem,
                               cudaStream_t stream, const float* data,
                               const float* origin, const float* res,
                               const int* bounds, const int* shift,
                               const float* verts, const int* n_valid,
                               const float* t, float* out, int Bm, int R,
                               int H, int W, int V, int S,
                               int lanes_per_block, int warps_per_lane,
                               int chunk) {
  cudaError_t (*launch)(dim3, int, long long, cudaStream_t, const float*,
                        const float*, const float*, const int*, const int*,
                        const float*, const int*, const float*, float*, int,
                        int, int, int, int, int, int, int, int) =
      S == 8    ? launch_footprint<8, kShift>
      : S == 16 ? launch_footprint<16, kShift>
      : S == 32 ? launch_footprint<32, kShift>
      : S == 64 ? launch_footprint<64, kShift>
                : launch_footprint<0, kShift>;
  return launch(blocks, threads, smem, stream, data, origin, res, bounds,
                shift, verts, n_valid, t, out, Bm, R, H, W, V, S,
                lanes_per_block, warps_per_lane, chunk);
}

// The cost of world-frame cell (x, y): the map value inside the bounds
// rectangle, lethal outside it.
__device__ __forceinline__ float walk_cell_cost(const float* map, int x, int y,
                                                int lo_x, int lo_y, int hi_x,
                                                int hi_y, int W) {
  return (x >= lo_x && x < hi_x && y >= lo_y && y < hi_y)
             ? __ldg(map + static_cast<size_t>(y) * W + x)
             : kLethal;
}

// One edge's walk from (x0, y0) to (x1, y1): the max cost over the cells
// it crosses (cells local to the origin o, world-frame after adding the
// shift), at most H + W steps as the JAX package's scan.
__device__ float walk_edge(const float* map, float x0, float y0, float x1,
                           float y1, float ox, float oy, float rs, int sh_x,
                           int sh_y, int lo_x, int lo_y, int hi_x, int hi_y,
                           int H, int W) {
  int mx = static_cast<int>(cell_of(x0, ox, rs));
  int my = static_cast<int>(cell_of(y0, oy, rs));
  const int ex = static_cast<int>(cell_of(x1, ox, rs));
  const int ey = static_cast<int>(cell_of(y1, oy, rs));
  const float dx = __fsub_rn(x1, x0), dy = __fsub_rn(y1, y0);
  const int step_x = dx > 0.0f ? 1 : -1, step_y = dy > 0.0f ? 1 : -1;
  float t_max_x = INFINITY, t_max_y = INFINITY;
  float t_delta_x = INFINITY, t_delta_y = INFINITY;
  if (dx != 0.0f) {
    const float edge = __fadd_rn(
        ox, __fmul_rn(static_cast<float>(mx + (dx > 0.0f ? 1 : 0)), rs));
    t_max_x = __fdiv_rn(__fsub_rn(edge, x0), dx);
    t_delta_x = __fdiv_rn(rs, fabsf(dx));
  }
  if (dy != 0.0f) {
    const float edge = __fadd_rn(
        oy, __fmul_rn(static_cast<float>(my + (dy > 0.0f ? 1 : 0)), rs));
    t_max_y = __fdiv_rn(__fsub_rn(edge, y0), dy);
    t_delta_y = __fdiv_rn(rs, fabsf(dy));
  }
  float best = walk_cell_cost(map, mx + sh_x, my + sh_y, lo_x, lo_y, hi_x,
                              hi_y, W);
  const int wex = ex + sh_x, wey = ey + sh_y;
  if (!(wex >= lo_x && wex < hi_x && wey >= lo_y && wey < hi_y))
    best = fmaxf(best, kLethal);
  for (int k = 0; k < H + W; ++k) {
    if (mx == ex && my == ey) break;
    const bool take_x = t_max_x < t_max_y;   // a tie takes the y step
    if ((take_x ? t_max_x : t_max_y) > 1.0f) break;
    if (take_x) {
      mx += step_x;
      t_max_x = __fadd_rn(t_max_x, t_delta_x);
    } else {
      my += step_y;
      t_max_y = __fadd_rn(t_max_y, t_delta_y);
    }
    best = fmaxf(best, walk_cell_cost(map, mx + sh_x, my + sh_y, lo_x, lo_y,
                                      hi_x, hi_y, W));
  }
  return best;
}

// Thread g walks edge g mod 2^log_vp of polygon g >> log_vp, and above 32
// vertices (log_vp = 5) also its edges + 32, + 64, ... (2^log_vp >= V up
// to 32 vertices, so a polygon's edges are adjacent threads of one warp);
// every thread reaches the shuffles.
__global__ void footprint_walk_kernel(
    const float* __restrict__ data, const float* __restrict__ origin,
    const float* __restrict__ res, const int* __restrict__ bounds,
    const int* __restrict__ shift, const float* __restrict__ verts,
    const int* __restrict__ n_valid, float* __restrict__ out,
    long long polys, int R, int H, int W, int V, int log_vp) {
  const long long g =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long q = g >> log_vp;
  const int v = static_cast<int>(g & ((1 << log_vp) - 1));
  float best = -INFINITY;
  if (q < polys) {
    const int nv = min(__ldg(n_valid + q), V);
    if (v < nv) {
      const long long b = q / R;
      const int e = (v + 1 < nv) ? v + 1 : 0;
      const float* vp = verts + q * V * 2;
      int lo_x = 0, lo_y = 0, hi_x = W, hi_y = H;
      if (bounds != nullptr) {
        lo_x = max(__ldg(bounds + 4 * b), 0);
        lo_y = max(__ldg(bounds + 4 * b + 1), 0);
        hi_x = min(__ldg(bounds + 4 * b + 2), W);
        hi_y = min(__ldg(bounds + 4 * b + 3), H);
      }
      const int sh_x = shift != nullptr ? __ldg(shift + 2 * b) : 0;
      const int sh_y = shift != nullptr ? __ldg(shift + 2 * b + 1) : 0;
      const float* map = data + b * H * W;
      const float ox = __ldg(origin + 2 * b), oy = __ldg(origin + 2 * b + 1);
      const float rs = __ldg(res + b);
      best = walk_edge(map, __ldg(vp + 2 * v), __ldg(vp + 2 * v + 1),
                       __ldg(vp + 2 * e), __ldg(vp + 2 * e + 1), ox, oy, rs,
                       sh_x, sh_y, lo_x, lo_y, hi_x, hi_y, H, W);
      for (int u = v + (1 << log_vp); u < nv; u += 1 << log_vp) {
        const int f = (u + 1 < nv) ? u + 1 : 0;
        best = fmaxf(best, walk_edge(map, __ldg(vp + 2 * u),
                                     __ldg(vp + 2 * u + 1), __ldg(vp + 2 * f),
                                     __ldg(vp + 2 * f + 1), ox, oy, rs, sh_x,
                                     sh_y, lo_x, lo_y, hi_x, hi_y, H, W));
      }
    }
  }
  for (int off = (1 << log_vp) >> 1; off > 0; off >>= 1)
    best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, off));
  if (q < polys && v == 0) out[q] = best;
}

}  // namespace neo_mpc

// Shared memory a block of the launch needs, in bytes (as
// kernels/binding.py::k3_smem_bytes computes it): `chunk` polygons of each
// of its lanes.
static long long footprint_cost_smem(int chunk, int V, int S,
                                     int lanes_per_block) {
  return static_cast<long long>(lanes_per_block) * chunk *
             (V * static_cast<long long>(sizeof(float4)) + sizeof(int)) +
         static_cast<long long>(S) * sizeof(float);
}

// data (Bm, H, W), origin (Bm, 2), res (Bm,), bounds (Bm, 4) int32 or null
// (the whole grid), shift (Bm, 2) int32 or null (no shift), verts
// (Bm, R, V, 2), n_valid (Bm, R) int32, t (S,); out (Bm, R). All
// contiguous. lanes_per_block * warps_per_lane warps a block, and a block
// takes `chunk` polygons of each of its lanes (chunk = R: all of them; the
// grid's second axis then has one block). Returns cudaGetLastError().
extern "C" int neo_footprint_cost_f32(int Bm, int R, int H, int W, int V,
                                      int S, int lanes_per_block,
                                      int warps_per_lane, int chunk,
                                      const void* data,
                                      const void* origin, const void* res,
                                      const void* bounds, const void* shift,
                                      const void* verts, const void* n_valid,
                                      const void* t, void* out,
                                      void* stream) {
  if (static_cast<long long>(Bm) * R == 0) return 0;
  const int threads = 32 * lanes_per_block * warps_per_lane;
  if (S < 1 || V < 1 || lanes_per_block < 1 || warps_per_lane < 1 ||
      threads > 1024 || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (chunk > R) chunk = R;   // the kernel strides its staging by chunk
  const long long chunks = (static_cast<long long>(R) + chunk - 1) / chunk;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = footprint_cost_smem(chunk, V, S, lanes_per_block);
  const dim3 blocks(
      static_cast<unsigned>((Bm + lanes_per_block - 1) / lanes_per_block),
      static_cast<unsigned>(chunks));
  const auto cs = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const float*>(data);
  const auto* o = static_cast<const float*>(origin);
  const auto* r = static_cast<const float*>(res);
  const auto* bo = static_cast<const int*>(bounds);
  const auto* sh = static_cast<const int*>(shift);
  const auto* v = static_cast<const float*>(verts);
  const auto* nv = static_cast<const int*>(n_valid);
  const auto* tt = static_cast<const float*>(t);
  auto* ou = static_cast<float*>(out);
  if (sh != nullptr)
    return static_cast<int>(neo_mpc::launch_footprint_s<true>(
        blocks, threads, smem, cs, d, o, r, bo, sh, v, nv, tt, ou, Bm, R, H,
        W, V, S, lanes_per_block, warps_per_lane, chunk));
  return static_cast<int>(neo_mpc::launch_footprint_s<false>(
      blocks, threads, smem, cs, d, o, r, bo, sh, v, nv, tt, ou, Bm, R, H, W,
      V, S, lanes_per_block, warps_per_lane, chunk));
}

// K3's walk mode. data (Bm, H, W), origin (Bm, 2), res (Bm,), bounds
// (Bm, 4) int32 or null (the whole grid), shift (Bm, 2) int32 or null,
// verts (Bm, R, V, 2), n_valid (Bm, R) int32; out (Bm, R). All contiguous.
// `threads` a block, a multiple of 32. Returns cudaGetLastError().
extern "C" int neo_footprint_walk_f32(int Bm, int R, int H, int W, int V,
                                      int threads, const void* data,
                                      const void* origin, const void* res,
                                      const void* bounds, const void* shift,
                                      const void* verts, const void* n_valid,
                                      void* out, void* stream) {
  const long long polys = static_cast<long long>(Bm) * R;
  if (polys == 0) return 0;
  if (V < 1 || threads < 32 || threads > 1024 || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  // Threads a polygon: V rounded up to a power of two, at most a warp.
  int log_vp = 0;
  while ((1 << log_vp) < V && log_vp < 5) ++log_vp;
  const long long total = polys << log_vp;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  neo_mpc::footprint_walk_kernel<<<blocks, threads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const float*>(origin),
      static_cast<const float*>(res), static_cast<const int*>(bounds),
      static_cast<const int*>(shift), static_cast<const float*>(verts),
      static_cast<const int*>(n_valid), static_cast<float*>(out), polys, R,
      H, W, V, log_vp);
  return static_cast<int>(cudaGetLastError());
}
