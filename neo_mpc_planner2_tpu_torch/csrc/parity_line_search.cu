// The parity line search: every lane's sequential Armijo backtracking on
// the parity objective's L1 merit, in one launch an SQP trip.
//
// Replaces no TPU kernel. It replaces the port's masked loop
// (neo_mpc_planner2_tpu_torch/sqp.py::_masked_armijo, the twin of the JAX
// package's vmapped `lax.while_loop` in neo_mpc_planner2_tpu/sqp.py's
// `_make_sqp.body`), which evaluates the merit of every lane op by op,
// about 200 PyTorch launches and one host `any()` a backtrack, until the
// slowest lane accepts. Lanes are independent, so each thread here runs
// one lane's backtracking to its own end and takes exactly the steps the
// masked loop takes for that lane: for j = 0 .. max_backtracks - 1 while
// the lane has not accepted,
//   1. the merit phi = f(x + alpha d) + mu sum_k max(-c_k, 0) at the
//      candidate: the parity objective (ops/objective.py::objective_parity
//      on make_point_sampler's flat gather) and the translational-speed
//      cone c_k = r - |(vx, vy)_k| (sqp.py::_cone_constraints);
//   2. the Armijo test phi <= phi0 + 1e-4 alpha dphi + 1e-12;
//   3. on rejection the next alpha: the quadratic through phi(0), phi'(0)
//      and phi(alpha) safeguarded to [0.1, 0.5] alpha, or the two-phase
//      factor (backtrack before coarse_after steps, coarse after);
// then writes alpha, f at the accepted candidate (f unchanged where none
// was) and whether one was accepted. Done and inactive lanes accept at
// once and evaluate nothing, as in the masked loop.
//
// Every compat quirk of the parity objective is a bit of `quirks` (the
// order of binding.PARITY_LS_QUIRKS), so a parity configuration with some
// quirks off runs here too; the schedule's constants are arguments; the
// per-lane poses, velocity, weights, cone radius, hoisted footprint term,
// map origin and resolution are one row of `lane` a lane (layout
// binding.PARITY_LS_LANE_COLUMNS), the configuration's values where the
// scenario has none.
//
// It computes what the masked loop computes on the card, bit for bit, so
// that a lane accepts the same alpha:
//   - each float operation is rounded on its own, as each PyTorch
//     elementwise kernel rounds it: __fmul_rn / __fadd_rn / __fsub_rn,
//     which the compiler never contracts into an FMA; sinf, cosf, atan2f,
//     floorf and fmodf as PyTorch's kernels call them; IEEE division and
//     square root (__fdiv_rn, __fsqrt_rn) where PyTorch divides by a
//     tensor or takes a square root;
//   - a division by a Python number (`/ n`) is a multiply by its float
//     reciprocal, as CUDA PyTorch computes it;
//   - every `.sum(-1)` is summed in the order of PyTorch's CUDA reduction
//     of a contiguous row (torch_row_sum below), whose width the launcher
//     gives (binding.parity_ls_sum_width); a sum of three velocity
//     components takes width 2: (e0 + e2) + e1;
//   - the nearest cell is floor((w - origin) / res) cast to int32, out of
//     bounds lethal (1.0), the u8 companion decoded as q / 255 with an
//     IEEE division, as ops/costmap.py's sampler reads them.
//
// What bounds it on an H100: almost nothing. At 4096 lanes of the fleet
// point (N = 3) a lane takes at most 7 merit evaluations a trip, each ~80
// operations and one map read a step; a first trip of 4,096 evaluations
// is 1.2 M operations and 0.83 MB, 0.25 us by bytes
// (kernels/bounds.py::parity_line_search_work counts them from the masked
// loop's own evaluations). The kernel is latency bound: one thread's chain of
// dependent transcendentals and gathers a backtrack. The design is a
// thread a lane in blocks of 64, so that 4096 lanes spread over 64 SMs;
// the per-step terms of the four sums are kept in per-thread arrays of
// PARITY_LS_MAX_STEPS (local memory, cached) because PyTorch's order of a
// row sum needs the whole row. It is not the pace setter: the launch it
// replaces was ~200 launches and a host synchronisation a backtrack.

#include <cuda_runtime.h>
#include <stdint.h>

namespace neo_mpc {
namespace {

// The most control steps a launch takes (binding.PARITY_LS_MAX_STEPS):
// K1's cap of 79, rounded up.
constexpr int kMaxSteps = 80;
// The widest row sum PyTorch's reduction splits over threads: 64 (a row
// of 64 or more at fewer than 16 rows; 32 otherwise).
constexpr int kMaxSumWidth = 64;
// Floats a lane's row of `lane` holds, and where each quantity starts
// (binding.PARITY_LS_LANE_COLUMNS).
constexpr int kLaneCols = 22;
enum LaneCol {
  kPose = 0,        // current pose x, y, yaw (odom frame)
  kCarrot = 3,      // carrot x, y, yaw (base frame)
  kGoal = 6,        // goal x, y, yaw
  kVel = 9,         // current velocity vx, vy, w
  kWTrans = 12, kWOrient, kWControl, kWTerminal, kWCostmap,
  kMaxTrans = 17,   // the cone's radius
  kFpTerm = 18,     // the hoisted parity footprint term
  kOrigin = 19,     // map origin x, y
  kRes = 21,        // map resolution
};
// Bits of `quirks` (binding.PARITY_LS_QUIRKS).
constexpr int kBuggyOdomYaw = 1, kFootprintAliasNoop = 2, kLethal1000x = 4,
              kUnsquaredControl = 8, kNoAngleWrap = 16;

constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

__device__ __forceinline__ float fmul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float fsub(float a, float b) {
  return __fsub_rn(a, b);
}

// torch.maximum / torch.minimum: a NaN operand propagates.
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

// The sum of v[0 .. n) in the order of PyTorch's CUDA reduction of a
// contiguous row of n over `width` threads (Reduce.cuh): thread t adds
// elements t, t + width, ... into four accumulators in turn and combines
// them in order; then the threads fold in halves, thread t taking thread
// t + width / 2's sum, then t + width / 4's, ... (measured on an H100:
// this order, and not folds at offsets 1, 2, 4, ..., gives PyTorch's sums
// bit for bit at 19 row lengths from 2 to 79 and 10 row counts from 1 to
// 4096, PERF.md).
__device__ float torch_row_sum(const float* v, int n, int width) {
  float p[kMaxSumWidth];
  for (int t = 0; t < width; ++t) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    int pos = 0;
    for (int i = t; i < n; i += width, ++pos)
      acc[pos & 3] = fadd(acc[pos & 3], v[i]);
    p[t] = fadd(fadd(fadd(acc[0], acc[1]), acc[2]), acc[3]);
  }
  for (int off = width / 2; off > 0; off >>= 1)
    for (int t = 0; t < off; ++t) p[t] = fadd(p[t], p[t + off]);
  return p[0];
}

// A row's sum over the N steps divided by N, a Python number: a multiply
// by its float reciprocal, as CUDA PyTorch divides by a scalar.
__device__ __forceinline__ float per_step(float sum, float inv_n) {
  return fmul(sum, inv_n);
}

// se2.wrap_angle: remainder(e + pi, 2 pi) - pi, torch.remainder's floor
// mod.
__device__ __forceinline__ float wrap_angle(float e) {
  float r = fmodf(fadd(e, kPi), kTwoPi);
  if (r != 0.f && (signbit(r) != signbit(kTwoPi))) r = fadd(r, kTwoPi);
  return fsub(r, kPi);
}

struct MapLane {
  const float* flat;       // the lane's H * W floats
  const uint8_t* flat_u8;  // its u8 companion, or null
  float ox, oy, res;
  int H, W;
};

// make_point_sampler's read at world (wx, wy): the nearest cell, lethal
// (1.0) out of bounds.
__device__ __forceinline__ float sample(const MapLane& m, float wx,
                                        float wy) {
  const int mx = static_cast<int>(floorf(__fdiv_rn(fsub(wx, m.ox), m.res)));
  const int my = static_cast<int>(floorf(__fdiv_rn(fsub(wy, m.oy), m.res)));
  const bool inb = (mx >= 0) & (mx < m.W) & (my >= 0) & (my < m.H);
  const int mxc = min(max(mx, 0), m.W - 1);
  const int myc = min(max(my, 0), m.H - 1);
  const int idx = myc * m.W + mxc;
  float val;
  if (m.flat_u8 != nullptr)
    val = __fdiv_rn(static_cast<float>(__ldg(m.flat_u8 + idx)), 255.f);
  else
    val = __ldg(m.flat + idx);
  return inb ? val : 1.f;
}

struct Lane {
  const float* x;    // the lane's iterate, 3N
  const float* d;    // its QP step, 3N
  const float* row;  // its row of `lane`
  MapLane map;
  float yaw0;        // the odom rollout's first yaw
};

struct Scalars {
  int n, sum_width, quirks;
  float dt, inv_n;
};

// The merit at x + alpha d and the objective there: (phi, f).
__device__ void merit(const Lane& L, const Scalars& S, float alpha, float mu,
                      float* phi_out, float* f_out) {
  const float* r = L.row;
  const int n = S.n;
  float stage[kMaxSteps], ctrl[kMaxSteps], cmc[kMaxSteps],
      viol[kMaxSteps];
  float bx = 0.f, by = 0.f, byaw = 0.f;                  // body frame
  float ox = r[kPose], oy = r[kPose + 1], oyaw = L.yaw0;  // odom frame
  const bool wrap = !(S.quirks & kNoAngleWrap);
  for (int i = 0; i < n; ++i) {
    const float u0 = fadd(L.x[3 * i], fmul(alpha, L.d[3 * i]));
    const float u1 = fadd(L.x[3 * i + 1], fmul(alpha, L.d[3 * i + 1]));
    const float u2 = fadd(L.x[3 * i + 2], fmul(alpha, L.d[3 * i + 2]));
    // ops/rollout.py: the yaw first, then the position at the new yaw.
    const float t = fmul(u2, S.dt);
    byaw = fadd(byaw, t);
    float c = cosf(byaw), s = sinf(byaw);
    bx = fadd(bx, fmul(fsub(fmul(u0, c), fmul(u1, s)), S.dt));
    by = fadd(by, fmul(fadd(fmul(u0, s), fmul(u1, c)), S.dt));
    oyaw = fadd(oyaw, t);
    c = cosf(oyaw);
    s = sinf(oyaw);
    ox = fadd(ox, fmul(fsub(fmul(u0, c), fmul(u1, s)), S.dt));
    oy = fadd(oy, fmul(fadd(fmul(u0, s), fmul(u1, c)), S.dt));
    // The stage's tracking terms against the carrot, in the body frame.
    const float dx = fsub(r[kCarrot], bx), dy = fsub(r[kCarrot + 1], by);
    const float d2 = fadd(fmul(dx, dx), fmul(dy, dy));
    float oerr = fsub(r[kCarrot + 2], byaw);
    if (wrap) oerr = wrap_angle(oerr);
    stage[i] = fadd(fmul(r[kWTrans], d2),
                    fmul(r[kWOrient], fmul(oerr, oerr)));
    // The control cost's difference to the current velocity.
    const float v0 = fsub(r[kVel], u0), v1 = fsub(r[kVel + 1], u1),
                v2 = fsub(r[kVel + 2], u2);
    const float dv2 = fadd(fadd(fmul(v0, v0), fmul(v2, v2)), fmul(v1, v1));
    if (S.quirks & kUnsquaredControl)
      ctrl[i] = dv2 == 0.f ? 0.f : __fsqrt_rn(dv2);
    else
      ctrl[i] = dv2;
    // The costmap read at the odom pose.
    const float pc = sample(L.map, ox, oy);
    const float scale = ((S.quirks & kLethal1000x) && pc == 1.f)
                            ? 1000.f : r[kWCostmap];
    cmc[i] = fmul(scale, fmul(pc, pc));
    // The cone's violation.
    const float nrm = __fsqrt_rn(fadd(fmul(u0, u0), fmul(u1, u1)));
    const float v = -fsub(r[kMaxTrans], nrm);
    viol[i] = (v != v || v > 0.f) ? v : 0.f;
  }
  float cost = per_step(torch_row_sum(stage, n, S.sum_width), S.inv_n);
  cost = fadd(cost, per_step(fmul(r[kWControl],
                                  torch_row_sum(ctrl, n, S.sum_width)),
                             S.inv_n));
  cost = fadd(cost, per_step(torch_row_sum(cmc, n, S.sum_width), S.inv_n));
  // The hoisted footprint term, summed as the expanded row it is.
  for (int i = 0; i < n; ++i) stage[i] = r[kFpTerm];
  cost = fadd(cost, per_step(torch_row_sum(stage, n, S.sum_width),
                             S.inv_n));
  // The terminal term.
  float term_o = fsub(r[kGoal + 2], byaw);
  if (wrap) term_o = wrap_angle(term_o);
  float tx, ty;
  if (S.quirks & kFootprintAliasNoop) {
    tx = fsub(r[kCarrot], r[kGoal]);
    ty = fsub(r[kCarrot + 1], r[kGoal + 1]);
  } else {
    tx = fsub(ox, r[kGoal]);
    ty = fsub(oy, r[kGoal + 1]);
  }
  const float term_d2 = fadd(fmul(tx, tx), fmul(ty, ty));
  cost = fadd(cost, fmul(fadd(fmul(r[kWTrans], term_d2),
                              fmul(r[kWOrient], fmul(term_o, term_o))),
                         r[kWTerminal]));
  *f_out = cost;
  *phi_out = fadd(cost, fmul(mu, torch_row_sum(viol, n, S.sum_width)));
}

__global__ void __launch_bounds__(64) parity_line_search_kernel(
    int B, Scalars S, int max_backtracks, int quad_interp, int coarse_after,
    float backtrack, float coarse, int H, int W, long long map_stride,
    const float* __restrict__ map, const uint8_t* __restrict__ map_u8,
    const float* __restrict__ lane, const float* __restrict__ x,
    const float* __restrict__ d, const float* __restrict__ alpha_in,
    const float* __restrict__ phi0_in, const float* __restrict__ dphi_in,
    const float* __restrict__ mu_in, const float* __restrict__ f_in,
    const bool* __restrict__ done, const bool* __restrict__ active,
    float* __restrict__ alpha_out, float* __restrict__ f_out,
    bool* __restrict__ ok_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int m = 3 * S.n;
  Lane L;
  L.x = x + static_cast<long long>(b) * m;
  L.d = d + static_cast<long long>(b) * m;
  L.row = lane + static_cast<long long>(b) * kLaneCols;
  L.map.flat = map + b * map_stride;
  L.map.flat_u8 = map_u8 == nullptr ? nullptr : map_u8 + b * map_stride;
  L.map.ox = L.row[kOrigin];
  L.map.oy = L.row[kOrigin + 1];
  L.map.res = L.row[kRes];
  L.map.H = H;
  L.map.W = W;
  if (S.quirks & kBuggyOdomYaw) {
    // objective.buggy_odom_yaw: the current yaw's sine with the goal's
    // cosine.
    const float zc = sinf(fmul(L.row[kPose + 2], 0.5f));
    const float wg = cosf(fmul(L.row[kGoal + 2], 0.5f));
    L.yaw0 = atan2f(fmul(fmul(2.f, wg), zc),
                    fsub(1.f, fmul(fmul(2.f, zc), zc)));
  } else {
    L.yaw0 = L.row[kPose + 2];
  }
  const float phi0 = phi0_in[b], dphi = dphi_in[b], mu = mu_in[b];
  float alpha = alpha_in[b], f_ls = f_in[b];
  bool ok = done[b] || !active[b];
  for (int j = 0; !ok && j < max_backtracks; ++j) {
    float phi, fv;
    merit(L, S, alpha, mu, &phi, &fv);
    const bool ok_new =
        phi <= fadd(fadd(phi0, fmul(fmul(1e-4f, alpha), dphi)), 1e-12f);
    if (ok_new) {
      f_ls = fv;
    } else if (quad_interp) {
      const float denom =
          fmul(2.f, fsub(fsub(phi, phi0), fmul(dphi, alpha)));
      const float a_q = __fdiv_rn(fmul(fmul(-dphi, alpha), alpha),
                                  fabsf(denom) > 1e-20f ? denom : 1e-20f);
      alpha = tmin(tmax(a_q, fmul(0.1f, alpha)), fmul(0.5f, alpha));
    } else {
      const float factor =
          (coarse_after <= 0 || j < coarse_after) ? backtrack : coarse;
      alpha = fmul(alpha, factor);
    }
    ok = ok_new;
  }
  alpha_out[b] = alpha;
  f_out[b] = f_ls;
  ok_out[b] = ok;
}

}  // namespace
}  // namespace neo_mpc

extern "C" int neo_parity_line_search_f32(int B, int n, int sum_width,
                                          int quirks, int max_backtracks,
                                          int quad_interp, int coarse_after,
                                          int H, int W, int map_lanes,
                                          float dt, float backtrack,
                                          float coarse, const void* map,
                                          const void* map_u8,
                                          const void* lane, const void* x,
                                          const void* d, const void* alpha,
                                          const void* phi0, const void* dphi,
                                          const void* mu, const void* f,
                                          const void* done,
                                          const void* active,
                                          void* alpha_out, void* f_out,
                                          void* ok_out, void* stream) {
  if (B == 0) return 0;
  if (B < 0 || n < 1 || n > neo_mpc::kMaxSteps || sum_width < 1 ||
      sum_width > neo_mpc::kMaxSumWidth || H < 1 || W < 1 ||
      (map_lanes != 1 && map_lanes != B))
    return static_cast<int>(cudaErrorInvalidValue);
  neo_mpc::Scalars S;
  S.n = n;
  S.sum_width = sum_width;
  S.quirks = quirks;
  S.dt = dt;
  S.inv_n = 1.f / static_cast<float>(n);   // the host's IEEE reciprocal
  const long long stride =
      map_lanes == 1 ? 0 : static_cast<long long>(H) * W;
  constexpr int threads = 64;
  const unsigned blocks = static_cast<unsigned>((B + threads - 1) / threads);
  neo_mpc::parity_line_search_kernel<<<blocks, threads, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      B, S, max_backtracks, quad_interp, coarse_after, backtrack, coarse, H,
      W, stride, static_cast<const float*>(map),
      static_cast<const uint8_t*>(map_u8), static_cast<const float*>(lane),
      static_cast<const float*>(x), static_cast<const float*>(d),
      static_cast<const float*>(alpha), static_cast<const float*>(phi0),
      static_cast<const float*>(dphi), static_cast<const float*>(mu),
      static_cast<const float*>(f), static_cast<const bool*>(done),
      static_cast<const bool*>(active), static_cast<float*>(alpha_out),
      static_cast<float*>(f_out), static_cast<bool*>(ok_out));
  return static_cast<int>(cudaGetLastError());
}
