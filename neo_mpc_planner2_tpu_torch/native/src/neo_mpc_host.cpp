// neo_mpc_host — native single-robot host front-end (C ABI).
//
// TPU-native re-design of the reference's C++ controller plugin (Layer A,
// src/NeoMpcPlanner.cpp:54-380) with ROS removed: the host owns the stateful
// per-robot path — global plan + consumed prefix (cpp:127, :274-281), the
// slow-down hysteresis (cpp:221-232), lookahead selection (cpp:157-189), the
// footprint collision gate (cpp:218-236) — and marshals a solve request for
// the device engine (the cpp:240-250 service call becomes a struct handed to
// the in-process JAX engine or the TCP serving layer).
//
// Costs are normalized [0,1] (1.0 lethal); the plugin's raw-scale thresholds
// map as 200/255 (slow-down gate) and 1.0 (lethal).
//
// Deliberate fixes vs the reference (documented divergences):
//  - the dead re-check at cpp:224-227 (identical-argument getLookAheadPoint)
//    is dropped — it can never change the outcome (SURVEY.md §2.3.3);
//  - the dynamic-parameter name bug (missing '.', cpp:363-368) and the
//    self-deadlocking try_lock (cpp:339+:352) are not reproduced: parameter
//    updates here are a plain setter under one mutex.

#include "neo_mpc_host.h"

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <mutex>
#include <vector>

namespace {

constexpr double kSlowDownGate = 200.0 / 255.0; // cpp:225/228
constexpr double kLethalGate = 1.0;             // cpp:234

struct Host {
  nmp_params params{};
  std::vector<nmp_pose> plan;   // map frame
  size_t plan_start = 0;        // consumed prefix (cpp:127 erase)
  nmp_pose goal{0, 0, 0};
  bool have_goal = false;
  bool slow_down = true;        // NeoMpcPlanner.h:162 init
  std::mutex mu;
};

double cell_cost(const nmp_costmap& cm, long mx, long my) {
  if (mx < 0 || my < 0 || mx >= cm.width || my >= cm.height) return 1.0;
  return static_cast<double>(cm.data[my * cm.width + mx]);
}

// Floor (not truncation): nav2 worldToMap's wx < origin_x guard makes the
// below-origin band out of bounds; floor to -1 reproduces that exactly.
long world_to_cell(double w, double origin, double resolution) {
  return static_cast<long>(std::floor((w - origin) / resolution));
}

// Max cost along a segment via grid line traversal (the nav2 LineIterator
// pattern used by FootprintCollisionChecker::lineCost): visit every cell the
// segment crosses using an Amanatides-Woo style walk.
double line_cost(const nmp_costmap& cm, double x0, double y0, double x1,
                 double y1) {
  long mx = world_to_cell(x0, cm.origin_x, cm.resolution);
  long my = world_to_cell(y0, cm.origin_y, cm.resolution);
  const long ex = world_to_cell(x1, cm.origin_x, cm.resolution);
  const long ey = world_to_cell(y1, cm.origin_y, cm.resolution);

  const double dx = x1 - x0, dy = y1 - y0;
  const int step_x = dx > 0 ? 1 : -1;
  const int step_y = dy > 0 ? 1 : -1;

  // Parametric distance to the next cell boundary along each axis.
  auto boundary = [&](double w, double o, long m, int step) {
    const double edge = o + (m + (step > 0 ? 1 : 0)) * cm.resolution;
    return edge - w;
  };
  double t_max_x = dx != 0.0 ? boundary(x0, cm.origin_x, mx, step_x) / dx
                             : std::numeric_limits<double>::infinity();
  double t_max_y = dy != 0.0 ? boundary(y0, cm.origin_y, my, step_y) / dy
                             : std::numeric_limits<double>::infinity();
  const double t_delta_x =
      dx != 0.0 ? cm.resolution / std::fabs(dx)
                : std::numeric_limits<double>::infinity();
  const double t_delta_y =
      dy != 0.0 ? cm.resolution / std::fabs(dy)
                : std::numeric_limits<double>::infinity();

  double best = cell_cost(cm, mx, my);
  double t = 0.0;
  // Bound iterations by the Manhattan cell distance (+2 safety).
  const long max_steps = std::labs(ex - mx) + std::labs(ey - my) + 2;
  for (long i = 0; i < max_steps && (mx != ex || my != ey); ++i) {
    if (t_max_x < t_max_y) {
      t = t_max_x;
      t_max_x += t_delta_x;
      mx += step_x;
    } else {
      t = t_max_y;
      t_max_y += t_delta_y;
      my += step_y;
    }
    if (t > 1.0) break;
    best = std::max(best, cell_cost(cm, mx, my));
  }
  return best;
}

// footprintCostAtPose equivalent (cpp:218-219): place the base-frame polygon
// at the pose, max line cost over the closed boundary.
double footprint_cost_at_pose(const nmp_costmap& cm, const double* verts,
                              int32_t n_verts, const nmp_pose& pose) {
  if (n_verts < 3) return 0.0;
  const double c = std::cos(pose.yaw), s = std::sin(pose.yaw);
  std::vector<double> wx(n_verts), wy(n_verts);
  for (int32_t i = 0; i < n_verts; ++i) {
    const double px = verts[2 * i], py = verts[2 * i + 1];
    wx[i] = pose.x + px * c - py * s;
    wy[i] = pose.y + px * s + py * c;
  }
  double best = 0.0;
  for (int32_t i = 0; i < n_verts; ++i) {
    const int32_t j = (i + 1) % n_verts;
    best = std::max(best, line_cost(cm, wx[i], wy[i], wx[j], wy[j]));
  }
  return best;
}

double dist2(const nmp_pose& a, const nmp_pose& b) {
  const double dx = a.x - b.x, dy = a.y - b.y;
  return dx * dx + dy * dy;
}

} // namespace

extern "C" {

void* nmp_host_create(const nmp_params* params) {
  auto* h = new Host();
  if (params) h->params = *params;
  return h;
}

void nmp_host_destroy(void* handle) { delete static_cast<Host*>(handle); }

// Runtime parameter update (replaces the broken dynamicParametersCallback,
// cpp:336-376).
void nmp_host_set_params(void* handle, const nmp_params* params) {
  auto* h = static_cast<Host*>(handle);
  std::lock_guard<std::mutex> lock(h->mu);
  h->params = *params;
}

// setPlan (cpp:274-281): store plan, flag slow-down on goal change, reset the
// consumed prefix.
int32_t nmp_host_set_plan(void* handle, const nmp_pose* poses, int32_t n) {
  auto* h = static_cast<Host*>(handle);
  if (n <= 0 || poses == nullptr) return NMP_ERR_EMPTY_PLAN;
  std::lock_guard<std::mutex> lock(h->mu);
  h->plan.assign(poses, poses + n);
  h->plan_start = 0;
  const nmp_pose& last = poses[n - 1];
  if (!h->have_goal || last.x != h->goal.x || last.y != h->goal.y ||
      last.yaw != h->goal.yaw) {
    h->slow_down = true; // cpp:277-279
  }
  h->goal = last;
  h->have_goal = true;
  return NMP_OK;
}

// computeVelocityCommands front half (cpp:202-246): everything before the
// service call. Fills *out on NMP_OK; NMP_ERR_LETHAL mirrors the cpp:234-236
// throw (out is still filled so callers can inspect).
int32_t nmp_host_tick(void* handle, const nmp_pose* robot_pose,
                      const double* speed, const nmp_costmap* costmap,
                      const double* footprint_verts, int32_t n_verts,
                      nmp_request* out) {
  auto* h = static_cast<Host*>(handle);
  if (!robot_pose || !speed || !costmap || !out) return NMP_ERR_BAD_ARG;
  std::lock_guard<std::mutex> lock(h->mu); // cpp:207
  if (h->plan.empty()) return NMP_ERR_EMPTY_PLAN;

  const nmp_pose robot = *robot_pose;

  // --- transformGlobalPlan (cpp:66-135) ---
  // Closest pose at/after the consumed prefix (cpp:85-90 + :127 erase).
  size_t begin = h->plan_start;
  double best_d = std::numeric_limits<double>::infinity();
  for (size_t i = h->plan_start; i < h->plan.size(); ++i) {
    const double d = dist2(robot, h->plan[i]);
    if (d < best_d) {
      best_d = d;
      begin = i;
    }
  }
  h->plan_start = begin;

  // closer_to_goal (cpp:92-100).
  const double close = h->params.lookahead_dist_close_to_goal;
  const bool closer_to_goal =
      dist2(robot, h->plan.back()) <= close * close;

  // Window end: first pose beyond half the costmap extent (cpp:80-82,
  // :102-106).
  const double max_dim = std::max(costmap->width, costmap->height);
  const double max_dist = max_dim * costmap->resolution / 2.0;
  size_t end = h->plan.size();
  for (size_t i = begin; i < h->plan.size(); ++i) {
    if (std::sqrt(dist2(robot, h->plan[i])) > max_dist) {
      end = i;
      break;
    }
  }
  if (end <= begin) return NMP_ERR_NO_WINDOW;

  // --- getLookAheadDistance (cpp:157-171; `speed` ignored, §2.3.2) ---
  double lookahead = h->params.lookahead_dist_min;
  if (!h->slow_down || closer_to_goal) {
    lookahead = closer_to_goal ? close : h->params.lookahead_dist_max;
  }

  // --- getLookAheadPoint in the base frame (cpp:173-189) ---
  const double cr = std::cos(robot.yaw), sr = std::sin(robot.yaw);
  auto to_base = [&](const nmp_pose& p) {
    nmp_pose b;
    const double dx = p.x - robot.x, dy = p.y - robot.y;
    b.x = dx * cr + dy * sr;
    b.y = -dx * sr + dy * cr;
    b.yaw = p.yaw - robot.yaw;
    return b;
  };
  nmp_pose carrot = to_base(h->plan[end - 1]);
  for (size_t i = begin; i < end; ++i) {
    const nmp_pose b = to_base(h->plan[i]);
    if (std::hypot(b.x, b.y) >= lookahead) {
      carrot = b;
      break;
    }
  }

  // --- footprint gate + hysteresis (cpp:216-236) ---
  const double fp_cost = footprint_cost_at_pose(
      *costmap, footprint_verts, n_verts, robot);
  const double yaw_mag = std::fabs(carrot.yaw);
  if (yaw_mag < 1.0) {
    h->slow_down = false; // the cpp:224-227 re-check is dead code (§2.3.3)
  } else {
    h->slow_down = fp_cost > kSlowDownGate; // cpp:228-231
  }

  // --- marshal the request (cpp:240-246) ---
  out->current_pose = robot;
  out->carrot_pose = carrot;
  out->goal_pose = h->goal;
  out->vel[0] = speed[0];
  out->vel[1] = speed[1];
  out->vel[2] = speed[2];
  out->switch_opt = closer_to_goal ? 1 : 0;
  out->control_interval =
      h->params.controller_frequency > 0.0
          ? 1.0 / h->params.controller_frequency
          : 0.0;
  out->slow_down = h->slow_down ? 1 : 0;
  out->footprint_cost = fp_cost;
  out->lookahead_dist = lookahead;
  out->window_begin = static_cast<int32_t>(begin);
  out->window_end = static_cast<int32_t>(end);

  if (fp_cost >= kLethalGate) return NMP_ERR_LETHAL; // cpp:234-236
  return NMP_OK;
}

// Exposed for unit tests: raw footprint cost at a pose.
double nmp_footprint_cost(const nmp_costmap* costmap,
                          const double* footprint_verts, int32_t n_verts,
                          const nmp_pose* pose) {
  if (!costmap || !pose) return -1.0;
  return footprint_cost_at_pose(*costmap, footprint_verts, n_verts, *pose);
}

} // extern "C"
