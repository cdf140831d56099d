// neo_mpc_host — C ABI for the native single-robot host front-end.
//
// One header shared by the host implementation (neo_mpc_host.cpp), the
// pure-C++ test program (host_test_main.cpp), the Python ctypes binding
// (../host.py mirrors these structs field-for-field), and the optional nav2
// controller plugin (neo_mpc_nav2_plugin.cpp). The types marshal the same
// data the reference plugin ships per tick (src/NeoMpcPlanner.cpp:202-254):
// plan + robot pose + costmap in, an Optimizer.srv-shaped request out.

#ifndef NEO_MPC_HOST_H_
#define NEO_MPC_HOST_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct {
  double x, y, yaw;
} nmp_pose;

typedef struct {
  double lookahead_dist_min;           // cpp:312
  double lookahead_dist_max;           // cpp:314
  double lookahead_dist_close_to_goal; // cpp:316
  double controller_frequency;         // cpp:323
} nmp_params;

typedef struct {
  const float* data; // row-major (height, width), normalized [0,1]
  int32_t width;
  int32_t height;
  double origin_x;
  double origin_y;
  double resolution;
} nmp_costmap;

// The request the tick produces — field-for-field the Optimizer.srv request
// (NeoMpcPlanner.cpp:240-246): current_vel, carrot_pose, goal_pose,
// current_pose, switch_opt, control_interval.
typedef struct {
  nmp_pose current_pose;  // robot pose, map frame
  nmp_pose carrot_pose;   // base frame (transformed plan)
  nmp_pose goal_pose;     // map frame
  double vel[3];          // vx, vy, wz
  int32_t switch_opt;     // closer_to_goal
  double control_interval;
  int32_t slow_down;      // hysteresis state after this tick
  double footprint_cost;  // normalized current-pose footprint cost
  double lookahead_dist;
  int32_t window_begin;   // transformed-plan window [begin, end) plan indices
  int32_t window_end;     // (cpp:102-124; received_global_plan = these poses
                          // in base frame, cpp:119-128)
} nmp_request;

enum nmp_status {
  NMP_OK = 0,
  NMP_ERR_EMPTY_PLAN = 1,      // cpp:69-71 "Received plan with zero length"
  NMP_ERR_NO_WINDOW = 2,       // cpp:130-132 "Resulting plan has 0 poses"
  NMP_ERR_LETHAL = 3,          // cpp:234-236 "MPC detected collision!"
  NMP_ERR_BAD_ARG = 4,
};

void* nmp_host_create(const nmp_params* params);
void nmp_host_destroy(void* handle);
void nmp_host_set_params(void* handle, const nmp_params* params);
int32_t nmp_host_set_plan(void* handle, const nmp_pose* poses, int32_t n);
int32_t nmp_host_tick(void* handle, const nmp_pose* robot_pose,
                      const double* speed, const nmp_costmap* costmap,
                      const double* footprint_verts, int32_t n_verts,
                      nmp_request* out);
double nmp_footprint_cost(const nmp_costmap* costmap,
                          const double* footprint_verts, int32_t n_verts,
                          const nmp_pose* pose);

#ifdef __cplusplus
} // extern "C"
#endif

#endif // NEO_MPC_HOST_H_
