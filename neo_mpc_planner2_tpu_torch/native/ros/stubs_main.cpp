// No-ROS harness for the nav2 plugin shim: compiles the REAL (guarded) branch
// of neo_mpc_nav2_plugin.cpp against the stub headers in ./stubs and drives
// the full controller lifecycle the way nav2's controller_server would —
// configure → activate → setPlan → computeVelocityCommands ticks — against a
// LIVE serving.py instance over TCP (the harness's pytest wrapper,
// tests/test_nav2_plugin.py, stages the costmap/footprint and owns the
// server). Mirrors the reference's deployment shape: plugin geometry gates
// locally, solve rides the service hop (src/NeoMpcPlanner.cpp:202-254).
//
// Build: scripts/check_nav2_plugin.sh. Run: stubs_harness <port>.

#include "neo_mpc_nav2_plugin.cpp" // the guarded TU, real branch via -Istubs

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <memory>

static int checks = 0;
#define CHECK(cond)                                                        \
  do {                                                                     \
    if (!(cond)) {                                                         \
      std::fprintf(stderr, "FAIL %s:%d: %s\n", __FILE__, __LINE__, #cond); \
      return 1;                                                            \
    }                                                                      \
    ++checks;                                                              \
  } while (0)

using neo_mpc_planner2_tpu::NeoMpcTpuController;

int main(int argc, char** argv) {
  const int port = argc > 1 ? std::atoi(argv[1]) : 7180;

  auto node = std::make_shared<rclcpp_lifecycle::LifecycleNode>();
  node->declare_parameter("controller_frequency",
                          rclcpp::ParameterValue(30.0));
  node->declare_parameter("FollowPath.optimizer_port",
                          rclcpp::ParameterValue(port));
  node->declare_parameter("FollowPath.lookahead_dist_min",
                          rclcpp::ParameterValue(0.4));
  node->declare_parameter("FollowPath.lookahead_dist_max",
                          rclcpp::ParameterValue(0.4));
  node->declare_parameter("FollowPath.lookahead_dist_close_to_goal",
                          rclcpp::ParameterValue(0.4));

  auto costmap_ros = std::make_shared<nav2_costmap_2d::Costmap2DROS>();
  costmap_ros->costmap_.stub_resize(80, 80, 0.05, -2.0, -2.0, 0);
  for (double x : {0.25, -0.25}) {
    for (double y : {0.18, -0.18}) {
      geometry_msgs::msg::Point p;
      p.x = x;
      p.y = y;
      costmap_ros->footprint_.push_back(p);
    }
  }

  NeoMpcTpuController plugin;
  plugin.configure(node, "FollowPath", std::make_shared<tf2_ros::Buffer>(),
                   costmap_ros);
  plugin.activate();

  // Empty plan must throw (reference would index poses[-1], cpp:276).
  {
    bool threw = false;
    try {
      plugin.setPlan(nav_msgs::msg::Path{});
    } catch (const nav2_core::InvalidPath&) {
      threw = true;
    }
    CHECK(threw);
  }

  // Straight-line plan: (0,0) → (1.2, 0).
  nav_msgs::msg::Path path;
  path.header.frame_id = "map";
  for (int i = 0; i < 40; ++i) {
    geometry_msgs::msg::PoseStamped ps;
    ps.header.frame_id = "map";
    ps.pose.position.x = 1.2 * i / 39.0;
    path.poses.push_back(ps);
  }
  plugin.setPlan(path);

  // Closed loop: integrate the commanded twist like the plant would.
  double x = 0, y = 0, yaw = 0;
  geometry_msgs::msg::Twist vel;
  const double dt = 1.0 / 30.0;
  for (int t = 0; t < 90; ++t) {
    geometry_msgs::msg::PoseStamped pose;
    pose.header.frame_id = "map";
    pose.pose.position.x = x;
    pose.pose.position.y = y;
    pose.pose.orientation.z = std::sin(yaw / 2.0);
    pose.pose.orientation.w = std::cos(yaw / 2.0);
    const auto cmd = plugin.computeVelocityCommands(pose, vel, nullptr);
    const double vx = cmd.twist.linear.x, vy = cmd.twist.linear.y,
                 wz = cmd.twist.angular.z;
    CHECK(std::isfinite(vx) && std::isfinite(vy) && std::isfinite(wz));
    CHECK(std::hypot(vx, vy) <= 1.5);
    const double c = std::cos(yaw), s = std::sin(yaw);
    x += (vx * c - vy * s) * dt;
    y += (vx * s + vy * c) * dt;
    yaw += wz * dt;
    vel.linear.x = vx;
    vel.linear.y = vy;
    vel.angular.z = wz;
  }
  CHECK(x > 0.3); // made real forward progress along the plan
  std::fprintf(stderr, "closed loop: advanced to x=%.3f y=%.3f\n", x, y);

  // Working dynamic-parameter callback (the documented divergence).
  auto res = node->trigger_param_callback(
      {rclcpp::Parameter("FollowPath.lookahead_dist_min", 0.45)});
  CHECK(res.successful);

  // Lethal costmap → the reference's exception text (cpp:234-236).
  costmap_ros->costmap_.stub_resize(80, 80, 0.05, -2.0, -2.0, 255);
  {
    bool threw = false;
    try {
      geometry_msgs::msg::PoseStamped pose;
      pose.pose.position.x = x;
      pose.pose.position.y = y;
      plugin.computeVelocityCommands(pose, vel, nullptr);
    } catch (const nav2_core::ControllerException& e) {
      threw = std::string(e.what()) == "MPC detected collision!";
    }
    CHECK(threw);
  }

  plugin.deactivate();
  plugin.cleanup();
  std::printf("nav2 plugin harness OK (%d checks)\n", checks);
  return 0;
}
