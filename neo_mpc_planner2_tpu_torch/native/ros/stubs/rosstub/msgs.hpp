// Minimal message structs for the no-ROS compile/run harness of the nav2
// plugin shim (see ../../README in CMakeLists.txt). Field-compatible with the
// real ROS 2 message headers FOR THE FIELDS THE PLUGIN TOUCHES — nothing
// else. Never installed; only -I'd by scripts/check_nav2_plugin.sh.
#ifndef ROSSTUB_MSGS_HPP_
#define ROSSTUB_MSGS_HPP_

#include <string>
#include <vector>

namespace builtin_interfaces {
namespace msg {
struct Time {
  int32_t sec = 0;
  uint32_t nanosec = 0;
};
} // namespace msg
} // namespace builtin_interfaces

namespace std_msgs {
namespace msg {
struct Header {
  builtin_interfaces::msg::Time stamp;
  std::string frame_id;
};
} // namespace msg
} // namespace std_msgs

namespace geometry_msgs {
namespace msg {
struct Point {
  double x = 0, y = 0, z = 0;
};
struct Vector3 {
  double x = 0, y = 0, z = 0;
};
struct Quaternion {
  double x = 0, y = 0, z = 0, w = 1;
};
struct Pose {
  Point position;
  Quaternion orientation;
};
struct PoseStamped {
  std_msgs::msg::Header header;
  Pose pose;
};
struct Twist {
  Vector3 linear;
  Vector3 angular;
};
struct TwistStamped {
  std_msgs::msg::Header header;
  Twist twist;
};
struct PointStamped {
  std_msgs::msg::Header header;
  Point point;
};
} // namespace msg
} // namespace geometry_msgs

namespace nav_msgs {
namespace msg {
struct Path {
  std_msgs::msg::Header header;
  std::vector<geometry_msgs::msg::PoseStamped> poses;
};
} // namespace msg
} // namespace nav_msgs

namespace rcl_interfaces {
namespace msg {
struct SetParametersResult {
  bool successful = false;
  std::string reason;
};
} // namespace msg
} // namespace rcl_interfaces

#endif // ROSSTUB_MSGS_HPP_
