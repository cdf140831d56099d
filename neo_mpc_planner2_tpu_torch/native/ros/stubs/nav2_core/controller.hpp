// Minimal nav2_core::Controller base for the no-ROS harness — virtual
// signatures match nav2 Humble's nav2_core/controller.hpp so the shim's
// overrides are checked by the compiler exactly as pluginlib would load them.
#ifndef ROSSTUB_NAV2_CORE_CONTROLLER_HPP_
#define ROSSTUB_NAV2_CORE_CONTROLLER_HPP_

#include <memory>
#include <string>

#include "nav2_costmap_2d/costmap_2d_ros.hpp"
#include "rclcpp/rclcpp.hpp"
#include "rosstub/msgs.hpp"
#include "tf2_ros/buffer.h"

namespace nav2_core {

class GoalChecker;

class Controller {
 public:
  using Ptr = std::shared_ptr<Controller>;
  virtual ~Controller() = default;

  virtual void configure(
      const rclcpp_lifecycle::LifecycleNode::WeakPtr& parent,
      std::string name, std::shared_ptr<tf2_ros::Buffer> tf,
      std::shared_ptr<nav2_costmap_2d::Costmap2DROS> costmap_ros) = 0;
  virtual void cleanup() = 0;
  virtual void activate() = 0;
  virtual void deactivate() = 0;
  virtual geometry_msgs::msg::TwistStamped computeVelocityCommands(
      const geometry_msgs::msg::PoseStamped& pose,
      const geometry_msgs::msg::Twist& velocity,
      GoalChecker* goal_checker) = 0;
  virtual void setPlan(const nav_msgs::msg::Path& path) = 0;
  virtual void setSpeedLimit(const double& speed_limit,
                             const bool& percentage) = 0;
};

} // namespace nav2_core

#endif // ROSSTUB_NAV2_CORE_CONTROLLER_HPP_
