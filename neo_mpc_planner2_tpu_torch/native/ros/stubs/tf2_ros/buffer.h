// tf2_ros::Buffer placeholder for the no-ROS harness (the shim only stores
// the shared_ptr; poses are already in the plan frame in the harness).
#ifndef ROSSTUB_TF2_ROS_BUFFER_H_
#define ROSSTUB_TF2_ROS_BUFFER_H_

namespace tf2_ros {
class Buffer {};
} // namespace tf2_ros

#endif // ROSSTUB_TF2_ROS_BUFFER_H_
