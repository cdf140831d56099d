// neo_mpc_nav2_plugin — the loadable nav2_core::Controller shim.
//
// The reference's Layer-A deliverable is a pluginlib-exported controller that
// nav2's controller_server loads in-process (src/NeoMpcPlanner.cpp:380
// PLUGINLIB_EXPORT_CLASS, neo_mpc_planner_plugin.xml:2). This file fills that
// plugin slot for the TPU engine: a thin ROS adapter that delegates
//   - ALL per-tick geometry (plan pruning, carrot selection, slow-down
//     hysteresis, footprint collision gate, request marshalling) to the
//     existing C-ABI host (neo_mpc_host.cpp — the de-ROS'd twin of
//     cpp:66-135 + cpp:202-254), and
//   - the solve to the TCP serving layer (serving.py) over the same
//     newline-delimited JSON protocol OptimizerClient speaks — the stand-in
//     for the reference's 'optimizer' service client (cpp:240-250), with the
//     same wait-for-service loop semantics (cpp:325-330).
//
// Compile-guarded like ros_adapter.py's import guard: without nav2/rclcpp
// headers this translation unit compiles EMPTY (so plain `g++ -c` in this
// repo's CI stays a syntax check of the guard itself); with a sourced ROS 2
// + nav2 workspace, native/ros/CMakeLists.txt builds it into
// libneo_mpc_tpu_nav2_plugin.so and exports the pluginlib class
// `neo_mpc_planner2_tpu::NeoMpcTpuController` (native/ros/
// neo_mpc_tpu_plugin.xml), a drop-in for the reference's controller entry in
// nav2_params.yaml.
//
// Deliberate divergences from the reference plugin (each documented in
// SURVEY.md §2.3 and mirrored by the C-ABI host):
//   - the dead identical-argument lookahead re-check (cpp:224-227) is gone;
//   - dynamicParametersCallback actually works: the reference's is dead code
//     (missing '.' in the compared names, cpp:363-368) and self-deadlocks
//     (try_lock under an already-held mutex, cpp:339+352) — here it is a
//     plain setter through nmp_host_set_params;
//   - an empty plan in setPlan throws instead of indexing poses[-1]
//     (cpp:276 would crash controller_server).

#if defined(__has_include)
#if __has_include(<nav2_core/controller.hpp>) && __has_include(<rclcpp/rclcpp.hpp>)
#define NEO_MPC_HAVE_NAV2 1
#endif
#endif

#ifdef NEO_MPC_HAVE_NAV2

#include "neo_mpc_host.h"

#include <arpa/inet.h>
#include <netdb.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cerrno>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <sstream>
#include <stdexcept>
#include <string>
#include <vector>

#include "geometry_msgs/msg/point_stamped.hpp"
#include "nav2_core/controller.hpp"
#include "nav2_core/controller_exceptions.hpp"
#include "nav2_costmap_2d/costmap_2d_ros.hpp"
#include "nav_msgs/msg/path.hpp"
#include "pluginlib/class_list_macros.hpp"
#include "rclcpp/rclcpp.hpp"

namespace neo_mpc_planner2_tpu {

// Named (not anonymous) detail namespace: JsonTcpClient is a member of the
// externally-visible plugin class, so internal linkage would trip
// -Wsubobject-linkage.
namespace detail {

// Planar yaw from a quaternion: the closed form for a z-axis rotation
// (same result as the reference's tf2 Matrix3x3 round-trip, cpp:56-62,
// without the tf2 dependency in this TU).
double yaw_of(const geometry_msgs::msg::Quaternion& q) {
  return std::atan2(2.0 * (q.w * q.z + q.x * q.y),
                    1.0 - 2.0 * (q.y * q.y + q.z * q.z));
}

void set_yaw(geometry_msgs::msg::Quaternion& q, double yaw) {
  q.x = 0.0;
  q.y = 0.0;
  q.z = std::sin(yaw / 2.0);
  q.w = std::cos(yaw / 2.0);
}

// Minimal blocking newline-delimited-JSON client for the serving layer —
// the C++ twin of serving.OptimizerClient. No JSON library dependency: the
// requests this plugin sends are flat and composed by hand; the single
// reply field it needs (output_vel) is extracted with a targeted scan.
class JsonTcpClient {
 public:
  ~JsonTcpClient() { close_(); }

  bool connect_once(const std::string& host, int port) {
    close_();
    addrinfo hints{};
    hints.ai_family = AF_UNSPEC;
    hints.ai_socktype = SOCK_STREAM;
    addrinfo* res = nullptr;
    const std::string port_s = std::to_string(port);
    if (getaddrinfo(host.c_str(), port_s.c_str(), &hints, &res) != 0) {
      return false;
    }
    for (addrinfo* it = res; it != nullptr; it = it->ai_next) {
      fd_ = ::socket(it->ai_family, it->ai_socktype, it->ai_protocol);
      if (fd_ < 0) continue;
      if (::connect(fd_, it->ai_addr, it->ai_addrlen) == 0) break;
      ::close(fd_);
      fd_ = -1;
    }
    freeaddrinfo(res);
    return fd_ >= 0;
  }

  bool connected() const { return fd_ >= 0; }

  void disconnect() { close_(); }

  // One request -> one reply line (the protocol is strictly one JSON object
  // per newline in each direction; requests serialize server-side).
  // MSG_NOSIGNAL: a peer that died between ticks must surface as an error
  // return, not a SIGPIPE that kills the whole controller_server process
  // (rclcpp installs no SIGPIPE handler). Any transport failure closes the
  // socket so the caller's next tick can reconnect instead of throwing on a
  // dead fd forever.
  std::string call(const std::string& json_line) {
    std::string out = json_line;
    out.push_back('\n');
    size_t sent = 0;
    while (sent < out.size()) {
      const ssize_t n = ::send(fd_, out.data() + sent, out.size() - sent,
                               MSG_NOSIGNAL);
      if (n <= 0) {
        close_();
        throw std::runtime_error("optimizer service send failed");
      }
      sent += static_cast<size_t>(n);
    }
    std::string line;
    char c;
    for (;;) {
      const ssize_t n = ::recv(fd_, &c, 1, 0);
      if (n <= 0) {
        close_();
        throw std::runtime_error("optimizer service closed");
      }
      if (c == '\n') break;
      line.push_back(c);
    }
    return line;
  }

 private:
  void close_() {
    if (fd_ >= 0) ::close(fd_);
    fd_ = -1;
  }
  int fd_ = -1;
};

std::string pose_json(const nmp_pose& p) {
  char buf[128];
  std::snprintf(buf, sizeof buf, "[%.17g, %.17g, %.17g]", p.x, p.y, p.yaw);
  return buf;
}

// Extract the first "key": [a, b, c] triple from a flat JSON object.
bool parse_vec3(const std::string& s, const char* key, double out[3]) {
  const std::string pat = std::string("\"") + key + "\"";
  size_t i = s.find(pat);
  if (i == std::string::npos) return false;
  i = s.find('[', i);
  if (i == std::string::npos) return false;
  const char* p = s.c_str() + i + 1;
  for (int k = 0; k < 3; ++k) {
    char* end = nullptr;
    out[k] = std::strtod(p, &end);
    if (end == p) return false;
    p = end;
    while (*p == ',' || *p == ' ') ++p;
  }
  return true;
}

} // namespace detail

using detail::JsonTcpClient;
using detail::parse_vec3;
using detail::pose_json;
using detail::set_yaw;
using detail::yaw_of;

class NeoMpcTpuController : public nav2_core::Controller {
 public:
  NeoMpcTpuController() = default;
  ~NeoMpcTpuController() override {
    if (host_) nmp_host_destroy(host_);
  }

  void configure(
      const rclcpp_lifecycle::LifecycleNode::WeakPtr& parent,
      std::string name, std::shared_ptr<tf2_ros::Buffer> tf,
      std::shared_ptr<nav2_costmap_2d::Costmap2DROS> costmap_ros) override {
    node_ = parent;
    auto node = node_.lock();
    if (!node) {
      throw nav2_core::ControllerException("Unable to lock node!");
    }
    costmap_ros_ = costmap_ros;
    costmap_ = costmap_ros_->getCostmap();
    tf_ = tf;
    plugin_name_ = name;
    logger_ = node->get_logger();

    // Same parameter names + defaults as the reference (cpp:309-323).
    declare_if_absent(node, plugin_name_ + ".lookahead_dist_min", 0.5);
    declare_if_absent(node, plugin_name_ + ".lookahead_dist_max", 0.5);
    declare_if_absent(node, plugin_name_ + ".lookahead_dist_close_to_goal",
                      0.5);
    // Serving endpoint (replaces the in-DDS 'optimizer' service).
    declare_if_absent_s(node, plugin_name_ + ".optimizer_host", "127.0.0.1");
    declare_if_absent_i(node, plugin_name_ + ".optimizer_port", 7180);

    nmp_params p{};
    node->get_parameter(plugin_name_ + ".lookahead_dist_min",
                        p.lookahead_dist_min);
    node->get_parameter(plugin_name_ + ".lookahead_dist_max",
                        p.lookahead_dist_max);
    node->get_parameter(plugin_name_ + ".lookahead_dist_close_to_goal",
                        p.lookahead_dist_close_to_goal);
    node->get_parameter("controller_frequency", p.controller_frequency);
    params_ = p;
    // Lifecycle can drive configure -> cleanup -> configure; never leak the
    // previous cycle's host (or keep its stale TCP connection).
    if (host_) nmp_host_destroy(host_);
    host_ = nmp_host_create(&p);

    node->get_parameter(plugin_name_ + ".optimizer_host", srv_host_);
    node->get_parameter(plugin_name_ + ".optimizer_port", srv_port_);
    // wait-for-service loop (cpp:325-330): retry at 1 Hz until the serving
    // layer accepts the connection or ROS shuts down.
    while (!client_.connect_once(srv_host_, srv_port_)) {
      if (!rclcpp::ok()) {
        RCLCPP_ERROR(logger_,
                     "Interrupted while waiting for the service. Exiting.");
        throw nav2_core::ControllerException(
            "optimizer service not available");
      }
      RCLCPP_INFO(logger_, "service not available, waiting again...");
      rclcpp::sleep_for(std::chrono::seconds(1));
    }

    global_path_pub_ = node->create_publisher<nav_msgs::msg::Path>(
        "received_global_plan", 1);
    carrot_pub_ = node->create_publisher<geometry_msgs::msg::PointStamped>(
        "/lookahead_point", 1);
  }

  void cleanup() override {
    global_path_pub_.reset();
    carrot_pub_.reset();
    client_.disconnect();
    if (host_) {
      nmp_host_destroy(host_);
      host_ = nullptr;
    }
  }

  void activate() override {
    global_path_pub_->on_activate();
    carrot_pub_->on_activate();
    auto node = node_.lock();
    dyn_params_handler_ = node->add_on_set_parameters_callback(
        [this](std::vector<rclcpp::Parameter> ps) {
          return this->on_params(ps);
        });
  }

  void deactivate() override {
    global_path_pub_->on_deactivate();
    carrot_pub_->on_deactivate();
    dyn_params_handler_.reset();
  }

  void setPlan(const nav_msgs::msg::Path& path) override {
    if (path.poses.empty()) {
      // The reference indexes poses[size()-1] here (cpp:276) — a crash on
      // an empty plan; surface it as the standard controller exception.
      throw nav2_core::InvalidPath("Received plan with zero length");
    }
    std::vector<nmp_pose> plan(path.poses.size());
    for (size_t i = 0; i < path.poses.size(); ++i) {
      const auto& pp = path.poses[i].pose;
      plan[i] = {pp.position.x, pp.position.y, yaw_of(pp.orientation)};
    }
    std::lock_guard<std::mutex> lock(mutex_);
    // Goal-change slow-down reset lives in the host (cpp:277-279 twin).
    nmp_host_set_plan(host_, plan.data(),
                      static_cast<int32_t>(plan.size()));
  }

  geometry_msgs::msg::TwistStamped computeVelocityCommands(
      const geometry_msgs::msg::PoseStamped& position,
      const geometry_msgs::msg::Twist& speed,
      nav2_core::GoalChecker* /*goal_checker*/) override {
    std::lock_guard<std::mutex> lock(mutex_); // cpp:207

    // Snapshot the rolling local costmap under nav2's own lock, normalized
    // to [0,1] (the engine's scale: raw/255, 1.0 lethal — the raw 200/255
    // slow-down and ==255 lethal gates keep their exact thresholds).
    const unsigned int w = costmap_->getSizeInCellsX();
    const unsigned int h = costmap_->getSizeInCellsY();
    grid_.resize(static_cast<size_t>(w) * h);
    {
      std::unique_lock<nav2_costmap_2d::Costmap2D::mutex_t> cm_lock(
          *costmap_->getMutex());
      const unsigned char* raw = costmap_->getCharMap();
      for (size_t i = 0; i < grid_.size(); ++i) {
        grid_[i] = static_cast<float>(raw[i]) / 255.0f;
      }
    }
    nmp_costmap cm{grid_.data(), static_cast<int32_t>(w),
                   static_cast<int32_t>(h), costmap_->getOriginX(),
                   costmap_->getOriginY(), costmap_->getResolution()};

    const auto footprint = costmap_ros_->getRobotFootprint();
    std::vector<double> verts;
    verts.reserve(footprint.size() * 2);
    for (const auto& pt : footprint) {
      verts.push_back(pt.x);
      verts.push_back(pt.y);
    }

    const nmp_pose robot{position.pose.position.x, position.pose.position.y,
                         yaw_of(position.pose.orientation)};
    const double vel[3] = {speed.linear.x, speed.linear.y, speed.angular.z};
    nmp_request req{};
    const int32_t st = nmp_host_tick(
        host_, &robot, vel, &cm, verts.data(),
        static_cast<int32_t>(verts.size() / 2), &req);
    if (st == NMP_ERR_EMPTY_PLAN) {
      throw nav2_core::ControllerException("Received plan with zero length");
    }
    if (st == NMP_ERR_NO_WINDOW) {
      throw nav2_core::ControllerException("Resulting plan has 0 poses in it.");
    }
    if (st == NMP_ERR_LETHAL) {
      throw nav2_core::ControllerException("MPC detected collision!");
    }
    if (st != NMP_OK) {
      throw nav2_core::ControllerException("MPC host tick failed");
    }

    publish_debug(position, req);

    // The service hop (cpp:240-250): blocking, like the reference's
    // result.get(). Serving replies {"output_vel": [vx, vy, wz], ...}.
    // Full %.17g precision throughout (ostream's default 6 significant
    // digits would perturb current_vel/control_interval at ~1e-7 — the
    // solver's warm-start continuity and accel box are anchored on them).
    char tail[256];
    std::snprintf(tail, sizeof tail,
                  ", \"current_vel\": [%.17g, %.17g, %.17g]"
                  ", \"switch_opt\": %s"
                  ", \"control_interval\": %.17g}",
                  req.vel[0], req.vel[1], req.vel[2],
                  req.switch_opt ? "true" : "false", req.control_interval);
    std::ostringstream os;
    os << "{\"op\": \"optimizer\""
       << ", \"current_pose\": " << pose_json(req.current_pose)
       << ", \"carrot_pose\": " << pose_json(req.carrot_pose)
       << ", \"goal_pose\": " << pose_json(req.goal_pose) << tail;
    // A serving restart (or dropped connection) must degrade to the
    // standard controller exception — recoverable by nav2 — not a dead fd
    // forever: reconnect once per tick, and surface transport failures as
    // ControllerException after the client closed the broken socket.
    if (!client_.connected() && !client_.connect_once(srv_host_, srv_port_)) {
      throw nav2_core::ControllerException("optimizer service not available");
    }
    std::string reply;
    try {
      reply = client_.call(os.str());
    } catch (const std::runtime_error& e) {
      throw nav2_core::ControllerException(e.what());
    }
    double out_vel[3] = {0.0, 0.0, 0.0};
    if (!parse_vec3(reply, "output_vel", out_vel)) {
      throw nav2_core::ControllerException(
          "optimizer service returned no output_vel");
    }

    geometry_msgs::msg::TwistStamped cmd;
    cmd.header = position.header;
    cmd.twist.linear.x = out_vel[0];
    cmd.twist.linear.y = out_vel[1];
    cmd.twist.angular.z = out_vel[2];
    return cmd;
  }

  void setSpeedLimit(const double& /*speed_limit*/,
                     const bool& /*percentage*/) override {
    // The reference leaves this a no-op (cpp:283-288); speed limits are
    // solver box bounds, settable via the serving configure op.
  }

 private:
  template <class NodeT>
  static void declare_if_absent(NodeT& node, const std::string& name,
                                double v) {
    if (!node->has_parameter(name)) {
      node->declare_parameter(name, rclcpp::ParameterValue(v));
    }
  }
  template <class NodeT>
  static void declare_if_absent_s(NodeT& node, const std::string& name,
                                  const std::string& v) {
    if (!node->has_parameter(name)) {
      node->declare_parameter(name, rclcpp::ParameterValue(v));
    }
  }
  template <class NodeT>
  static void declare_if_absent_i(NodeT& node, const std::string& name,
                                  int v) {
    if (!node->has_parameter(name)) {
      node->declare_parameter(name, rclcpp::ParameterValue(v));
    }
  }

  // WORKING dynamic-parameter setter (divergence: the reference's compares
  // names missing the '.' separator so no branch can ever match, cpp:363-368,
  // and its try_lock under the held mutex self-deadlocks, cpp:339+352).
  rcl_interfaces::msg::SetParametersResult on_params(
      const std::vector<rclcpp::Parameter>& parameters) {
    std::lock_guard<std::mutex> lock(mutex_);
    nmp_params p = params_;
    for (const auto& parameter : parameters) {
      if (parameter.get_type() !=
          rclcpp::ParameterType::PARAMETER_DOUBLE) {
        continue;
      }
      const std::string& name = parameter.get_name();
      if (name == plugin_name_ + ".lookahead_dist_min") {
        p.lookahead_dist_min = parameter.as_double();
      } else if (name == plugin_name_ + ".lookahead_dist_max") {
        p.lookahead_dist_max = parameter.as_double();
      } else if (name == plugin_name_ + ".lookahead_dist_close_to_goal") {
        p.lookahead_dist_close_to_goal = parameter.as_double();
      } else if (name == "controller_frequency") {
        p.controller_frequency = parameter.as_double();
      }
    }
    params_ = p;
    nmp_host_set_params(host_, &p);
    rcl_interfaces::msg::SetParametersResult result;
    result.successful = true;
    return result;
  }

  // Debug publishers (cpp:190-199 createCarrotMsg + cpp:128 global_path_pub_):
  // the carrot right over the map (z=0.01) and the base-frame transformed
  // plan window the host selected.
  void publish_debug(const geometry_msgs::msg::PoseStamped& position,
                     const nmp_request& req) {
    geometry_msgs::msg::PointStamped carrot;
    carrot.header = position.header;
    carrot.point.x = req.carrot_pose.x;
    carrot.point.y = req.carrot_pose.y;
    carrot.point.z = 0.01; // publish right over map to stand out
    carrot_pub_->publish(carrot);

    nav_msgs::msg::Path window;
    window.header.stamp = position.header.stamp;
    window.header.frame_id = costmap_ros_->getBaseFrameID();
    // One representative pose (the carrot) — the full base-frame window
    // lives host-side; serializing all of it per tick is debug-only cost.
    geometry_msgs::msg::PoseStamped ps;
    ps.header = window.header;
    ps.pose.position.x = req.carrot_pose.x;
    ps.pose.position.y = req.carrot_pose.y;
    set_yaw(ps.pose.orientation, req.carrot_pose.yaw);
    window.poses.push_back(ps);
    global_path_pub_->publish(window);
  }

  rclcpp_lifecycle::LifecycleNode::WeakPtr node_;
  rclcpp::Logger logger_{rclcpp::get_logger("NeoMpcTpu")};
  std::shared_ptr<tf2_ros::Buffer> tf_;
  std::shared_ptr<nav2_costmap_2d::Costmap2DROS> costmap_ros_;
  nav2_costmap_2d::Costmap2D* costmap_ = nullptr;
  std::string plugin_name_;
  std::string srv_host_;
  int srv_port_ = 0;
  void* host_ = nullptr;
  nmp_params params_{};
  JsonTcpClient client_;
  std::vector<float> grid_;
  std::mutex mutex_;
  rclcpp_lifecycle::LifecyclePublisher<nav_msgs::msg::Path>::SharedPtr
      global_path_pub_;
  rclcpp_lifecycle::LifecyclePublisher<
      geometry_msgs::msg::PointStamped>::SharedPtr carrot_pub_;
  rclcpp::node_interfaces::OnSetParametersCallbackHandle::SharedPtr
      dyn_params_handler_;
};

} // namespace neo_mpc_planner2_tpu

PLUGINLIB_EXPORT_CLASS(neo_mpc_planner2_tpu::NeoMpcTpuController,
                       nav2_core::Controller)

#else // !NEO_MPC_HAVE_NAV2

// nav2/rclcpp headers are absent: this TU intentionally compiles to nothing
// (the guarded ament target in native/ros/CMakeLists.txt is skipped too).
// scripts/build_native.sh still compiles this file so the guard itself and
// the non-ROS branch stay syntax-checked in ROS-less CI.

#endif // NEO_MPC_HAVE_NAV2
