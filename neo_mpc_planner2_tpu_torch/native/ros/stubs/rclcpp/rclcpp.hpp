// Minimal rclcpp / rclcpp_lifecycle surface for the no-ROS harness of the
// nav2 plugin shim: just the API neo_mpc_nav2_plugin.cpp touches (lifecycle
// node with parameters + publishers + param callback, logger macros, ok()).
// API-compatible in shape with ROS 2 Humble for those calls; nothing more.
#ifndef ROSSTUB_RCLCPP_HPP_
#define ROSSTUB_RCLCPP_HPP_

#include <chrono>
#include <cstdio>
#include <functional>
#include <map>
#include <memory>
#include <string>
#include <thread>
#include <variant>
#include <vector>

#include "rosstub/msgs.hpp"

namespace rclcpp {

inline bool ok() { return true; }

template <class Rep, class Period>
inline void sleep_for(const std::chrono::duration<Rep, Period>& d) {
  std::this_thread::sleep_for(d);
}

class Logger {
 public:
  explicit Logger(std::string name = "stub") : name_(std::move(name)) {}
  const std::string& get_name() const { return name_; }

 private:
  std::string name_;
};

inline Logger get_logger(const std::string& name) { return Logger(name); }

enum class ParameterType { PARAMETER_DOUBLE, PARAMETER_STRING,
                           PARAMETER_INTEGER, PARAMETER_NOT_SET };

class ParameterValue {
 public:
  ParameterValue() = default;
  explicit ParameterValue(double v) : v_(v) {}
  explicit ParameterValue(const std::string& v) : v_(v) {}
  explicit ParameterValue(const char* v) : v_(std::string(v)) {}
  explicit ParameterValue(int v) : v_(v) {}
  std::variant<std::monostate, double, std::string, int> v_;
};

class Parameter {
 public:
  Parameter() = default;
  Parameter(std::string name, double v)
      : name_(std::move(name)), type_(ParameterType::PARAMETER_DOUBLE),
        dbl_(v) {}
  const std::string& get_name() const { return name_; }
  ParameterType get_type() const { return type_; }
  double as_double() const { return dbl_; }

 private:
  std::string name_;
  ParameterType type_ = ParameterType::PARAMETER_NOT_SET;
  double dbl_ = 0.0;
};

namespace node_interfaces {
struct OnSetParametersCallbackHandle {
  using SharedPtr = std::shared_ptr<OnSetParametersCallbackHandle>;
  std::function<rcl_interfaces::msg::SetParametersResult(
      std::vector<Parameter>)>
      callback;
};
} // namespace node_interfaces

} // namespace rclcpp

namespace rclcpp_lifecycle {

template <class MsgT>
class LifecyclePublisher {
 public:
  using SharedPtr = std::shared_ptr<LifecyclePublisher<MsgT>>;
  void on_activate() { active_ = true; }
  void on_deactivate() { active_ = false; }
  void publish(const MsgT& msg) {
    last_ = msg;
    ++count_;
  }
  bool active_ = false;
  MsgT last_{};
  int count_ = 0;
};

class LifecycleNode {
 public:
  using SharedPtr = std::shared_ptr<LifecycleNode>;
  using WeakPtr = std::weak_ptr<LifecycleNode>;

  rclcpp::Logger get_logger() const { return rclcpp::Logger("lifecycle"); }

  bool has_parameter(const std::string& name) const {
    return params_.count(name) != 0;
  }
  void declare_parameter(const std::string& name,
                         const rclcpp::ParameterValue& v) {
    params_.emplace(name, v);
  }
  bool get_parameter(const std::string& name, double& out) const {
    auto it = params_.find(name);
    if (it == params_.end()) return false;
    if (auto* d = std::get_if<double>(&it->second.v_)) {
      out = *d;
      return true;
    }
    return false;
  }
  bool get_parameter(const std::string& name, std::string& out) const {
    auto it = params_.find(name);
    if (it == params_.end()) return false;
    if (auto* s = std::get_if<std::string>(&it->second.v_)) {
      out = *s;
      return true;
    }
    return false;
  }
  bool get_parameter(const std::string& name, int& out) const {
    auto it = params_.find(name);
    if (it == params_.end()) return false;
    if (auto* i = std::get_if<int>(&it->second.v_)) {
      out = *i;
      return true;
    }
    if (auto* d = std::get_if<double>(&it->second.v_)) {
      out = static_cast<int>(*d);
      return true;
    }
    return false;
  }
  void set_parameter_value(const std::string& name,
                           const rclcpp::ParameterValue& v) {
    params_[name] = v;
  }

  template <class MsgT>
  typename LifecyclePublisher<MsgT>::SharedPtr create_publisher(
      const std::string& /*topic*/, int /*qos_depth*/) {
    return std::make_shared<LifecyclePublisher<MsgT>>();
  }

  rclcpp::node_interfaces::OnSetParametersCallbackHandle::SharedPtr
  add_on_set_parameters_callback(
      std::function<rcl_interfaces::msg::SetParametersResult(
          std::vector<rclcpp::Parameter>)>
          cb) {
    auto h = std::make_shared<
        rclcpp::node_interfaces::OnSetParametersCallbackHandle>();
    h->callback = std::move(cb);
    param_cb_ = h;
    return h;
  }

  // Harness hook: fire the registered dynamic-parameter callback like the
  // parameter service would.
  rcl_interfaces::msg::SetParametersResult trigger_param_callback(
      const std::vector<rclcpp::Parameter>& ps) {
    if (param_cb_ && param_cb_->callback) return param_cb_->callback(ps);
    return {};
  }

 private:
  std::map<std::string, rclcpp::ParameterValue> params_;
  rclcpp::node_interfaces::OnSetParametersCallbackHandle::SharedPtr param_cb_;
};

} // namespace rclcpp_lifecycle

#define RCLCPP_INFO(logger, ...)                         \
  do {                                                   \
    std::fprintf(stderr, "[INFO] [%s] ", (logger).get_name().c_str()); \
    std::fprintf(stderr, __VA_ARGS__);                   \
    std::fprintf(stderr, "\n");                          \
  } while (0)
#define RCLCPP_ERROR(logger, ...)                        \
  do {                                                   \
    std::fprintf(stderr, "[ERROR] [%s] ", (logger).get_name().c_str()); \
    std::fprintf(stderr, __VA_ARGS__);                   \
    std::fprintf(stderr, "\n");                          \
  } while (0)

#endif // ROSSTUB_RCLCPP_HPP_
