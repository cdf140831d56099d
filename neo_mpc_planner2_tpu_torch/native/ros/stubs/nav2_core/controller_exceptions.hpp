// Exception types matching nav2_core/controller_exceptions.hpp (Humble).
#ifndef ROSSTUB_NAV2_CORE_CONTROLLER_EXCEPTIONS_HPP_
#define ROSSTUB_NAV2_CORE_CONTROLLER_EXCEPTIONS_HPP_

#include <stdexcept>
#include <string>

namespace nav2_core {

class ControllerException : public std::runtime_error {
 public:
  explicit ControllerException(const std::string& description)
      : std::runtime_error(description) {}
};

class InvalidPath : public ControllerException {
 public:
  explicit InvalidPath(const std::string& description)
      : ControllerException(description) {}
};

} // namespace nav2_core

#endif // ROSSTUB_NAV2_CORE_CONTROLLER_EXCEPTIONS_HPP_
