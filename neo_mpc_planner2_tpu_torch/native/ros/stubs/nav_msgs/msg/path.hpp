#ifndef ROSSTUB_NAV_MSGS_PATH_HPP_
#define ROSSTUB_NAV_MSGS_PATH_HPP_
#include "rosstub/msgs.hpp"
#endif
