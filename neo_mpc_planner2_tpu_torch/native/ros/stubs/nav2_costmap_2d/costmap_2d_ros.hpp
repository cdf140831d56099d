// Minimal Costmap2D / Costmap2DROS for the no-ROS harness: the accessor
// surface the shim touches, holding a harness-settable raw uchar grid.
#ifndef ROSSTUB_NAV2_COSTMAP_2D_ROS_HPP_
#define ROSSTUB_NAV2_COSTMAP_2D_ROS_HPP_

#include <mutex>
#include <string>
#include <vector>

#include "rosstub/msgs.hpp"

namespace nav2_costmap_2d {

class Costmap2D {
 public:
  using mutex_t = std::recursive_mutex;

  unsigned int getSizeInCellsX() const { return size_x_; }
  unsigned int getSizeInCellsY() const { return size_y_; }
  double getOriginX() const { return origin_x_; }
  double getOriginY() const { return origin_y_; }
  double getResolution() const { return resolution_; }
  unsigned char* getCharMap() const {
    return const_cast<unsigned char*>(grid_.data());
  }
  mutex_t* getMutex() const { return &mutex_; }

  // Harness setters (the real class fills these from map updates).
  void stub_resize(unsigned int sx, unsigned int sy, double resolution,
                   double ox, double oy, unsigned char fill = 0) {
    size_x_ = sx;
    size_y_ = sy;
    resolution_ = resolution;
    origin_x_ = ox;
    origin_y_ = oy;
    grid_.assign(static_cast<size_t>(sx) * sy, fill);
  }
  void stub_set(unsigned int mx, unsigned int my, unsigned char v) {
    grid_[static_cast<size_t>(my) * size_x_ + mx] = v;
  }

 private:
  unsigned int size_x_ = 0, size_y_ = 0;
  double origin_x_ = 0, origin_y_ = 0, resolution_ = 0.05;
  std::vector<unsigned char> grid_;
  mutable mutex_t mutex_;
};

class Costmap2DROS {
 public:
  Costmap2D* getCostmap() { return &costmap_; }
  const std::vector<geometry_msgs::msg::Point>& getRobotFootprint() const {
    return footprint_;
  }
  std::string getBaseFrameID() const { return "base_link"; }

  Costmap2D costmap_;
  std::vector<geometry_msgs::msg::Point> footprint_;
};

} // namespace nav2_costmap_2d

#endif // ROSSTUB_NAV2_COSTMAP_2D_ROS_HPP_
