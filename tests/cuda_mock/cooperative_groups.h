// The grid group of tests/cuda_mock/cuda_runtime.h: this_grid().sync()
// waits for every thread of the block, then for every block of the grid.
#pragma once
#include "cuda_runtime.h"

namespace cooperative_groups {
struct grid_group {
  void sync() const { mock::grid_sync(); }
};
inline grid_group this_grid() { return {}; }
}  // namespace cooperative_groups
