// An empty kernel: the card's fixed cost of a launch, as a yardstick.
//
// chip_smoke.py launches it with a step kernel's grid and block through the
// same CUDA-graph timing harness as the kernel itself (floor_ms), so that a
// step kernel whose bytes bound (bound_ms) lies under the launch's own cost
// shows as floor-bound, not as badly designed.  Nothing on a serving path
// launches it.

#include <cuda_runtime.h>

namespace {

__global__ void launch_floor_kernel() {}

}  // namespace

extern "C" int sage_launch_floor(int blocks_x, int blocks_y, int threads, void* stream) {
  if (blocks_x < 1 || blocks_y < 1 || blocks_y > 65535 || threads < 1 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  launch_floor_kernel<<<dim3((unsigned)blocks_x, (unsigned)blocks_y), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
