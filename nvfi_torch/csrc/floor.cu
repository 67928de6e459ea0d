// The launch floor: what one launch costs on this card before any work.
//
// Measurement instruments, not kernels of a path: chip_smoke.py's `floor`
// phase times them inside CUDA graphs (20 launches a graph, as every "alone"
// time) at the grids of the port's small kernels, and each entry of its
// kernels line carries the empty kernel's time at that entry's grid
// (`floor_ms`).  A kernel whose time sits at its floor has no time to gain
// from a new body, whatever its bound says.
//
//   floor_empty  <<<blocks, threads>>> of an empty body: launch, block
//                scheduling and retirement alone.
//   floor_touch  one thread a sample: reads the sample's 12 bytes of coords
//                (evict-first, as K3 and K4 read them) and writes one byte,
//                out[p] = (x + y) + z > 0.  The least work of a sample kernel
//                such as K4: the launch plus the first DRAM round trip.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTouchThreads = 256;

__global__ void floor_empty_kernel() {}

__global__ void __launch_bounds__(kTouchThreads)
floor_touch_kernel(const float* __restrict__ xyz, int64_t P, uint8_t* __restrict__ out) {
  const int64_t p = (int64_t)blockIdx.x * kTouchThreads + threadIdx.x;
  if (p >= P) return;
  const float x = __ldcs(xyz + 3 * p), y = __ldcs(xyz + 3 * p + 1), z = __ldcs(xyz + 3 * p + 2);
  out[p] = __fadd_rn(__fadd_rn(x, y), z) > 0.0f ? 1 : 0;
}

}  // namespace

// blocks x threads of the empty kernel on `stream`.  Returns
// cudaGetLastError() after the launch.
extern "C" int nvfi_floor_empty(int blocks, int threads, void* stream) {
  floor_empty_kernel<<<(unsigned int)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// xyz: (P, 3) f32, out: (P,) bytes, both on the device; ceil(P / 256)
// blocks of 256 threads.  Returns cudaGetLastError() after the launch.
extern "C" int nvfi_floor_touch(const float* xyz, int64_t P, uint8_t* out, void* stream) {
  const int64_t blocks = (P + kTouchThreads - 1) / kTouchThreads;
  floor_touch_kernel<<<(unsigned int)blocks, kTouchThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(xyz, P, out);
  return (int)cudaGetLastError();
}
