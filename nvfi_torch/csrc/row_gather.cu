// K5 row_gather_fwd: out[i, :] = tab[idx[i], :].
//
// Replaces the repository's two Pallas call sites, both the same vectorized
// dynamic row gather from VMEM that Mosaic could not lower
// (docs/pallas_decision.md §1-3):
//   tests/test_mosaic_probe.py:_probe (:30, pallas_call :35; bodies :59, :62)
//   scripts/perf_micro2.py:probe      (:84, pallas_call :86; bodies :105, :108)
// at idx (1024,) int32, tab (512, 128) f32.  It is also the `pick` of the
// block-sparse render (nvfi_tpu/fields/kplane.py:861-863: rows of 64*3
// floats), which no path of the port runs yet.
//
// Design: one warp per output row, lanes over columns, so a row is read and
// written coalesced; 16-byte loads when the row length is a multiple of 4
// floats (both base pointers come 16-byte aligned from the allocator, and a
// row start then stays aligned).  Indices must lie in [0, R): the wrapper
// checks that before the launch, the kernel does not.
//
// Bound: bytes.  Each output row is written once and each distinct table row
// read once: n*C*4 + min(n, R)*C*4 + n*4 bytes over 3.35 TB/s; the probe's
// shape (0.79 MB) is launch latency, not bandwidth.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename Vec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
row_gather_fwd_kernel(const Vec* __restrict__ tab, const int* __restrict__ idx, int64_t n,
                      int cols, Vec* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t i = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;  // uniform across the warp
  const Vec* src = tab + (int64_t)__ldg(idx + i) * cols;
  Vec* dst = out + i * cols;
  for (int c = lane; c < cols; c += 32) dst[c] = __ldg(src + c);
}

}  // namespace

// tab: (R, C) f32, idx: (n,) int32 in [0, R), out: (n, C) f32, all on the
// device.  Returns cudaGetLastError() after the launch.
extern "C" int nvfi_row_gather_fwd(const float* tab, const int* idx, int64_t n, int C,
                                   float* out, void* stream) {
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 4 == 0) {
    row_gather_fwd_kernel<float4><<<(unsigned int)blocks, kWarpsPerBlock * 32, 0, s>>>(
        reinterpret_cast<const float4*>(tab), idx, n, C / 4, reinterpret_cast<float4*>(out));
  } else {
    row_gather_fwd_kernel<float><<<(unsigned int)blocks, kWarpsPerBlock * 32, 0, s>>>(
        tab, idx, n, C, out);
  }
  return (int)cudaGetLastError();
}
