// K5 row_gather_fwd: out[i, :] = tab[idx[i], :].
//
// Replaces the repository's two Pallas call sites, both the same vectorized
// dynamic row gather from VMEM that Mosaic could not lower
// (docs/pallas_decision.md §1-3):
//   tests/test_mosaic_probe.py:_probe (:30, pallas_call :35; bodies :59, :62)
//   scripts/perf_micro2.py:probe      (:84, pallas_call :86; bodies :105, :108)
// at idx (1024,) int32, tab (512, 128) f32.  It is also the `pick` of the
// block-sparse render (nvfi_tpu/fields/kplane.py:861-863), three launches a
// chunk of the port's turbo render (nvfi_torch/fields/kplane.py, through
// ops/gather.py:pick_rows): at bat (configs/synth/bat.yaml, sample_block 16)
// a 4096-ray chunk's sample axis is padded to 688 = 43 blocks of 16, and the
// picks gather B of its 176,128 block rows from three tables, xyz (rows of
// 48 floats) and t and base_times (rows of 16 floats).
//
// Bound: bytes.  Each output row is written once and each distinct table row
// read once: n*C*4 + distinct(idx)*C*4 + n*4 bytes over 3.35 TB/s.  The
// probe's 0.79 MB take 0.24 us, under the launch floor of its grid on the
// H100 (chip_smoke.py, phase `floor`): there the launch is the time.
//
// Design: a thread per 16-byte piece of the output (a float4; a float where
// C is not a multiple of 4), over the flat (row, piece) space, so every lane
// is busy whatever the row's width (one warp a row left 20 of 32 lanes idle
// at 48 floats and 28 at 16, and launched 8 rows' warps a block: 4800 blocks
// for bat's picks, whose launch alone took 4.1 us on the H100).  A thread
// reads its piece's row index (neighbouring threads share it through L1),
// loads the piece and writes it with an evict-first store: the caller
// consumes the picked rows at once.  Two or four pieces a thread, with all
// loads issued before the first store, were slower at the probe and at all
// three picks; PERF.md keeps their times.  Both base pointers are 16-byte
// aligned (the wrapper checks the table's; the output comes from the
// allocator), so a row start stays aligned.  Indices must lie in [0, R): the
// kernel does not check.  row_gather checks them before the launch (a
// read-back); pick_rows takes the render's selections, in range by
// construction, without one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename Vec>
__global__ void __launch_bounds__(kThreads)
row_gather_fwd_kernel(const Vec* __restrict__ tab, const int* __restrict__ idx,
                      unsigned int total, unsigned int cols, Vec* __restrict__ out) {
  const unsigned int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= total) return;
  const unsigned int i = j / cols;
  __stcs(out + j, __ldg(tab + (int64_t)__ldg(idx + i) * cols + (j - i * cols)));
}

template <typename Vec>
int launch(const Vec* tab, const int* idx, int64_t n, int cols, Vec* out, cudaStream_t s) {
  const unsigned int total = (unsigned int)(n * cols);
  const unsigned int blocks = (total + kThreads - 1) / kThreads;
  row_gather_fwd_kernel<Vec><<<blocks, kThreads, 0, s>>>(tab, idx, total, cols, out);
  return (int)cudaGetLastError();
}

}  // namespace

// tab: (R, C) f32, idx: (n,) int32 in [0, R), out: (n, C) f32, all on the
// device, n * C < 2^31.  Returns cudaGetLastError() after the launch.
extern "C" int nvfi_row_gather_fwd(const float* tab, const int* idx, int64_t n, int C,
                                   float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 4 == 0) {
    return launch(reinterpret_cast<const float4*>(tab), idx, n, C / 4,
                  reinterpret_cast<float4*>(out), s);
  }
  return launch(tab, idx, n, C, out, s);
}
