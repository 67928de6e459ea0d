// K2 composite_fwd: volume-rendering compositing of the dense eval render.
//
// Replaces (JAX reference, the function the TPU design planned as kernel B2):
//   nvfi_tpu/ops/compositing.py:raw2alpha (:17-33) and the per-ray sums of
//   nvfi_tpu/fields/kplane.py:render_rays (dense branch, :884-990).
//
// Per ray r over its S samples (sigma already zeroed where the sample is
// outside the box, dist already multiplied by distance_scale):
//   alpha  = 1 - exp(-sigma * dist)
//   T      = exclusive cumprod of (1 - alpha) + 1e-10     (floor kept as written)
//   weight = alpha * T,  acc = sum(weight)
//   rgb    = sum over samples with weight > thres of weight * rgb_pts
//   rgb   += 1 - acc if white_bg;  rgb = clip(rgb, 0, 1)
//   depth  = sum(weight * z) + (1 - acc) * far
//
// Design: one warp per ray; the lanes walk the samples in tiles of 32.  Each
// tile's exclusive product is an in-warp multiplicative scan (shuffles), and
// the tile total carries into the next tile.  Each lane keeps its partial
// sums, reduced by shuffles at the end.  Every load and the weight store are
// coalesced along the ray.
//
// Bound on the H100 at the bat main-path shape (4096 rays * 686 samples):
// 28 B per sample must move (sigma, dist, z, 3 rgb in; weight out), ~79 MB per
// chunk, 24 us at 3.35 TB/s; the ~17 FLOPs per sample are negligible.  With
// 4096 warps the card is not full (132 SMs * 64 warps), and each warp's tiles
// run in sequence, so latency rather than bandwidth is what this simple design
// meets; more rays in flight per SM (several warps per ray) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRaysPerBlock = 4;
constexpr unsigned int kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kRaysPerBlock * 32)
composite_fwd_kernel(const float* __restrict__ sigma, const float* __restrict__ dist,
                     const float* __restrict__ z, const float* __restrict__ rgb_pts,
                     int64_t N, int S, float thres, int white_bg, float far,
                     float* __restrict__ weight, float* __restrict__ acc,
                     float* __restrict__ rgb, float* __restrict__ depth) {
  const int lane = threadIdx.x & 31;
  const int64_t ray = (int64_t)blockIdx.x * kRaysPerBlock + (threadIdx.x >> 5);
  if (ray >= N) return;  // uniform across the warp
  const int64_t base = ray * S;

  float carry = 1.0f;  // transmittance in front of the current tile
  float a_sum = 0.0f, r_sum = 0.0f, g_sum = 0.0f, b_sum = 0.0f, d_sum = 0.0f;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const bool in = s < S;
    float alpha = 0.0f, keep = 1.0f;
    if (in) {
      alpha = 1.0f - expf(-__ldg(sigma + base + s) * __ldg(dist + base + s));
      keep = (1.0f - alpha) + 1e-10f;
    }
    float incl = keep;  // inclusive product over the tile's lanes 0..lane
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl *= v;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 1.0f;
    const float w = alpha * (carry * excl);
    if (in) {
      weight[base + s] = w;
      a_sum += w;
      d_sum += w * __ldg(z + base + s);
      if (w > thres) {
        const float* c = rgb_pts + (base + s) * 3;
        r_sum += w * __ldg(c);
        g_sum += w * __ldg(c + 1);
        b_sum += w * __ldg(c + 2);
      }
    }
    carry *= __shfl_sync(kFull, incl, 31);
  }
  a_sum = warp_sum(a_sum);
  r_sum = warp_sum(r_sum);
  g_sum = warp_sum(g_sum);
  b_sum = warp_sum(b_sum);
  d_sum = warp_sum(d_sum);
  if (lane == 0) {
    if (white_bg) {
      const float bg = 1.0f - a_sum;
      r_sum += bg;
      g_sum += bg;
      b_sum += bg;
    }
    rgb[ray * 3 + 0] = fminf(fmaxf(r_sum, 0.0f), 1.0f);
    rgb[ray * 3 + 1] = fminf(fmaxf(g_sum, 0.0f), 1.0f);
    rgb[ray * 3 + 2] = fminf(fmaxf(b_sum, 0.0f), 1.0f);
    acc[ray] = a_sum;
    depth[ray] = d_sum + (1.0f - a_sum) * far;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int nvfi_composite_fwd(const float* sigma, const float* dist, const float* z,
                                  const float* rgb_pts, int64_t N, int S, float thres,
                                  int white_bg, float far, float* weight, float* acc,
                                  float* rgb, float* depth, void* stream) {
  const int64_t blocks = (N + kRaysPerBlock - 1) / kRaysPerBlock;
  composite_fwd_kernel<<<(unsigned int)blocks, kRaysPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      sigma, dist, z, rgb_pts, N, S, thres, white_bg, far, weight, acc, rgb, depth);
  return (int)cudaGetLastError();
}
