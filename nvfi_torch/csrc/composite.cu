// K2 composite_fwd: volume-rendering compositing of the dense render and of
// the train step's forward.
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
// Where rgb_raw is not null the rgb before the clip is stored there as well:
// the backward kernel (composite_bwd.cu) reads the clip's state from it.
//
// The colourless arm (rgb_pts, rgb and rgb_raw null) writes weight, acc and
// depth only: the per-ray top-K shade of the turbo render (JAX kplane.py
// :884-887, 893-954) needs them before it shades, and composites its colour
// from the selected samples afterwards.  It reads no colour: 16 B a sample
// (sigma, dist, z in; weight out) instead of 28.  Both arms are one body,
// instantiated with and without the colour work; their weight, acc and depth
// are the same scan, bit for bit.
//
// What bounds it on the H100.  Per sample 28 B must move (sigma, dist, z,
// 3 rgb in; weight out): 79 MB for a render chunk (4096 rays * 686 samples),
// 24 us at 3.35 TB/s, and 2.5 MB for a train chunk (128 rays), under a
// microsecond; the ~17 FLOPs a sample are negligible.  The scan along a ray
// is a chain.  One warp a ray, walking its 22 tiles of 32 samples in
// sequence, streams a render chunk's 4096 rays near the byte bound, but a
// train chunk's 128 rays are 128 warps, 1% of the card's warp slots: there
// it waits on latency.
//
// Design (no tensor cores: a scan has no contraction to feed them):
//   * Warps a ray from the plan (ops/compositing.py:composite_plan).  Where
//     the rays alone nearly fill the card (a render chunk's 4096) one warp
//     streams each ray; where they are few (a train chunk's 128) up to 22
//     warps share a ray, one tile of 32 samples each, so that about 32
//     warps a multiprocessor are in flight.  Warp w of a ray owns the contiguous samples
//     [w * tiles_per_warp * 32, ...); a block holds rays_per_block rays.
//   * A warp walks its samples in batches of kMaxTiles tiles held in
//     registers, every load of a batch issued first: sigma, dist and z
//     coalesced, and the tiles' 32 * 3 colours as three coalesced loads that
//     shared memory then transposes to one sample's three a lane.
//   * Where several warps share a ray (one batch each), each multiplies its
//     segment's (1 - alpha) + 1e-10 into one product (lane products, then a
//     butterfly) and takes its carry, the exclusive product of the segment
//     totals before it, from shared memory in segment order.
//   * Then, from registers, an in-tile multiplicative scan by shuffles gives
//     each sample's exclusive product; w = alpha * (carry * excl) is stored
//     with an evict-first store, and the masked sums (w > thres) are taken on
//     that final w, so no partial sum is rescaled afterwards.
//   * Each warp reduces its five sums by shuffles; the first warp of the ray
//     adds the warps' sums in segment order.  Every order is fixed, so the
//     outputs do not change from run to run.
// The scan associates differently from the sequential cumprod (the carries
// come from tile and segment products): the plain version agrees to rtol
// 1e-4.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 32;  // a block: rays_per_block * warps_per_ray warps
constexpr int kMaxTiles = 4;   // tiles of 32 samples a warp holds in registers at once
constexpr unsigned int kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_prod(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v *= __shfl_xor_sync(kFull, v, off);
  return v;
}

template <bool kColour>
__global__ void __launch_bounds__(kMaxWarps * 32)
composite_fwd_kernel(const float* __restrict__ sigma, const float* __restrict__ dist,
                     const float* __restrict__ z, const float* __restrict__ rgb_pts,
                     int64_t N, int S, int warps_per_ray, int tiles_per_warp, float thres,
                     int white_bg, float far, float* __restrict__ weight,
                     float* __restrict__ acc, float* __restrict__ rgb,
                     float* __restrict__ depth, float* __restrict__ rgb_raw) {
  __shared__ float seg_total[kMaxWarps];
  __shared__ float sums[5][kMaxWarps];
  __shared__ float stage[kMaxWarps][96];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r_local = warp / warps_per_ray;
  const int w = warp - r_local * warps_per_ray;  // the warp's segment of its ray
  const int rays_per_block = (int)(blockDim.x >> 5) / warps_per_ray;
  const int64_t ray = (int64_t)blockIdx.x * rays_per_block + r_local;
  const bool live = ray < N;  // uniform across the warp
  const int s_begin = w * tiles_per_warp * 32;
  const int s_end = min(S, s_begin + tiles_per_warp * 32);
  const int64_t base = ray * S;
  float* st = stage[warp];
  float carry = 1.0f;  // transmittance in front of the current tile
  float a_sum = 0.0f, r_sum = 0.0f, g_sum = 0.0f, b_sum = 0.0f, d_sum = 0.0f;

  // batches of kMaxTiles tiles; every warp of the block runs as many
  for (int b0 = 0; b0 < tiles_per_warp; b0 += kMaxTiles) {
    // every load of the batch, in flight together; n[t]: samples of tile t
    int n[kMaxTiles];
    float alpha[kMaxTiles], dz[kMaxTiles], col[kMaxTiles][3];
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t) {
      const int s0 = s_begin + 32 * (b0 + t);
      n[t] = live && b0 + t < tiles_per_warp ? max(0, min(32, s_end - s0)) : 0;  // uniform
      alpha[t] = dz[t] = 0.0f;
      if (lane < n[t]) {
        alpha[t] = __ldg(sigma + base + s0 + lane) * __ldg(dist + base + s0 + lane);
        dz[t] = __ldg(z + base + s0 + lane);
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int i = lane + 32 * j;
        col[t][j] = kColour && i < 3 * n[t] ? __ldg(rgb_pts + (base + s0) * 3 + i) : 0.0f;
      }
    }
    // the colours, transposed through the warp's stage to one sample a lane
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t) {
      if (n[t] > 0) {
        if constexpr (kColour) {
#pragma unroll
          for (int j = 0; j < 3; ++j) st[lane + 32 * j] = col[t][j];
          __syncwarp();
#pragma unroll
          for (int j = 0; j < 3; ++j) col[t][j] = st[3 * lane + j];
          __syncwarp();
        }
        if (lane < n[t]) alpha[t] = 1.0f - expf(-alpha[t]);
      }
    }
    if (warps_per_ray > 1) {  // one batch a warp: its segment's product, then its carry
      float prod = 1.0f;
#pragma unroll
      for (int t = 0; t < kMaxTiles; ++t) {
        if (lane < n[t]) prod *= (1.0f - alpha[t]) + 1e-10f;
      }
      prod = warp_prod(prod);
      if (lane == 0) seg_total[warp] = prod;
      __syncthreads();
      for (int j = 0; j < w; ++j) carry *= seg_total[warp - w + j];
    }
    // weights and the masked sums, from registers
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t) {
      if (n[t] > 0) {
        const bool in = lane < n[t];
        float incl = in ? (1.0f - alpha[t]) + 1e-10f : 1.0f;  // product over lanes 0..lane
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float v = __shfl_up_sync(kFull, incl, off);
          if (lane >= off) incl *= v;
        }
        float excl = __shfl_up_sync(kFull, incl, 1);
        if (lane == 0) excl = 1.0f;
        const float wt = alpha[t] * (carry * excl);
        if (in) {
          __stcs(weight + base + s_begin + 32 * (b0 + t) + lane, wt);
          a_sum += wt;
          d_sum += wt * dz[t];
          if (kColour && wt > thres) {
            r_sum += wt * col[t][0];
            g_sum += wt * col[t][1];
            b_sum += wt * col[t][2];
          }
        }
        carry *= __shfl_sync(kFull, incl, 31);
      }
    }
  }
  a_sum = warp_sum(a_sum);
  if constexpr (kColour) {
    r_sum = warp_sum(r_sum);
    g_sum = warp_sum(g_sum);
    b_sum = warp_sum(b_sum);
  }
  d_sum = warp_sum(d_sum);
  if (lane == 0) {
    sums[0][warp] = a_sum;
    sums[1][warp] = r_sum;
    sums[2][warp] = g_sum;
    sums[3][warp] = b_sum;
    sums[4][warp] = d_sum;
  }
  __syncthreads();
  if (live && w == 0 && lane == 0) {
    a_sum = r_sum = g_sum = b_sum = d_sum = 0.0f;
    for (int j = warp; j < warp + warps_per_ray; ++j) {
      a_sum += sums[0][j];
      r_sum += sums[1][j];
      g_sum += sums[2][j];
      b_sum += sums[3][j];
      d_sum += sums[4][j];
    }
    if constexpr (kColour) {
      if (white_bg) {
        const float bg = 1.0f - a_sum;
        r_sum += bg;
        g_sum += bg;
        b_sum += bg;
      }
      if (rgb_raw != nullptr) {
        rgb_raw[ray * 3 + 0] = r_sum;
        rgb_raw[ray * 3 + 1] = g_sum;
        rgb_raw[ray * 3 + 2] = b_sum;
      }
      rgb[ray * 3 + 0] = fminf(fmaxf(r_sum, 0.0f), 1.0f);
      rgb[ray * 3 + 1] = fminf(fmaxf(g_sum, 0.0f), 1.0f);
      rgb[ray * 3 + 2] = fminf(fmaxf(b_sum, 0.0f), 1.0f);
    }
    acc[ray] = a_sum;
    depth[ray] = d_sum + (1.0f - a_sum) * far;
  }
}

}  // namespace

// warps_per_ray, tiles_per_warp, rays_per_block: the wrapper's launch plan
// (ops/compositing.py:composite_plan).  rgb_raw may be null.  With rgb_pts
// null the colourless arm runs: rgb and rgb_raw must be null too, and only
// weight, acc and depth are written.  Returns cudaErrorInvalidValue for a
// plan that does not cover each ray's samples exactly once, gives a warp
// that shares its ray more than kMaxTiles tiles or does not fit a block, or
// for colour pointers that name neither arm; else cudaGetLastError() after
// the launch.
extern "C" int nvfi_composite_fwd(const float* sigma, const float* dist, const float* z,
                                  const float* rgb_pts, int64_t N, int S, int warps_per_ray,
                                  int tiles_per_warp, int rays_per_block, float thres,
                                  int white_bg, float far, float* weight, float* acc,
                                  float* rgb, float* depth, float* rgb_raw, void* stream) {
  const int64_t span = (int64_t)warps_per_ray * tiles_per_warp * 32;
  if (N < 1 || S < 0 || warps_per_ray < 1 || tiles_per_warp < 1 || rays_per_block < 1 ||
      (warps_per_ray > 1 && tiles_per_warp > kMaxTiles) ||
      (int64_t)warps_per_ray * rays_per_block > kMaxWarps || span < S ||
      (S > 0 && span - (int64_t)tiles_per_warp * 32 >= S) ||
      (rgb_pts != nullptr && rgb == nullptr) ||
      (rgb_pts == nullptr && (rgb != nullptr || rgb_raw != nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t blocks = (N + rays_per_block - 1) / rays_per_block;
  const unsigned int threads = rays_per_block * warps_per_ray * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rgb_pts != nullptr) {
    composite_fwd_kernel<true><<<(unsigned int)blocks, threads, 0, s>>>(
        sigma, dist, z, rgb_pts, N, S, warps_per_ray, tiles_per_warp, thres, white_bg, far,
        weight, acc, rgb, depth, rgb_raw);
  } else {
    composite_fwd_kernel<false><<<(unsigned int)blocks, threads, 0, s>>>(
        sigma, dist, z, rgb_pts, N, S, warps_per_ray, tiles_per_warp, thres, white_bg, far,
        weight, acc, rgb, depth, rgb_raw);
  }
  return (int)cudaGetLastError();
}
