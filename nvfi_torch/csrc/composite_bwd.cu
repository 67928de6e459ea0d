// K2b composite_bwd: the backward pass of K2 (composite.cu), the reverse scan
// of the volume-rendering compositing.
//
// Replaces (JAX reference): the VJP that jax.grad derives for
//   nvfi_tpu/ops/compositing.py:raw2alpha (:17-33) and the per-ray sums of
//   nvfi_tpu/fields/kplane.py:render_rays (dense branch, :884-990),
// the backward half of the function the TPU design planned as kernel B2.
//
// Per ray over its S samples, with the forward's
//   alpha = 1 - exp(-sigma * dist),  keep = (1 - alpha) + 1e-10,
//   T = exclusive cumprod of keep,   weight = alpha * T,
//   rgb = clip(sum_{weight > thres} weight * rgb_pts + [white_bg] (1 - acc), 0, 1)
// and the incoming grads g_rgb (3), g_acc, g_depth, g_weight (S), any of which
// may be absent (a null pointer counts as zeros):
//   gt[c]  = g_rgb[c] * (1 where 0 < rgb_raw[c] < 1, 0.5 where rgb_raw[c] is
//            exactly 0 or 1, 0 outside)           -- the clip splits its ties
//            evenly, as jax.grad(jnp.clip) does; with a white background every
//            ray that misses the box has rgb_raw == 1 exactly
//   m[i]   = weight[i] > thres                    -- no gradient through it
//   Gw[i]  = sum_c gt[c] (m[i] rgb_pts[i,c] - [white_bg]) + g_acc
//            + g_depth (z[i] - far) + g_weight[i]           (= dL/dweight[i])
//   R[i]   = alpha[i+1] Gw[i+1] + keep[i+1] R[i+1],  R[S-1] = 0
//   grad_alpha[i]   = T[i] (Gw[i] - R[i])
//   grad_sigma[i]   = grad_alpha[i] dist[i] exp(-sigma[i] dist[i])
//   grad_rgb_pts[i,c] = m[i] weight[i] gt[c]
// dist and z get no gradient.  The colourless arm (rgb_pts, rgb_raw, g_rgb and
// grad_rgb_pts null) is the backward of K2's colourless arm: it takes g_acc,
// g_depth and g_weight (the top-K shade's gradient lands on weight) and
// writes grad_sigma only, from the same scan as the colour arm with g_rgb
// absent: one body, instantiated with and without the colour work.  R is the
// division-free form of
// sum_{j>i} Gw[j] weight[j] / keep[i]: keep is 1e-10 at a saturated sample and
// T underflows a few samples later, so the quotient form is 0/0 there.
//
// What bounds it on the H100.  Per sample 24 B in (sigma, dist, 3 rgb,
// weight; z and g_weight only with their grads) and 16 B out: 3.5 MB for a
// train chunk (128 rays * 686 samples), 1.05 us at 3.35 TB/s.  T is a
// forward chain and R a backward one along each ray.  With one warp a ray
// and two passes in sequence, 128 rays are 128 warps on a card of 132
// multiprocessors: latency, not bandwidth, sets the time.
//
// Design (plan: ops/compositing.py:composite_bwd_plan; no tensor cores: a
// scan has no contraction to feed them):
//   * Several warps share each ray, each owning one segment of <= kMaxTiles
//     tiles of 32 samples: 22 warps of one tile at a train chunk's 128 rays
//     (about 21 warps a multiprocessor), 6 of four tiles at a render chunk's
//     4096; a block holds rays_per_block rays.  Each warp loads its segment
//     once, all loads in flight together, and keeps it in registers through
//     both passes: exp(-sigma dist) is evaluated once a sample and T never
//     goes through device memory.
//   * Forward carry: each warp multiplies its segment's keep into one
//     product (lane products, then a butterfly) and takes T in front of the
//     segment, the product of the earlier segments' totals in segment order,
//     from shared memory (as K2 does).
//   * Reverse carry: each warp composes its tiles' suffix scans of the affine
//     maps R -> keep R + alpha Gw into its segment's map and publishes it in
//     shared memory; R behind the segment is the later segments' maps applied
//     to 0 in a fixed order.  No atomics: the outputs are the same from run
//     to run.
//   * The colours (rgb_pts in, grad_rgb_pts out) move as three coalesced
//     accesses a tile, transposed through a shared stage of the warp.
//   * One warp streaming each ray of a render chunk, as K2 does, was slower
//     on the card: it has to read sigma and dist twice and evaluate exp twice.
//     So rays of up to kMaxWarps * kMaxTiles * 32 = 4096 samples are taken.
// The scans associate differently from the sequential cumprod and the
// autograd sum: the plain version agrees to rtol 1e-4.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 32;  // warps a block, and a ray's segments
constexpr int kMaxTiles = 4;   // tiles of 32 samples a segment holds in registers
constexpr unsigned int kFull = 0xffffffffu;

__device__ __forceinline__ float clip_grad_factor(float x) {
  if (x > 0.0f && x < 1.0f) return 1.0f;
  return (x == 0.0f || x == 1.0f) ? 0.5f : 0.0f;
}

__device__ __forceinline__ float warp_prod(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v *= __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float keep_of(float alpha) { return (1.0f - alpha) + 1e-10f; }

// What a warp needs to read and write its segment.
struct Segment {
  const float* __restrict__ sigma;
  const float* __restrict__ dist;
  const float* __restrict__ z;
  const float* __restrict__ rgb_pts;
  const float* __restrict__ weight;
  const float* __restrict__ g_weight;  // may be null
  float* __restrict__ grad_sigma;
  float* __restrict__ grad_rgb_pts;  // null in the colourless arm, never read there
  int64_t first;  // the segment's first sample, counted over all rays
  int n[kMaxTiles];  // samples of each tile (0 past the segment), uniform across the warp
};

// The ray's incoming grads (zeros where absent).
struct RayGrads {
  float gt[3];  // g_rgb through the clip
  float ga, gd, bg, thres, far;
  bool rgb, depth;
};

// The segment into registers: per tile t, alpha[t], de[t] = dist
// exp(-sigma dist) and gw[t] = Gw of the lane's sample (0 past the segment),
// every load in flight together; the colour grads m weight gt are stored on
// the way.
template <bool kColour>
__device__ __forceinline__ void load_segment(const Segment& seg, const RayGrads& g, int lane,
                                             float* st, float (&alpha)[kMaxTiles],
                                             float (&de)[kMaxTiles], float (&gw)[kMaxTiles]) {
  float sg[kMaxTiles], dd[kMaxTiles], wt[kMaxTiles], zz[kMaxTiles], gx[kMaxTiles];
  float col[kMaxTiles][3];
#pragma unroll
  for (int t = 0; t < kMaxTiles; ++t) {
    const int64_t s0 = seg.first + 32 * t;
    sg[t] = dd[t] = wt[t] = zz[t] = gx[t] = 0.0f;
    if (lane < seg.n[t]) {
      sg[t] = __ldg(seg.sigma + s0 + lane);
      dd[t] = __ldg(seg.dist + s0 + lane);
      wt[t] = __ldg(seg.weight + s0 + lane);
      if (g.depth) zz[t] = __ldg(seg.z + s0 + lane);
      if (seg.g_weight != nullptr) gx[t] = __ldg(seg.g_weight + s0 + lane);
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int i = lane + 32 * j;
      col[t][j] = kColour && g.rgb && i < 3 * seg.n[t] ? __ldg(seg.rgb_pts + s0 * 3 + i) : 0.0f;
    }
  }
#pragma unroll
  for (int t = 0; t < kMaxTiles; ++t) {
    alpha[t] = de[t] = gw[t] = 0.0f;
    const int n = seg.n[t];
    if (n == 0) continue;  // uniform
    if constexpr (kColour) {
      float* out = seg.grad_rgb_pts + (seg.first + 32 * t) * 3;
      const float mw = wt[t] > g.thres ? wt[t] : 0.0f;  // m weight
      if (g.rgb) {
        // the colours, transposed through the stage to one sample's three a lane
#pragma unroll
        for (int j = 0; j < 3; ++j) st[lane + 32 * j] = col[t][j];
        __syncwarp();
#pragma unroll
        for (int j = 0; j < 3; ++j) col[t][j] = st[3 * lane + j];
        __syncwarp();
#pragma unroll
        for (int j = 0; j < 3; ++j) st[3 * lane + j] = mw * g.gt[j];
        __syncwarp();
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int i = lane + 32 * j;
          if (i < 3 * n) __stcs(out + i, st[i]);
        }
        __syncwarp();
      } else {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int i = lane + 32 * j;
          if (i < 3 * n) __stcs(out + i, 0.0f);
        }
      }
    }
    if (lane < n) {
      const float e = expf(-sg[t] * dd[t]);
      alpha[t] = 1.0f - e;
      de[t] = dd[t] * e;
      float Gw = g.ga + g.gd * (zz[t] - g.far) - g.bg;
      if (seg.g_weight != nullptr) Gw += gx[t];
      if (kColour && wt[t] > g.thres) {
        Gw += g.gt[0] * col[t][0] + g.gt[1] * col[t][1] + g.gt[2] * col[t][2];
      }
      gw[t] = Gw;
    }
  }
}

template <bool kColour>
__global__ void __launch_bounds__(kMaxWarps * 32)
composite_bwd_kernel(const float* __restrict__ sigma, const float* __restrict__ dist,
                     const float* __restrict__ z, const float* __restrict__ rgb_pts,
                     const float* __restrict__ weight, const float* __restrict__ rgb_raw,
                     const float* __restrict__ g_rgb, const float* __restrict__ g_acc,
                     const float* __restrict__ g_depth, const float* __restrict__ g_weight,
                     int64_t N, int S, int warps_per_ray, int tiles_per_warp, float thres,
                     int white_bg, float far, float* __restrict__ grad_sigma,
                     float* __restrict__ grad_rgb_pts) {
  __shared__ float seg_keep[kMaxWarps];                // a segment's product of keep
  __shared__ float seg_a[kMaxWarps], seg_c[kMaxWarps];  // a segment's map of R
  __shared__ float stage[kMaxWarps][96];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r_local = warp / warps_per_ray;
  const int w = warp - r_local * warps_per_ray;  // the warp's segment of its ray
  const int rays_per_block = (int)(blockDim.x >> 5) / warps_per_ray;
  const int64_t ray = (int64_t)blockIdx.x * rays_per_block + r_local;
  const bool live = ray < N;  // uniform across the warp
  const int begin = w * tiles_per_warp * 32, end = min(S, begin + tiles_per_warp * 32);
  float* st = stage[warp];

  Segment seg{sigma, dist, z, rgb_pts, weight, g_weight, grad_sigma, grad_rgb_pts,
              ray * S + begin, {}};
#pragma unroll
  for (int t = 0; t < kMaxTiles; ++t) {
    seg.n[t] = live && t < tiles_per_warp ? max(0, min(32, end - (begin + 32 * t))) : 0;
  }
  RayGrads g{{0.0f, 0.0f, 0.0f}, 0.0f, 0.0f, 0.0f, thres, far, kColour && g_rgb != nullptr,
             g_depth != nullptr};
  if (live) {
    if (g.rgb) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        g.gt[c] = __ldg(g_rgb + ray * 3 + c) * clip_grad_factor(__ldg(rgb_raw + ray * 3 + c));
      }
    }
    g.ga = g_acc != nullptr ? __ldg(g_acc + ray) : 0.0f;
    g.gd = g.depth ? __ldg(g_depth + ray) : 0.0f;
    g.bg = white_bg ? (g.gt[0] + g.gt[1] + g.gt[2]) : 0.0f;
  }

  float alpha[kMaxTiles], tde[kMaxTiles], gw[kMaxTiles], a[kMaxTiles], c[kMaxTiles];
  load_segment<kColour>(seg, g, lane, st, alpha, tde, gw);

  // pass 1: T in front of the segment, then T of each sample;
  // tde[t] becomes T dist exp(-sigma dist)
  float carry = 1.0f;
  if (warps_per_ray > 1) {
    float prod = 1.0f;
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t) {
      if (lane < seg.n[t]) prod *= keep_of(alpha[t]);
    }
    prod = warp_prod(prod);
    if (lane == 0) seg_keep[warp] = prod;
    __syncthreads();
    for (int j = 0; j < w; ++j) carry *= seg_keep[warp - w + j];
  }
#pragma unroll
  for (int t = 0; t < kMaxTiles; ++t) {
    if (seg.n[t] == 0) continue;  // uniform
    float incl = lane < seg.n[t] ? keep_of(alpha[t]) : 1.0f;  // product over lanes 0..lane
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl *= v;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 1.0f;
    tde[t] = (carry * excl) * tde[t];
    carry *= __shfl_sync(kFull, incl, 31);
  }

  // pass 2: per tile, the suffix scan of the maps x -> keep x + alpha Gw:
  // lane l ends with (a[t], c[t]), the map of the tile's samples l..31
  // composed with sample l applied last (the identity past the segment)
#pragma unroll
  for (int t = 0; t < kMaxTiles; ++t) {
    a[t] = 1.0f;
    c[t] = 0.0f;
    if (seg.n[t] == 0) continue;  // uniform
    if (lane < seg.n[t]) {
      a[t] = keep_of(alpha[t]);
      c[t] = alpha[t] * gw[t];
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float a2 = __shfl_down_sync(kFull, a[t], off);
      const float c2 = __shfl_down_sync(kFull, c[t], off);
      if (lane + off < 32) {
        c[t] = a[t] * c2 + c[t];
        a[t] = a[t] * a2;
      }
    }
  }
  // R behind the segment: the later segments' maps applied to 0
  float r = 0.0f;
  if (warps_per_ray > 1) {
    float A = 1.0f, C = 0.0f;  // the segment's map, its tiles composed
#pragma unroll
    for (int t = kMaxTiles - 1; t >= 0; --t) {
      if (seg.n[t] == 0) continue;  // uniform
      const float ta = __shfl_sync(kFull, a[t], 0), tc = __shfl_sync(kFull, c[t], 0);
      C = ta * C + tc;
      A = ta * A;
    }
    if (lane == 0) {
      seg_a[warp] = A;
      seg_c[warp] = C;
    }
    __syncthreads();
    for (int j = warps_per_ray - 1; j > w; --j) r = seg_a[warp - w + j] * r + seg_c[warp - w + j];
  }
  // grad_sigma, walking the tiles from the far end; r is R at the tile's
  // last sample slot
#pragma unroll
  for (int t = kMaxTiles - 1; t >= 0; --t) {
    if (seg.n[t] == 0) continue;  // uniform
    float a_next = __shfl_down_sync(kFull, a[t], 1);  // the map of samples l+1..31
    float c_next = __shfl_down_sync(kFull, c[t], 1);
    if (lane == 31) {
      a_next = 1.0f;
      c_next = 0.0f;
    }
    const float R = a_next * r + c_next;
    if (lane < seg.n[t]) __stcs(grad_sigma + seg.first + 32 * t + lane, (gw[t] - R) * tde[t]);
    r = __shfl_sync(kFull, a[t], 0) * r + __shfl_sync(kFull, c[t], 0);
  }
}

}  // namespace

// warps_per_ray, tiles_per_warp, rays_per_block: the wrapper's launch plan
// (ops/compositing.py:composite_bwd_plan).  g_rgb, g_acc, g_depth and
// g_weight may each be null (zeros); rgb_raw is read only with g_rgb.  With
// rgb_pts and grad_rgb_pts null the colourless arm runs (g_rgb must be null).
// Returns cudaErrorInvalidValue for a plan that does not cover each ray's
// samples exactly once, gives a warp more than kMaxTiles tiles, or does not
// fit a block, for g_rgb without rgb_raw or without the colour pointers, and
// for one colour pointer without the other; else cudaGetLastError() after
// the launch.
extern "C" int nvfi_composite_bwd(const float* sigma, const float* dist, const float* z,
                                  const float* rgb_pts, const float* weight,
                                  const float* rgb_raw, const float* g_rgb,
                                  const float* g_acc, const float* g_depth,
                                  const float* g_weight, int64_t N, int S, int warps_per_ray,
                                  int tiles_per_warp, int rays_per_block, float thres,
                                  int white_bg, float far, float* grad_sigma,
                                  float* grad_rgb_pts, void* stream) {
  const int64_t span = (int64_t)warps_per_ray * tiles_per_warp * 32;
  if (N < 1 || S < 0 || warps_per_ray < 1 || tiles_per_warp < 1 || rays_per_block < 1 ||
      tiles_per_warp > kMaxTiles || (int64_t)warps_per_ray * rays_per_block > kMaxWarps ||
      span < S || (S > 0 && span - (int64_t)tiles_per_warp * 32 >= S) ||
      (g_rgb != nullptr && (rgb_raw == nullptr || rgb_pts == nullptr)) ||
      ((rgb_pts == nullptr) != (grad_rgb_pts == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t blocks = (N + rays_per_block - 1) / rays_per_block;
  const unsigned int threads = rays_per_block * warps_per_ray * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rgb_pts != nullptr) {
    composite_bwd_kernel<true><<<(unsigned int)blocks, threads, 0, s>>>(
        sigma, dist, z, rgb_pts, weight, rgb_raw, g_rgb, g_acc, g_depth, g_weight, N, S,
        warps_per_ray, tiles_per_warp, thres, white_bg, far, grad_sigma, grad_rgb_pts);
  } else {
    composite_bwd_kernel<false><<<(unsigned int)blocks, threads, 0, s>>>(
        sigma, dist, z, rgb_pts, weight, rgb_raw, g_rgb, g_acc, g_depth, g_weight, N, S,
        warps_per_ray, tiles_per_warp, thres, white_bg, far, grad_sigma, grad_rgb_pts);
  }
  return (int)cudaGetLastError();
}
