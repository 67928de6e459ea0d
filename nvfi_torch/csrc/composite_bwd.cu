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
// dist and z get no gradient.  R is the division-free form of
// sum_{j>i} Gw[j] weight[j] / keep[i]: keep is 1e-10 at a saturated sample and
// T underflows a few samples later, so the quotient form is 0/0 there.
//
// Design: one warp per ray, as K2.  Pass 1 repeats K2's forward scan and parks
// T[i] in grad_sigma[i] (each lane later reads back only what it wrote: the
// tiles of both passes start at multiples of 32).  Pass 2 walks the tiles from
// the far end; within a tile the recurrence is a scan of the affine maps
// R -> keep R + alpha Gw composed by shuffles (suffix scan), and the tile's
// whole map carries R into the next tile.
//
// Bound on the H100 at the train chunk's shape (128 rays * 686 samples): per
// sample 32 B in (sigma, dist, z, 3 rgb, weight, g_weight when present) and
// 16 B out, ~4.2 MB per chunk, 1.3 us at 3.35 TB/s.  128 warps fill a small
// part of the card and each walks its tiles twice in sequence, so this simple
// design meets latency, not bandwidth; several warps per ray is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRaysPerBlock = 4;
constexpr unsigned int kFull = 0xffffffffu;

__device__ __forceinline__ float clip_grad_factor(float x) {
  if (x > 0.0f && x < 1.0f) return 1.0f;
  return (x == 0.0f || x == 1.0f) ? 0.5f : 0.0f;
}

__global__ void __launch_bounds__(kRaysPerBlock * 32)
composite_bwd_kernel(const float* __restrict__ sigma, const float* __restrict__ dist,
                     const float* __restrict__ z, const float* __restrict__ rgb_pts,
                     const float* __restrict__ weight, const float* __restrict__ rgb_raw,
                     const float* __restrict__ g_rgb, const float* __restrict__ g_acc,
                     const float* __restrict__ g_depth, const float* __restrict__ g_weight,
                     int64_t N, int S, float thres, int white_bg, float far,
                     float* grad_sigma, float* __restrict__ grad_rgb_pts) {
  const int lane = threadIdx.x & 31;
  const int64_t ray = (int64_t)blockIdx.x * kRaysPerBlock + (threadIdx.x >> 5);
  if (ray >= N) return;  // uniform across the warp
  const int64_t base = ray * S;

  // pass 1: T[i], the forward's exclusive product, parked in grad_sigma
  float carry = 1.0f;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const bool in = s < S;
    float keep = 1.0f;
    if (in) {
      const float alpha = 1.0f - expf(-__ldg(sigma + base + s) * __ldg(dist + base + s));
      keep = (1.0f - alpha) + 1e-10f;
    }
    float incl = keep;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl *= v;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 1.0f;
    if (in) grad_sigma[base + s] = carry * excl;
    carry *= __shfl_sync(kFull, incl, 31);
  }

  float gt[3] = {0.0f, 0.0f, 0.0f};
  if (g_rgb != nullptr) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      gt[c] = __ldg(g_rgb + ray * 3 + c) * clip_grad_factor(__ldg(rgb_raw + ray * 3 + c));
    }
  }
  const float ga = g_acc != nullptr ? __ldg(g_acc + ray) : 0.0f;
  const float gd = g_depth != nullptr ? __ldg(g_depth + ray) : 0.0f;
  const float bg = white_bg ? (gt[0] + gt[1] + gt[2]) : 0.0f;

  // pass 2: the reverse scan, tile by tile from the far end
  float r_carry = 0.0f;  // R at the last sample of the current tile
  for (int s0 = ((S - 1) / 32) * 32; s0 >= 0; s0 -= 32) {
    const int s = s0 + lane;
    const bool in = s < S;
    float a = 1.0f, b = 0.0f;  // the identity map for lanes past the ray's end
    float Gw = 0.0f, T = 0.0f, e = 0.0f, d = 0.0f, w = 0.0f;
    bool m = false;
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
    if (in) {
      d = __ldg(dist + base + s);
      e = expf(-__ldg(sigma + base + s) * d);
      const float alpha = 1.0f - e;
      a = (1.0f - alpha) + 1e-10f;
      T = grad_sigma[base + s];
      w = __ldg(weight + base + s);
      m = w > thres;
      Gw = ga + gd * (__ldg(z + base + s) - far) - bg;
      if (g_weight != nullptr) Gw += __ldg(g_weight + base + s);
      if (m) {
        const float* c = rgb_pts + (base + s) * 3;
        c0 = __ldg(c);
        c1 = __ldg(c + 1);
        c2 = __ldg(c + 2);
        Gw += gt[0] * c0 + gt[1] * c1 + gt[2] * c2;
      }
      b = alpha * Gw;
    }
    // suffix scan: lane l ends with the map of samples l..31 of the tile,
    // x -> a x + b, sample l applied last
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float a2 = __shfl_down_sync(kFull, a, off);
      const float b2 = __shfl_down_sync(kFull, b, off);
      if (lane + off < 32) {
        b = a * b2 + b;
        a = a * a2;
      }
    }
    float a_next = __shfl_down_sync(kFull, a, 1);  // the map of samples l+1..31
    float b_next = __shfl_down_sync(kFull, b, 1);
    if (lane == 31) {
      a_next = 1.0f;
      b_next = 0.0f;
    }
    const float R = a_next * r_carry + b_next;
    if (in) {
      grad_sigma[base + s] = T * (Gw - R) * d * e;
      float* o = grad_rgb_pts + (base + s) * 3;
      const float mw = m ? w : 0.0f;
      o[0] = mw * gt[0];
      o[1] = mw * gt[1];
      o[2] = mw * gt[2];
    }
    r_carry = __shfl_sync(kFull, a, 0) * r_carry + __shfl_sync(kFull, b, 0);
  }
}

}  // namespace

// g_rgb, g_acc, g_depth and g_weight may each be null (zeros); rgb_raw is read
// only with g_rgb.  Returns cudaGetLastError() after the launch.
extern "C" int nvfi_composite_bwd(const float* sigma, const float* dist, const float* z,
                                  const float* rgb_pts, const float* weight,
                                  const float* rgb_raw, const float* g_rgb,
                                  const float* g_acc, const float* g_depth,
                                  const float* g_weight, int64_t N, int S, float thres,
                                  int white_bg, float far, float* grad_sigma,
                                  float* grad_rgb_pts, void* stream) {
  const int64_t blocks = (N + kRaysPerBlock - 1) / kRaysPerBlock;
  composite_bwd_kernel<<<(unsigned int)blocks, kRaysPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      sigma, dist, z, rgb_pts, weight, rgb_raw, g_rgb, g_acc, g_depth, g_weight, N, S, thres,
      white_bg, far, grad_sigma, grad_rgb_pts);
  return (int)cudaGetLastError();
}
