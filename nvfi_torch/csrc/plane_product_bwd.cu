// K1b plane_product_bwd: the backward pass of K1 (plane_product.cu): the
// scatter-add into the six plane gradients and d/dxyz through the tents.
//
// Replaces (JAX reference): the VJP that jax.grad derives for
//   nvfi_tpu/fields/kplane.py:_plane_product (:444-480), its six calls of
//   nvfi_tpu/ops/grid_sample.py:grid_sample_2d_block (:79-129), and the
//   Density-mode channel sum of kplane._decode_density (:494),
// the backward half of the function the TPU design planned as kernel B1.
//
// The forward saves nothing but xyzt and the planes.  Per sample p this
// kernel recomputes what K1 computes (clamped cell, tent weights, the six
// bilinear values s[k] per channel), takes g[c] = grad_density[p] for c < Cd,
// else grad_app[p, c - Cd], and forms
//   t[k] = g[c] * prod_{j != k} s[j]
// from prefix and suffix products (never by dividing by s[k], which can be 0).
//   * plane gradients: w * t[k] is added to the four corners of plane k with
//     atomicAdd on f32.  Lanes run over channels, so the 32 atomics of a warp
//     instruction fall on one 128-byte row segment.  The order of the atomics
//     changes from run to run, and so do the last bits of the plane grads.
//   * grad_xyzt[p] = (d/dx, d/dy, d/dz, 0): t[k] * ds[k]/du summed over planes
//     and channels (warp reduction).  Each of x, y, z appears in three planes.
//     With pixel coordinate x = (u + 1)/2 (W - 1), d tent(x, col)/du is
//     -sign(x - col) (W - 1)/2 where 0 <= 1 - |x - col| <= 1 and 0 where the
//     tent is clipped: torch.clamp's rule (the bounds included), sign(0) = 0.
//     No gradient is produced for the time column: it is
//     normalize_time(base_times), which no parameter reaches.
// Either output set may be absent (null pointers): plane grads when the
// planes need none, grad_xyzt when the coords carry no graph (keyframe
// batches rendered without advection).
//
// A sample whose incoming grads are all exactly zero is skipped by its warp.
// That is exact (every term it would add is 0 * finite) and it is the common
// case in training: sigma is where(valid, ., 0), so samples outside the box
// (or the occupancy mask) get grad_density == 0, and rgb_pts is masked at or
// under rayMarch_weight_thres, so their grad_app is 0 as well.
//
// Bound on the H100 at the train chunk's shape (P = 87,808, 199^3 grid,
// K = 16, C = 72): the grads in (P * 196 B), the coords (P * 16 B), the planes
// read once (37 MB) and the six plane grads written once (37 MB) plus
// grad_xyzt: ~94 MB, 28 us at 3.35 TB/s.  What this simple design meets is
// the atomic rate of the L2: 24 atomics per channel of every sample that is
// not skipped, and the three time planes have only K * 199 rows, all hit at
// one t per chunk, so their atomics contend.  A per-block reduction of the
// time planes in shared memory would lift that; later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPlanes = 6;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned int kFull = 0xffffffffu;

struct PlaneSet {
  const float* ptr[kPlanes];
  float* grad[kPlanes];
  int H[kPlanes];
  int W[kPlanes];
};

__device__ __forceinline__ float tent(float x, float col) {
  return fminf(fmaxf(1.0f - fabsf(x - col), 0.0f), 1.0f);
}

// d tent(x, col) / dx: torch.clamp passes the gradient where 0 <= u <= 1
__device__ __forceinline__ float dtent(float x, float col) {
  const float d = x - col;
  const float u = 1.0f - fabsf(d);
  if (!(u >= 0.0f && u <= 1.0f)) return 0.0f;
  return d > 0.0f ? -1.0f : (d < 0.0f ? 1.0f : 0.0f);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
plane_product_bwd_kernel(PlaneSet planes, const float* __restrict__ xyzt, int64_t P, int C,
                         int Cd, const float* __restrict__ g_density,
                         const float* __restrict__ g_app, int want_planes,
                         float* __restrict__ g_xyzt) {
  constexpr int kCX[kPlanes] = {0, 0, 1, 2, 1, 0};
  constexpr int kCY[kPlanes] = {1, 2, 2, 3, 3, 3};
  const int lane = threadIdx.x & 31;
  const int64_t p = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= P) return;  // uniform across the warp
  const int Ca = C - Cd;

  // skip a sample whose incoming grads are all exactly zero (exact, see above)
  const float gd = __ldg(g_density + p);
  bool any = gd != 0.0f;
  for (int c = lane; c < Ca; c += 32) any = any || (__ldg(g_app + p * Ca + c) != 0.0f);
  if (!__any_sync(kFull, any)) {
    if (g_xyzt != nullptr && lane == 0) {
      reinterpret_cast<float4*>(g_xyzt)[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    return;
  }

  const float4 q = __ldg(reinterpret_cast<const float4*>(xyzt) + p);
  const float u[4] = {q.x, q.y, q.z, q.w};

  int64_t corner[kPlanes];  // offset of row (y0, x0) of the clamped cell
  int row_stride[kPlanes];  // W*C: from row y0 to row y0+1
  float wx0[kPlanes], wx1[kPlanes], wy0[kPlanes], wy1[kPlanes];
  float dx0[kPlanes], dx1[kPlanes], dy0[kPlanes], dy1[kPlanes];  // d tent / d coord
#pragma unroll
  for (int k = 0; k < kPlanes; ++k) {
    const int H = planes.H[k], W = planes.W[k];
    const float sx = 0.5f * (float)(W - 1), sy = 0.5f * (float)(H - 1);
    const float x = (u[kCX[k]] + 1.0f) * 0.5f * (float)(W - 1);
    const float y = (u[kCY[k]] + 1.0f) * 0.5f * (float)(H - 1);
    const int x0 = min(max(__float2int_rd(x), 0), W - 2);
    const int y0 = min(max(__float2int_rd(y), 0), H - 2);
    const float x0f = (float)x0, y0f = (float)y0;
    wx0[k] = tent(x, x0f);
    wx1[k] = tent(x, x0f + 1.0f);
    wy0[k] = tent(y, y0f);
    wy1[k] = tent(y, y0f + 1.0f);
    dx0[k] = dtent(x, x0f) * sx;
    dx1[k] = dtent(x, x0f + 1.0f) * sx;
    dy0[k] = dtent(y, y0f) * sy;
    dy1[k] = dtent(y, y0f + 1.0f) * sy;
    corner[k] = ((int64_t)y0 * W + x0) * C;
    row_stride[k] = W * C;
  }

  float gu[3] = {0.0f, 0.0f, 0.0f};  // this lane's share of d/dx, d/dy, d/dz
  for (int c = lane; c < C; c += 32) {
    const float g = c < Cd ? gd : __ldg(g_app + p * Ca + (c - Cd));
    float v00[kPlanes], v01[kPlanes], v10[kPlanes], v11[kPlanes], s[kPlanes];
#pragma unroll
    for (int k = 0; k < kPlanes; ++k) {
      const float* r0 = planes.ptr[k] + corner[k] + c;
      const float* r1 = r0 + row_stride[k];
      v00[k] = __ldg(r0);
      v01[k] = __ldg(r0 + C);
      v10[k] = __ldg(r1);
      v11[k] = __ldg(r1 + C);
      s[k] = v00[k] * (wy0[k] * wx0[k]) + v01[k] * (wy0[k] * wx1[k]) +
             v10[k] * (wy1[k] * wx0[k]) + v11[k] * (wy1[k] * wx1[k]);
    }
    // t[k] = g * prod_{j != k} s[j], by prefix and suffix products
    float t[kPlanes];
    float pre = g;
#pragma unroll
    for (int k = 0; k < kPlanes; ++k) {
      t[k] = pre;
      pre *= s[k];
    }
    float suf = 1.0f;
#pragma unroll
    for (int k = kPlanes - 1; k >= 0; --k) {
      t[k] *= suf;
      suf *= s[k];
    }
#pragma unroll
    for (int k = 0; k < kPlanes; ++k) {
      if (want_planes) {
        float* o0 = planes.grad[k] + corner[k] + c;
        float* o1 = o0 + row_stride[k];
        atomicAdd(o0, t[k] * (wy0[k] * wx0[k]));
        atomicAdd(o0 + C, t[k] * (wy0[k] * wx1[k]));
        atomicAdd(o1, t[k] * (wy1[k] * wx0[k]));
        atomicAdd(o1 + C, t[k] * (wy1[k] * wx1[k]));
      }
      if (g_xyzt != nullptr) {
        const float top = v00[k] * dx0[k] + v01[k] * dx1[k];
        const float bot = v10[k] * dx0[k] + v11[k] * dx1[k];
        gu[kCX[k]] += t[k] * (wy0[k] * top + wy1[k] * bot);
        if (kCY[k] < 3) {  // the time column gets no gradient
          const float lo = v00[k] * wx0[k] + v01[k] * wx1[k];
          const float hi = v10[k] * wx0[k] + v11[k] * wx1[k];
          gu[kCY[k]] += t[k] * (dy0[k] * lo + dy1[k] * hi);
        }
      }
    }
  }
  if (g_xyzt != nullptr) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) gu[i] += __shfl_xor_sync(kFull, gu[i], off);
    }
    if (lane == 0) reinterpret_cast<float4*>(g_xyzt)[p] = make_float4(gu[0], gu[1], gu[2], 0.0f);
  }
}

}  // namespace

// hw: 12 host ints, (H, W) of the planes in the order s0, s1, s2, t0, t1, t2.
// plane_grads: six device pointers to zero-initialised buffers shaped like the
// planes, or null when no plane gradient is wanted; g_xyzt: (P, 4) or null.
// Returns cudaGetLastError() after the launch.
extern "C" int nvfi_plane_product_bwd(const float* s0, const float* s1, const float* s2,
                                      const float* t0, const float* t1, const float* t2,
                                      const int* hw, const float* xyzt, int64_t P, int C,
                                      int Cd, const float* g_density, const float* g_app,
                                      float* const* plane_grads, float* g_xyzt,
                                      void* stream) {
  const float* ptrs[kPlanes] = {s0, s1, s2, t0, t1, t2};
  PlaneSet planes;
  for (int k = 0; k < kPlanes; ++k) {
    planes.ptr[k] = ptrs[k];
    planes.grad[k] = plane_grads != nullptr ? plane_grads[k] : nullptr;
    planes.H[k] = hw[2 * k];
    planes.W[k] = hw[2 * k + 1];
  }
  const int64_t blocks = (P + kWarpsPerBlock - 1) / kWarpsPerBlock;
  plane_product_bwd_kernel<<<(unsigned int)blocks, kWarpsPerBlock * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      planes, xyzt, P, C, Cd, g_density, g_app, plane_grads != nullptr ? 1 : 0, g_xyzt);
  return (int)cudaGetLastError();
}
