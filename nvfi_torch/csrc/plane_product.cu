// K1 plane_product_fwd: the K-plane feature lookup of the dense eval render,
// and K1d plane_product_density_fwd: the same body over the density channels
// only, for the alpha-mask sweep.
//
// Replaces (JAX reference, the function the TPU design planned as kernel B1):
//   nvfi_tpu/fields/kplane.py:_plane_product (:444-480), its six calls of
//   nvfi_tpu/ops/grid_sample.py:grid_sample_2d_block (:79-129), and the
//   Density-mode channel sum of kplane._decode_density (:494).
// Mosaic could not lower the per-sample row gather (docs/pallas_decision.md
// §1-3), so on the TPU XLA ran it; on Hopper the gather is native.
//
// Per sample p, with xyzt[p] = (x, y, z, t) normalized to [-1, 1]:
//   plane k (0..5) is (H_k, W_k, C) channels-last; its coordinate pair is
//   (xyzt[kCX[k]], xyzt[kCY[k]]), the first indexing W, the second H:
//     space planes xy, xz, yz -> (0,1), (0,2), (1,2)   kplane.MAT_SPACE
//     time planes  zt, yt, xt -> (2,3), (1,3), (0,3)   kplane.MAT_TIME
//   so a time plane is (K, W, C) and is indexed by (xyz[m0], t).
//   Bilinear lookup, align_corners=True, zeros padding, in the JAX block
//   form: the cell is clamped to [0, S-2] and each corner is weighted by the
//   tent clip(1 - |x - col|, 0, 1) of the CLAMPED cell.  That is what makes
//   corners outside the grid weigh zero: advected coords do leave [-1, 1].
//   The four terms are summed in the JAX order, then
//   f[c] = ((s0*s1)*s2) * ((t0*t1)*t2);
//   density[p] = sum_{c<Cd} f[c]  and  app[p, c-Cd] = f[c] for c >= Cd.
//
// K1d replaces nvfi_tpu/fields/kplane.py:density_feature (:513-527), which
// slices the Cd density channels out of the merged planes before the gather.
// Here the kernel stops its channel loop at Cd (c_end) and reads the merged
// (H, W, C) planes in place with row stride C: no sliced copy of the planes,
// no app output.  Each lane adds the same channels in the same order as in
// K1 and the shuffle reduction is the same, so K1d's density equals K1's bit
// for bit.  At Cd = 24 only 24 lanes of the warp load; the compulsory
// traffic at the sweep's shape (P = 262144) is the density third of the
// planes, 16 B of coords and 4 B out per sample.
//
// Design: one warp per sample, lanes over channels, so each corner row
// (C floats, 288 B at C = 72) is read coalesced.  The corner offsets and tent
// weights are computed once per sample (by every lane: a few FLOPs).  The
// density sum is a warp shuffle reduction.  The app rows go out coalesced.
//
// Bound on the H100 at the bat main-path shape (P = 4096*686 samples,
// 199^3 grid, K = 16, C = 72): the compulsory traffic is ~0.63 GB (planes
// 37 MB read once, coords 45 MB, outputs 551 MB), 0.19 ms at 3.35 TB/s; the
// ~11 GFLOP of f32 work take 0.16 ms at 67 TFLOP/s.  The planes fit in the
// 50 MB L2, so what this simple design really meets is L2 gather traffic:
// 6 planes * 4 corners * 288 B = 6.9 KB per sample, ~19.4 GB per chunk.
// Reusing corner rows between neighbouring samples of a ray and wider loads
// would cut it; that is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPlanes = 6;
constexpr int kWarpsPerBlock = 8;

struct PlaneSet {
  const float* ptr[kPlanes];
  int H[kPlanes];
  int W[kPlanes];
};

__device__ __forceinline__ float tent(float x, float col) {
  return fminf(fmaxf(1.0f - fabsf(x - col), 0.0f), 1.0f);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
plane_product_fwd_kernel(PlaneSet planes, const float* __restrict__ xyzt, int64_t P,
                         int C, int Cd, int c_end, float* __restrict__ density,
                         float* __restrict__ app) {
  constexpr int kCX[kPlanes] = {0, 0, 1, 2, 1, 0};
  constexpr int kCY[kPlanes] = {1, 2, 2, 3, 3, 3};
  const int lane = threadIdx.x & 31;
  const int64_t p = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= P) return;  // uniform across the warp

  const float4 q = __ldg(reinterpret_cast<const float4*>(xyzt) + p);
  const float u[4] = {q.x, q.y, q.z, q.w};

  const float* corner[kPlanes];  // row (y0, x0) of the clamped cell
  int row_stride[kPlanes];       // W*C: from row y0 to row y0+1
  float w00[kPlanes], w01[kPlanes], w10[kPlanes], w11[kPlanes];
#pragma unroll
  for (int k = 0; k < kPlanes; ++k) {
    const int H = planes.H[k], W = planes.W[k];
    const float x = (u[kCX[k]] + 1.0f) * 0.5f * (float)(W - 1);
    const float y = (u[kCY[k]] + 1.0f) * 0.5f * (float)(H - 1);
    const int x0 = min(max(__float2int_rd(x), 0), W - 2);
    const int y0 = min(max(__float2int_rd(y), 0), H - 2);
    const float x0f = (float)x0, y0f = (float)y0;
    const float wx0 = tent(x, x0f), wx1 = tent(x, x0f + 1.0f);
    const float wy0 = tent(y, y0f), wy1 = tent(y, y0f + 1.0f);
    w00[k] = wy0 * wx0;
    w01[k] = wy0 * wx1;
    w10[k] = wy1 * wx0;
    w11[k] = wy1 * wx1;
    corner[k] = planes.ptr[k] + ((int64_t)y0 * W + x0) * C;
    row_stride[k] = W * C;
  }

  const int Ca = C - Cd;
  float dens = 0.0f;
  for (int c = lane; c < c_end; c += 32) {  // c_end: C for K1, Cd for K1d
    float s[kPlanes];
#pragma unroll
    for (int k = 0; k < kPlanes; ++k) {
      const float* r0 = corner[k] + c;
      const float* r1 = r0 + row_stride[k];
      s[k] = __ldg(r0) * w00[k] + __ldg(r0 + C) * w01[k] + __ldg(r1) * w10[k] +
             __ldg(r1 + C) * w11[k];
    }
    const float f = ((s[0] * s[1]) * s[2]) * ((s[3] * s[4]) * s[5]);
    if (c < Cd) {
      dens += f;
    } else {
      app[p * Ca + (c - Cd)] = f;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) dens += __shfl_xor_sync(0xffffffffu, dens, off);
  if (lane == 0) density[p] = dens;
}

int launch(const float* const* ptrs, const int* hw, const float* xyzt, int64_t P, int C,
           int Cd, int c_end, float* density, float* app, void* stream) {
  PlaneSet planes;
  for (int k = 0; k < kPlanes; ++k) {
    planes.ptr[k] = ptrs[k];
    planes.H[k] = hw[2 * k];
    planes.W[k] = hw[2 * k + 1];
  }
  const int64_t blocks = (P + kWarpsPerBlock - 1) / kWarpsPerBlock;
  plane_product_fwd_kernel<<<(unsigned int)blocks, kWarpsPerBlock * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(planes, xyzt, P, C, Cd,
                                                                   c_end, density, app);
  return (int)cudaGetLastError();
}

}  // namespace

// hw: 12 host ints, (H, W) of the planes in the order s0, s1, s2, t0, t1, t2.
// Returns cudaGetLastError() after the launch.
extern "C" int nvfi_plane_product_fwd(const float* s0, const float* s1, const float* s2,
                                      const float* t0, const float* t1, const float* t2,
                                      const int* hw, const float* xyzt, int64_t P, int C,
                                      int Cd, float* density, float* app, void* stream) {
  const float* ptrs[kPlanes] = {s0, s1, s2, t0, t1, t2};
  return launch(ptrs, hw, xyzt, P, C, Cd, C, density, app, stream);
}

// K1d: the planes are the merged (H, W, C) planes of K1; only density (P,)
// is written.
extern "C" int nvfi_plane_product_density_fwd(const float* s0, const float* s1,
                                              const float* s2, const float* t0,
                                              const float* t1, const float* t2,
                                              const int* hw, const float* xyzt, int64_t P,
                                              int C, int Cd, float* density, void* stream) {
  const float* ptrs[kPlanes] = {s0, s1, s2, t0, t1, t2};
  return launch(ptrs, hw, xyzt, P, C, Cd, Cd, density, nullptr, stream);
}

extern "C" const char* nvfi_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
