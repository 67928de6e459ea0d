// K1 plane_product_fwd: the K-plane feature lookup of the dense eval render
// and of the train step's forward, and K1d plane_product_density_fwd: the
// same body over the density channels only, for the alpha-mask sweep and the
// PDE filter.
//
// Replaces (JAX reference, the function the TPU design planned as kernel B1):
//   nvfi_tpu/fields/kplane.py:_plane_product (:444-480), its six calls of
//   nvfi_tpu/ops/grid_sample.py:grid_sample_2d_block (:79-129), and the
//   Density-mode channel sum of kplane._decode_density (:494); K1d replaces
//   nvfi_tpu/fields/kplane.py:density_feature (:513-527), which slices the Cd
//   density channels out of the merged planes before the gather.  Mosaic
//   could not lower the per-sample row gather (docs/pallas_decision.md
//   §1-3), so on the TPU XLA ran it; on Hopper the gather is native.
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
// What bounds it on the H100.  At the render chunk (P = 4096*686 samples,
// 199^3 grid, K = 16, C = 72) the compulsory traffic is ~0.63 GB (planes
// 37 MB, coords 45 MB, density 11 MB, app 540 MB): 0.19 ms at 3.35 TB/s; the
// ~11 GFLOP of f32 work take 0.16 ms at 67 TFLOP/s.  The planes fit in the
// 50 MB L2, so what the kernel really meets is the gather traffic from L2:
// 6 planes * 4 corners * 288 B = 6.9 KB a sample, ~19 GB a render chunk if no
// corner row is reused, and the issue rate of those loads.  Samples arrive
// in runs that share corner rows: a render chunk is ray-major (686 samples a
// ray, half a voxel apart) and a mask-sweep chunk walks grid lines.
//
// Design (no tensor cores: the product is elementwise, with no contraction
// to feed them):
//   * A block of kThreads threads owns a run of `run` consecutive samples
//     (128 at the model's shapes), so that it covers a stretch of one ray or
//     grid line and neighbouring samples meet their shared corner rows in
//     the SM's L1 instead of in L2.
//   * Phase 1: one thread per (sample, half of the planes) computes each
//     (sample, plane) cell offset and its four corner weights once, into
//     shared memory.
//   * Phase 2: threads walk (sample, channel group) items, the group fastest,
//     so that a warp reads whole corner rows; a group is kVec channels.  On
//     the 16-byte path (kVec = 4: C % 4 == 0, Cd % 4 == 0 and 16-byte aligned
//     planes, as the wrapper's plan checks) each corner is one 128-bit load,
//     and no group straddles Cd or a row's end; otherwise kVec = 1, one
//     channel a thread with scalar loads.  Every lane has work: C = 72 is 18
//     groups a sample, Cd = 24 is 6.
//   * A density group writes the sum of its kVec products, in channel order,
//     into shared memory; phase 3 sums each sample's partials in group order.
//     K1 and K1d run this one body with the same assignment of density
//     channels to threads and the same order of sums (K1d stops its groups
//     at Cd), so K1d's density equals K1's bit for bit at every P.
//   * Density and app go out with streaming, evict-first stores (__stcs), so
//     that the 540 MB of app a render chunk does not push the planes out of
//     L2.
//   * __launch_bounds__(kThreads, kMinBlocks) holds the registers at 80 a
//     thread with no spills, so that three blocks (24 warps, 55 KB of shared
//     memory at the model's shapes) fit an SM, and the rest of its 256 KB
//     stays L1 for the corner rows.  At four blocks (64 registers) ptxas
//     spills; more blocks a SM leave too few registers for the loads in
//     flight.
//
// The bf16 arm (kBf16, K1.bf16 and K1d.bf16): the JAX package's mixed
// precision, grid_sample_2d_block(compute_dtype=bf16) under _plane_product.
// The planes and coords stay f32, with the same cells and tents.  The four
// tent products are rounded to bf16 in phase 1, each gathered corner value
// as it is loaded, and every product and sum of the lookup and of the chain
// ((s0*s1)*s2)*((t0*t1)*t2) is rounded to bf16 in that order with
// __fmul_rn / __fadd_rn, which nvcc never contracts into an FMA: one FMA
// would round once where JAX rounds twice.  (A product of two bf16 values is
// exact in f32, and an f32 sum of two of them rounded to bf16 is the bf16
// sum, so this is what torch and XLA compute, op by op.)  The density sum
// stays f32, in the f32 arm's order; app is stored as bf16, which halves its
// writes: 0.36 GB of compulsory traffic at the render chunk instead of 0.63.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kPlanes = 6;
constexpr int kThreads = 256;
constexpr int kMinBlocks = 3;

struct PlaneSet {
  const float* ptr[kPlanes];
  int H[kPlanes];
  int W[kPlanes];
};

__device__ __forceinline__ float tent(float x, float col) {
  return fminf(fmaxf(1.0f - fabsf(x - col), 0.0f), 1.0f);
}

// x rounded to the nearest bf16 (ties to even), as a float
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Shared-memory layout of a block: float4 weights[6][run] (w00 w01 w10 w11),
// int offsets[6][run] (element offset of corner (y0, x0)), then float
// partials[run][Cd / kVec].  ops/grid_sample.py:plane_product_plan computes
// the same byte count.
constexpr int smem_bytes_for(int run, int density_groups) {
  return run * (kPlanes * 16 + kPlanes * 4 + density_groups * 4);
}

// Phase 1 for plane k of sample s: the clamped cell and its tents (the four
// products rounded to bf16 in the bf16 arm).
template <int k, bool kBf16>
__device__ __forceinline__ void cell(const PlaneSet& planes, const float4 q, int s, int run,
                                     int C, float4* weights, int* offsets) {
  constexpr int cx = k == 2 ? 1 : k == 3 ? 2 : k == 4 ? 1 : 0;
  constexpr int cy = k == 0 ? 1 : k <= 2 ? 2 : 3;
  const float ux = cx == 0 ? q.x : cx == 1 ? q.y : q.z;
  const float uy = cy == 1 ? q.y : cy == 2 ? q.z : q.w;
  const int H = planes.H[k], W = planes.W[k];
  const float x = (ux + 1.0f) * 0.5f * (float)(W - 1);
  const float y = (uy + 1.0f) * 0.5f * (float)(H - 1);
  const int x0 = min(max(__float2int_rd(x), 0), W - 2);
  const int y0 = min(max(__float2int_rd(y), 0), H - 2);
  const float x0f = (float)x0, y0f = (float)y0;
  const float wx0 = tent(x, x0f), wx1 = tent(x, x0f + 1.0f);
  const float wy0 = tent(y, y0f), wy1 = tent(y, y0f + 1.0f);
  if constexpr (kBf16) {
    weights[k * run + s] = make_float4(bf16r(wy0 * wx0), bf16r(wy0 * wx1), bf16r(wy1 * wx0),
                                       bf16r(wy1 * wx1));
  } else {
    weights[k * run + s] = make_float4(wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1);
  }
  offsets[k * run + s] = (y0 * W + x0) * C;  // < 2^31: the wrapper checks each plane's size
}

template <int kVec>
__device__ __forceinline__ void load(const float* p, float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int kVec>
__device__ __forceinline__ void store_streaming(float* p, const float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    __stcs(p, v[0]);
  }
}

// bf16 values held in floats, stored as bf16 (exact: they are bf16 already)
template <int kVec>
__device__ __forceinline__ void store_streaming(__nv_bfloat16* p, const float (&v)[kVec]) {
  unsigned int b[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) b[j] = __bfloat16_as_ushort(__float2bfloat16_rn(v[j]));
  if constexpr (kVec == 4) {
    __stcs(reinterpret_cast<uint2*>(p), make_uint2(b[0] | b[1] << 16, b[2] | b[3] << 16));
  } else {
    __stcs(reinterpret_cast<unsigned short*>(p), (unsigned short)b[0]);
  }
}

// a = a * b for kVec channels, rounded to bf16 in the bf16 arm
template <int kVec, bool kBf16>
__device__ __forceinline__ void mul(float (&a)[kVec], const float (&b)[kVec]) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    if constexpr (kBf16) {
      a[j] = bf16r(__fmul_rn(a[j], b[j]));
    } else {
      a[j] *= b[j];
    }
  }
}

// Phase 2 for plane k of one (sample, group) item: the bilinear value of
// kVec channels, the four corners in the JAX order.
template <int k, int kVec, bool kBf16>
__device__ __forceinline__ void bilinear(const PlaneSet& planes, const float4* weights,
                                         const int* offsets, int s, int run, int C, int c,
                                         float (&out)[kVec]) {
  const float4 w = weights[k * run + s];
  const float* r0 = planes.ptr[k] + offsets[k * run + s] + c;
  const float* r1 = r0 + planes.W[k] * C;
  float v00[kVec], v01[kVec], v10[kVec], v11[kVec];
  load<kVec>(r0, v00);
  load<kVec>(r0 + C, v01);
  load<kVec>(r1, v10);
  load<kVec>(r1 + C, v11);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    if constexpr (kBf16) {  // (((r0 w0 + r1 w1) + r2 w2) + r3 w3), each op rounded
      float acc = bf16r(__fadd_rn(bf16r(__fmul_rn(bf16r(v00[j]), w.x)),
                                  bf16r(__fmul_rn(bf16r(v01[j]), w.y))));
      acc = bf16r(__fadd_rn(acc, bf16r(__fmul_rn(bf16r(v10[j]), w.z))));
      out[j] = bf16r(__fadd_rn(acc, bf16r(__fmul_rn(bf16r(v11[j]), w.w))));
    } else {
      out[j] = v00[j] * w.x + v01[j] * w.y + v10[j] * w.z + v11[j] * w.w;
    }
  }
}

// n_groups: C / kVec for K1, Cd / kVec for K1d (app null).  AppT: float, or
// __nv_bfloat16 in the bf16 arm.
template <int kVec, bool kBf16, typename AppT = std::conditional_t<kBf16, __nv_bfloat16, float>>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
plane_product_kernel(PlaneSet planes, const float* __restrict__ xyzt, int64_t P, int C, int Cd,
                     int n_groups, int run, float* __restrict__ density,
                     AppT* __restrict__ app) {
  extern __shared__ float4 smem[];
  float4* weights = smem;
  int* offsets = reinterpret_cast<int*>(weights + kPlanes * run);
  float* partials = reinterpret_cast<float*>(offsets + kPlanes * run);
  const int density_groups = Cd / kVec;
  const int64_t p0 = (int64_t)blockIdx.x * run;
  const int n = P - p0 < run ? (int)(P - p0) : run;  // samples of this block

  // phase 1: thread i < n takes the space planes of sample i, n <= i < 2n
  // the time planes of sample i - n
  for (int i = threadIdx.x; i < 2 * n; i += kThreads) {
    const int s = i < n ? i : i - n;
    const float4 q = __ldg(reinterpret_cast<const float4*>(xyzt) + p0 + s);
    if (i < n) {
      cell<0, kBf16>(planes, q, s, run, C, weights, offsets);
      cell<1, kBf16>(planes, q, s, run, C, weights, offsets);
      cell<2, kBf16>(planes, q, s, run, C, weights, offsets);
    } else {
      cell<3, kBf16>(planes, q, s, run, C, weights, offsets);
      cell<4, kBf16>(planes, q, s, run, C, weights, offsets);
      cell<5, kBf16>(planes, q, s, run, C, weights, offsets);
    }
  }
  __syncthreads();

  // phase 2: (sample, channel group) items, the group fastest
  const int Ca = C - Cd;
  for (int item = threadIdx.x; item < n * n_groups; item += kThreads) {
    const int s = item / n_groups;
    const int g = item - s * n_groups;
    const int c = g * kVec;
    float a[kVec], b[kVec], f[kVec];
    bilinear<0, kVec, kBf16>(planes, weights, offsets, s, run, C, c, a);
    bilinear<1, kVec, kBf16>(planes, weights, offsets, s, run, C, c, b);
    mul<kVec, kBf16>(a, b);
    bilinear<2, kVec, kBf16>(planes, weights, offsets, s, run, C, c, b);
    mul<kVec, kBf16>(a, b);  // (s0*s1)*s2
    bilinear<3, kVec, kBf16>(planes, weights, offsets, s, run, C, c, f);
    bilinear<4, kVec, kBf16>(planes, weights, offsets, s, run, C, c, b);
    mul<kVec, kBf16>(f, b);
    bilinear<5, kVec, kBf16>(planes, weights, offsets, s, run, C, c, b);
    mul<kVec, kBf16>(f, b);  // (t0*t1)*t2
    if constexpr (kBf16) {
      mul<kVec, kBf16>(f, a);  // (s-chain)*(t-chain): the one product, either order
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) f[j] = a[j] * f[j];  // (s-chain)*((t0*t1)*t2)
    }
    if (g < density_groups) {
      float sum = f[0];
#pragma unroll
      for (int j = 1; j < kVec; ++j) sum += f[j];
      partials[s * density_groups + g] = sum;
    } else {
      store_streaming<kVec>(app + (p0 + s) * Ca + (c - Cd), f);
    }
  }
  __syncthreads();

  // phase 3: each sample's density, its partials summed in group order
  for (int s = threadIdx.x; s < n; s += kThreads) {
    float d = 0.0f;
    for (int g = 0; g < density_groups; ++g) d += partials[s * density_groups + g];
    __stcs(density + p0 + s, d);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <bool kBf16>
void launch_arm(unsigned int blocks, int smem_bytes, cudaStream_t s, const PlaneSet& planes,
                const float* xyzt, int64_t P, int C, int Cd, int c_end, int vec, int run,
                float* density, void* app) {
  using AppT = std::conditional_t<kBf16, __nv_bfloat16, float>;
  AppT* out = static_cast<AppT*>(app);
  if (vec == 4) {
    plane_product_kernel<4, kBf16><<<blocks, kThreads, smem_bytes, s>>>(
        planes, xyzt, P, C, Cd, c_end / 4, run, density, out);
  } else {
    plane_product_kernel<1, kBf16><<<blocks, kThreads, smem_bytes, s>>>(
        planes, xyzt, P, C, Cd, c_end, run, density, out);
  }
}

int launch(const float* const* ptrs, const int* hw, const float* xyzt, int64_t P, int C,
           int Cd, int c_end, int vec, int run, int smem_bytes, int bf16, float* density,
           void* app, void* stream) {
  PlaneSet planes;
  bool all_aligned = true;
  for (int k = 0; k < kPlanes; ++k) {
    planes.ptr[k] = ptrs[k];
    planes.H[k] = hw[2 * k];
    planes.W[k] = hw[2 * k + 1];
    all_aligned = all_aligned && aligned16(ptrs[k]);
  }
  // the wrapper's plan (ops/grid_sample.py:plane_product_plan), checked
  const bool vec_ok = C % 4 == 0 && Cd % 4 == 0 && all_aligned &&
                      (app == nullptr || aligned16(app));
  if ((vec != 1 && vec != 4) || (vec == 4 && !vec_ok) || run < 1 || (bf16 != 0 && bf16 != 1) ||
      smem_bytes < smem_bytes_for(run, Cd / vec) || smem_bytes > 48 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned int blocks = (unsigned int)((P + run - 1) / run);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch_arm<true>(blocks, smem_bytes, s, planes, xyzt, P, C, Cd, c_end, vec, run, density,
                     app);
  } else {
    launch_arm<false>(blocks, smem_bytes, s, planes, xyzt, P, C, Cd, c_end, vec, run, density,
                      app);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// hw: 12 host ints, (H, W) of the planes in the order s0, s1, s2, t0, t1, t2.
// vec, run, smem_bytes: the wrapper's launch plan (16-byte path or scalar,
// samples a block, dynamic shared memory).  bf16: the arm, 0 for float32
// (app float32), 1 for bfloat16 (app bf16).  Returns cudaErrorInvalidValue
// for a plan the inputs do not allow, else cudaGetLastError() after the
// launch.
extern "C" int nvfi_plane_product_fwd(const float* s0, const float* s1, const float* s2,
                                      const float* t0, const float* t1, const float* t2,
                                      const int* hw, const float* xyzt, int64_t P, int C,
                                      int Cd, int vec, int run, int smem_bytes, int bf16,
                                      float* density, void* app, void* stream) {
  const float* ptrs[kPlanes] = {s0, s1, s2, t0, t1, t2};
  return launch(ptrs, hw, xyzt, P, C, Cd, C, vec, run, smem_bytes, bf16, density, app, stream);
}

// K1d: the planes are the merged (H, W, C) planes of K1, read in place with
// row stride C; only density (P,) is written.
extern "C" int nvfi_plane_product_density_fwd(const float* s0, const float* s1,
                                              const float* s2, const float* t0,
                                              const float* t1, const float* t2,
                                              const int* hw, const float* xyzt, int64_t P,
                                              int C, int Cd, int vec, int run, int smem_bytes,
                                              int bf16, float* density, void* stream) {
  const float* ptrs[kPlanes] = {s0, s1, s2, t0, t1, t2};
  return launch(ptrs, hw, xyzt, P, C, Cd, Cd, vec, run, smem_bytes, bf16, density, nullptr,
                stream);
}

extern "C" const char* nvfi_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
