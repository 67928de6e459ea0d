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
//     at Cd), so in float32 K1d's density equals K1's bit for bit at every P.
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
// The bf16 arm (ArmBf16: K1.bf16, and K1d.bf16 with kExactLast): the JAX
// package's mixed precision,
// grid_sample_2d_block(compute_dtype=bf16) under _plane_product.  JAX rounds
// each gathered row to bf16 (r = rows.astype(cd)) and each tent product
// (wy * wx, f32) to bf16, then rounds every product and sum of the lookup,
// (((r0 w0 + r1 w1) + r2 w2) + r3 w3), and of the chain
// ((s0*s1)*s2) * ((t0*t1)*t2) to bf16 in that order.
//   * The kernel reads bf16 copies of the planes (ops/grid_sample.py:
//     bf16_planes, rounded to nearest even once per plane version: the very
//     values JAX's cast gives each gathered row), 2 bytes a channel.  One
//     16-byte load carries 8 channels, so a sample gathers 3.5 KB at C = 72
//     where the float32 planes take 6.9 KB.  K1d.bf16 reads a copy of the Cd
//     density channels alone (row stride Cd).
//   * The arithmetic is packed: channel pairs in __nv_bfloat162, the four
//     products and three sums of a corner sum and the chain's products in
//     __hmul2_rn / __hadd2_rn (mul.rn.bf16x2 / add.rn.bf16x2 on sm_90); the
//     loads and the corner sum are bf16x2.cuh's, which K1b.bf16 shares.
//     Each rounds the exact result once, which is JAX's "f32 op, then round
//     to bf16": a product of two bf16 values is exact in f32, and a sum
//     rounded to f32 and then to bf16 is rounded once, since 24 >= 2*8 + 2.
//     Never an FMA (__hfma2) nor the contracting __hmul2 / __hadd2: one FMA
//     rounds once where JAX rounds twice.
//   * Phase 1 keeps the four tent products as four bf16 (8 bytes a sample
//     and plane); phase 2 broadcasts each to both lanes.
//   * A group is 8 channels (4 pairs) on the 16-byte path (C % 8 == 0,
//     Cd % 8 == 0, 16-byte aligned copies and app, as the wrapper's plan
//     checks): 9 groups a sample at C = 72, 3 at Cd = 24; otherwise one
//     channel, in the low lane of a pair.  A run is 256 samples, so that a
//     block's items at those widths are a whole number of rounds of its 256
//     threads.  App leaves as 8 bf16 in one 16-byte streaming store.
//   * K1.bf16 rounds the last product, s-chain x t-chain, to bf16 for every
//     channel, as JAX's field_features does; K1d.bf16 (kExactLast) takes it
//     in f32 (exact) into the f32 sum, as XLA does in JAX's density_feature,
//     where that sum is its only consumer.  Density partials are f32, summed
//     in channel order within a group and in group order across groups.
//   * Both arms run one walk, plane_product_kernel<Arm>: phases 1-3 are
//     shared, and an arm (ArmF32<kVec>, ArmBf16<kVec, kExactLast>) gives
//     the element and weight types, the loads, the corner sum, the chain's
//     products, a density partial and the app store.
//   * What bounds it: per 8 channels of a (sample, plane) four 16-byte loads,
//     four broadcasts, 16 packed ops; the chain 20 more per group: about the
//     float32 arm's instruction count a channel, for half its gather bytes.
//     The compulsory traffic of a launch at the render chunk is 0.34 GB
//     (the bf16 copies read once, app in bf16): 0.103 ms at 3.35 TB/s,
//     above its 9.9 GFLOP at the 133.8 TFLOP/s of packed bf16 (0.074 ms).
//     The copies cost their own pass, 37 MB read and 18 MB written once a
//     plane version.  As in the float32 arm, what the kernel really meets
//     is the L1/L2 gather traffic and the issue rate of its loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16x2.cuh"

namespace {

constexpr int kPlanes = 6;
constexpr int kThreads = 256;
constexpr int kMinBlocks = 3;

// the six planes, (H, W, C) channels-last: float32, or the bf16 copies
template <typename T>
struct PlaneSet {
  const T* ptr[kPlanes];
  int H[kPlanes];
  int W[kPlanes];
};

__device__ __forceinline__ float tent(float x, float col) {
  return fminf(fmaxf(1.0f - fabsf(x - col), 0.0f), 1.0f);
}

// Shared-memory layout of a block: the corner weights [6][run] (float32: a
// float4 w00 w01 w10 w11; bf16: a uint2 of those four as bf16), int
// offsets[6][run] (element offset of corner (y0, x0)), then float
// partials[run][Cd / kVec].  ops/grid_sample.py:plane_product_plan computes
// the same byte counts.
constexpr int smem_bytes_for(int run, int density_groups, bool bf16) {
  return run * (kPlanes * (bf16 ? 8 : 16) + kPlanes * 4 + density_groups * 4);
}

// ---------------------------------------------------------------------------
// The two arms.  An arm is the element type of the planes and of app, the
// corner weights as phase 1 keeps them, kVec channels of values, and the
// arithmetic of a corner sum, of the chain and of a density partial; the
// walk over samples and groups (plane_product_kernel) is shared.
// ---------------------------------------------------------------------------

// float32: kVec = 4 on the 16-byte path, else 1
template <int kVec_>
struct ArmF32 {
  static constexpr int kVec = kVec_;
  using Elem = float;
  using Weight = float4;
  struct Vals {
    float v[kVec];
  };

  static __device__ __forceinline__ Weight weight(const float (&w)[4]) {
    return make_float4(w[0], w[1], w[2], w[3]);
  }

  static __device__ __forceinline__ Vals load(const float* p) {
    Vals v;
    if constexpr (kVec == 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p));
      v.v[0] = t.x;
      v.v[1] = t.y;
      v.v[2] = t.z;
      v.v[3] = t.w;
    } else {
      v.v[0] = __ldg(p);
    }
    return v;
  }

  // the bilinear value from the four corners, in the JAX order
  static __device__ __forceinline__ Vals corners(const Vals& v00, const Vals& v01,
                                                 const Vals& v10, const Vals& v11, Weight w) {
    Vals out;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      out.v[j] = v00.v[j] * w.x + v01.v[j] * w.y + v10.v[j] * w.z + v11.v[j] * w.w;
    }
    return out;
  }

  // a = a * b
  static __device__ __forceinline__ void mul(Vals& a, const Vals& b) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) a.v[j] *= b.v[j];
  }

  // a density group's partial: the sum of (s-chain)*(t-chain), channel order;
  // each product rounded apart (__fmul_rn: never contracted into the sum)
  static __device__ __forceinline__ float density(const Vals& a, const Vals& f) {
    float x[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) x[j] = __fmul_rn(a.v[j], f.v[j]);
    float sum = x[0];
#pragma unroll
    for (int j = 1; j < kVec; ++j) sum += x[j];
    return sum;
  }

  // an app group: (s-chain)*(t-chain), streamed out
  static __device__ __forceinline__ void app(float* p, const Vals& a, const Vals& f) {
    if constexpr (kVec == 4) {
      __stcs(reinterpret_cast<float4*>(p), make_float4(a.v[0] * f.v[0], a.v[1] * f.v[1],
                                                       a.v[2] * f.v[2], a.v[3] * f.v[3]));
    } else {
      __stcs(p, a.v[0] * f.v[0]);
    }
  }
};

// bf16, packed bf16x2 on the bf16 copies: kVec = 8 (4 pairs) on the 16-byte
// path, else 1 (one pair whose low lane holds the channel).  kExactLast:
// K1d.bf16, whose density takes the chain's last product in f32.
template <int kVec_, bool kExactLast>
struct ArmBf16 {
  static constexpr int kVec = kVec_;
  using Elem = __nv_bfloat16;
  using Weight = uint2;  // w00 w01 | w10 w11, each rounded to bf16
  using Vals = Bf16Vals<kVec>;
  static constexpr int kPairs = Vals::kPairs;

  static __device__ __forceinline__ Weight weight(const float (&w)[4]) { return bf16_weights(w); }

  static __device__ __forceinline__ Vals load(const __nv_bfloat16* p) { return load_bf16<kVec>(p); }

  // (((r0 w0 + r1 w1) + r2 w2) + r3 w3), every product and sum rounded to bf16
  static __device__ __forceinline__ Vals corners(const Vals& v00, const Vals& v01,
                                                 const Vals& v10, const Vals& v11, Weight w) {
    return bf16_corners<kVec>(v00, v01, v10, v11, w);
  }

  // a = a * b, each product rounded to bf16
  static __device__ __forceinline__ void mul(Vals& a, const Vals& b) {
#pragma unroll
    for (int j = 0; j < kPairs; ++j) a.h[j] = __hmul2_rn(a.h[j], b.h[j]);
  }

  // a density group's f32 partial in channel order: of (s-chain)*(t-chain)
  // rounded to bf16 (JAX's field_features), or exact in f32 with kExactLast
  // (8 + 8 significant bits; JAX's density_feature)
  static __device__ __forceinline__ float density(const Vals& a, const Vals& f) {
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      float2 x;
      if constexpr (kExactLast) {
        const float2 u = __bfloat1622float2(a.h[j]), v = __bfloat1622float2(f.h[j]);
        x = make_float2(u.x * v.x, u.y * v.y);
      } else {
        x = __bfloat1622float2(__hmul2_rn(f.h[j], a.h[j]));
      }
      sum = j == 0 ? x.x : sum + x.x;
      if constexpr (kVec > 1) sum += x.y;
    }
    return sum;
  }

  // an app group: (s-chain)*(t-chain) rounded to bf16, streamed out
  static __device__ __forceinline__ void app(__nv_bfloat16* p, const Vals& a, const Vals& f) {
    Vals x = f;
    mul(x, a);
    if constexpr (kVec == 8) {
      __stcs(reinterpret_cast<uint4*>(p),
             make_uint4(as_u32(x.h[0]), as_u32(x.h[1]), as_u32(x.h[2]), as_u32(x.h[3])));
    } else {
      __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(__low2bfloat16(x.h[0])));
    }
  }
};

// ---------------------------------------------------------------------------
// The walk
// ---------------------------------------------------------------------------

// Phase 1 for plane k of a sample at q: the element offset of the clamped
// cell's corner (y0, x0) and the four tent products w00 w01 w10 w11 (f32,
// kept in the arm's form).
template <int k, typename Arm>
__device__ __forceinline__ void cell(const PlaneSet<typename Arm::Elem>& planes, const float4 q,
                                     int s, int run, int C, typename Arm::Weight* weights,
                                     int* offsets) {
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
  const float w[4] = {wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1};
  offsets[k * run + s] = (y0 * W + x0) * C;  // < 2^31: the wrapper checks each plane's size
  weights[k * run + s] = Arm::weight(w);
}

// Phase 2 for plane k of one (sample, group) item: the bilinear value of
// kVec channels.
template <int k, typename Arm>
__device__ __forceinline__ typename Arm::Vals bilinear(
    const PlaneSet<typename Arm::Elem>& planes, const typename Arm::Weight* weights,
    const int* offsets, int s, int run, int C, int c) {
  const typename Arm::Elem* r0 = planes.ptr[k] + offsets[k * run + s] + c;
  const typename Arm::Elem* r1 = r0 + planes.W[k] * C;
  return Arm::corners(Arm::load(r0), Arm::load(r0 + C), Arm::load(r1), Arm::load(r1 + C),
                      weights[k * run + s]);
}

// n_groups: C / kVec for K1, Cd / kVec for K1d (app null).
template <typename Arm>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
plane_product_kernel(PlaneSet<typename Arm::Elem> planes, const float* __restrict__ xyzt,
                     int64_t P, int C, int Cd, int n_groups, int run, float* __restrict__ density,
                     typename Arm::Elem* __restrict__ app) {
  extern __shared__ float4 smem[];
  auto* weights = reinterpret_cast<typename Arm::Weight*>(smem);
  int* offsets = reinterpret_cast<int*>(weights + kPlanes * run);
  float* partials = reinterpret_cast<float*>(offsets + kPlanes * run);
  constexpr int kVec = Arm::kVec;
  const int density_groups = Cd / kVec;
  const int64_t p0 = (int64_t)blockIdx.x * run;
  const int n = P - p0 < run ? (int)(P - p0) : run;  // samples of this block

  // phase 1: thread i < n takes the space planes of sample i, n <= i < 2n
  // the time planes of sample i - n
  for (int i = threadIdx.x; i < 2 * n; i += kThreads) {
    const int s = i < n ? i : i - n;
    const float4 q = __ldg(reinterpret_cast<const float4*>(xyzt) + p0 + s);
    if (i < n) {
      cell<0, Arm>(planes, q, s, run, C, weights, offsets);
      cell<1, Arm>(planes, q, s, run, C, weights, offsets);
      cell<2, Arm>(planes, q, s, run, C, weights, offsets);
    } else {
      cell<3, Arm>(planes, q, s, run, C, weights, offsets);
      cell<4, Arm>(planes, q, s, run, C, weights, offsets);
      cell<5, Arm>(planes, q, s, run, C, weights, offsets);
    }
  }
  __syncthreads();

  // phase 2: (sample, channel group) items, the group fastest
  const int Ca = C - Cd;
  for (int item = threadIdx.x; item < n * n_groups; item += kThreads) {
    const int s = item / n_groups;
    const int g = item - s * n_groups;
    const int c = g * kVec;
    typename Arm::Vals a = bilinear<0, Arm>(planes, weights, offsets, s, run, C, c);
    Arm::mul(a, bilinear<1, Arm>(planes, weights, offsets, s, run, C, c));
    Arm::mul(a, bilinear<2, Arm>(planes, weights, offsets, s, run, C, c));  // (s0*s1)*s2
    typename Arm::Vals f = bilinear<3, Arm>(planes, weights, offsets, s, run, C, c);
    Arm::mul(f, bilinear<4, Arm>(planes, weights, offsets, s, run, C, c));
    Arm::mul(f, bilinear<5, Arm>(planes, weights, offsets, s, run, C, c));  // (t0*t1)*t2
    if (g < density_groups) {
      partials[s * density_groups + g] = Arm::density(a, f);
    } else {
      Arm::app(app + (p0 + s) * Ca + (c - Cd), a, f);
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

template <typename Arm>
void launch_arm(const void* const* ptrs, const int* hw, unsigned int blocks, int smem_bytes,
                cudaStream_t stream, const float* xyzt, int64_t P, int C, int Cd, int n_groups,
                int run, float* density, void* app) {
  using Elem = typename Arm::Elem;
  PlaneSet<Elem> planes;
  for (int k = 0; k < kPlanes; ++k) {
    planes.ptr[k] = static_cast<const Elem*>(ptrs[k]);
    planes.H[k] = hw[2 * k];
    planes.W[k] = hw[2 * k + 1];
  }
  plane_product_kernel<Arm><<<blocks, kThreads, smem_bytes, stream>>>(
      planes, xyzt, P, C, Cd, n_groups, run, density, static_cast<Elem*>(app));
}

int launch(const void* const* ptrs, const int* hw, const float* xyzt, int64_t P, int C, int Cd,
           int c_end, int vec, int run, int smem_bytes, int bf16, float* density, void* app,
           void* stream) {
  bool all_aligned = app == nullptr || aligned16(app);
  for (int k = 0; k < kPlanes; ++k) all_aligned = all_aligned && aligned16(ptrs[k]);
  // the wrapper's plan (ops/grid_sample.py:plane_product_plan), checked:
  // the 16-byte path is vec 4 in float32 and vec 8 in bf16
  const int wide = bf16 ? 8 : 4;
  const bool wide_ok = C % wide == 0 && Cd % wide == 0 && all_aligned;
  if ((bf16 != 0 && bf16 != 1) || (vec != 1 && vec != wide) || (vec == wide && !wide_ok) ||
      run < 1 || Cd < 0 || Cd > C || smem_bytes < smem_bytes_for(run, Cd / vec, bf16) ||
      smem_bytes > 48 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned int blocks = (unsigned int)((P + run - 1) / run);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_groups = c_end / vec;
  const bool exact_last = app == nullptr;  // K1d.bf16
  auto go = [&](auto arm) {
    launch_arm<decltype(arm)>(ptrs, hw, blocks, smem_bytes, s, xyzt, P, C, Cd, n_groups, run,
                              density, app);
  };
  if (!bf16 && vec == 4) {
    go(ArmF32<4>{});
  } else if (!bf16) {
    go(ArmF32<1>{});
  } else if (exact_last && vec == 8) {
    go(ArmBf16<8, true>{});
  } else if (exact_last) {
    go(ArmBf16<1, true>{});
  } else if (vec == 8) {
    go(ArmBf16<8, false>{});
  } else {
    go(ArmBf16<1, false>{});
  }
  return (int)cudaGetLastError();
}

}  // namespace

// hw: 12 host ints, (H, W) of the planes in the order s0, s1, s2, t0, t1, t2.
// vec, run, smem_bytes: the wrapper's launch plan (16-byte path or scalar,
// samples a block, dynamic shared memory).  bf16: the arm, 0 for float32
// (float32 planes, app float32), 1 for bfloat16 (the planes' bf16 copies,
// app bf16).  Returns cudaErrorInvalidValue for a plan the inputs do not
// allow, else cudaGetLastError() after the launch.
extern "C" int nvfi_plane_product_fwd(const void* s0, const void* s1, const void* s2,
                                      const void* t0, const void* t1, const void* t2,
                                      const int* hw, const float* xyzt, int64_t P, int C,
                                      int Cd, int vec, int run, int smem_bytes, int bf16,
                                      float* density, void* app, void* stream) {
  const void* ptrs[kPlanes] = {s0, s1, s2, t0, t1, t2};
  return launch(ptrs, hw, xyzt, P, C, Cd, C, vec, run, smem_bytes, bf16, density, app, stream);
}

// K1d: only density (P,) is written.  float32: the merged (H, W, C) planes of
// K1, read in place with row stride C.  bf16: the (H, W, Cd) bf16 copies of
// the density channels, C == Cd.
extern "C" int nvfi_plane_product_density_fwd(const void* s0, const void* s1, const void* s2,
                                              const void* t0, const void* t1, const void* t2,
                                              const int* hw, const float* xyzt, int64_t P,
                                              int C, int Cd, int vec, int run, int smem_bytes,
                                              int bf16, float* density, void* stream) {
  const void* ptrs[kPlanes] = {s0, s1, s2, t0, t1, t2};
  return launch(ptrs, hw, xyzt, P, C, Cd, Cd, vec, run, smem_bytes, bf16, density, nullptr,
                stream);
}

extern "C" const char* nvfi_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
