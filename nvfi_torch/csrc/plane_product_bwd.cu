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
//   * plane gradients: w * t[k] is added to the four corners of plane k.
//   * grad_xyzt[p] = (d/dx, d/dy, d/dz, 0): t[k] * ds[k]/du summed over planes
//     and channels.  Each of x, y, z appears in three planes.  With pixel
//     coordinate x = (u + 1)/2 (W - 1), d tent(x, col)/du is
//     -sign(x - col) (W - 1)/2 where 0 <= 1 - |x - col| <= 1 and 0 where the
//     tent is clipped: torch.clamp's rule (the bounds included), sign(0) = 0.
//     No gradient is produced for the time column: it is
//     normalize_time(base_times), which no parameter reaches.
// Either output set may be absent (null pointers): plane grads when the
// planes need none, grad_xyzt when the coords carry no graph (keyframe
// batches rendered without advection).
//
// A sample whose incoming grads are all exactly zero is skipped.  That is
// exact (every term it would add is 0 * finite) and it is the common case in
// training: sigma is where(valid, ., 0), so samples outside the box (or the
// occupancy mask) get grad_density == 0, and rgb_pts is masked at or under
// rayMarch_weight_thres, so their grad_app is 0 as well.
//
// What bounds it on the H100.  At the train chunk's shape (P = 87,808, 199^3
// grid, K = 16, C = 72) the compulsory traffic is the grads in (P * 196 B),
// the coords (P * 16 B), the planes read once (37 MB) and the six plane grads
// written once (37 MB) plus grad_xyzt: ~94 MB, 28 us at 3.35 TB/s.  What
// bounds it instead is the L2's atomic throughput.  A 32-byte sector costs
// the same whether an atomic fills it with 4 floats or 8, and this design,
// whose warp touches 16 sectors in 16 different lines, runs at ~20-28 G
// sectors a second (chip_smoke.py phase K1b, with the kernel's own count of
// its atomics).  The design this file replaces, a warp adding one sample's
// 32 channels (a whole 128-byte line), reached more than 40 G sectors a
// second when every sample was active: a line request costs more than a
// sector, so with every sample active that design was the faster one.  Unmerged,
// every active sample adds 24 corner rows of 288 B, 216 sectors: ~9.5 M a
// call.  A ray-ordered chunk has
// 2-4 consecutive samples a cell, and every sample of a chunk shares one
// keyframe t, so that half of the time planes' corners have a tent weight
// of 0.
//
// Design (no tensor cores: the work is a scatter of elementwise products,
// with no contraction to feed them):
//   * A block of kThreads threads owns a run of `run` consecutive samples
//     (128 at the model's shapes).  Phase 0 finds the samples with a
//     non-zero incoming grad (the threads read the block's grads together,
//     coalesced) and writes the zero grad_xyzt row of the others; warp 0
//     compacts the active ones, in order, by ballots.
//   * Phase 1: one thread per (active sample, half of the planes) computes
//     each (sample, plane) cell offset, its four tents and four tent
//     derivatives once, into shared memory.
//   * Phase 2: a warp takes a (tile, chunk) item: its 32 lanes are 16 pairs,
//     pair i holding the tile's i-th active sample, and it walks the chunk's
//     channels in steps of 2 kVec, the even lane of a pair taking the first
//     kVec channels and the odd lane the next.  On the 16-byte path (kVec =
//     4: C % 4 == 0, Cd % 4 == 0, 16-byte aligned planes, grads and
//     grad_app, as the wrapper's plan checks) each corner is one 128-bit
//     load a lane and each plane-gradient update one float4 atomicAdd
//     (sm_90's vector red.global.add) a lane, so that a pair fills one
//     32-byte sector: half the sector operations of a float4 atomic a sample.
//     Otherwise the same body runs one channel a lane.
//   * Merging: for plane k, pairs whose samples fall in the same cell as
//     their neighbour's form a segment; a segmented suffix sum by shuffles
//     (only as many steps as the warp's longest segment needs) leaves each
//     segment's total on its first pair, which alone issues the atomics.  A
//     ray-ordered chunk has 2-4 samples a cell, uniform coords nearly none.
//     Merging further cost more than it saved on the card: merging the
//     corners that neighbouring cells share as well (40% fewer sector
//     operations on a train chunk) needed four segmentations a plane and
//     spilled, and running sums in registers over a stream of samples, one
//     channel a lane (60% fewer), left each warp a quarter of the work an
//     iteration and waiting on memory.
//   * A corner whose tent weight is exactly 0 in every sample of a segment is
//     not added: the term is 0 * finite.
//   * grad_xyzt is deterministic: a lane sums its sample's terms over its
//     channels of the chunk in order, the pair's two sums are added even lane
//     first into shared memory, and phase 3 adds the chunks in order.  No
//     atomic touches it.
//   * __launch_bounds__(kThreads, kMinBlocks): two blocks an SM, at most 128
//     registers a thread.
// The order of the plane-gradient atomics changes from run to run, and so do
// the last bits of the plane grads.
//
// stats, where not null, counts (by warp reductions) the global atomic
// instructions issued [0] (one a lane: kVec channels), the (sample, plane,
// corner, channel group) updates whose tent weight is exactly 0 [1] and the
// non-zero ones folded into another sample's atomic by the merge [2]; it
// costs nothing when null.
//
// The bf16 arm (kBf16, K1b.bf16): the VJP that jax.grad derives for K1's
// bf16 arm (grid_sample_2d_block(compute_dtype=bf16)), as XLA computes it.
// g_app comes in as bf16, g_density as f32 and is rounded to bf16 for every
// density channel (the VJP of the f32 density sum).  Phase 2 recomputes the
// bf16 lookup and takes each plane's cotangent by the chain rule in the
// forward's order, ((s0*s1)*s2)*((t0*t1)*t2), every product rounded to bf16
// (__fmul_rn: no FMA).  A corner's row cotangent is bf16(cotangent * tent
// product), widened to f32 for the same merges and f32 atomics as the f32
// arm: the same lanes and merge, and the plane grads stay f32.  The
// coordinate gradient needs each tent product's cotangent, the sum over the
// channels of bf16(cotangent * corner value), and XLA takes that sum as a
// running bf16 sum in channel order (it adds in f32 and rounds after every
// add).  A running sum cannot be split over lanes and chunks, so phase 3 of
// this arm walks each active sample's channels in order, one thread a
// sample, recomputing the chain with scalar loads and holding the 24 running
// sums in registers, then takes d/dxyz through the tents in f32.  It is
// correct first: its one thread a sample is latency-bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kPlanes = 6;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 2;
constexpr int kChunkChannels = 24;  // channels of one phase-2 item
constexpr int kTile = 16;           // active samples of one phase-2 item: a lane pair each
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

// x rounded to the nearest bf16 (ties to even), as a float
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf16_bits(unsigned int lo16) { return __uint_as_float(lo16 << 16); }

// d tent(x, col) / dx: torch.clamp passes the gradient where 0 <= u <= 1
__device__ __forceinline__ float dtent(float x, float col) {
  const float d = x - col;
  const float u = 1.0f - fabsf(d);
  if (!(u >= 0.0f && u <= 1.0f)) return 0.0f;
  return d > 0.0f ? -1.0f : (d < 0.0f ? 1.0f : 0.0f);
}

// Shared-memory layout of a block: float4 tents[6][run] (wx0 wx1 wy0 wy1),
// float4 dtents[6][run] (their derivatives, times (W-1)/2 or (H-1)/2), int
// offsets[6][run] (element offset of corner (y0, x0)), int active[run] (local
// index of the a-th active sample), float g_density[run], then float
// partials[chunks][3][run] (grad_xyz by chunk).
// ops/grid_sample.py:plane_product_bwd_plan computes the same byte count.
constexpr int smem_bytes_for(int run, int chunks) {
  return run * (2 * kPlanes * 16 + kPlanes * 4 + 4 + 4 + chunks * 12);
}

// Phase 1 for plane k of active sample a: the clamped cell, its tents and
// their derivatives.
template <int k>
__device__ __forceinline__ void cell(const PlaneSet& planes, const float4 q, int a, int run,
                                     int C, float4* tents, float4* dtents, int* offsets) {
  constexpr int cx = k == 2 ? 1 : k == 3 ? 2 : k == 4 ? 1 : 0;
  constexpr int cy = k == 0 ? 1 : k <= 2 ? 2 : 3;
  const float ux = cx == 0 ? q.x : cx == 1 ? q.y : q.z;
  const float uy = cy == 1 ? q.y : cy == 2 ? q.z : q.w;
  const int H = planes.H[k], W = planes.W[k];
  const float sx = 0.5f * (float)(W - 1), sy = 0.5f * (float)(H - 1);
  const float x = (ux + 1.0f) * 0.5f * (float)(W - 1);
  const float y = (uy + 1.0f) * 0.5f * (float)(H - 1);
  const int x0 = min(max(__float2int_rd(x), 0), W - 2);
  const int y0 = min(max(__float2int_rd(y), 0), H - 2);
  const float x0f = (float)x0, y0f = (float)y0;
  tents[k * run + a] = make_float4(tent(x, x0f), tent(x, x0f + 1.0f), tent(y, y0f),
                                   tent(y, y0f + 1.0f));
  dtents[k * run + a] = make_float4(dtent(x, x0f) * sx, dtent(x, x0f + 1.0f) * sx,
                                    dtent(y, y0f) * sy, dtent(y, y0f + 1.0f) * sy);
  offsets[k * run + a] = (y0 * W + x0) * C;  // < 2^31: the wrapper checks each plane's size
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

// kVec incoming grads as floats: f32, or bf16 (widened exactly)
template <int kVec>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = bf16_bits(t.x & 0xffffu);
    v[1] = bf16_bits(t.x >> 16);
    v[2] = bf16_bits(t.y & 0xffffu);
    v[3] = bf16_bits(t.y >> 16);
  } else {
    v[0] = bf16_bits(__ldg(reinterpret_cast<const unsigned short*>(p)));
  }
}

// The four corner weights of a plane from its tents (wx0 wx1 wy0 wy1), in
// the corner order y0x0, y0x1, y1x0, y1x1; rounded to bf16 in the bf16 arm.
template <bool kBf16>
__device__ __forceinline__ void corner_weights(const float4 w, float (&cw)[4]) {
  cw[0] = w.z * w.x;
  cw[1] = w.z * w.y;
  cw[2] = w.w * w.x;
  cw[3] = w.w * w.y;
  if constexpr (kBf16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) cw[i] = bf16r(cw[i]);
  }
}

// bf16(a * b) and bf16(a + b) of bf16 values
__device__ __forceinline__ float bmul(float a, float b) { return bf16r(__fmul_rn(a, b)); }
__device__ __forceinline__ float badd(float a, float b) { return bf16r(__fadd_rn(a, b)); }

// The bf16 lookup of one channel from its four corner values (rounded here)
// and the bf16 corner weights: (((r0 w0 + r1 w1) + r2 w2) + r3 w3), each op
// rounded, as K1's bf16 arm and grid_sample_2d_block compute it.
__device__ __forceinline__ float bf16_bilinear(float v00, float v01, float v10, float v11,
                                               const float (&cw)[4]) {
  float acc = badd(bmul(bf16r(v00), cw[0]), bmul(bf16r(v01), cw[1]));
  acc = badd(acc, bmul(bf16r(v10), cw[2]));
  return badd(acc, bmul(bf16r(v11), cw[3]));
}

// The cotangents t[k] of the six lookups s[k] of one channel, from the
// cotangent g of their product, by the chain rule in the forward's order
// ((s0*s1)*s2)*((t0*t1)*t2), every product rounded to bf16.
__device__ __forceinline__ void bf16_chain_vjp(float g, const float (&s)[kPlanes],
                                               float (&t)[kPlanes]) {
  const float s01 = bmul(s[0], s[1]), t01 = bmul(s[3], s[4]);
  const float sa = bmul(s01, s[2]), ta = bmul(t01, s[5]);
  const float g_sa = bmul(g, ta), g_ta = bmul(g, sa);
  const float g_s01 = bmul(g_sa, s[2]), g_t01 = bmul(g_ta, s[5]);
  t[2] = bmul(g_sa, s01);
  t[5] = bmul(g_ta, t01);
  t[0] = bmul(g_s01, s[1]);
  t[1] = bmul(g_s01, s[0]);
  t[3] = bmul(g_t01, s[4]);
  t[4] = bmul(g_t01, s[3]);
}

template <int kVec>
__device__ __forceinline__ void atomic_add(float* p, const float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    atomicAdd(p, v[0]);
  }
}

// Lane l's view of plane k's segment, in pairs (pair i = lanes 2i, 2i+1 hold
// the same sample), from the cell offsets, packed into one register: bit 0
// whether its pair heads the segment, bits 1-4 the segment's last pair, bits
// 5-9 the warp's longest segment (uniform).
__device__ __forceinline__ unsigned int segment_of(int off, int lane) {
  const int prev = __shfl_up_sync(kFull, off, 2);
  const int next = __shfl_down_sync(kFull, off, 2);
  const bool head = lane < 2 || prev != off;
  const unsigned int tails = __ballot_sync(kFull, lane >= 30 || next != off);
  const unsigned int last = (lane + __ffs(tails >> lane) - 1) >> 1;
  const unsigned int len = head ? last - (lane >> 1) + 1 : 1;
  return (unsigned int)head | last << 1 | __reduce_max_sync(kFull, len) << 5;
}

__device__ __forceinline__ bool seg_head(unsigned int seg) { return seg & 1u; }
__device__ __forceinline__ int seg_last(unsigned int seg) { return seg >> 1 & 15u; }
__device__ __forceinline__ int seg_longest(unsigned int seg) { return seg >> 5; }

__device__ __forceinline__ void count(unsigned long long* stats, int i, int lane, int n) {
  const unsigned int total = __reduce_add_sync(kFull, (unsigned int)n);
  if (lane == 0 && total != 0) atomicAdd(stats + i, (unsigned long long)total);
}

// GradT: the type of g_app, float or __nv_bfloat16 (the bf16 arm).
template <int kVec, bool kBf16,
          typename GradT = std::conditional_t<kBf16, __nv_bfloat16, float>>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
plane_product_bwd_kernel(PlaneSet planes, const float* __restrict__ xyzt, int64_t P, int C,
                         int Cd, int run, const float* __restrict__ g_density,
                         const GradT* __restrict__ g_app, float* __restrict__ g_xyzt,
                         unsigned long long* __restrict__ stats) {
  extern __shared__ float4 smem[];
  float4* tents = smem;
  float4* dtents = tents + kPlanes * run;
  int* offsets = reinterpret_cast<int*>(dtents + kPlanes * run);
  int* active = offsets + kPlanes * run;
  float* gd = reinterpret_cast<float*>(active + run);
  float* partials = gd + run;
  __shared__ int n_active;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t p0 = (int64_t)blockIdx.x * run;
  const int n = P - p0 < run ? (int)(P - p0) : run;  // samples of this block
  const int Ca = C - Cd;
  const bool want_planes = planes.grad[0] != nullptr;
  const bool want_xyz = g_xyzt != nullptr;

  // phase 0: is any incoming grad of a sample non-zero?  g_density first,
  // then the block's rows of g_app, one contiguous range that the threads
  // read together, kVec floats a load (a group never straddles two rows:
  // Ca % kVec == 0), each load independent of the others
  for (int s = threadIdx.x; s < n; s += kThreads) active[s] = __ldg(g_density + p0 + s) != 0.0f;
  __syncthreads();
  const GradT* ga_block = g_app + p0 * Ca;
  for (int i = threadIdx.x * kVec; i < n * Ca; i += kThreads * kVec) {
    float v[kVec];
    load<kVec>(ga_block + i, v);
    bool any = false;
#pragma unroll
    for (int j = 0; j < kVec; ++j) any = any || v[j] != 0.0f;
    if (any) active[i / Ca] = 1;  // every writer writes 1
  }
  __syncthreads();
  if (want_xyz) {
    float4* out = reinterpret_cast<float4*>(g_xyzt) + p0;
    for (int s = threadIdx.x; s < n; s += kThreads) {
      if (!active[s]) out[s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  // compaction, in sample order, in place: the a-th active sample's index is
  // written at a <= its own index, after the ballot has read the tile's flags
  if (warp == 0) {
    int total = 0;
    for (int s0 = 0; s0 < n; s0 += 32) {
      const int s = s0 + lane;
      const bool live = s < n && active[s] != 0;
      const unsigned int mask = __ballot_sync(kFull, live);
      if (live) active[total + __popc(mask & ((1u << lane) - 1u))] = s;
      total += __popc(mask);
      __syncwarp();
    }
    if (lane == 0) n_active = total;
  }
  __syncthreads();
  const int na = n_active;

  // phase 1: thread i < na takes the space planes of active sample i,
  // na <= i < 2 na the time planes of active sample i - na
  for (int i = threadIdx.x; i < 2 * na; i += kThreads) {
    const int a = i < na ? i : i - na;
    const int64_t p = p0 + active[a];
    const float4 q = __ldg(reinterpret_cast<const float4*>(xyzt) + p);
    if (i < na) {
      cell<0>(planes, q, a, run, C, tents, dtents, offsets);
      cell<1>(planes, q, a, run, C, tents, dtents, offsets);
      cell<2>(planes, q, a, run, C, tents, dtents, offsets);
      gd[a] = __ldg(g_density + p);
    } else {
      cell<3>(planes, q, a, run, C, tents, dtents, offsets);
      cell<4>(planes, q, a, run, C, tents, dtents, offsets);
      cell<5>(planes, q, a, run, C, tents, dtents, offsets);
    }
  }
  __syncthreads();

  // phase 2: (tile of kTile active samples, chunk of channels) items, a warp
  // each; every loop below is uniform across the warp, so that all lanes
  // take part in the shuffles
  constexpr int kCX[kPlanes] = {0, 0, 1, 2, 1, 0};
  constexpr int kCY[kPlanes] = {1, 2, 2, 3, 3, 3};
  const int tiles = (na + kTile - 1) / kTile;
  const int chunks = (C + kChunkChannels - 1) / kChunkChannels;
  const int pair = lane >> 1;
  const volatile int* offs = offsets;
  for (int item = warp; item < tiles * chunks; item += kWarps) {
    const int tile = item / chunks;
    const int chunk = item - tile * chunks;
    const int a = tile * kTile + pair;
    const bool live = a < na;
    const int64_t p = live ? p0 + active[a] : 0;
    // plane k's cell offset, read from shared memory where it is used rather
    // than held in registers (a volatile read: the register budget is 128);
    // a lane past the last active sample is a segment of its own
    auto cell_off = [&](int k) { return live ? offs[k * run + a] : -1 - lane; };
    float gu[3] = {0.0f, 0.0f, 0.0f};  // this lane's share of d/dx, d/dy, d/dz
    const int c_begin = chunk * kChunkChannels;
    const int c_end = min(C, c_begin + kChunkChannels);
    const int steps = (c_end - c_begin + 2 * kVec - 1) / (2 * kVec);
    for (int step = 0; step < steps; ++step) {
      const int c = c_begin + (2 * step + (lane & 1)) * kVec;
      const bool on = live && c < c_end;  // the odd lane may run past the chunk
      float g[kVec], s[kPlanes][kVec];
      if (on) {
        if (c < Cd) {
          // bf16: the VJP of the f32 density sum hands each channel bf16(g)
          const float gdc = kBf16 ? bf16r(gd[a]) : gd[a];
#pragma unroll
          for (int j = 0; j < kVec; ++j) g[j] = gdc;
        } else {
          load<kVec>(g_app + p * Ca + (c - Cd), g);
        }
#pragma unroll
        for (int k = 0; k < kPlanes; ++k) {
          const float4 w = tents[k * run + a];
          const float* r0 = planes.ptr[k] + cell_off(k) + c;
          const float* r1 = r0 + planes.W[k] * C;
          float v00[kVec], v01[kVec], v10[kVec], v11[kVec];
          load<kVec>(r0, v00);
          load<kVec>(r0 + C, v01);
          load<kVec>(r1, v10);
          load<kVec>(r1 + C, v11);
          if constexpr (kBf16) {
            float cw[4];
            corner_weights<true>(w, cw);
#pragma unroll
            for (int j = 0; j < kVec; ++j) {
              s[k][j] = bf16_bilinear(v00[j], v01[j], v10[j], v11[j], cw);
            }
          } else {
#pragma unroll
            for (int j = 0; j < kVec; ++j) {
              s[k][j] = v00[j] * (w.z * w.x) + v01[j] * (w.z * w.y) + v10[j] * (w.w * w.x) +
                        v11[j] * (w.w * w.y);
            }
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          g[j] = 0.0f;
#pragma unroll
          for (int k = 0; k < kPlanes; ++k) s[k][j] = 0.0f;
        }
      }
      // t[k] = g * prod_{j != k} s[j]: by prefix and suffix products in f32,
      // by the forward's chain in bf16
      float t[kPlanes][kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        if constexpr (kBf16) {
          float sj[kPlanes], tj[kPlanes];
#pragma unroll
          for (int k = 0; k < kPlanes; ++k) sj[k] = s[k][j];
          bf16_chain_vjp(g[j], sj, tj);
#pragma unroll
          for (int k = 0; k < kPlanes; ++k) t[k][j] = tj[k];
        } else {
          float pre = g[j];
#pragma unroll
          for (int k = 0; k < kPlanes; ++k) {
            t[k][j] = pre;
            pre *= s[k][j];
          }
          float suf = 1.0f;
#pragma unroll
          for (int k = kPlanes - 1; k >= 0; --k) {
            t[k][j] *= suf;
            suf *= s[k][j];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kPlanes; ++k) {
        const float4 w = live ? tents[k * run + a] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const float* r0 = planes.ptr[k] + cell_off(k) + c;
        const float* r1 = r0 + planes.W[k] * C;
        if constexpr (!kBf16) {  // the bf16 arm's d/dxyz is phase 3's
          if (want_xyz && on) {
            const float4 d = dtents[k * run + a];
            float v00[kVec], v01[kVec], v10[kVec], v11[kVec];
            load<kVec>(r0, v00);  // again: L1 holds them since the lookup above
            load<kVec>(r0 + C, v01);
            load<kVec>(r1, v10);
            load<kVec>(r1 + C, v11);
#pragma unroll
            for (int j = 0; j < kVec; ++j) {
              const float top = v00[j] * d.x + v01[j] * d.y;
              const float bot = v10[j] * d.x + v11[j] * d.y;
              gu[kCX[k]] += t[k][j] * (w.z * top + w.w * bot);
              if (kCY[k] < 3) {  // the time column gets no gradient
                const float lo = v00[j] * w.x + v01[j] * w.y;
                const float hi = v10[j] * w.x + v11[j] * w.y;
                gu[kCY[k]] += t[k][j] * (d.z * lo + d.w * hi);
              }
            }
          }
        }
        if (want_planes) {
          const int off = cell_off(k);
          const unsigned int seg = segment_of(off, lane);
          float cw[4];
          corner_weights<kBf16>(w, cw);
          float q[4][kVec];
          int nonzero = 0;  // bit i: corner i has a non-zero tent weight
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            nonzero |= (cw[i] != 0.0f) << i;
#pragma unroll
            for (int j = 0; j < kVec; ++j) q[i][j] = kBf16 ? bmul(t[k][j], cw[i]) : t[k][j] * cw[i];
          }
          const int own = nonzero;
          // segmented suffix sum over pairs: the head pair ends with its
          // segment's total, each lane of it for its own channels
          for (int d = 1; d < seg_longest(seg); d <<= 1) {
            const bool take = pair + d <= seg_last(seg);
            const int nz = __shfl_down_sync(kFull, nonzero, 2 * d);
            if (take) nonzero |= nz;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
              for (int j = 0; j < kVec; ++j) {
                const float o = __shfl_down_sync(kFull, q[i][j], 2 * d);
                if (take) q[i][j] += o;
              }
            }
          }
          const bool issue = on && seg_head(seg);
          if (issue) {
            float* o0 = planes.grad[k] + off + c;
            float* o1 = o0 + planes.W[k] * C;
            if (nonzero & 1) atomic_add<kVec>(o0, q[0]);
            if (nonzero & 2) atomic_add<kVec>(o0 + C, q[1]);
            if (nonzero & 4) atomic_add<kVec>(o1, q[2]);
            if (nonzero & 8) atomic_add<kVec>(o1 + C, q[3]);
          }
          if (stats != nullptr) {
            count(stats, 0, lane, issue ? __popc(nonzero) : 0);
            count(stats, 1, lane, on ? 4 - __popc(own) : 0);
            count(stats, 2, lane, on && !seg_head(seg) ? __popc(own) : 0);
          }
        }
      }
    }
    if constexpr (!kBf16) {
      if (want_xyz) {  // the pair's two shares, even lane first
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float other = __shfl_down_sync(kFull, gu[i], 1);
          if (live && (lane & 1) == 0) partials[(chunk * 3 + i) * run + a] = gu[i] + other;
        }
      }
    }
  }
  __syncthreads();

  // phase 3 of the bf16 arm: each active sample's channels in order, one
  // thread a sample; the 24 tent products' cotangents as running bf16 sums,
  // then d/dxyz through the tents in f32
  if constexpr (kBf16) {
    if (want_xyz) {
      for (int a = threadIdx.x; a < na; a += kThreads) {
        const int64_t p = p0 + active[a];
        const float gdc = bf16r(gd[a]);
        float gw[kPlanes][4];
#pragma unroll
        for (int k = 0; k < kPlanes; ++k) {
#pragma unroll
          for (int i = 0; i < 4; ++i) gw[k][i] = 0.0f;
        }
        for (int c = 0; c < C; ++c) {
          float g[1];
          if (c < Cd) {
            g[0] = gdc;
          } else {
            load<1>(g_app + p * Ca + (c - Cd), g);
          }
          float r[kPlanes][4], s[kPlanes], t[kPlanes];
#pragma unroll
          for (int k = 0; k < kPlanes; ++k) {
            float cw[4];
            corner_weights<true>(tents[k * run + a], cw);
            const float* r0 = planes.ptr[k] + offsets[k * run + a] + c;
            const float* r1 = r0 + planes.W[k] * C;
            r[k][0] = __ldg(r0);
            r[k][1] = __ldg(r0 + C);
            r[k][2] = __ldg(r1);
            r[k][3] = __ldg(r1 + C);
            s[k] = bf16_bilinear(r[k][0], r[k][1], r[k][2], r[k][3], cw);
          }
          bf16_chain_vjp(g[0], s, t);
#pragma unroll
          for (int k = 0; k < kPlanes; ++k) {
#pragma unroll
            for (int i = 0; i < 4; ++i) gw[k][i] = badd(gw[k][i], bmul(t[k], bf16r(r[k][i])));
          }
        }
        float gu[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int k = 0; k < kPlanes; ++k) {
          const float4 w = tents[k * run + a];  // wx0 wx1 wy0 wy1
          const float4 d = dtents[k * run + a];
          const float g_wx0 = gw[k][0] * w.z + gw[k][2] * w.w;
          const float g_wx1 = gw[k][1] * w.z + gw[k][3] * w.w;
          gu[kCX[k]] += g_wx0 * d.x + g_wx1 * d.y;
          if (kCY[k] < 3) {  // the time column gets no gradient
            const float g_wy0 = gw[k][0] * w.x + gw[k][1] * w.y;
            const float g_wy1 = gw[k][2] * w.x + gw[k][3] * w.y;
            gu[kCY[k]] += g_wy0 * d.z + g_wy1 * d.w;
          }
        }
        reinterpret_cast<float4*>(g_xyzt)[p] = make_float4(gu[0], gu[1], gu[2], 0.0f);
      }
    }
  }

  // phase 3: each active sample's grad_xyzt, its chunks added in order
  if (!kBf16 && want_xyz) {
    for (int a = threadIdx.x; a < na; a += kThreads) {
      float gx = 0.0f, gy = 0.0f, gz = 0.0f;
      for (int ch = 0; ch < chunks; ++ch) {
        gx += partials[(ch * 3 + 0) * run + a];
        gy += partials[(ch * 3 + 1) * run + a];
        gz += partials[(ch * 3 + 2) * run + a];
      }
      reinterpret_cast<float4*>(g_xyzt)[p0 + active[a]] = make_float4(gx, gy, gz, 0.0f);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

template <bool kBf16>
void launch_arm(unsigned int blocks, int smem_bytes, cudaStream_t s, const PlaneSet& planes,
                const float* xyzt, int64_t P, int C, int Cd, int vec, int run,
                const float* g_density, const void* g_app, float* g_xyzt,
                unsigned long long* stats) {
  using GradT = std::conditional_t<kBf16, __nv_bfloat16, float>;
  const GradT* ga = static_cast<const GradT*>(g_app);
  if (vec == 4) {
    plane_product_bwd_kernel<4, kBf16><<<blocks, kThreads, smem_bytes, s>>>(
        planes, xyzt, P, C, Cd, run, g_density, ga, g_xyzt, stats);
  } else {
    plane_product_bwd_kernel<1, kBf16><<<blocks, kThreads, smem_bytes, s>>>(
        planes, xyzt, P, C, Cd, run, g_density, ga, g_xyzt, stats);
  }
}

// hw: 12 host ints, (H, W) of the planes in the order s0, s1, s2, t0, t1, t2.
// vec, run, smem_bytes: the wrapper's launch plan
// (ops/grid_sample.py:plane_product_bwd_plan).  bf16: the arm, 0 for float32
// (g_app float32), 1 for bfloat16 (g_app bf16).  plane_grads: six device
// pointers to zero-initialised buffers shaped like the planes, or null when
// no plane gradient is wanted; g_xyzt: (P, 4) or null; stats: three device
// counters, or null.  Returns cudaErrorInvalidValue for a plan the inputs do
// not allow, else cudaGetLastError() after the launch.
extern "C" int nvfi_plane_product_bwd(const float* s0, const float* s1, const float* s2,
                                      const float* t0, const float* t1, const float* t2,
                                      const int* hw, const float* xyzt, int64_t P, int C,
                                      int Cd, int vec, int run, int smem_bytes, int bf16,
                                      const float* g_density, const void* g_app,
                                      float* const* plane_grads, float* g_xyzt,
                                      unsigned long long* stats, void* stream) {
  const float* ptrs[kPlanes] = {s0, s1, s2, t0, t1, t2};
  PlaneSet planes;
  bool all_aligned = aligned16(g_app);
  for (int k = 0; k < kPlanes; ++k) {
    planes.ptr[k] = ptrs[k];
    planes.grad[k] = plane_grads != nullptr ? plane_grads[k] : nullptr;
    planes.H[k] = hw[2 * k];
    planes.W[k] = hw[2 * k + 1];
    all_aligned = all_aligned && aligned16(ptrs[k]) && aligned16(planes.grad[k]);
  }
  // the wrapper's plan, checked
  const bool vec_ok = C % 4 == 0 && Cd % 4 == 0 && all_aligned;
  const int chunks = (C + kChunkChannels - 1) / kChunkChannels;
  if ((vec != 1 && vec != 4) || (vec == 4 && !vec_ok) || run < 1 || P < 1 ||
      (bf16 != 0 && bf16 != 1) || smem_bytes < smem_bytes_for(run, chunks) ||
      smem_bytes > 48 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned int blocks = (unsigned int)((P + run - 1) / run);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch_arm<true>(blocks, smem_bytes, s, planes, xyzt, P, C, Cd, vec, run, g_density, g_app,
                     g_xyzt, stats);
  } else {
    launch_arm<false>(blocks, smem_bytes, s, planes, xyzt, P, C, Cd, vec, run, g_density, g_app,
                      g_xyzt, stats);
  }
  return (int)cudaGetLastError();
}
