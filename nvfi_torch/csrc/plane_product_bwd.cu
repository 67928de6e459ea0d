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
// written once (37 MB) plus grad_xyzt: ~94 MB, 28 us at 3.35 TB/s (fewer on
// real data: chip_smoke.py counts the sectors a chunk touches).  What bounds
// it instead, we infer from its times (no profiler counter has read it), is
// the L2's atomic throughput.  A 32-byte sector costs
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
// with no contraction to feed them); phases 0 and 1 and the merged atomics
// (scatter) are both arms', the rest is the f32 arm's:
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
// The bf16 arm (K1b.bf16: plane_product_bwd_kernel<vec, true>, whose phase
// 2 is bf16_walk): the VJP that jax.grad derives for K1's bf16 arm
// (grid_sample_2d_block(compute_dtype=bf16)), as XLA computes it.  g_app
// comes in as bf16, g_density as f32 and is rounded to bf16 for every
// density channel (the VJP of the f32 density sum).  Per (sample, channel)
// it recomputes the bf16 lookup s[k] and takes each plane's cotangent t[k]
// by the chain rule in the forward's order, ((s0*s1)*s2)*((t0*t1)*t2), every
// product rounded to bf16.  A corner's row cotangent is bf16(t[k] * w_i),
// widened to f32 for the f32 merge and atomics: the plane grads stay f32.
// The coordinate gradient needs each of the 24 tent products' cotangents,
// the sum over the channels of bf16(t[k] * r_i), and XLA takes that sum as a
// running bf16 sum in channel order: it adds in f32 and rounds after every
// add, so the sum cannot be split over channels and merged.
//   * It reads the bf16 plane copies K1.bf16 reads (ops/grid_sample.py:
//     bf16_planes, made once per plane version, a cache hit in a train step:
//     the backward runs before the optimizer moves the version).  They are
//     exact: JAX rounds each gathered row to bf16 before any arithmetic, ties
//     to even as the copy.  g_app is read as 8 bf16 in 16 bytes.
//   * Its arithmetic is packed (bf16x2.cuh, the lookup shared with K1.bf16):
//     __hmul2_rn / __hadd2_rn for the lookup, the chain, the row cotangents
//     and the running sums.  Two corners' running sums share one
//     __nv_bfloat162 add; each half rounds once, so it equals two scalar bf16
//     adds, and a lane's 12 sums take 6 registers.
//   * One walk, in channel order.  A warp owns a tile of 16 active samples
//     for all C channels in turn.  Lanes 2i and 2i+1 hold the tile's i-th
//     sample and split its planes, not its channels: the even lane looks up
//     the space planes s0 s1 s2, the odd lane the time planes t0 t1 t2.  Each
//     lane forms its half of the chain, ((s0*s1)*s2) or ((t0*t1)*t2), takes
//     the other half by one shuffle, and gives the cotangents of its own three
//     planes.  So every running sum lives in one lane, which walks channels
//     0..C-1 in order, 8 a step on the 16-byte path (C % 8 == 0, Cd % 8 == 0,
//     16-byte aligned copies, grads and g_app, as the wrapper's plan checks),
//     one pair after the other, low channel first: XLA's order, with no hand-
//     over between lanes.  The lookup and the chain are computed once per
//     (sample, channel) for both outputs; the corner rows are read again for
//     the running sums after the chain (L1 hits).
//   * Plane grads: on the 16-byte path the pair swaps half of each plane's
//     cotangents before the atomics (two shuffles a plane pair), so that for
//     plane k both lanes hold sample i's cotangents, the even lane channels
//     c..c+3 and the odd lane c+4..c+7, and go through the f32 arm's merge
//     and float4 atomics (scatter): a pair fills one 32-byte sector a corner,
//     as in the f32 arm, and issues exactly the f32 arm's atomics on the same
//     inputs.  The narrow path (one channel a step) has no second channel to
//     swap, so for plane j the even lane adds its channel and the odd lane,
//     whose cotangent is plane j + 3's, only takes part in the merge, and
//     the other way round for plane j + 3: both merges run over the pairs'
//     cells, as in the f32 arm.
//   * d/dxyz through the tents in f32 after the last channel: the even lane
//     adds the space planes' terms, hands its three partial sums to the odd
//     lane, which adds the time planes' terms: plane 0 to plane 5, each term
//     as xyz_terms writes it.  No atomic touches grad_xyzt, so two launches
//     give it bit for bit.
//   * A block is kThreadsBf16 = 128 threads over a run of 128 samples (about
//     half active in a train chunk: a tile a warp); __launch_bounds__ keeps
//     four blocks an SM, at most 128 registers a thread.
// What bounds it is not measured: no profiler counter has read its L2
// atomics or its issue rate.  On the real bf16 train chunk it issues exactly
// the f32 arm's atomics and takes less time than the f32 arm on the same
// grads (PERF.md section 6), so neither arm's time is set by the atomics'
// count alone; chip_smoke.py gives both arms' sectors a second and the
// kernel alone without grad_xyzt.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bf16x2.cuh"

namespace {

constexpr int kPlanes = 6;
constexpr int kThreads = 256;  // the f32 arm's block
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 2;
constexpr int kThreadsBf16 = 128;  // the bf16 arm's block
constexpr int kWarpsBf16 = kThreadsBf16 / 32;
constexpr int kMinBlocksBf16 = 4;
constexpr int kChunkChannels = 24;  // channels of one f32 phase-2 item
constexpr int kTile = 16;           // active samples of a warp's item: a lane pair each
constexpr unsigned int kFull = 0xffffffffu;

// plane k's coordinate pair (kplane.MAT_SPACE, then MAT_TIME): the column
// of xyzt that indexes its W, and the one that indexes its H
__host__ __device__ constexpr int coord_x(int k) { return k == 2 ? 1 : k == 3 ? 2 : k == 4 ? 1 : 0; }
__host__ __device__ constexpr int coord_y(int k) { return k == 0 ? 1 : k <= 2 ? 2 : 3; }

// the six planes, (H, W, C) channels-last: float32 (T = float) or the bf16
// copies (T = __nv_bfloat16); their gradients are float32 (H, W, C) in both
template <typename T>
struct PlaneSet {
  const T* ptr[kPlanes];
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

// Shared-memory layout of a block: float4 tents[6][run] (wx0 wx1 wy0 wy1),
// float4 dtents[6][run] (their derivatives, times (W-1)/2 or (H-1)/2), int
// offsets[6][run] (element offset of corner (y0, x0)), int active[run] (local
// index of the a-th active sample), float g_density[run], then, in the f32
// arm, float partials[chunks][3][run] (grad_xyz by chunk; chunks = 0 in the
// bf16 arm).  ops/grid_sample.py:plane_product_bwd_plan computes the same
// byte count.
constexpr int smem_bytes_for(int run, int chunks) {
  return run * (2 * kPlanes * 16 + kPlanes * 4 + 4 + 4 + chunks * 12);
}

// Phase 1 for plane k of active sample a: the clamped cell, its tents and
// their derivatives.
template <int k, typename T>
__device__ __forceinline__ void cell(const PlaneSet<T>& planes, const float4 q, int a, int run,
                                     int C, float4* tents, float4* dtents, int* offsets) {
  constexpr int cx = coord_x(k);
  constexpr int cy = coord_y(k);
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

// whether any of the kLoad incoming grads at p is non-zero (-0 counts as
// zero): float32, or bf16 (8 in one 16-byte load, or 1)
template <int kLoad>
__device__ __forceinline__ bool any_nonzero(const float* p) {
  float v[kLoad];
  load<kLoad>(p, v);
  bool any = false;
#pragma unroll
  for (int j = 0; j < kLoad; ++j) any = any || v[j] != 0.0f;
  return any;
}

template <int kLoad>
__device__ __forceinline__ bool any_nonzero(const __nv_bfloat16* p) {
  const Bf16Vals<kLoad> v = load_bf16<kLoad>(p);
  bool any = false;
#pragma unroll
  for (int j = 0; j < Bf16Vals<kLoad>::kPairs; ++j) {
    any = any || (as_u32(v.h[j]) & 0x7fff7fffu) != 0;
  }
  return any;
}

// The four corner weights of a plane from its tents (wx0 wx1 wy0 wy1), in
// the corner order y0x0, y0x1, y1x0, y1x1.
__device__ __forceinline__ void corner_weights(const float4 w, float (&cw)[4]) {
  cw[0] = w.z * w.x;
  cw[1] = w.z * w.y;
  cw[2] = w.w * w.x;
  cw[3] = w.w * w.y;
}

template <int kVec>
__device__ __forceinline__ void atomic_add(float* p, const float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    atomicAdd(p, v[0]);
  }
}

// Lane l's view of a plane's segment, in pairs (pair i = lanes 2i, 2i+1 hold
// the same cell), from the cell offsets, packed into one register: bit 0
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

// One lane's update of plane k's gradient, both arms: q[i] holds kW
// channels, from channel c, of corner i's row cotangent (y0x0, y0x1, y1x0,
// y1x1) in the cell at element offset off, seg is segment_of(off, lane),
// taken before the cotangents, and the gradient's pointer and row stride are
// read where the atomics need them (taken at the call, they cost the f32
// arm's scalar form 2 registers); bit i of nonzero says whether corner i's
// tent weight is non-zero.  A segmented suffix sum by shuffles
// (only as many steps as the warp's longest segment needs) leaves each
// segment's total on its first pair, which alone issues the atomics, one for
// each corner whose weight is non-zero in some sample of the segment (0 *
// finite otherwise).  Uniform across the warp; `on`: the lane adds its q.
template <int kW, typename T>
__device__ __forceinline__ void scatter(const PlaneSet<T>& planes, int k, int C, int off, int c,
                                        unsigned int seg, float (&q)[4][kW], int nonzero,
                                        bool on, int lane, unsigned long long* stats) {
  const int pair = lane >> 1;
  const int own = nonzero;
  for (int d = 1; d < seg_longest(seg); d <<= 1) {
    const bool take = pair + d <= seg_last(seg);
    const int nz = __shfl_down_sync(kFull, nonzero, 2 * d);
    if (take) nonzero |= nz;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < kW; ++j) {
        const float o = __shfl_down_sync(kFull, q[i][j], 2 * d);
        if (take) q[i][j] += o;
      }
    }
  }
  const bool issue = on && seg_head(seg);
  if (issue) {
    float* o0 = planes.grad[k] + off + c;
    float* o1 = o0 + planes.W[k] * C;
    if (nonzero & 1) atomic_add<kW>(o0, q[0]);
    if (nonzero & 2) atomic_add<kW>(o0 + C, q[1]);
    if (nonzero & 4) atomic_add<kW>(o1, q[2]);
    if (nonzero & 8) atomic_add<kW>(o1 + C, q[3]);
  }
  if (stats != nullptr) {
    count(stats, 0, lane, issue ? __popc(nonzero) : 0);
    count(stats, 1, lane, on ? 4 - __popc(own) : 0);
    count(stats, 2, lane, on && !seg_head(seg) ? __popc(own) : 0);
  }
}

// ---------------------------------------------------------------------------
// The bf16 arm
// ---------------------------------------------------------------------------

// The 4 x 2 nP row cotangents bf16(t * w_i) of nP channel pairs, widened to
// f32: kW = 2 nP channels a corner, or kW = 1 (the pair's low lane)
template <int kW, int nP>
__device__ __forceinline__ void bf16_rows(const __nv_bfloat162 (&t)[nP], uint2 cw,
                                          float (&q)[4][kW]) {
  const __nv_bfloat162 w01 = as_bf162(cw.x), w23 = as_bf162(cw.y);
  const __nv_bfloat162 w[4] = {__low2bfloat162(w01), __high2bfloat162(w01),
                               __low2bfloat162(w23), __high2bfloat162(w23)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < nP; ++j) {
      const float2 f = __bfloat1622float2(__hmul2_rn(t[j], w[i]));
      q[i][2 * j] = f.x;
      if constexpr (kW > 1) q[i][2 * j + 1] = f.y;
    }
  }
}

// bit i: whether the bf16 tent product of corner i is non-zero
__device__ __forceinline__ int nonzero_of(uint2 cw) {
  return ((cw.x & 0x7fffu) != 0) | ((cw.x & 0x7fff0000u) != 0) << 1 |
         ((cw.y & 0x7fffu) != 0) << 2 | ((cw.y & 0x7fff0000u) != 0) << 3;
}

// plane k's terms of d/dxyz from its four tent products' cotangents gw
// (y0x0 y0x1 y1x0 y1x1), its tents w (wx0 wx1 wy0 wy1) and their
// derivatives d, added to gu in f32
template <int k>
__device__ __forceinline__ void xyz_terms(const float (&gw)[4], const float4 w, const float4 d,
                                          float (&gu)[3]) {
  const float g_wx0 = gw[0] * w.z + gw[2] * w.w;
  const float g_wx1 = gw[1] * w.z + gw[3] * w.w;
  gu[coord_x(k)] += g_wx0 * d.x + g_wx1 * d.y;
  if (coord_y(k) < 3) {  // the time column gets no gradient
    const float g_wy0 = gw[0] * w.x + gw[1] * w.y;
    const float g_wy1 = gw[2] * w.x + gw[3] * w.y;
    gu[coord_y(k)] += g_wy0 * d.z + g_wy1 * d.w;
  }
}

// Phase 2 of the bf16 arm: the walk, for the block's na active samples
// (phases 0 and 1 done).
template <int kVec>
__device__ __forceinline__ void bf16_walk(const PlaneSet<__nv_bfloat16>& planes, int C, int Cd,
                                          int run, int64_t p0, int na, const float4* tents,
                                          const float4* dtents, const int* offsets,
                                          const int* active, const float* gd,
                                          const __nv_bfloat16* __restrict__ g_app,
                                          float* __restrict__ g_xyzt,
                                          unsigned long long* __restrict__ stats, int lane,
                                          int warp, bool want_planes, bool want_xyz) {
  using Vals = Bf16Vals<kVec>;
  constexpr int kPairs = Vals::kPairs;
  const int pair = lane >> 1;
  const int half = lane & 1;  // 0: the space planes s0 s1 s2; 1: the time planes t0 t1 t2
  const int Ca = C - Cd;
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.0f);

  // a warp owns a tile of kTile active samples for all C channels; every
  // loop below is uniform across the warp (shuffles)
  const int tiles = (na + kTile - 1) / kTile;
  for (int tile = warp; tile < tiles; tile += kWarpsBf16) {
    const int a = tile * kTile + pair;
    const bool live = a < na;
    const int64_t p = live ? p0 + active[a] : 0;
    // per plane: the cell offset (a lane past the last active sample is a
    // segment of its own), the four bf16 tent products and which are non-zero
    int off[kPlanes], nonzero[kPlanes];
    uint2 cw[kPlanes];
#pragma unroll
    for (int k = 0; k < kPlanes; ++k) {
      const float4 w = live ? tents[k * run + a] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float wk[4];
      corner_weights(w, wk);
      cw[k] = bf16_weights(wk);
      nonzero[k] = nonzero_of(cw[k]);
      off[k] = live ? offsets[k * run + a] : -1 - lane;
    }
    // bf16(g_density) for every density channel, as JAX's VJP of the f32 sum
    const __nv_bfloat162 gdc = __float2bfloat162_rn(live ? gd[a] : 0.0f);
    // this lane's 12 running sums: [plane][corners y0x0 y0x1 | y1x0 y1x1]
    __nv_bfloat162 sums[3][2];
#pragma unroll
    for (int j = 0; j < 3; ++j) sums[j][0] = sums[j][1] = zero;

    for (int c = 0; c < C; c += kVec) {
      Vals g;
      if (c < Cd || !live) {
#pragma unroll
        for (int i = 0; i < kPairs; ++i) g.h[i] = live ? gdc : zero;
      } else {
        g = load_bf16<kVec>(g_app + p * Ca + (c - Cd));
      }
      // the lookups of this lane's three planes
      Vals s[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (live) {
          const __nv_bfloat16* r0 = (half ? planes.ptr[j + 3] : planes.ptr[j]) +
                                    (half ? off[j + 3] : off[j]) + c;
          const __nv_bfloat16* r1 = r0 + (half ? planes.W[j + 3] : planes.W[j]) * C;
          s[j] = bf16_corners<kVec>(load_bf16<kVec>(r0), load_bf16<kVec>(r0 + C),
                                    load_bf16<kVec>(r1), load_bf16<kVec>(r1 + C),
                                    half ? cw[j + 3] : cw[j]);
        } else {
#pragma unroll
          for (int i = 0; i < kPairs; ++i) s[j].h[i] = zero;
        }
      }
      // the chain ((s0*s1)*s2) * ((t0*t1)*t2) and its VJP: a lane forms its
      // half's product, takes the other half's by shuffle, and gives its
      // planes' cotangents: t[2] = g * other * (x0*x1), t[0] = g * other *
      // x2 * x1, t[1] = g * other * x2 * x0, each product rounded
      Vals t[3];
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        const __nv_bfloat162 p01 = __hmul2_rn(s[0].h[i], s[1].h[i]);
        const __nv_bfloat162 own = __hmul2_rn(p01, s[2].h[i]);
        const __nv_bfloat162 other = as_bf162(__shfl_xor_sync(kFull, as_u32(own), 1));
        const __nv_bfloat162 g_own = __hmul2_rn(g.h[i], other);
        const __nv_bfloat162 g01 = __hmul2_rn(g_own, s[2].h[i]);
        t[2].h[i] = __hmul2_rn(g_own, p01);
        t[0].h[i] = __hmul2_rn(g01, s[1].h[i]);
        t[1].h[i] = __hmul2_rn(g01, s[0].h[i]);
      }
      // the running sums of the tent products' cotangents, channel by
      // channel: a pair's low channel, then its high one
      if (want_xyz && live) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const __nv_bfloat16* r0 = (half ? planes.ptr[j + 3] : planes.ptr[j]) +
                                    (half ? off[j + 3] : off[j]) + c;
          const __nv_bfloat16* r1 = r0 + (half ? planes.W[j + 3] : planes.W[j]) * C;
          const Vals r[4] = {load_bf16<kVec>(r0), load_bf16<kVec>(r0 + C), load_bf16<kVec>(r1),
                             load_bf16<kVec>(r1 + C)};  // again: L1 holds them
#pragma unroll
          for (int i = 0; i < kPairs; ++i) {
            const __nv_bfloat162 q0 = __hmul2_rn(t[j].h[i], r[0].h[i]);
            const __nv_bfloat162 q1 = __hmul2_rn(t[j].h[i], r[1].h[i]);
            const __nv_bfloat162 q2 = __hmul2_rn(t[j].h[i], r[2].h[i]);
            const __nv_bfloat162 q3 = __hmul2_rn(t[j].h[i], r[3].h[i]);
            sums[j][0] = __hadd2_rn(sums[j][0], __lows2bfloat162(q0, q1));
            sums[j][1] = __hadd2_rn(sums[j][1], __lows2bfloat162(q2, q3));
            if constexpr (kVec > 1) {
              sums[j][0] = __hadd2_rn(sums[j][0], __highs2bfloat162(q0, q1));
              sums[j][1] = __hadd2_rn(sums[j][1], __highs2bfloat162(q2, q3));
            }
          }
        }
      }
      if (want_planes) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          if constexpr (kVec == 8) {
            // the even lane gives the odd one channels c+4..c+7 of plane j
            // and takes channels c..c+3 of plane j + 3: then both lanes of
            // the pair add plane j, and then plane j + 3, 4 channels each
            const unsigned int give0 = as_u32(half ? t[j].h[0] : t[j].h[2]);
            const unsigned int give1 = as_u32(half ? t[j].h[1] : t[j].h[3]);
            const __nv_bfloat162 took0 = as_bf162(__shfl_xor_sync(kFull, give0, 1));
            const __nv_bfloat162 took1 = as_bf162(__shfl_xor_sync(kFull, give1, 1));
            const int ch = c + 4 * half;
            float q[4][4];
            unsigned int seg = segment_of(off[j], lane);
            const __nv_bfloat162 ts[2] = {half ? took0 : t[j].h[0], half ? took1 : t[j].h[1]};
            bf16_rows<4>(ts, cw[j], q);
            scatter<4>(planes, j, C, off[j], ch, seg, q, nonzero[j], live,
                       lane, stats);
            seg = segment_of(off[j + 3], lane);
            const __nv_bfloat162 tt[2] = {half ? t[j].h[2] : took0, half ? t[j].h[3] : took1};
            bf16_rows<4>(tt, cw[j + 3], q);
            scatter<4>(planes, j + 3, C, off[j + 3], ch, seg, q,
                       nonzero[j + 3], live, lane, stats);
          } else {
            // one channel: the lane that holds the plane adds it (the even
            // lane plane j, the odd lane plane j + 3); its partner takes part
            // in the merge, whose segments are the pairs' cells, and adds
            // nothing (its q is another plane's)
            float q[4][1];
            const __nv_bfloat162 ts[1] = {t[j].h[0]};
            unsigned int seg = segment_of(off[j], lane);
            bf16_rows<1>(ts, cw[j], q);
            scatter<1>(planes, j, C, off[j], c, seg, q, nonzero[j],
                       live && !half, lane, stats);
            seg = segment_of(off[j + 3], lane);
            bf16_rows<1>(ts, cw[j + 3], q);
            scatter<1>(planes, j + 3, C, off[j + 3], c, seg, q,
                       nonzero[j + 3], live && half, lane, stats);
          }
        }
      }
    }
    // d/dxyz: the even lane adds the space planes' terms, the odd lane then
    // the time planes', in the plain version's order (plane 0 to plane 5)
    if (want_xyz) {
      float gw[3][4];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float2 w01 = __bfloat1622float2(sums[j][0]), w23 = __bfloat1622float2(sums[j][1]);
        gw[j][0] = w01.x;
        gw[j][1] = w01.y;
        gw[j][2] = w23.x;
        gw[j][3] = w23.y;
      }
      float gu[3] = {0.0f, 0.0f, 0.0f};
      if (live && half == 0) {
        xyz_terms<0>(gw[0], tents[0 * run + a], dtents[0 * run + a], gu);
        xyz_terms<1>(gw[1], tents[1 * run + a], dtents[1 * run + a], gu);
        xyz_terms<2>(gw[2], tents[2 * run + a], dtents[2 * run + a], gu);
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) gu[i] = __shfl_xor_sync(kFull, gu[i], 1);
      if (live && half == 1) {
        xyz_terms<3>(gw[0], tents[3 * run + a], dtents[3 * run + a], gu);
        xyz_terms<4>(gw[1], tents[4 * run + a], dtents[4 * run + a], gu);
        xyz_terms<5>(gw[2], tents[5 * run + a], dtents[5 * run + a], gu);
        reinterpret_cast<float4*>(g_xyzt)[p] = make_float4(gu[0], gu[1], gu[2], 0.0f);
      }
    }
  }
}


// ---------------------------------------------------------------------------
// The kernel: phases 0 and 1 for both arms, then the arm's walk.  T: float
// (the planes and g_app of the f32 arm) or __nv_bfloat16 (the bf16 arm's
// copies and g_app).  Phases 0 and 1 and the f32 arm's phases 2 and 3 stand
// in the body, and the f32 walk indexes gu through the kCX / kCY tables:
// written otherwise (an inlined helper, coord_x() in place of the table),
// the same arithmetic compiles to other code.  So written, the f32 arm's
// SASS is, instruction for instruction, what it was before the bf16 arm's
// redesign (scripts/compare_sass.py against a checkout of the older tree),
// but for phase 0's barrier, added since.
// ---------------------------------------------------------------------------

template <int kVec, bool kBf16, typename T = std::conditional_t<kBf16, __nv_bfloat16, float>>
__global__ void __launch_bounds__(kBf16 ? kThreadsBf16 : kThreads,
                                  kBf16 ? kMinBlocksBf16 : kMinBlocks)
plane_product_bwd_kernel(PlaneSet<T> planes, const float* __restrict__ xyzt, int64_t P, int C,
                         int Cd, int run, const float* __restrict__ g_density,
                         const T* __restrict__ g_app, float* __restrict__ g_xyzt,
                         unsigned long long* __restrict__ stats) {
  constexpr int kBlock = kBf16 ? kThreadsBf16 : kThreads;
  extern __shared__ float4 smem[];
  float4* tents = smem;
  float4* dtents = tents + kPlanes * run;
  int* offsets = reinterpret_cast<int*>(dtents + kPlanes * run);
  int* active = offsets + kPlanes * run;
  float* gd = reinterpret_cast<float*>(active + run);
  float* partials = gd + run;  // the f32 arm's
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
  // read together, kVec values a load (a load never straddles two rows:
  // Ca % kVec == 0), each load independent of the others; the zero
  // grad_xyzt row of the others is written here, before a barrier: warp 0
  // then compacts the active ones, in order, by ballots, over the flags in
  // place, and a warp still reading a flag there would take a sample index
  // for it and leave an inactive sample's row unwritten.
  for (int s = threadIdx.x; s < n; s += kBlock) active[s] = __ldg(g_density + p0 + s) != 0.0f;
  __syncthreads();
  const T* ga_block = g_app + p0 * Ca;
  for (int i = threadIdx.x * kVec; i < n * Ca; i += kBlock * kVec) {
    if (any_nonzero<kVec>(ga_block + i)) active[i / Ca] = 1;  // every writer writes 1
  }
  __syncthreads();
  if (want_xyz) {
    float4* out = reinterpret_cast<float4*>(g_xyzt) + p0;
    for (int s = threadIdx.x; s < n; s += kBlock) {
      if (!active[s]) out[s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();  // want_xyz is the block's: every thread reaches it or none
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

  // phase 1: one thread per (active sample, half of the planes) computes
  // each (sample, plane) cell offset, its four tents and four tent
  // derivatives once, into shared memory: thread i < na takes the space
  // planes of active sample i, na <= i < 2 na the time planes of active
  // sample i - na
  for (int i = threadIdx.x; i < 2 * na; i += kBlock) {
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

  if constexpr (kBf16) {
    bf16_walk<kVec>(planes, C, Cd, run, p0, na, tents, dtents, offsets, active, gd, g_app, g_xyzt,
                    stats, lane, warp, want_planes, want_xyz);
  } else {
    // phase 2: (tile of kTile active samples, chunk of channels) items, a warp
    // each; every loop below is uniform across the warp, so that all lanes
    // take part in the shuffles
    constexpr int kCX[kPlanes] = {coord_x(0), coord_x(1), coord_x(2),
                                  coord_x(3), coord_x(4), coord_x(5)};
    constexpr int kCY[kPlanes] = {coord_y(0), coord_y(1), coord_y(2),
                                  coord_y(3), coord_y(4), coord_y(5)};
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
#pragma unroll
            for (int j = 0; j < kVec; ++j) g[j] = gd[a];
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
#pragma unroll
            for (int j = 0; j < kVec; ++j) {
              s[k][j] = v00[j] * (w.z * w.x) + v01[j] * (w.z * w.y) + v10[j] * (w.w * w.x) +
                        v11[j] * (w.w * w.y);
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
        // t[k] = g * prod_{j != k} s[j], by prefix and suffix products
        float t[kPlanes][kVec];
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
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
#pragma unroll
        for (int k = 0; k < kPlanes; ++k) {
          const float4 w = live ? tents[k * run + a] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          const float* r0 = planes.ptr[k] + cell_off(k) + c;
          const float* r1 = r0 + planes.W[k] * C;
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
          if (want_planes) {
            const int off = cell_off(k);
            const unsigned int seg = segment_of(off, lane);
            float cw[4];
            corner_weights(w, cw);
            float q[4][kVec];
            int nonzero = 0;  // bit i: corner i has a non-zero tent weight
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              nonzero |= (cw[i] != 0.0f) << i;
#pragma unroll
              for (int j = 0; j < kVec; ++j) q[i][j] = t[k][j] * cw[i];
            }
            scatter<kVec>(planes, k, C, off, c, seg, q, nonzero, on, lane, stats);
          }
        }
      }
      if (want_xyz) {  // the pair's two shares, even lane first
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float other = __shfl_down_sync(kFull, gu[i], 1);
          if (live && (lane & 1) == 0) partials[(chunk * 3 + i) * run + a] = gu[i] + other;
        }
      }
    }
    __syncthreads();

    // phase 3: each active sample's grad_xyzt, its chunks added in order
    if (want_xyz) {
      for (int a = threadIdx.x; a < na; a += kBlock) {
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
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
PlaneSet<T> plane_set(const void* const* ptrs, const int* hw, float* const* plane_grads) {
  PlaneSet<T> planes;
  for (int k = 0; k < kPlanes; ++k) {
    planes.ptr[k] = static_cast<const T*>(ptrs[k]);
    planes.grad[k] = plane_grads != nullptr ? plane_grads[k] : nullptr;
    planes.H[k] = hw[2 * k];
    planes.W[k] = hw[2 * k + 1];
  }
  return planes;
}

}  // namespace

// s0..t2: the six planes, float32 (bf16 = 0) or their bf16 copies (bf16 = 1,
// ops/grid_sample.py:bf16_planes, row stride C).  hw: 12 host ints, (H, W)
// of the planes in the order s0, s1, s2, t0, t1, t2.  vec, run, smem_bytes:
// the wrapper's launch plan (ops/grid_sample.py:plane_product_bwd_plan): vec
// 4 (float32) or 8 (bf16) on the 16-byte path, else 1.  g_app: float32 in
// the float32 arm, bf16 in the bf16 arm.  plane_grads: six device pointers
// to zero-initialised float32 buffers shaped like the planes, or null when no
// plane gradient is wanted; g_xyzt: (P, 4) or null; stats: three device
// counters, or null.  Returns cudaErrorInvalidValue for a plan the inputs do
// not allow, else cudaGetLastError() after the launch.
extern "C" int nvfi_plane_product_bwd(const void* s0, const void* s1, const void* s2,
                                      const void* t0, const void* t1, const void* t2,
                                      const int* hw, const float* xyzt, int64_t P, int C,
                                      int Cd, int vec, int run, int smem_bytes, int bf16,
                                      const float* g_density, const void* g_app,
                                      float* const* plane_grads, float* g_xyzt,
                                      unsigned long long* stats, void* stream) {
  const void* ptrs[kPlanes] = {s0, s1, s2, t0, t1, t2};
  bool all_aligned = aligned16(g_app);
  for (int k = 0; k < kPlanes; ++k) {
    all_aligned = all_aligned && aligned16(ptrs[k]) &&
                  (plane_grads == nullptr || aligned16(plane_grads[k]));
  }
  // the wrapper's plan, checked: the 16-byte path is vec 4 in float32 and
  // vec 8 in bf16
  const int wide = bf16 ? 8 : 4;
  const bool wide_ok = C % wide == 0 && Cd % wide == 0 && all_aligned;
  const int chunks = bf16 ? 0 : (C + kChunkChannels - 1) / kChunkChannels;
  if ((bf16 != 0 && bf16 != 1) || (vec != 1 && vec != wide) || (vec == wide && !wide_ok) ||
      run < 1 || P < 1 || Cd < 0 || Cd > C || smem_bytes < smem_bytes_for(run, chunks) ||
      smem_bytes > 48 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned int blocks = (unsigned int)((P + run - 1) / run);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const auto planes = plane_set<__nv_bfloat16>(ptrs, hw, plane_grads);
    const auto* ga = static_cast<const __nv_bfloat16*>(g_app);
    if (vec == 8) {
      plane_product_bwd_kernel<8, true><<<blocks, kThreadsBf16, smem_bytes, s>>>(
          planes, xyzt, P, C, Cd, run, g_density, ga, g_xyzt, stats);
    } else {
      plane_product_bwd_kernel<1, true><<<blocks, kThreadsBf16, smem_bytes, s>>>(
          planes, xyzt, P, C, Cd, run, g_density, ga, g_xyzt, stats);
    }
  } else {
    const auto planes = plane_set<float>(ptrs, hw, plane_grads);
    const auto* ga = static_cast<const float*>(g_app);
    if (vec == 4) {
      plane_product_bwd_kernel<4, false><<<blocks, kThreads, smem_bytes, s>>>(
          planes, xyzt, P, C, Cd, run, g_density, ga, g_xyzt, stats);
    } else {
      plane_product_bwd_kernel<1, false><<<blocks, kThreads, smem_bytes, s>>>(
          planes, xyzt, P, C, Cd, run, g_density, ga, g_xyzt, stats);
    }
  }
  return (int)cudaGetLastError();
}
