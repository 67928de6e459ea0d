// K3 occupancy_trilinear_fwd and K4 occupancy_nearest_fwd: the alpha-mask
// lookups of the eval render and of occupancy pruning.
//
// Replace (JAX reference, the function the TPU design planned as kernel B3):
//   K3  nvfi_tpu/fields/kplane.py:sample_alpha (:1039) = _to_mask_coords
//       (:1024) + nvfi_tpu/ops/grid_sample.py:grid_sample_3d (:227-260);
//   K4  nvfi_tpu/fields/kplane.py:sample_occupied (:1056-1084).
// On the TPU both stayed on XLA's gather (docs/pallas_decision.md §1-3).
//
// Per sample p, with xyz[p] normalized to the MODEL aabb (a0, a0 + asize):
//   world = (xyz + 1) * asize / 2 + a0               kplane.denormalize_coord
//   c     = (world - A0) * 2 / (A1 - A0) - 1         the mask's own aabb A
//   (skipped when renorm == 0: the two boxes are taken to be the same)
//   pix   = (c + 1) * 0.5 * (size - 1) per axis; x indexes W, y H, z D of the
//   (D, H, W) volume.
// K3: i0 = floor(pix), w1 = pix - i0, w0 = 1 - w1, corners i0 and i0 + 1 are
//   valid where 0 <= i <= size - 1, indices clipped, weight (wz*wy)*wx times
//   the validity, eight terms summed in the JAX order.  Output f32.
// K4: in_range = all(pix > -1 and pix < size); cell = clip(floor(pix), 0,
//   size - 2); out = dilated[cell] > 0 and in_range.  Output one byte.
//
// The cell index turns a float into an integer, so the coordinate maps keep
// the reference's operation order exactly: every step is a rounded single
// operation (__fmul_rn, __fadd_rn, __fdiv_rn: no FMA contraction, a true
// division, no reciprocal).  K3's sum uses the same intrinsics, so on one
// card it equals the plain PyTorch version bit for bit.
//
// K3's bound on the H100 at the bat main-path shape (P = 4096*686 samples,
// 199^3 volume): 33.7 MB of coords in and 11.2 MB out, 0.0134 ms at 3.35
// TB/s; the 31.5 MB volume and its 1.1 MB of cell bits stay in the 50 MB L2
// across the 40 launches of a frame.  What a thread does per sample is a
// chain of dependent steps (coords, three true divisions, the lookups, the
// sum), so latency and instruction throughput, not bytes, set its time.
//
// K3's design:
//   * Cell bits (ops/occupancy.py:occupancy_bits): one bit a cell, packed
//     along W into 32-bit words, 0 only where all eight corners of the cell
//     (K4's cell c = clip(floor(pix), 0, size - 2), corners c and c + 1
//     clipped to size - 1) hold +0.0 exactly.  The corners the trilinear sum
//     reads are always among cell c's, and its weights are finite and >= 0
//     for a finite pix, so there every term is +0 and the sum is exactly
//     +0.0: the kernel writes +0.0 after one 4-byte bit lookup, with no
//     corner gather and no sum.  A non-finite pix takes the full path.  In a
//     masked frame most samples lie in empty cells.
//   * One thread a sample and 31 registers, eight blocks of 256 threads on
//     each multiprocessor (__launch_bounds__(256, 8)): the most chains in
//     flight.  The coords are read with evict-first loads (__ldcs) and the
//     output written with evict-first stores (__stcs), so the streamed
//     arrays do not push the volume and the bits out of L2.  Staging a
//     block's coords in shared memory with 16-byte loads and giving a thread
//     two or four samples were slower on the card: the barrier and the
//     registers cost more chains in flight than the wider loads saved.
//
// K4's bound at the pruned train step's shapes (P = 87,808 samples of a
// train chunk, 262,144 of the PDE prefilter): 12 bytes of coords in and one
// byte out a sample, 1.1 MB and 3.4 MB, plus the 32-byte sectors of the
// occupied bits that the samples' cells fall in: 0.4-1.1 us at 3.35 TB/s,
// below the launch floor of its grid (chip_smoke.py, phase `floor`).  A
// launch this small is latency: the coords' DRAM round trip, the three true
// divisions, the dependent lookup and the store of each chain.
//
// K4's design:
//   * Occupied bits (ops/occupancy.py:occupied_bits): bit c_x % 32 of word
//     (c_z, c_y, c_x / 32) is dilated[c] > 0, in K3's layout; exact for any
//     dilated volume (NaN, -0.0, negative or non-binary values included),
//     1.1 MB for 199^3 where the f32 volume is 31.5 MB, so the step's 33
//     launches find them in L2.  The kernel reads only the bits.
//   * One thread a sample in blocks of 128, the coords read with evict-first
//     loads: the most chains in flight at both shapes, which fit in one wave
//     of the H100's resident threads.  Two, four or eight samples a thread
//     (16-byte coord loads, the lookups issued together, one wide store)
//     and blocks of 256 were slower there; PERF.md keeps their times.
//   * The pixel coords come from K3's mask_pixels, so the cell is the plain
//     version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNearestThreads = 128;  // K4
constexpr int kTrilinearBlocksPerSM = 8;  // K3: 2048 threads, all an SM holds

struct Box {
  float a0[3];     // model aabb, low corner
  float asize[3];  // model aabb, high - low
};

// (c + 1) * 0.5 * (size - 1) of a sample's three mask coords
__device__ __forceinline__ void mask_pixels(const float xyz[3], const Box& box,
                                            const float* __restrict__ mask_aabb, int renorm,
                                            int W, int H, int D, float pix[3]) {
  const int size[3] = {W, H, D};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float c = xyz[k];
    if (renorm) {
      const float world = __fadd_rn(
          __fmul_rn(__fmul_rn(__fadd_rn(c, 1.0f), box.asize[k]), 0.5f), box.a0[k]);
      const float A0 = __ldg(mask_aabb + k), A1 = __ldg(mask_aabb + 3 + k);
      c = __fadd_rn(
          __fdiv_rn(__fmul_rn(__fsub_rn(world, A0), 2.0f), __fsub_rn(A1, A0)), -1.0f);
    }
    pix[k] = __fmul_rn(__fmul_rn(__fadd_rn(c, 1.0f), 0.5f), (float)(size[k] - 1));
  }
}

// K4's cell on one axis: clip(floor(pix), 0, size - 2); 0 on an axis of size 1
__device__ __forceinline__ int mask_cell(float pix, int size) {
  return min(max(__float2int_rd(pix), 0), max(size - 2, 0));
}

__global__ void __launch_bounds__(kThreads, kTrilinearBlocksPerSM)
occupancy_trilinear_fwd_kernel(const float* __restrict__ volume, int D, int H, int W,
                               const uint32_t* __restrict__ bits,
                               const float* __restrict__ xyz, int64_t P, Box box,
                               const float* __restrict__ mask_aabb, int renorm,
                               float* __restrict__ out) {
  const int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const float c[3] = {__ldcs(xyz + 3 * p), __ldcs(xyz + 3 * p + 1), __ldcs(xyz + 3 * p + 2)};
  float pix[3];
  mask_pixels(c, box, mask_aabb, renorm, W, H, D, pix);
  if (isfinite(pix[0]) && isfinite(pix[1]) && isfinite(pix[2])) {
    const int cx = mask_cell(pix[0], W), cy = mask_cell(pix[1], H), cz = mask_cell(pix[2], D);
    const int words = (max(W - 1, 1) + 31) >> 5;
    const uint32_t word = __ldg(bits + ((int64_t)cz * max(H - 1, 1) + cy) * words + (cx >> 5));
    if (((word >> (cx & 31)) & 1u) == 0) {  // all eight corners +0.0: the sum is +0.0
      __stcs(out + p, 0.0f);
      return;
    }
  }
  const int size[3] = {W, H, D};
  int idx[3][2], i0[3];
  float w[3][2];  // weight, per axis and corner
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float x0 = floorf(pix[k]);
    w[k][1] = __fsub_rn(pix[k], x0);
    w[k][0] = __fsub_rn(1.0f, w[k][1]);
    i0[k] = __float2int_rd(pix[k]);
    idx[k][0] = min(max(i0[k], 0), size[k] - 1);
    idx[k][1] = min(max(i0[k] + 1, 0), size[k] - 1);
  }
  float v[8];  // every corner gather in flight before the sum
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    const int cz = corner >> 2, cy = (corner >> 1) & 1, cx = corner & 1;
    v[corner] = __ldg(volume + ((int64_t)idx[2][cz] * H + idx[1][cy]) * W + idx[0][cx]);
  }
  const int last[3] = {W - 1, H - 1, D - 1};
  float acc = 0.0f;
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    // JAX order: z outermost, then y, then x
    const int cz = corner >> 2, cy = (corner >> 1) & 1, cx = corner & 1;
    const int rz = i0[2] + cz, ry = i0[1] + cy, rx = i0[0] + cx;
    const bool ok = rz >= 0 && rz <= last[2] && ry >= 0 && ry <= last[1] && rx >= 0 &&
                    rx <= last[0];
    const float wt = __fmul_rn(__fmul_rn(__fmul_rn(w[2][cz], w[1][cy]), w[0][cx]),
                               ok ? 1.0f : 0.0f);
    const float term = __fmul_rn(v[corner], wt);
    acc = corner == 0 ? term : __fadd_rn(acc, term);
  }
  __stcs(out + p, acc);
}

// K4: one thread a sample; reads the occupied bits of the dilated volume.
__global__ void __launch_bounds__(kNearestThreads)
occupancy_nearest_fwd_kernel(const uint32_t* __restrict__ occupied, int D, int H, int W,
                             const float* __restrict__ xyz, int64_t P, Box box,
                             const float* __restrict__ mask_aabb, int renorm,
                             uint8_t* __restrict__ out) {
  const int64_t p = (int64_t)blockIdx.x * kNearestThreads + threadIdx.x;
  if (p >= P) return;
  const float c[3] = {__ldcs(xyz + 3 * p), __ldcs(xyz + 3 * p + 1), __ldcs(xyz + 3 * p + 2)};
  float pix[3];
  mask_pixels(c, box, mask_aabb, renorm, W, H, D, pix);
  const int size[3] = {W, H, D};
  bool in_range = true;
  int cell[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    in_range = in_range && pix[k] > -1.0f && pix[k] < (float)size[k];
    cell[k] = mask_cell(pix[k], size[k]);
  }
  const int words = (max(W - 1, 1) + 31) >> 5;
  const uint32_t word = __ldg(occupied + (cell[2] * max(H - 1, 1) + cell[1]) * words +
                              (cell[0] >> 5));
  out[p] = (((word >> (cell[0] & 31)) & 1u) && in_range) ? 1 : 0;
}

Box make_box(const float* a0, const float* asize) {
  Box box;
  for (int k = 0; k < 3; ++k) {
    box.a0[k] = a0[k];
    box.asize[k] = asize[k];
  }
  return box;
}

}  // namespace

// volume: (D, H, W) f32 on the device; bits: its cell bits, (max(D-1, 1),
// max(H-1, 1), ceil(max(W-1, 1) / 32)) 32-bit words on the device; xyz:
// (P, 3) f32; a0, asize: 3 host floats each (the model aabb); mask_aabb: 6
// f32 on the device (low corner, high corner).  Returns cudaGetLastError()
// after the launch.
extern "C" int nvfi_occupancy_trilinear_fwd(const float* volume, int D, int H, int W,
                                            const uint32_t* bits, const float* xyz, int64_t P,
                                            const float* a0, const float* asize,
                                            const float* mask_aabb, int renorm, float* out,
                                            void* stream) {
  const int64_t blocks = (P + kThreads - 1) / kThreads;
  occupancy_trilinear_fwd_kernel<<<(unsigned int)blocks, kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      volume, D, H, W, bits, xyz, P, make_box(a0, asize), mask_aabb, renorm, out);
  return (int)cudaGetLastError();
}

// occupied: the occupied bits of the corner-dilated (D, H, W) volume, one
// bit a cell in K3's layout, (max(D-1, 1), max(H-1, 1), ceil(max(W-1, 1) /
// 32)) 32-bit words on the device; xyz: (P, 3) f32; a0, asize: 3 host floats
// each (the model aabb); mask_aabb: 6 f32 on the device.  Returns
// cudaGetLastError() after the launch.
extern "C" int nvfi_occupancy_nearest_fwd(const uint32_t* occupied, int D, int H, int W,
                                          const float* xyz, int64_t P, const float* a0,
                                          const float* asize, const float* mask_aabb,
                                          int renorm, uint8_t* out, void* stream) {
  const int64_t blocks = (P + kNearestThreads - 1) / kNearestThreads;
  occupancy_nearest_fwd_kernel<<<(unsigned int)blocks, kNearestThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      occupied, D, H, W, xyz, P, make_box(a0, asize), mask_aabb, renorm, out);
  return (int)cudaGetLastError();
}
