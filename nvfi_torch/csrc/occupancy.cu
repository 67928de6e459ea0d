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
// Design: one thread per sample.  Bound at the bat main-path shape
// (P = 4096*686 samples, 199^3 volume): 33.7 MB of coords, 11.2 MB out and
// the 31.5 MB volume read once, 0.023 ms at 3.35 TB/s.  The volume fits in
// the 50 MB L2 and the samples of a ray walk neighbouring cells; the eight
// corner loads are 4-byte gathers, two per 32-byte sector along W.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Box {
  float a0[3];     // model aabb, low corner
  float asize[3];  // model aabb, high - low
};

// (c + 1) * 0.5 * (size - 1) of the sample's three mask coords
__device__ __forceinline__ void mask_pixels(const float* __restrict__ xyz, int64_t p,
                                            const Box& box,
                                            const float* __restrict__ mask_aabb, int renorm,
                                            int W, int H, int D, float pix[3]) {
  const int size[3] = {W, H, D};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float c = __ldg(xyz + 3 * p + k);
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

__global__ void __launch_bounds__(kThreads)
occupancy_trilinear_fwd_kernel(const float* __restrict__ volume, int D, int H, int W,
                               const float* __restrict__ xyz, int64_t P, Box box,
                               const float* __restrict__ mask_aabb, int renorm,
                               float* __restrict__ out) {
  const int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  float pix[3];
  mask_pixels(xyz, p, box, mask_aabb, renorm, W, H, D, pix);

  const int size[3] = {W, H, D};
  int idx[3][2];
  float w[3][2];  // weight times validity, per axis and corner
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float x0 = floorf(pix[k]);
    const float w1 = __fsub_rn(pix[k], x0);
    const float w0 = __fsub_rn(1.0f, w1);
    const int i0 = __float2int_rd(pix[k]);
    const int i1 = i0 + 1;
    idx[k][0] = min(max(i0, 0), size[k] - 1);
    idx[k][1] = min(max(i1, 0), size[k] - 1);
    w[k][0] = w0;
    w[k][1] = w1;
  }
  const int last[3] = {W - 1, H - 1, D - 1};
  float acc = 0.0f;
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    // JAX order: z outermost, then y, then x
    const int cz = corner >> 2, cy = (corner >> 1) & 1, cx = corner & 1;
    const int rz = __float2int_rd(pix[2]) + cz, ry = __float2int_rd(pix[1]) + cy,
              rx = __float2int_rd(pix[0]) + cx;
    const bool ok = rz >= 0 && rz <= last[2] && ry >= 0 && ry <= last[1] && rx >= 0 &&
                    rx <= last[0];
    const float wt = __fmul_rn(__fmul_rn(__fmul_rn(w[2][cz], w[1][cy]), w[0][cx]),
                               ok ? 1.0f : 0.0f);
    const float v = __ldg(volume + ((int64_t)idx[2][cz] * H + idx[1][cy]) * W + idx[0][cx]);
    const float term = __fmul_rn(v, wt);
    acc = corner == 0 ? term : __fadd_rn(acc, term);
  }
  out[p] = acc;
}

__global__ void __launch_bounds__(kThreads)
occupancy_nearest_fwd_kernel(const float* __restrict__ dilated, int D, int H, int W,
                             const float* __restrict__ xyz, int64_t P, Box box,
                             const float* __restrict__ mask_aabb, int renorm,
                             uint8_t* __restrict__ out) {
  const int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  float pix[3];
  mask_pixels(xyz, p, box, mask_aabb, renorm, W, H, D, pix);
  const int size[3] = {W, H, D};
  bool in_range = true;
  int cell[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    in_range = in_range && pix[k] > -1.0f && pix[k] < (float)size[k];
    cell[k] = min(max(__float2int_rd(pix[k]), 0), max(size[k] - 2, 0));
  }
  const float v = __ldg(dilated + ((int64_t)cell[2] * H + cell[1]) * W + cell[0]);
  out[p] = (v > 0.0f && in_range) ? 1 : 0;
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

// volume: (D, H, W) f32 on the device; xyz: (P, 3) f32; a0, asize: 3 host
// floats each (the model aabb); mask_aabb: 6 f32 on the device (low corner,
// high corner).  Returns cudaGetLastError() after the launch.
extern "C" int nvfi_occupancy_trilinear_fwd(const float* volume, int D, int H, int W,
                                            const float* xyz, int64_t P, const float* a0,
                                            const float* asize, const float* mask_aabb,
                                            int renorm, float* out, void* stream) {
  const int64_t blocks = (P + kThreads - 1) / kThreads;
  occupancy_trilinear_fwd_kernel<<<(unsigned int)blocks, kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      volume, D, H, W, xyz, P, make_box(a0, asize), mask_aabb, renorm, out);
  return (int)cudaGetLastError();
}

extern "C" int nvfi_occupancy_nearest_fwd(const float* dilated, int D, int H, int W,
                                          const float* xyz, int64_t P, const float* a0,
                                          const float* asize, const float* mask_aabb,
                                          int renorm, uint8_t* out, void* stream) {
  const int64_t blocks = (P + kThreads - 1) / kThreads;
  occupancy_nearest_fwd_kernel<<<(unsigned int)blocks, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      dilated, D, H, W, xyz, P, make_box(a0, asize), mask_aabb, renorm, out);
  return (int)cudaGetLastError();
}
