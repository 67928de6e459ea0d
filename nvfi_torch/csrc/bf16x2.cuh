// Packed bf16 helpers shared by the bf16 arms of K1 (plane_product.cu) and
// K1b (plane_product_bwd.cu): kVec channels of a bf16 plane copy as channel
// pairs in __nv_bfloat162, their loads, and the bf16 lookup of JAX's
// grid_sample_2d_block(compute_dtype=bf16), so that the backward recomputes
// the very values the forward gave.
//
// Every op is __hmul2_rn / __hadd2_rn (mul.rn.bf16x2 / add.rn.bf16x2 on
// sm_90): each rounds the exact result once, which is JAX's "f32 op, then
// round to bf16": a product of two bf16 values is exact in f32, and a sum
// rounded to f32 and then to bf16 is rounded once, since 24 >= 2*8 + 2.
// Never an FMA (__hfma2) nor the contracting __hmul2 / __hadd2: one FMA
// rounds once where JAX rounds twice.

#pragma once

#include <cuda_bf16.h>
#include <string.h>

namespace {

__device__ __forceinline__ __nv_bfloat162 as_bf162(unsigned int u) {
  __nv_bfloat162 h;
  memcpy(&h, &u, sizeof(h));
  return h;
}

__device__ __forceinline__ unsigned int as_u32(__nv_bfloat162 h) {
  unsigned int u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

// kVec channels as pairs: kVec = 8 (4 pairs, one 16-byte load), or 1 (one
// pair whose low lane holds the channel and whose high lane repeats it)
template <int kVec>
struct Bf16Vals {
  static constexpr int kPairs = kVec == 1 ? 1 : kVec / 2;
  __nv_bfloat162 h[kPairs];
};

template <int kVec>
__device__ __forceinline__ Bf16Vals<kVec> load_bf16(const __nv_bfloat16* p) {
  Bf16Vals<kVec> v;
  if constexpr (kVec == 8) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    v.h[0] = as_bf162(t.x);
    v.h[1] = as_bf162(t.y);
    v.h[2] = as_bf162(t.z);
    v.h[3] = as_bf162(t.w);
  } else {
    v.h[0] = __bfloat162bfloat162(__ldg(p));
  }
  return v;
}

// The four tent products w00 w01 w10 w11 (f32) rounded to bf16, packed as
// w00 w01 | w10 w11
__device__ __forceinline__ uint2 bf16_weights(const float (&w)[4]) {
  return make_uint2(as_u32(__floats2bfloat162_rn(w[0], w[1])),
                    as_u32(__floats2bfloat162_rn(w[2], w[3])));
}

// The bilinear value from the four corners: (((r0 w0 + r1 w1) + r2 w2) +
// r3 w3), every product and sum rounded to bf16
template <int kVec>
__device__ __forceinline__ Bf16Vals<kVec> bf16_corners(const Bf16Vals<kVec>& v00,
                                                       const Bf16Vals<kVec>& v01,
                                                       const Bf16Vals<kVec>& v10,
                                                       const Bf16Vals<kVec>& v11, uint2 w) {
  const __nv_bfloat162 w01 = as_bf162(w.x), w23 = as_bf162(w.y);
  const __nv_bfloat162 w0 = __low2bfloat162(w01), w1 = __high2bfloat162(w01);
  const __nv_bfloat162 w2 = __low2bfloat162(w23), w3 = __high2bfloat162(w23);
  Bf16Vals<kVec> out;
#pragma unroll
  for (int j = 0; j < Bf16Vals<kVec>::kPairs; ++j) {
    __nv_bfloat162 acc = __hadd2_rn(__hmul2_rn(v00.h[j], w0), __hmul2_rn(v01.h[j], w1));
    acc = __hadd2_rn(acc, __hmul2_rn(v10.h[j], w2));
    out.h[j] = __hadd2_rn(acc, __hmul2_rn(v11.h[j], w3));
  }
  return out;
}

}  // namespace
