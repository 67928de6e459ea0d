// Shared pieces of K6 / K6d (plane_line.cu) and K6b (plane_line_bwd.cu):
// the argument structs, the zeros-padded linear lookup along one axis, and
// the corner rows of a plane cell or a line segment with their bilinear and
// linear values (nvfi_tpu/ops/grid_sample.py:22-66, :209-224).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nvfi_plane_line {

constexpr int kThreads = 256;  // the most threads a block (ops/plane_line.py)

// one kind of channels (density or app): three planes (VM; null in CP) and
// three lines, C channels each
struct Field {
  const float* plane[3];
  const float* line[3];
  int C;
};

// plane i is (ph[i], pw[i], C), line i is (ll[i], C)
struct Geometry {
  int ph[3], pw[3], ll[3];
};

inline Field make_field(const void* const* ptrs, int C) {
  Field f;
  for (int i = 0; i < 3; ++i) {
    f.plane[i] = static_cast<const float*>(ptrs[i]);
    f.line[i] = static_cast<const float*>(ptrs[3 + i]);
  }
  f.C = C;
  return f;
}

inline Geometry make_geometry(const int* dims) {
  Geometry g;
  for (int i = 0; i < 3; ++i) {
    g.ph[i] = dims[i];
    g.pw[i] = dims[3 + i];
    g.ll[i] = dims[6 + i];
  }
  return g;
}

template <typename T>
__device__ __forceinline__ T sel3(const T (&a)[3], int i) {
  return i == 0 ? a[0] : (i == 1 ? a[1] : a[2]);
}

// MAT_SPACE[mode] = (m0, m1): (0, 1), (0, 2), (1, 2); VEC_MODE[mode] = 2 - mode
__device__ __forceinline__ int mat_m0(int mode) { return mode == 2 ? 1 : 0; }
__device__ __forceinline__ int mat_m1(int mode) { return mode == 0 ? 1 : 2; }

// the two corners of a linear lookup along an axis of `size` points:
// indices clamped into [0, size - 1], weights zero where a corner lies
// outside (the plain version's w * valid, which is w or 0).  Every plane
// and line lookup of a sample takes its corners along one of the three
// axes, so a sample's three Lin values, one an axis, serve them all.
struct __align__(16) Lin {
  int i0, i1;
  float w0, w1;
};

__device__ __forceinline__ Lin linear_corners(float u, int size) {
  const float x = __fmul_rn(__fmul_rn(__fadd_rn(u, 1.0f), 0.5f), (float)(size - 1));
  const float x0 = floorf(x);
  const float w1 = __fsub_rn(x, x0);
  const float w0 = __fsub_rn(1.0f, w1);
  // x0 is integral; clamped first so that neither conversion nor i0 + 1 overflows
  const int i0 = (int)fminf(fmaxf(x0, -2.0f), (float)size);
  Lin c;
  c.i0 = min(max(i0, 0), size - 1);
  c.i1 = min(max(i0 + 1, 0), size - 1);
  c.w0 = (i0 >= 0 && i0 <= size - 1) ? w0 : 0.0f;
  c.w1 = (i0 >= -1 && i0 <= size - 2) ? w1 : 0.0f;
  return c;
}

// the points along axis a: line 2 - a lies along it
__device__ __forceinline__ int axis_size(const Geometry& g, int a) { return sel3(g.ll, 2 - a); }

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

// the plane weights wy * wx of corners y0x0, y0x1, y1x0, y1x1
__device__ __forceinline__ void plane_weights(const Lin& cy, const Lin& cx, float (&w)[4]) {
  w[0] = __fmul_rn(cy.w0, cx.w0);
  w[1] = __fmul_rn(cy.w0, cx.w1);
  w[2] = __fmul_rn(cy.w1, cx.w0);
  w[3] = __fmul_rn(cy.w1, cx.w1);
}

// kVec channels from c0 of the four corner rows of the plane cell a lane
// is in, in the order y0x0, y0x1, y1x0, y1x1 (row = y W + x), with their
// row indices.
template <int kVec>
struct PlaneRows {
  int row[4];
  float r[4][kVec];

  __device__ __forceinline__ void fetch(const float* plane, int W, int C, int c0, const Lin& cy,
                                        const Lin& cx) {
    row[0] = cy.i0 * W + cx.i0;
    row[1] = cy.i0 * W + cx.i1;
    row[2] = cy.i1 * W + cx.i0;
    row[3] = cy.i1 * W + cx.i1;
#pragma unroll
    for (int k = 0; k < 4; ++k) load<kVec>(plane + row[k] * C + c0, r[k]);
  }

  // the bilinear value: the corner terms summed in the JAX order
  // ((c00 + c01) + c10) + c11
  __device__ __forceinline__ void value(const float (&w)[4], float (&out)[kVec]) const {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        const float t = __fmul_rn(r[k][c], w[k]);
        out[c] = k ? __fadd_rn(out[c], t) : t;
      }
    }
  }
};

// kVec channels from c0 of the two rows of a line segment a lane is in
template <int kVec>
struct LineRows {
  int row[2];
  float r[2][kVec];

  __device__ __forceinline__ void clear() { row[0] = row[1] = -1; }

  __device__ __forceinline__ bool moved(const Lin& l) const {
    return l.i0 != row[0] || l.i1 != row[1];
  }

  __device__ __forceinline__ void fetch(const float* line, int C, int c0, const Lin& l) {
    row[0] = l.i0;
    row[1] = l.i1;
    load<kVec>(line + l.i0 * C + c0, r[0]);
    load<kVec>(line + l.i1 * C + c0, r[1]);
  }

  __device__ __forceinline__ void value(const Lin& l, float (&out)[kVec]) const {
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      out[c] = __fadd_rn(__fmul_rn(r[0][c], l.w0), __fmul_rn(r[1][c], l.w1));
    }
  }
};

}  // namespace nvfi_plane_line
