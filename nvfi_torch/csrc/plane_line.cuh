// Shared pieces of K6 / K6d (plane_line.cu) and K6b (plane_line_bwd.cu):
// the argument structs and the zeros-padded plane and line lookups of the
// static TensoRF field (nvfi_tpu/ops/grid_sample.py:22-66, :209-224).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nvfi_plane_line {

constexpr int kFwdThreads = 256;  // ops/plane_line.py PLANE_LINE_THREADS
constexpr int kBwdThreads = 256;

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
// outside (the plain version's w * valid, which is w or 0)
struct Lin {
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

// the four corners of a plane lookup, in the order y0x0, y0x1, y1x0, y1x1:
// element offsets of their rows and their weights wy * wx
struct Quad {
  int64_t off[4];
  float w[4];
};

__device__ __forceinline__ Quad plane_corners(float u, float v, int H, int W, int C) {
  const Lin cx = linear_corners(u, W), cy = linear_corners(v, H);
  Quad q;
  q.off[0] = ((int64_t)cy.i0 * W + cx.i0) * C;
  q.off[1] = ((int64_t)cy.i0 * W + cx.i1) * C;
  q.off[2] = ((int64_t)cy.i1 * W + cx.i0) * C;
  q.off[3] = ((int64_t)cy.i1 * W + cx.i1) * C;
  q.w[0] = __fmul_rn(cy.w0, cx.w0);
  q.w[1] = __fmul_rn(cy.w0, cx.w1);
  q.w[2] = __fmul_rn(cy.w1, cx.w0);
  q.w[3] = __fmul_rn(cy.w1, cx.w1);
  return q;
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

// kVec channels from c0 of a plane at its four corners: the corner terms
// summed in the JAX order ((c00 + c01) + c10) + c11
template <int kVec>
__device__ __forceinline__ void plane_value(const float* plane, const Quad& q, int c0,
                                            float (&out)[kVec]) {
  float r[kVec];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    load<kVec>(plane + q.off[k] + c0, r);
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      const float t = __fmul_rn(r[c], q.w[k]);
      out[c] = k ? __fadd_rn(out[c], t) : t;
    }
  }
}

// kVec channels from c0 of a line at its two corners
template <int kVec>
__device__ __forceinline__ void line_value(const float* line, const Lin& l, int C, int c0,
                                           float (&out)[kVec]) {
  float a[kVec], b[kVec];
  load<kVec>(line + (int64_t)l.i0 * C + c0, a);
  load<kVec>(line + (int64_t)l.i1 * C + c0, b);
#pragma unroll
  for (int c = 0; c < kVec; ++c) out[c] = __fadd_rn(__fmul_rn(a[c], l.w0), __fmul_rn(b[c], l.w1));
}

// the arrays one work item reads, picked from the kernel's arguments by
// value (selects of their fields, no copy of an argument struct)
struct Pick {
  const float* plane;    // VM: the mode's plane
  const float* line[3];  // VM: the mode's line in [0]; CP: the three lines
  int C, H, W, L[3];
};

__device__ __forceinline__ Pick pick_vm(const Field& dens, const Field& app, bool is_app,
                                        const Geometry& g, int mode) {
  Pick k;
  k.plane = is_app ? sel3(app.plane, mode) : sel3(dens.plane, mode);
  k.line[0] = is_app ? sel3(app.line, mode) : sel3(dens.line, mode);
  k.line[1] = k.line[2] = nullptr;
  k.C = is_app ? app.C : dens.C;
  k.H = sel3(g.ph, mode);
  k.W = sel3(g.pw, mode);
  k.L[0] = sel3(g.ll, mode);
  k.L[1] = k.L[2] = 0;
  return k;
}

__device__ __forceinline__ Pick pick_cp(const Field& dens, const Field& app, bool is_app,
                                        const Geometry& g) {
  Pick k;
  k.plane = nullptr;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    k.line[i] = is_app ? app.line[i] : dens.line[i];
    k.L[i] = g.ll[i];
  }
  k.C = is_app ? app.C : dens.C;
  k.H = k.W = 0;
  return k;
}

// VM: plane_mode(x[m0], x[m1]) * line_mode(x[2 - mode]), channels c0..c0+kVec
template <int kVec>
__device__ __forceinline__ void lookup_vm(const Pick& k, int mode, const float* x, int c0,
                                          float (&v)[kVec]) {
  const Quad q = plane_corners(x[mat_m0(mode)], x[mat_m1(mode)], k.H, k.W, k.C);
  const Lin l = linear_corners(x[2 - mode], k.L[0]);
  float p[kVec], s[kVec];
  plane_value<kVec>(k.plane, q, c0, p);
  line_value<kVec>(k.line[0], l, k.C, c0, s);
#pragma unroll
  for (int c = 0; c < kVec; ++c) v[c] = __fmul_rn(p[c], s[c]);
}

// CP: (s_0 * s_1) * s_2, s_i = line_i(x[2 - i])
template <int kVec>
__device__ __forceinline__ void lookup_cp(const Pick& k, const float* x, int c0,
                                          float (&v)[kVec]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float s[kVec];
    line_value<kVec>(k.line[i], linear_corners(x[2 - i], k.L[i]), k.C, c0, s);
#pragma unroll
    for (int c = 0; c < kVec; ++c) v[c] = i ? __fmul_rn(v[c], s[c]) : s[c];
  }
}

}  // namespace nvfi_plane_line
