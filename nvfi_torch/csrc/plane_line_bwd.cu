// K6b plane_line_bwd: the gradient of K6 (csrc/plane_line.cu) with respect
// to the static TensoRF planes and lines, VM and CP arms.
//
// Replaces the VJP that XLA derives for the JAX package's static lookup,
// nvfi_tpu/fields/tensorf_vm.py:density_feature (:119-134) and app_feature
// (:137-151) through ops/grid_sample.py:grid_sample_2d / grid_sample_1d:
// for a sample, mode i and channel c with incoming grad g (g_density for
// every density channel, g_app[i Ca + c] for the app ones),
//   VM: f = p * l with p the plane's bilinear value and l the line's linear
//       value: the plane's four corners get w_k * g * l and the line's two
//       corners w_j * g * p;
//   CP: f = (s_0 * s_1) * s_2: line i's two corners get w_j * g * (the
//       product of the other two), in the rounding order of that product.
// Out-of-range corners weigh zero and get nothing.  The coords get no
// gradient: the static render's samples are not trained (ops/plane_line.py
// refuses an xyz that requires one).
//
// Bound: bytes.  g_density and g_app in (4 + 4 * 3 Ca B a sample, 580 B at
// bat's widths), xyz (12 B) for the samples whose incoming grad is not all
// zero, and the grad sectors those samples touch written once.  The
// static render zeroes the colour of samples at or below the weight
// threshold, so most samples of a step carry a zero app grad, and samples
// outside the box a zero density grad.
//
// The hot rows: a line has one row a grid point (199 at bat), so the three
// lines of a kind take every line update of 1.4 M samples on a few thousand
// rows; one global atomic each would serialize on them.  So a block owns a
// run of samples and one chunk of at most 24 channels of one kind, and sums
// its line grads for that chunk in shared memory (the three lines x their
// rows x the chunk, at most 48 KB: ops/plane_line.py:plane_line_bwd_plan),
// with shared-memory atomics; at the end it adds each non-zero group of the
// sums to the global grads with one atomic (float4 on the 16-byte path).
// The plane grads, spread over 199^2 rows a plane, take a global atomic a
// corner, skipped where the corner weighs zero.  Work items are (sample,
// mode, group of kVec channels) of the block's chunk, spread over its
// threads; an item whose incoming grad is all zero does nothing.  Grads are
// summed with atomics, so their last bits change from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "plane_line.cuh"

namespace {

using namespace nvfi_plane_line;

constexpr int kThreads = kBwdThreads;

// the grads of one kind, shaped like its planes (VM; null in CP) and lines
struct Grads {
  float* plane[3];
  float* line[3];
};

Grads make_grads(void* const* ptrs) {
  Grads g;
  for (int i = 0; i < 3; ++i) {
    g.plane[i] = static_cast<float*>(ptrs[i]);
    g.line[i] = static_cast<float*>(ptrs[3 + i]);
  }
  return g;
}

template <int kVec>
__device__ __forceinline__ void atomic_add_global(float* p, const float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    atomicAdd(p, v[0]);
  }
}

// w_j * g into the two rows of a line's shared-memory sums (row stride `chunk`)
template <int kVec>
__device__ __forceinline__ void add_line(float* acc, const Lin& l, int chunk, int cl,
                                         const float (&g)[kVec]) {
  if (l.w0 != 0.0f) {
#pragma unroll
    for (int q = 0; q < kVec; ++q) atomicAdd(acc + l.i0 * chunk + cl + q, __fmul_rn(g[q], l.w0));
  }
  if (l.w1 != 0.0f) {
#pragma unroll
    for (int q = 0; q < kVec; ++q) atomicAdd(acc + l.i1 * chunk + cl + q, __fmul_rn(g[q], l.w1));
  }
}

template <int kVec, bool kCP>
__global__ void __launch_bounds__(kThreads)
plane_line_bwd_kernel(const Field dens, const Field app, const Grads gdens, const Grads gapp,
                      const Geometry geo, const float* __restrict__ xyz, int64_t P, int run,
                      int chunk, int d_chunks, const float* __restrict__ g_density,
                      const float* __restrict__ g_app) {
  extern __shared__ float acc[];  // line i's rows x chunk, the three lines one after another
  const bool is_app = (int)blockIdx.y >= d_chunks;
  const int C = is_app ? app.C : dens.C;
  const int ch0 = (is_app ? (int)blockIdx.y - d_chunks : (int)blockIdx.y) * chunk;
  const int groups = min(chunk, C - ch0) / kVec;
  const int base[3] = {0, geo.ll[0] * chunk, (geo.ll[0] + geo.ll[1]) * chunk};
  const int rows = geo.ll[0] + geo.ll[1] + geo.ll[2];
  for (int j = threadIdx.x; j < rows * chunk; j += kThreads) acc[j] = 0.0f;
  __syncthreads();

  const int modes = kCP ? 1 : 3;
  const int items = modes * groups;
  const int app_width = modes * app.C;
  const int64_t p0 = (int64_t)blockIdx.x * run;
  const int n = (int)min((int64_t)run, P - p0);
  for (int j = threadIdx.x; j < n * items; j += kThreads) {
    const int r = j / items, k = j - r * items;
    const int mode = kCP ? 0 : k / groups;
    const int cl = (k - mode * groups) * kVec;  // the channel in the chunk
    const int c = ch0 + cl;                      // and in the kind
    const int64_t p = p0 + r;
    float g[kVec];
    if (is_app) {
      load<kVec>(g_app + p * app_width + mode * C + c, g);
    } else {
      const float gd = __ldg(g_density + p);
#pragma unroll
      for (int q = 0; q < kVec; ++q) g[q] = gd;
    }
    bool any = false;
#pragma unroll
    for (int q = 0; q < kVec; ++q) any |= g[q] != 0.0f;
    if (!any) continue;
    const float* x = xyz + p * 3;
    if constexpr (kCP) {
      const Pick pk = pick_cp(dens, app, is_app, geo);
      Lin l[3];
      float s[3][kVec];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        l[i] = linear_corners(__ldg(x + 2 - i), pk.L[i]);
        line_value<kVec>(pk.line[i], l[i], C, c, s[i]);
      }
      // f = (s0 * s1) * s2: d s2 = g (s0 s1); d s0 = (g s2) s1; d s1 = (g s2) s0
      float gs[3][kVec];
#pragma unroll
      for (int q = 0; q < kVec; ++q) {
        const float g2 = __fmul_rn(g[q], s[2][q]);
        gs[0][q] = __fmul_rn(g2, s[1][q]);
        gs[1][q] = __fmul_rn(g2, s[0][q]);
        gs[2][q] = __fmul_rn(g[q], __fmul_rn(s[0][q], s[1][q]));
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) add_line<kVec>(acc + base[i], l[i], chunk, cl, gs[i]);
    } else {
      const Pick pk = pick_vm(dens, app, is_app, geo, mode);
      const Quad qd = plane_corners(__ldg(x + mat_m0(mode)), __ldg(x + mat_m1(mode)), pk.H,
                                    pk.W, C);
      const Lin l = linear_corners(__ldg(x + 2 - mode), pk.L[0]);
      float pv[kVec], lv[kVec], gp[kVec], gl[kVec];
      plane_value<kVec>(pk.plane, qd, c, pv);
      line_value<kVec>(pk.line[0], l, C, c, lv);
#pragma unroll
      for (int q = 0; q < kVec; ++q) {
        gp[q] = __fmul_rn(g[q], lv[q]);
        gl[q] = __fmul_rn(g[q], pv[q]);
      }
      float* gplane = is_app ? sel3(gapp.plane, mode) : sel3(gdens.plane, mode);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (qd.w[kk] == 0.0f) continue;
        float v[kVec];
#pragma unroll
        for (int q = 0; q < kVec; ++q) v[q] = __fmul_rn(gp[q], qd.w[kk]);
        atomic_add_global<kVec>(gplane + qd.off[kk] + c, v);
      }
      add_line<kVec>(acc + sel3(base, mode), l, chunk, cl, gl);
    }
  }
  __syncthreads();

  // flush: each non-zero group of the sums, one global atomic
  for (int j = threadIdx.x; j < rows * groups; j += kThreads) {
    int row = j / groups;
    const int grp = j - row * groups;
    int line = 0;
    if (row >= geo.ll[0]) {
      row -= geo.ll[0];
      line = 1;
      if (row >= geo.ll[1]) {
        row -= geo.ll[1];
        line = 2;
      }
    }
    const float* a = acc + sel3(base, line) + row * chunk + grp * kVec;
    float v[kVec];
    bool any = false;
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      v[q] = a[q];
      any |= v[q] != 0.0f;
    }
    if (!any) continue;
    float* gline = is_app ? sel3(gapp.line, line) : sel3(gdens.line, line);
    atomic_add_global<kVec>(gline + (int64_t)row * C + ch0 + grp * kVec, v);
  }
}

template <int kVec, bool kCP>
int launch(const Field& dens, const Field& app, const Grads& gd, const Grads& ga,
           const Geometry& geo, const float* xyz, int64_t P, int run, int chunk, int d_chunks,
           int a_chunks, int smem_bytes, const float* g_density, const float* g_app,
           cudaStream_t s) {
  const dim3 grid((unsigned int)((P + run - 1) / run), (unsigned int)(d_chunks + a_chunks));
  plane_line_bwd_kernel<kVec, kCP><<<grid, kThreads, smem_bytes, s>>>(
      dens, app, gd, ga, geo, xyz, P, run, chunk, d_chunks, g_density, g_app);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: the 12 device pointers K6 reads (density planes, density lines, app
// planes, app lines; planes null in the CP arm); grads: 12 device pointers
// shaped like them, zeroed by the caller, the kernel adds to them; dims:
// the planes' H[3], W[3] and the lines' L[3]; xyz (P, 3); g_density (P,);
// g_app (P, 3 Ca) (VM) or (P, Ca) (CP); run, chunk, the chunks of each kind
// and smem_bytes from ops/plane_line.py:plane_line_bwd_plan.  Returns
// cudaGetLastError() after the launch.
extern "C" int nvfi_plane_line_bwd(const void* const* ptrs, void* const* grads, const int* dims,
                                   const float* xyz, int64_t P, int Cd, int Ca, int vec,
                                   int run, int chunk, int d_chunks, int a_chunks,
                                   int smem_bytes, int cp, const float* g_density,
                                   const float* g_app, void* stream) {
  const Field fd = make_field(ptrs, Cd), fa = make_field(ptrs + 6, Ca);
  const Grads gd = make_grads(grads), ga = make_grads(grads + 6);
  const Geometry geo = make_geometry(dims);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    return cp ? launch<4, true>(fd, fa, gd, ga, geo, xyz, P, run, chunk, d_chunks, a_chunks,
                                smem_bytes, g_density, g_app, s)
              : launch<4, false>(fd, fa, gd, ga, geo, xyz, P, run, chunk, d_chunks, a_chunks,
                                 smem_bytes, g_density, g_app, s);
  }
  return cp ? launch<1, true>(fd, fa, gd, ga, geo, xyz, P, run, chunk, d_chunks, a_chunks,
                              smem_bytes, g_density, g_app, s)
            : launch<1, false>(fd, fa, gd, ga, geo, xyz, P, run, chunk, d_chunks, a_chunks,
                               smem_bytes, g_density, g_app, s);
}
