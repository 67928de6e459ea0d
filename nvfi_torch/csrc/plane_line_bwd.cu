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
// Design: K6's walk.  A block computes each sample's three Lin values once
// into shared memory and copies its run's incoming grads there too, read
// once from device memory in whole rows (reading them lane by lane inside
// the walk left a dependent device-memory load at every sample).  A lane
// owns a column (kind, mode, group of kVec channels) and its team walks
// `walk` consecutive samples in order.  The lane skips a sample whose grad
// for its channels is zero (a row of g_app is zero as a whole or not, so
// the skip is nearly uniform across a warp).  For the others it reads the
// corner rows (from L1 while the samples stay in one cell), recomputes p
// and l, and adds the corner grads in registers while the sample stays in
// the plane cell (or line segment) of the one before it; when it leaves,
// or the walk ends, the sums go out as one float4 atomic a non-zero corner
// row (a scalar one on the one-channel arm), into the plane grads and
// straight into the line grads.  A line row is hot (199 rows a line at
// bat), but a lane adds to it only where its walk leaves the segment, a few
// times a walk; and shared-memory float atomics, the alternative, compile
// to compare-and-swap loops on sm_90a.  A VM lane walks its samples twice,
// for the plane grads and then for the line grads, so that it holds half
// the state at a time: 64 registers, four blocks an SM (CP: 80, three).
// Grads are summed with atomics, so their last bits change from run to
// run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "plane_line.cuh"

namespace {

using namespace nvfi_plane_line;

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
__device__ __forceinline__ bool any_nonzero(const float (&v)[kVec]) {
  bool any = false;
#pragma unroll
  for (int q = 0; q < kVec; ++q) any |= v[q] != 0.0f;
  return any;
}

template <int kVec>
__device__ __forceinline__ void atomic_add_global(float* p, const float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    atomicAdd(p, v[0]);
  }
}

template <int kVec>
__device__ __forceinline__ void clear(float (&v)[kVec]) {
#pragma unroll
  for (int q = 0; q < kVec; ++q) v[q] = 0.0f;
}

// the corner sums a lane holds for the rows `row` (the first -1: none
// held) into their grad rows (row stride C, from the lane's channel), one
// atomic a non-zero row, and cleared
template <int kVec, int kRows>
__device__ __forceinline__ void flush(const int (&row)[kRows], float (&acc)[kRows][kVec],
                                      float* grad, int C) {
  if (row[0] < 0) return;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (any_nonzero<kVec>(acc[k])) atomic_add_global<kVec>(grad + row[k] * C, acc[k]);
    clear<kVec>(acc[k]);
  }
}

// the incoming grad of the run's sample r for the lane's channels, from
// the block's copy in shared memory: g_app's (src: at the lane's mode and
// channels, row stride `stride`), or g_density's for every channel
template <int kVec, bool kApp>
__device__ __forceinline__ void incoming(const float* src, int stride, int r, float (&g)[kVec]) {
  if constexpr (kApp && kVec == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src + r * stride);
    g[0] = t.x;
    g[1] = t.y;
    g[2] = t.z;
    g[3] = t.w;
  } else {
#pragma unroll
    for (int q = 0; q < kVec; ++q) g[q] = src[r * stride + (kApp ? q : 0)];
  }
}

// one column's walk over the samples [r0, r1) of the run: VM, in two
// passes over the same samples, so that a lane holds half the state at a
// time: the plane grads (g l w_k, from the line rows), then the line grads
// (g p w_j, from the plane rows)
template <int kVec, bool kApp>
__device__ __forceinline__ void grad_walk_vm(const float* plane, const float* line, float* gplane,
                                             float* gline, int W, int C, int c, int mode,
                                             const Lin* lin, int r0, int r1, const float* gsrc,
                                             int gstride) {
  const int ax = mat_m0(mode), ay = mat_m1(mode), al = 2 - mode;
  {
    int held[4] = {-1, -1, -1, -1};
    float acc[4][kVec];
#pragma unroll
    for (int k = 0; k < 4; ++k) clear<kVec>(acc[k]);
#pragma unroll 1
    for (int r = r0; r < r1; ++r) {
      float g[kVec];
      incoming<kVec, kApp>(gsrc, gstride, r, g);
      if (!any_nonzero<kVec>(g)) continue;
      const Lin cx = lin[3 * r + ax], cy = lin[3 * r + ay], cl = lin[3 * r + al];
      const int now[4] = {cy.i0 * W + cx.i0, cy.i0 * W + cx.i1, cy.i1 * W + cx.i0,
                          cy.i1 * W + cx.i1};
      if (now[0] != held[0] || now[3] != held[3]) {
        flush<kVec, 4>(held, acc, gplane + c, C);
#pragma unroll
        for (int k = 0; k < 4; ++k) held[k] = now[k];
      }
      LineRows<kVec> lr;
      lr.fetch(line, C, c, cl);
      float w[4], l[kVec];
      plane_weights(cy, cx, w);
      lr.value(cl, l);
#pragma unroll
      for (int q = 0; q < kVec; ++q) {
        const float gp = __fmul_rn(g[q], l[q]);
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k][q] = fmaf(gp, w[k], acc[k][q]);
      }
    }
    flush<kVec, 4>(held, acc, gplane + c, C);
  }
  {
    int held[2] = {-1, -1};
    float acc[2][kVec];
    clear<kVec>(acc[0]);
    clear<kVec>(acc[1]);
#pragma unroll 1
    for (int r = r0; r < r1; ++r) {
      float g[kVec];
      incoming<kVec, kApp>(gsrc, gstride, r, g);
      if (!any_nonzero<kVec>(g)) continue;
      const Lin cx = lin[3 * r + ax], cy = lin[3 * r + ay], cl = lin[3 * r + al];
      if (cl.i0 != held[0] || cl.i1 != held[1]) {
        flush<kVec, 2>(held, acc, gline + c, C);
        held[0] = cl.i0;
        held[1] = cl.i1;
      }
      PlaneRows<kVec> pr;
      pr.fetch(plane, W, C, c, cy, cx);
      float w[4], p[kVec];
      plane_weights(cy, cx, w);
      pr.value(w, p);
#pragma unroll
      for (int q = 0; q < kVec; ++q) {
        const float gl = __fmul_rn(g[q], p[q]);
        acc[0][q] = fmaf(gl, cl.w0, acc[0][q]);
        acc[1][q] = fmaf(gl, cl.w1, acc[1][q]);
      }
    }
    flush<kVec, 2>(held, acc, gline + c, C);
  }
}

// the same for CP: f = (s0 * s1) * s2, so d s2 = g (s0 s1), d s0 = (g s2) s1,
// d s1 = (g s2) s0
template <int kVec, bool kApp>
__device__ __forceinline__ void grad_walk_cp(const Field& f, float* const (&glines)[3], int c,
                                             const Lin* lin, int r0, int r1, const float* gsrc,
                                             int gstride) {
  LineRows<kVec> lr[3];
  float acc[3][2][kVec];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    lr[i].clear();
    clear<kVec>(acc[i][0]);
    clear<kVec>(acc[i][1]);
  }
#pragma unroll 2
  for (int r = r0; r < r1; ++r) {
    float g[kVec];
    incoming<kVec, kApp>(gsrc, gstride, r, g);
    if (!any_nonzero<kVec>(g)) continue;
    Lin l[3];
    float s[3][kVec];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      l[i] = lin[3 * r + 2 - i];
      if (lr[i].moved(l[i])) flush<kVec, 2>(lr[i].row, acc[i], glines[i] + c, f.C);
      lr[i].fetch(f.line[i], f.C, c, l[i]);
      lr[i].value(l[i], s[i]);
    }
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      const float g2 = __fmul_rn(g[q], s[2][q]);
      const float gs[3] = {__fmul_rn(g2, s[1][q]), __fmul_rn(g2, s[0][q]),
                           __fmul_rn(g[q], __fmul_rn(s[0][q], s[1][q]))};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        acc[i][0][q] = fmaf(gs[i], l[i].w0, acc[i][0][q]);
        acc[i][1][q] = fmaf(gs[i], l[i].w1, acc[i][1][q]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) flush<kVec, 2>(lr[i].row, acc[i], glines[i] + c, f.C);
}

template <int kVec, bool kCP>
__global__ void __launch_bounds__(kThreads, kCP ? 3 : 4)
plane_line_bwd_kernel(const Field dens, const Field app, const Grads gdens, const Grads gapp,
                      const Geometry geo, const float* __restrict__ xyz, int64_t P, int walk,
                      const float* __restrict__ g_density, const float* __restrict__ g_app) {
  extern __shared__ float4 smem[];
  const int modes = kCP ? 1 : 3;
  const int gd = dens.C / kVec, ga = app.C / kVec;
  const int acols = modes * ga, cols = acols + modes * gd;
  const int run = walk * (int)blockDim.y;
  const int app_width = modes * app.C;
  Lin* lin = reinterpret_cast<Lin*>(smem);                  // run x 3 axes
  float* sga = reinterpret_cast<float*>(lin + 3 * run);     // run x app_width
  float* sgd = sga + run * app_width;                       // run
  const int64_t p0 = (int64_t)blockIdx.x * run;
  const int n = (int)min((int64_t)run, P - p0);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int threads = blockDim.x * blockDim.y;
  for (int j = tid; j < 3 * n; j += threads) {
    lin[j] = linear_corners(__ldg(xyz + p0 * 3 + j), axis_size(geo, j % 3));
  }
  // the run's incoming grads, read once (coalesced, evict-first)
  if constexpr (kVec == 4) {
    const float4* src = reinterpret_cast<const float4*>(g_app + p0 * app_width);
    float4* dst = reinterpret_cast<float4*>(sga);
#pragma unroll 4
    for (int j = tid; j < n * app_width / 4; j += threads) dst[j] = __ldcs(src + j);
  } else {
#pragma unroll 4
    for (int j = tid; j < n * app_width; j += threads) {
      sga[j] = __ldcs(g_app + p0 * app_width + j);
    }
  }
  for (int j = tid; j < n; j += threads) sgd[j] = __ldcs(g_density + p0 + j);
  __syncthreads();

  const int r0 = threadIdx.y * walk, r1 = min(r0 + walk, n);
  for (int col = threadIdx.x; col < cols; col += blockDim.x) {
    const bool is_app = col < acols;
    const int k = is_app ? col : col - acols;
    const int groups = is_app ? ga : gd;
    const int mode = kCP ? 0 : k / groups;
    const int c = (k - mode * groups) * kVec;
    if constexpr (kCP) {
      if (is_app) {
        grad_walk_cp<kVec, true>(app, gapp.line, c, lin, r0, r1, sga + c, app_width);
      } else {
        grad_walk_cp<kVec, false>(dens, gdens.line, c, lin, r0, r1, sgd, 1);
      }
    } else {
      const int W = sel3(geo.pw, mode);
      if (is_app) {
        grad_walk_vm<kVec, true>(sel3(app.plane, mode), sel3(app.line, mode),
                                 sel3(gapp.plane, mode), sel3(gapp.line, mode), W, app.C, c,
                                 mode, lin, r0, r1, sga + mode * app.C + c, app_width);
      } else {
        grad_walk_vm<kVec, false>(sel3(dens.plane, mode), sel3(dens.line, mode),
                                  sel3(gdens.plane, mode), sel3(gdens.line, mode), W, dens.C, c,
                                  mode, lin, r0, r1, sgd, 1);
      }
    }
  }
}

template <int kVec, bool kCP>
int launch(const Field& dens, const Field& app, const Grads& gd, const Grads& ga,
           const Geometry& geo, const float* xyz, int64_t P, int walk, int block_x, int teams,
           int smem_bytes, const float* g_density, const float* g_app, cudaStream_t s) {
  const int64_t run = (int64_t)walk * teams;
  const unsigned int blocks = (unsigned int)((P + run - 1) / run);
  const dim3 block(block_x, teams);
  plane_line_bwd_kernel<kVec, kCP><<<blocks, block, smem_bytes, s>>>(
      dens, app, gd, ga, geo, xyz, P, walk, g_density, g_app);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: the 12 device pointers K6 reads (density planes, density lines, app
// planes, app lines; planes null in the CP arm); grads: 12 device pointers
// shaped like them, zeroed by the caller, the kernel adds to them; dims:
// the planes' H[3], W[3] and the lines' L[3]; xyz (P, 3); g_density (P,);
// g_app (P, 3 Ca) (VM) or (P, Ca) (CP); walk samples a team, blocks of
// (block_x, teams) threads and smem_bytes of dynamic shared memory from
// ops/plane_line.py:plane_line_bwd_plan.  Returns cudaGetLastError() after
// the launch.
extern "C" int nvfi_plane_line_bwd(const void* const* ptrs, void* const* grads, const int* dims,
                                   const float* xyz, int64_t P, int Cd, int Ca, int vec, int walk,
                                   int block_x, int teams, int smem_bytes, int cp,
                                   const float* g_density, const float* g_app, void* stream) {
  const Field fd = make_field(ptrs, Cd), fa = make_field(ptrs + 6, Ca);
  const Grads gd = make_grads(grads), ga = make_grads(grads + 6);
  const Geometry geo = make_geometry(dims);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    return cp ? launch<4, true>(fd, fa, gd, ga, geo, xyz, P, walk, block_x, teams, smem_bytes,
                                g_density, g_app, s)
              : launch<4, false>(fd, fa, gd, ga, geo, xyz, P, walk, block_x, teams, smem_bytes,
                                 g_density, g_app, s);
  }
  return cp ? launch<1, true>(fd, fa, gd, ga, geo, xyz, P, walk, block_x, teams, smem_bytes,
                              g_density, g_app, s)
            : launch<1, false>(fd, fa, gd, ga, geo, xyz, P, walk, block_x, teams, smem_bytes,
                               g_density, g_app, s);
}
