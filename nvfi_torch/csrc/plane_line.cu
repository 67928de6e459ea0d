// K6 plane_line_fwd and K6d plane_line_density_fwd: the static TensoRF
// lookup, VM (plane x line) and CP (line x line x line) arms.
//
// Replaces the lookup of the JAX package's static TensoRF field,
// nvfi_tpu/fields/tensorf_vm.py: density_feature (:119-134) and app_feature
// (:137-151) before the basis matmul, which XLA builds from
// ops/grid_sample.py:grid_sample_2d (:36-66) and grid_sample_1d (:209-224);
// SURVEY.md §7.1.4(a) planned it as a fused plane/line gather (ROADMAP queue
// B item 1).  No Pallas kernel computed it on the TPU.
//
//   VM: for mode i, (m0, m1) = MAT_SPACE[i] = (0,1), (0,2), (1,2) and
//       vm = VEC_MODE[i] = 2 - i:
//         f_i = grid_sample_2d(plane_i, (x[m0], x[m1])) * grid_sample_1d(line_i, x[vm])
//       density = sum over i and the Cd channels of f_i (density planes and
//       lines); app = [f_0 | f_1 | f_2] of the Ca-channel app planes and
//       lines, (P, 3 Ca).
//   CP: f = s_0 * s_1 * s_2 with s_i = grid_sample_1d(line_i, x[2 - i]);
//       density = its channel sum, app = f of the app lines, (P, Ca).
//   K6d (density_only): the density alone, from the density planes and
//       lines (compute_dense_alpha, :270).
//
// Planes are channels-last (H, W, C) = (gs[m1], gs[m0], C): x[m0] indexes W,
// x[m1] indexes H; lines are (L, C).  Normalized u maps to (u + 1) / 2 *
// (S - 1); each corner carries its own validity and an out-of-range corner
// weighs zero, its index clamped into the grid (zeros padding), so
// samples outside the box, which the render computes and masks only after,
// give the plain version's values and never read outside a plane or line.
// Every rounding step of the plain version is kept (no contraction into
// FMAs): the interpolation weights, each corner term and the corner sums in
// the JAX order.
//
// Bound: bytes.  xyz in (12 B) and density and app out (4 + 4 * 3 Ca B) a
// sample: 592 B at bat's widths (Cd 24, Ca 48), 0.83 GB for a train step's
// 2048 x 686 samples, about 0.25 ms at 3.35 TB/s.  The planes (34 MB at
// 199^3) stay in the 50 MB L2, so the corner reads are L2 traffic.
//
// Design.  Every plane and line lookup of a sample takes its two corners
// along one of the three axes, so a block first computes each sample's
// three Lin values (corner indices and weights, one an axis) once, into
// shared memory.  Then a lane owns one column, a (kind, mode, group of kVec
// channels) of the output: threadIdx.x is the column (app columns first,
// mode-major, then the density columns; the block's x width is the columns
// padded to whole warps where there are 32 or more, else teams share
// warps), threadIdx.y a team that walks `walk` consecutive samples of the
// block's run in order.  kVec is 4 on the 16-byte path (float4 loads of each
// corner row and a float4 store), else 1.  Neighbouring lanes hold
// neighbouring channel groups of one row, so the loads and the app stores
// stay 16-byte and coalesced.  A ray's consecutive samples, half a voxel
// apart, mostly stay in one plane cell or line segment, so a lane's corner
// rows come from L1 after the first sample there; the walk is unrolled by 8
// (CP: 4) without a branch on the cell, so that the loads of eight samples
// are in flight at once (keeping the rows in registers and reading them only on a
// change of cell left each lane a chain of dependent loads: slower on the
// H100, PERF.md §6).  The outputs are stored evict-first (__stcs), so that
// they do not push the planes out of L2.  A density column leaves its
// channel sum in shared memory; after a barrier a thread a sample adds them
// up, a mode's groups in channel order and the modes in order, so that
// K6d's density equals K6's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "plane_line.cuh"

namespace {

using namespace nvfi_plane_line;

// density = sum over a sample's density columns, mode by mode
__device__ __forceinline__ float sum_partials(const float* part, int modes, int groups) {
  float total = 0.0f;
  for (int m = 0; m < modes; ++m) {
    float c = part[m * groups];
    for (int q = 1; q < groups; ++q) c = __fadd_rn(c, part[m * groups + q]);
    total = m ? __fadd_rn(total, c) : c;
  }
  return total;
}

// sample r's value of the lane's column: an app column stores it, a density
// column leaves its channel sum in shared memory
template <int kVec, bool kApp>
__device__ __forceinline__ void put(const float (&v)[kVec], int r, float* out, int64_t out_stride,
                                    float* part, int part_stride) {
  if constexpr (kApp) {
    float* o = out + r * out_stride;
    if constexpr (kVec == 4) {
      __stcs(reinterpret_cast<float4*>(o), make_float4(v[0], v[1], v[2], v[3]));
    } else {
      __stcs(o, v[0]);
    }
  } else {
    float c = v[0];
#pragma unroll
    for (int q = 1; q < kVec; ++q) c = __fadd_rn(c, v[q]);
    part[r * part_stride] = c;
  }
}

// the samples r0..r1 of the run in order, for one column: VM
template <int kVec, bool kApp>
__device__ __forceinline__ void walk_vm(const float* plane, const float* line, int W, int C,
                                        const Lin* lin, int mode, int c0, int r0, int r1,
                                        float* out, int64_t out_stride, float* part,
                                        int part_stride) {
  const int ax = mat_m0(mode), ay = mat_m1(mode), al = 2 - mode;
  for (int r8 = r0; r8 < r1; r8 += 8) {
#pragma unroll
    for (int r = r8; r < r8 + 8; ++r) {
      if (r >= r1) break;
      const Lin cx = lin[3 * r + ax], cy = lin[3 * r + ay], cl = lin[3 * r + al];
      PlaneRows<kVec> pr;
      LineRows<kVec> lr;
      pr.fetch(plane, W, C, c0, cy, cx);
      lr.fetch(line, C, c0, cl);
      float w[4], p[kVec], s[kVec];
      plane_weights(cy, cx, w);
      pr.value(w, p);
      lr.value(cl, s);
#pragma unroll
      for (int c = 0; c < kVec; ++c) p[c] = __fmul_rn(p[c], s[c]);
      put<kVec, kApp>(p, r, out, out_stride, part, part_stride);
    }
  }
}

// the same for CP: (s_0 * s_1) * s_2, s_i from line i along axis 2 - i
template <int kVec, bool kApp>
__device__ __forceinline__ void walk_cp(const float* l0, const float* l1, const float* l2, int C,
                                        const Lin* lin, int c0, int r0, int r1, float* out,
                                        int64_t out_stride, float* part, int part_stride) {
  const float* lines[3] = {l0, l1, l2};
  for (int r4 = r0; r4 < r1; r4 += 4) {
#pragma unroll
    for (int r = r4; r < r4 + 4; ++r) {
      if (r >= r1) break;
      float v[kVec];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const Lin l = lin[3 * r + 2 - i];
        LineRows<kVec> lr;
        lr.fetch(lines[i], C, c0, l);
        float s[kVec];
        lr.value(l, s);
#pragma unroll
        for (int c = 0; c < kVec; ++c) v[c] = i ? __fmul_rn(v[c], s[c]) : s[c];
      }
      put<kVec, kApp>(v, r, out, out_stride, part, part_stride);
    }
  }
}

template <int kVec, bool kCP, bool kDensityOnly>
__global__ void __launch_bounds__(kThreads)
plane_line_fwd_kernel(const Field dens, const Field app, const Geometry geo,
                      const float* __restrict__ xyz, int64_t P, int walk,
                      float* __restrict__ density, float* __restrict__ app_out) {
  extern __shared__ float4 smem[];
  const int modes = kCP ? 1 : 3;
  const int gd = dens.C / kVec;
  const int ga = kDensityOnly ? 0 : app.C / kVec;
  const int acols = modes * ga, dcols = modes * gd, cols = acols + dcols;
  const int run = walk * (int)blockDim.y;
  Lin* lin = reinterpret_cast<Lin*>(smem);        // run x 3 axes
  float* part = reinterpret_cast<float*>(lin + 3 * run);  // run x dcols channel sums
  const int64_t p0 = (int64_t)blockIdx.x * run;
  const int n = (int)min((int64_t)run, P - p0);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int threads = blockDim.x * blockDim.y;
  for (int j = tid; j < 3 * n; j += threads) {
    lin[j] = linear_corners(__ldg(xyz + p0 * 3 + j), axis_size(geo, j % 3));
  }
  __syncthreads();

  const int r0 = threadIdx.y * walk, r1 = min(r0 + walk, n);
  const int app_width = modes * app.C;
  for (int col = threadIdx.x; col < cols; col += blockDim.x) {
    const bool is_app = col < acols;
    const int k = is_app ? col : col - acols;
    const int groups = is_app ? ga : gd;
    const int mode = kCP ? 0 : k / groups;
    const int c0 = (k - mode * groups) * kVec;
    float* out = kDensityOnly ? nullptr : app_out + p0 * app_width + col * kVec;
    float* pcol = part + k;
    if constexpr (kCP) {
      if (is_app) {
        walk_cp<kVec, true>(app.line[0], app.line[1], app.line[2], app.C, lin, c0, r0, r1, out,
                            app_width, pcol, dcols);
      } else {
        walk_cp<kVec, false>(dens.line[0], dens.line[1], dens.line[2], dens.C, lin, c0, r0, r1,
                             out, app_width, pcol, dcols);
      }
    } else {
      if (is_app) {
        walk_vm<kVec, true>(sel3(app.plane, mode), sel3(app.line, mode), sel3(geo.pw, mode),
                            app.C, lin, mode, c0, r0, r1, out, app_width, pcol, dcols);
      } else {
        walk_vm<kVec, false>(sel3(dens.plane, mode), sel3(dens.line, mode), sel3(geo.pw, mode),
                             dens.C, lin, mode, c0, r0, r1, out, app_width, pcol, dcols);
      }
    }
  }
  __syncthreads();
  for (int r = tid; r < n; r += threads) {
    __stcs(density + p0 + r, sum_partials(part + r * dcols, modes, gd));
  }
}

template <int kVec, bool kCP, bool kDensityOnly>
int launch(const Field& dens, const Field& app, const Geometry& geo, const float* xyz,
           int64_t P, int walk, int block_x, int teams, int smem_bytes, float* density,
           float* app_out, cudaStream_t s) {
  const int64_t run = (int64_t)walk * teams;
  const unsigned int blocks = (unsigned int)((P + run - 1) / run);
  const dim3 block(block_x, teams);
  plane_line_fwd_kernel<kVec, kCP, kDensityOnly><<<blocks, block, smem_bytes, s>>>(
      dens, app, geo, xyz, P, walk, density, app_out);
  return (int)cudaGetLastError();
}

template <int kVec>
int dispatch(const Field& dens, const Field& app, const Geometry& geo, const float* xyz,
             int64_t P, int walk, int block_x, int teams, int smem_bytes, int cp,
             int density_only, float* density, float* app_out, cudaStream_t s) {
  if (cp) {
    return density_only ? launch<kVec, true, true>(dens, app, geo, xyz, P, walk, block_x,
                                                   teams, smem_bytes, density, app_out, s)
                        : launch<kVec, true, false>(dens, app, geo, xyz, P, walk, block_x,
                                                    teams, smem_bytes, density, app_out, s);
  }
  return density_only ? launch<kVec, false, true>(dens, app, geo, xyz, P, walk, block_x, teams,
                                                  smem_bytes, density, app_out, s)
                      : launch<kVec, false, false>(dens, app, geo, xyz, P, walk, block_x,
                                                   teams, smem_bytes, density, app_out, s);
}

}  // namespace

// ptrs: 12 device pointers, the density planes, density lines, app planes
// and app lines, three each (planes null in the CP arm, the app ones null
// with density_only); dims: the planes' H[3], W[3] and the lines' L[3];
// xyz (P, 3) normalized; density (P,); app (P, 3 Ca) (VM) or (P, Ca) (CP),
// null with density_only; walk samples a team, blocks of (block_x, teams)
// threads and smem_bytes of dynamic shared memory from
// ops/plane_line.py:plane_line_plan.  Returns cudaGetLastError() after the
// launch.
extern "C" int nvfi_plane_line_fwd(const void* const* ptrs, const int* dims, const float* xyz,
                                   int64_t P, int Cd, int Ca, int vec, int walk, int block_x,
                                   int teams, int smem_bytes, int cp, int density_only,
                                   float* density, float* app, void* stream) {
  Field fd = make_field(ptrs, Cd), fa = make_field(ptrs + 6, Ca);
  Geometry geo = make_geometry(dims);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    return dispatch<4>(fd, fa, geo, xyz, P, walk, block_x, teams, smem_bytes, cp, density_only,
                       density, app, s);
  }
  return dispatch<1>(fd, fa, geo, xyz, P, walk, block_x, teams, smem_bytes, cp, density_only,
                     density, app, s);
}
