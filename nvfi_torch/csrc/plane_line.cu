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
// Design: a block owns a run of samples and spreads (sample, slot) work
// items over its threads, slot by slot within a sample: an app slot is one
// mode and a group of `kVec` channels (4: the 16-byte path, float4 loads of
// each corner row and a float4 store; else 1), a density slot the same over
// the density channels.  Neighbouring threads take neighbouring channel
// groups of one corner row, so a row is read in whole sectors, and the app
// slots, ordered mode-major, store one sample's 3 Ca outputs contiguously.
// A density slot leaves its channel sum in shared memory; after a barrier a
// thread a sample adds them up, a mode's groups in channel order and the
// modes in order.  The run's coords are staged in shared memory first.

#include <cuda_runtime.h>
#include <stdint.h>

#include "plane_line.cuh"

namespace {

using namespace nvfi_plane_line;

constexpr int kThreads = kFwdThreads;

// density = sum over a sample's density slots, mode by mode
__device__ __forceinline__ float sum_partials(const float* part, int modes, int groups) {
  float total = 0.0f;
  for (int m = 0; m < modes; ++m) {
    float c = part[m * groups];
    for (int q = 1; q < groups; ++q) c = __fadd_rn(c, part[m * groups + q]);
    total = m ? __fadd_rn(total, c) : c;
  }
  return total;
}

template <int kVec, bool kCP, bool kDensityOnly>
__global__ void __launch_bounds__(kThreads)
plane_line_fwd_kernel(const Field dens, const Field app, const Geometry geo,
                      const float* __restrict__ xyz, int64_t P, int run,
                      float* __restrict__ density, float* __restrict__ app_out) {
  extern __shared__ float smem[];
  const int modes = kCP ? 1 : 3;
  const int gd = dens.C / kVec;
  const int ga = kDensityOnly ? 0 : app.C / kVec;
  const int aslots = modes * ga, dslots = modes * gd, slots = aslots + dslots;
  float* sx = smem;              // run x 3 coords
  float* part = smem + run * 3;  // run x dslots channel sums
  const int64_t p0 = (int64_t)blockIdx.x * run;
  const int n = (int)min((int64_t)run, P - p0);
  for (int j = threadIdx.x; j < n * 3; j += kThreads) sx[j] = __ldg(xyz + p0 * 3 + j);
  __syncthreads();

  const int app_width = modes * app.C;
  for (int j = threadIdx.x; j < n * slots; j += kThreads) {
    const int r = j / slots, s = j - r * slots;
    const bool is_app = s < aslots;
    const int k = is_app ? s : s - aslots;
    const int groups = is_app ? ga : gd;
    const int mode = kCP ? 0 : k / groups;
    const int c0 = (k - mode * groups) * kVec;
    const float* x = sx + r * 3;
    float v[kVec];
    if constexpr (kCP) {
      lookup_cp<kVec>(pick_cp(dens, app, is_app, geo), x, c0, v);
    } else {
      lookup_vm<kVec>(pick_vm(dens, app, is_app, geo, mode), mode, x, c0, v);
    }
    if (is_app) {
      float* o = app_out + (p0 + r) * app_width + (int64_t)s * kVec;
      if constexpr (kVec == 4) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        *o = v[0];
      }
    } else {
      float c = v[0];
#pragma unroll
      for (int q = 1; q < kVec; ++q) c = __fadd_rn(c, v[q]);
      part[r * dslots + k] = c;
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < n; r += kThreads) {
    density[p0 + r] = sum_partials(part + r * dslots, modes, gd);
  }
}

template <int kVec, bool kCP, bool kDensityOnly>
int launch(const Field& dens, const Field& app, const Geometry& geo, const float* xyz,
           int64_t P, int run, int smem_bytes, float* density, float* app_out,
           cudaStream_t s) {
  const int64_t blocks = (P + run - 1) / run;
  plane_line_fwd_kernel<kVec, kCP, kDensityOnly><<<(unsigned int)blocks, kThreads, smem_bytes,
                                                   s>>>(dens, app, geo, xyz, P, run, density,
                                                        app_out);
  return (int)cudaGetLastError();
}

template <int kVec>
int dispatch(const Field& dens, const Field& app, const Geometry& geo, const float* xyz,
             int64_t P, int run, int smem_bytes, int cp, int density_only, float* density,
             float* app_out, cudaStream_t s) {
  if (cp) {
    return density_only
        ? launch<kVec, true, true>(dens, app, geo, xyz, P, run, smem_bytes, density, app_out, s)
        : launch<kVec, true, false>(dens, app, geo, xyz, P, run, smem_bytes, density, app_out, s);
  }
  return density_only
      ? launch<kVec, false, true>(dens, app, geo, xyz, P, run, smem_bytes, density, app_out, s)
      : launch<kVec, false, false>(dens, app, geo, xyz, P, run, smem_bytes, density, app_out, s);
}

}  // namespace

// ptrs: 12 device pointers, the density planes, density lines, app planes
// and app lines, three each (planes null in the CP arm, the app ones null
// with density_only); dims: the planes' H[3], W[3] and the lines' L[3];
// xyz (P, 3) normalized; density (P,); app (P, 3 Ca) (VM) or (P, Ca) (CP),
// null with density_only; run samples a block and smem_bytes of dynamic
// shared memory from ops/plane_line.py:plane_line_plan.  Returns
// cudaGetLastError() after the launch.
extern "C" int nvfi_plane_line_fwd(const void* const* ptrs, const int* dims, const float* xyz,
                                   int64_t P, int Cd, int Ca, int vec, int run, int smem_bytes,
                                   int cp, int density_only, float* density, float* app,
                                   void* stream) {
  Field fd = make_field(ptrs, Cd), fa = make_field(ptrs + 6, Ca);
  Geometry geo = make_geometry(dims);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    return dispatch<4>(fd, fa, geo, xyz, P, run, smem_bytes, cp, density_only, density, app, s);
  }
  return dispatch<1>(fd, fa, geo, xyz, P, run, smem_bytes, cp, density_only, density, app, s);
}
