// Fused position-Verlet substep for structured grid cloth, for Hopper
// (sm_90a).  Built by softbodyunity_torch/kernels/build.py, wrapped by
// softbodyunity_torch/kernels/grid_verlet.py; its plain PyTorch version is
// softbodyunity_torch/kernels/stencil.py::verlet_substep_grid (with
// update_features, in the launch-start order of
// softbodyunity_torch/kernels/grid_features.py).
//
// Replaces two TPU kernels of softbodyunity_tpu/kernels/: the whole-VMEM
// pallas_substep.py::_make_verlet_kernel, launched by
// ::_pallas_verlet_substeps through pl.pallas_call, and the row-tiled
// pallas_tiled.py::_make_verlet_kernel, launched by
// ::_tiled_verlet_substeps (grids past the whole-VMEM cap).  It runs their
// branches of the grid-cloth Verlet path: the six-offset spring stencil on
// the velocity estimate (x - xp) / dt, the damped position update,
// pinning, position-only plane, sphere, capsule and oriented-box contact,
// their friction (grid_common.cuh::position_contact), and the tear-liveness and plastic rest-scale planes (the kFeat
// instantiation, in the row-tiled kernel's launch-start form: see
// grid_euler.cu), the wind's drag and lift at the velocity estimate (the
// kWind instantiation), and the strain limit's sweeps, one cooperative
// launch a substep (grid_common.cuh::grid_strain_sweep_kernel, position
// only, the last sweep running the contact chain: VerletStrainEpilogue
// below), with an optional
// external force plane (the self-collision repulsion at x, block_pairs.cu)
// added to the spring forces as solver/step.py::verlet_integrate adds it.
//
// Design.  As grid_euler.cu: one launch per substep, one thread per vertex,
// the state in L2 or device memory between launches, no vertex cap, the
// feature planes updated at each launch's start from its input positions
// (the frame's first launch excepted) and once more at the frame's end.
// The damper reads each neighbour's velocity estimate, so a neighbour's xp
// is read while the owner writes its new position: writing the new x over
// xp would race.  The wrapper therefore rotates three buffers: read (x,
// xp), write out, then (x, xp, out) <- (out, x, xp).  Spring forces are the
// same gather as the Euler kernel's, from the shared
// grid_common.cuh::edge_force (owned edge plus the recomputed reaction of
// the edge owned by p - o), and so is the feature update of both.  Contact
// and friction read only the vertex's own data.
//
// What bounds it.  Per vertex and substep it reads x, xp and inv_mass and
// writes x: 40 bytes, 2.6 MB at 64k vertices, ~0.8 us at 3.35 TB/s, and
// ~300 flops; the feature planes add 4 bytes in and out per offset and
// plane.  As with the Euler kernel, launch overhead and the serial chain of
// 12 neighbour gathers bound it at 64k, not bandwidth.
//
// Rounding.  sqrtf and IEEE divides (the velocity estimate is a divide by
// dt) in the plain version's order; FMA contraction makes the agreement one
// of rounding, except in the feature update, rounded as the plain version
// rounds it.  Pinned vertices keep x bit for bit.

#include <cuda_runtime.h>

#include "grid_common.cuh"

namespace {

// Scalars of one substep, computed by the wrapper in double from SimConfig
// and rounded once to float, as the plain version's Python scalars are.
struct Params {
  float dt;
  float damping;      // spring-axis damper coefficient
  float gx, gy, gz;   // gravity
  float decay;        // 1 - global_damping * dt
  float mu;           // friction
  float keep;         // 1 - friction
  float shell;        // SPHERE_CONTACT_SHELL
};

// One thread per vertex (i, j).  x, xp, out are [3, ny, nx] planes; offsets
// is [n_off, 4] rows of (di, dj, k, rest); col holds the collider rows
// (grid_common.cuh; its friction flags are 0 when friction is 0 or the
// collider is off).
// kExt: f_ext, [3, ny, nx], is added to the spring forces; the
// instantiation without it is the kernel as it was before the plane existed.
// kFeat: the tear and plastic planes, as grid_euler.cu's.  kWind: the wind
// force at x and the velocity estimate, added after f_ext.
template <bool kExt, bool kFeat, bool kWind>
__global__ void __launch_bounds__(256) grid_verlet_substep_kernel(
    const float* __restrict__ x, const float* __restrict__ xp,
    float* __restrict__ out, const float* __restrict__ inv_mass,
    const float* __restrict__ offsets, int n_off, Colliders col,
    const float* __restrict__ f_ext, const float* __restrict__ alive_in,
    float* __restrict__ alive_out, const float* __restrict__ scale_in,
    float* __restrict__ scale_out, const float* __restrict__ tear_limits,
    int first, FeatParams fp, Wind wind, int ny, int nx, Params p) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  const int ps = ny * nx;
  const int idx = i * nx + j;
  const Vec3 xi = load3(x, idx, ps);
  const Vec3 pi = load3(xp, idx, ps);
  const Vec3 vi = velocity_estimate(xi, pi, p.dt);

  float fx = 0.0f, fy = 0.0f, fz = 0.0f;
  for (int o = 0; o < n_off; ++o) {
    const int di = static_cast<int>(offsets[4 * o]);
    const int dj = static_cast<int>(offsets[4 * o + 1]);
    const float k = offsets[4 * o + 2];
    const float rest = offsets[4 * o + 3];
    // the edge this vertex owns, to (i + di, j + dj)
    int ii = i + di, jj = j + dj;
    if (ii >= 0 && ii < ny && jj >= 0 && jj < nx) {
      const int nb = ii * nx + jj;
      const Vec3 xn = load3(x, nb, ps);
      float a = 1.0f, s = 1.0f;
      if (kFeat) {
        edge_features(alive_in, scale_in, o * ps + idx, xi, xn, rest,
                      tear_limits[o], fp, first, a, s);
        if (alive_out) alive_out[o * ps + idx] = a;
        if (scale_out) scale_out[o * ps + idx] = s;
      }
      if (a != 0.0f) {
        const Vec3 e = edge_force(
            xi, vi, xn, velocity_estimate(xn, load3(xp, nb, ps), p.dt), k,
            kFeat ? scaled_rest(rest, s, scale_in) : rest, p.damping);
        fx += e.x;
        fy += e.y;
        fz += e.z;
      }
    } else if (kFeat) {   // no edge here: the entry is carried, unread
      if (alive_out) alive_out[o * ps + idx] = alive_in[o * ps + idx];
      if (scale_out) scale_out[o * ps + idx] = scale_in[o * ps + idx];
    }
    // the reaction of the edge owned by (i - di, j - dj)
    ii = i - di;
    jj = j - dj;
    if (ii >= 0 && ii < ny && jj >= 0 && jj < nx) {
      const int nb = ii * nx + jj;
      const Vec3 xn = load3(x, nb, ps);
      float a = 1.0f, s = 1.0f;
      if (kFeat)
        edge_features(alive_in, scale_in, o * ps + nb, xn, xi, rest,
                      tear_limits[o], fp, first, a, s);
      if (a != 0.0f) {
        const Vec3 e = edge_force(
            xn, velocity_estimate(xn, load3(xp, nb, ps), p.dt), xi, vi, k,
            kFeat ? scaled_rest(rest, s, scale_in) : rest, p.damping);
        fx -= e.x;
        fy -= e.y;
        fz -= e.z;
      }
    }
  }

  if (kExt) {   // springs + f_ext, as total_forces sums them
    fx += f_ext[idx];
    fy += f_ext[ps + idx];
    fz += f_ext[2 * ps + idx];
  }
  if (kWind) {  // + wind, as total_forces sums them
    const Vec3 fw = wind_force(x, i, j, ny, nx, ps, vi, wind);
    fx += fw.x;
    fy += fw.y;
    fz += fw.z;
  }

  const float im = inv_mass[idx];
  if (!(im > 0.0f)) {          // pinned: x stays, bit for bit
    store3(out, idx, ps, xi);
    return;
  }
  const float ax = p.gx + fx * im, ay = p.gy + fy * im, az = p.gz + fz * im;
  Vec3 xnew = {xi.x + (xi.x - pi.x) * p.decay + ax * p.dt * p.dt,
               xi.y + (xi.y - pi.y) * p.decay + ay * p.dt * p.dt,
               xi.z + (xi.z - pi.z) * p.decay + az * p.dt * p.dt};
  store3(out, idx, ps,
         position_contact(xnew, xi, col, p.mu, p.keep, p.dt, p.shell));
}

// The last strain sweep's epilogue (stencil.py::verlet_substep_grid): the
// change x_new - x0 from the integrated positions x0 goes into x, then a
// movable vertex takes the position-level contact and friction against the
// substep's start x_start; x is written to out.
struct VerletStrainEpilogue {
  const float* x0;
  const float* x_start;
  float* out;
  const float* inv_mass;
  Colliders col;
  int ps;
  Params p;

  __device__ void operator()(int idx, Vec3 xn) const {
    const Vec3 a = load3(x0, idx, ps);
    const Vec3 d = sub3(xn, a);
    Vec3 x = {a.x + d.x, a.y + d.y, a.z + d.z};
    if (inv_mass[idx] > 0.0f)
      x = position_contact(x, load3(x_start, idx, ps), col, p.mu, p.keep,
                           p.dt, p.shell);
    store3(out, idx, ps, x);
  }
};

}  // namespace

// Launch one substep on `stream`; returns the cudaError_t of the launch
// (0 = cudaSuccess).  f_ext may be null (no external force plane).  The
// feature arguments are grid_euler_substep's.  Allocates nothing and does
// not synchronise.
extern "C" int grid_verlet_substep(
    const float* x, const float* xp, float* out, const float* inv_mass,
    const float* offsets, int n_off, COLLIDER_PARAMS, const float* f_ext,
    int feat, const float* alive_in, float* alive_out,
    const float* scale_in, float* scale_out, const float* tear_limits,
    int first, float strain1, float yield_strain, float creep,
    float min_scale, float max_scale, int wind_on, float wvx, float wvy,
    float wvz, float drag, float lift, int ny, int nx, float dt,
    float damping, float gx, float gy, float gz, float decay, float mu,
    float keep, float shell, void* stream) {
  const Params p{dt, damping, gx, gy, gz, decay, mu, keep, shell};
  const FeatParams fp{strain1, yield_strain, creep, min_scale, max_scale};
  const Wind wind{wvx, wvy, wvz, drag, lift};
  const dim3 block(32, 8);
  const dim3 grid((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Colliders col = COLLIDERS;
#define GRID_VERLET_LAUNCH(EXT, FEAT, WIND)                                 \
  grid_verlet_substep_kernel<EXT, FEAT, WIND><<<grid, block, 0, st>>>(      \
      x, xp, out, inv_mass, offsets, n_off, col, f_ext, alive_in,           \
      alive_out, scale_in, scale_out, tear_limits, first, fp, wind, ny, nx, \
      p)
#define GRID_VERLET_WIND(EXT, FEAT)          \
  do {                                       \
    if (wind_on)                             \
      GRID_VERLET_LAUNCH(EXT, FEAT, true);   \
    else                                     \
      GRID_VERLET_LAUNCH(EXT, FEAT, false);  \
  } while (0)
  if (f_ext && feat)
    GRID_VERLET_WIND(true, true);
  else if (f_ext)
    GRID_VERLET_WIND(true, false);
  else if (feat)
    GRID_VERLET_WIND(false, true);
  else
    GRID_VERLET_WIND(false, false);
#undef GRID_VERLET_WIND
#undef GRID_VERLET_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

extern "C" int grid_verlet_strain_size() {
  return static_cast<int>(sizeof(StrainSweeps));
}

// Launch one substep's strain-limit sweeps (grid_common.cuh::
// grid_strain_sweep_kernel, one cooperative launch) on `stream`, the last
// running the Verlet epilogue: x0 is the integrate launch's output, where
// the sweeps start, x_start the substep's start, out receives the
// substep's positions.  Returns the cudaError_t of the launch.  Allocates
// nothing and does not synchronise.
extern "C" int grid_verlet_strain(
    const StrainSweeps* s, const float* alive, const float* scale,
    const float* x0, const float* x_start, float* out, COLLIDER_PARAMS,
    float dt, float mu, float keep, float shell, void* stream) {
  const Params p{dt, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f, mu, keep, shell};
  const VerletStrainEpilogue epi{x0,        x_start,       out, s->inv_mass,
                                 COLLIDERS, s->ny * s->nx, p};
  return launch_strain_sweeps(*s, x0, nullptr, alive, scale, epi, stream);
}

// Launch the frame-end feature update over the final positions x
// (grid_common.cuh::grid_feature_finish_kernel); returns the cudaError_t.
extern "C" int grid_verlet_features(
    const float* x, const float* alive_in, float* alive_out,
    const float* scale_in, float* scale_out, const float* offsets,
    const float* tear_limits, int n_off, float strain1, float yield_strain,
    float creep, float min_scale, float max_scale, int ny, int nx,
    void* stream) {
  return launch_feature_finish(
      x, alive_in, alive_out, scale_in, scale_out, offsets, tear_limits,
      n_off, ny, nx,
      FeatParams{strain1, yield_strain, creep, min_scale, max_scale}, stream);
}

extern "C" const char* grid_verlet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
