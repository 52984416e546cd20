// Fused position-Verlet substep for banded tet lattices, for Hopper
// (sm_90a).  Built by softbodyunity_torch/kernels/build.py, wrapped by
// softbodyunity_torch/kernels/lattice_verlet.py; its plain PyTorch version
// is softbodyunity_torch/solver/step.py::substep_verlet.
//
// Replaces the TPU kernel softbodyunity_tpu/kernels/pallas_lattice.py
// ::_make_verlet_kernel, launched by ::_pallas_lattice_verlet_substeps
// through pl.pallas_call, for the branches the tet-cube Verlet path runs:
// banded springs on the velocity estimate (x - xp) / dt, the damped
// position update, pinning, the banded PBD volume projection,
// position-only plane, sphere, capsule and oriented-box contact with their
// friction (grid_common.cuh::position_contact), and the wind's drag at the
// velocity estimate (the kDrag instantiation; lift is gated off lattices).
//
// Design.  As lattice_euler.cu: flat [3, N] planes, one thread per vertex,
// neighbours at i + delta, and two launches per substep because the volume
// projection reads the neighbours' integrated positions:
//   integrate  springs and the damped update from (x, xp), written to a
//              scratch buffer xs (with no volume projection it also runs
//              the contact and xs is the substep's result);
//   volume     the tet corrections over xs, count-averaged and scaled by
//              volume_stiffness, then the contact and friction against the
//              substep's start x; written over xp, which no thread of this
//              launch reads.
// The damper reads each neighbour's (x - xp) / dt, so nothing may overwrite
// x or xp during the integrate launch: the wrapper rotates three buffers.
//
// What bounds it.  One substep must read x, xp, inv_mass, the ownership
// word and the tet count and write x: 48 B per vertex, 3.1 MB at 64k,
// ~0.9 us at 3.35 TB/s, and ~55 MFLOP (~0.8 us): bound by bytes.  As with
// the Euler kernel the recomputed reactions (2x springs, 4x tets), the
// neighbour gathers, the velocity-estimate divides and two launches per
// substep keep it well above that.
//
// Rounding.  sqrtf and IEEE divides in the plain version's order; FMA
// contraction makes the agreement one of rounding.  Pinned vertices keep x
// bit for bit.

#include <cuda_runtime.h>

#include "lattice_common.cuh"

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
  float vol_stiff;    // volume_stiffness
};

// The position-level contact chain of a movable vertex that ends the
// substep at x, having started it at x0 (step.py::verlet_contact_project).
__device__ __forceinline__ Vec3 contact(Vec3 x, Vec3 x0, const Colliders& c,
                                        const Params& p) {
  return position_contact(x, x0, c, p.mu, p.keep, p.dt, p.shell);
}

// x, xp, xs are [3, n] planes; edges is [n_edge, 3] rows of (delta, k,
// rest).  finish = 1 when the substep has no volume projection.  kDrag: the
// wind's drag at the velocity estimate is added to the springs.
template <bool kDrag>
__global__ void __launch_bounds__(256) lattice_verlet_integrate_kernel(
    const float* __restrict__ x, const float* __restrict__ xp,
    float* __restrict__ xs, const float* __restrict__ inv_mass,
    const unsigned* __restrict__ bits, const float* __restrict__ edges,
    int n_edge, Colliders col, int finish, Wind wind, int n, Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Vec3 xi = load3(x, i, n);
  const Vec3 pi = load3(xp, i, n);
  const Vec3 vi = velocity_estimate(xi, pi, p.dt);
  Vec3 f = banded_spring_sum(
      x,
      [&](int j) {
        return velocity_estimate(load3(x, j, n), load3(xp, j, n), p.dt);
      },
      bits, edges, n_edge, p.damping, i, n, xi, vi);
  if (kDrag) f = add_drag(f, vi, wind);
  const float im = inv_mass[i];
  if (!(im > 0.0f)) {          // pinned: x stays, bit for bit
    store3(xs, i, n, xi);
    return;
  }
  const float ax = p.gx + f.x * im, ay = p.gy + f.y * im, az = p.gz + f.z * im;
  Vec3 xn = {xi.x + (xi.x - pi.x) * p.decay + ax * p.dt * p.dt,
             xi.y + (xi.y - pi.y) * p.decay + ay * p.dt * p.dt,
             xi.z + (xi.z - pi.z) * p.decay + az * p.dt * p.dt};
  if (finish) xn = contact(xn, xi, col, p);
  store3(xs, i, n, xn);
}

// xs is the integrated plane, x the substep's start; tets is [n_tet, 4]
// rows of (d1, d2, d3, rest volume); cnt is each vertex's tet count, at
// least 1.
__global__ void __launch_bounds__(256) lattice_verlet_volume_kernel(
    const float* __restrict__ xs, const float* __restrict__ x,
    float* __restrict__ out, const float* __restrict__ inv_mass,
    const unsigned* __restrict__ bits, const float* __restrict__ tets,
    int n_tet, const float* __restrict__ cnt, Colliders col, int n,
    Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Vec3 xn = load3(xs, i, n);
  if (inv_mass[i] > 0.0f) {
    const Vec3 s = banded_tet_sum(
        {0.0f, 0.0f, 0.0f}, [&](int j) { return load3(xs, j, n); }, inv_mass,
        bits, tets, n_tet, 0.0f, nullptr, nullptr, i, n);
    const float c = cnt[i];
    xn = {xn.x + p.vol_stiff * s.x / c, xn.y + p.vol_stiff * s.y / c,
          xn.z + p.vol_stiff * s.z / c};
    xn = contact(xn, load3(x, i, n), col, p);
  }
  store3(out, i, n, xn);
}

unsigned blocks_of(int n) { return (n + 255) / 256; }

}  // namespace

// Launch the integrate pass of one substep on `stream`; returns the
// cudaError_t of the launch (0 = cudaSuccess).  Allocates nothing and does
// not synchronise.
extern "C" int lattice_verlet_integrate(
    const float* x, const float* xp, float* xs, const float* inv_mass,
    const unsigned* bits, const float* edges, int n_edge, COLLIDER_PARAMS,
    int finish, int drag_on, float wvx, float wvy,
    float wvz, float drag, int n, float dt, float damping, float gx,
    float gy, float gz, float decay, float mu, float keep, float shell,
    void* stream) {
  const Params p{dt, damping, gx, gy, gz, decay, mu, keep, shell, 0.0f};
  const Colliders col = COLLIDERS;
  const Wind wind{wvx, wvy, wvz, drag, 0.0f};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (drag_on)
    lattice_verlet_integrate_kernel<true><<<blocks_of(n), 256, 0, st>>>(
        x, xp, xs, inv_mass, bits, edges, n_edge, col, finish, wind, n, p);
  else
    lattice_verlet_integrate_kernel<false><<<blocks_of(n), 256, 0, st>>>(
        x, xp, xs, inv_mass, bits, edges, n_edge, col, finish, wind, n, p);
  return static_cast<int>(cudaGetLastError());
}

// Launch the volume pass of one substep on `stream`; returns the
// cudaError_t of the launch.  Allocates nothing and does not synchronise.
extern "C" int lattice_verlet_volume(
    const float* xs, const float* x, float* out, const float* inv_mass,
    const unsigned* bits, const float* tets, int n_tet, const float* cnt,
    COLLIDER_PARAMS, int n, float dt, float mu, float keep,
    float shell, float vol_stiff, void* stream) {
  const Params p{dt, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f, mu, keep, shell, vol_stiff};
  const Colliders col = COLLIDERS;
  lattice_verlet_volume_kernel<<<blocks_of(n), 256, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      xs, x, out, inv_mass, bits, tets, n_tet, cnt, col, n, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lattice_verlet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
