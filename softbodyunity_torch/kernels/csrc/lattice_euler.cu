// Fused semi-implicit Euler substep for banded tet lattices, for Hopper
// (sm_90a).  Built by softbodyunity_torch/kernels/build.py, wrapped by
// softbodyunity_torch/kernels/lattice_euler.py; its plain PyTorch version is
// softbodyunity_torch/solver/step.py::substep_euler.
//
// Replaces the TPU kernel softbodyunity_tpu/kernels/pallas_lattice.py
// ::_make_kernel, launched by ::_pallas_lattice_substeps through
// pl.pallas_call, for the branches the tet-cube Euler path runs: banded
// springs (Hooke + axial damper), gravity, global damping and pinning, the
// banded PBD volume projection, plane, sphere, capsule and oriented-box
// contact with the colliders' kinematic velocities
// (grid_common.cuh::resolve_velocity_contact), and the wind's drag (the
// kDrag instantiation; the TPU kernel gates lift off lattices, and so does
// the wrapper).
//
// Design.  The TPU kernel folds the state into [3, S, 128] lane planes and
// keeps it in VMEM for all substeps of a frame, reaching a neighbour with a
// lane/sublane "flat roll".  Here the state is flat [3, N] planes in device
// memory (1.5 MB at 64k vertices, resident in the 50 MB L2), one thread per
// vertex, and the neighbour across a band is simply i + delta
// (lattice_common.cuh).  The volume projection reads the neighbours'
// integrated positions, and with no grid-wide barrier that takes a kernel
// boundary, so a substep is two launches:
//   integrate  springs, the velocity and position update, pinning; writes
//              x*, v* (with no volume projection it also runs the contact
//              and writes the substep's x, v: one launch per substep);
//   volume     the tet corrections over x*, count-averaged and scaled by
//              volume_stiffness, x += dx, v += dx / dt, then the contact.
// Each launch reads one pair of buffers and writes the other (ping-pong).
// The 9 edge and 10 tet ownership bits of a vertex are one packed word.
//
// What bounds it.  One substep must read x, v, inv_mass, the ownership word
// and the tet count and write x, v: 60 B per vertex, 3.8 MB at 64k, ~1.2 us
// at 3.35 TB/s, and ~53 MFLOP (~0.8 us at 67 TFLOP/s): bound by bytes.  The
// kernels do far more: each thread recomputes the reactions of the edges
// and tets it shares (about 2x the spring and 4x the tet arithmetic) and
// gathers its neighbours from L1/L2, and two launches per substep each pay
// the launch latency.  A two-pass form (per-tet scalars, then a gather)
// and fewer launches are later work.
//
// Rounding.  sqrtf and IEEE divides in the plain version's order; nvcc
// contracts a * b + c into FMAs, so kernel and plain version agree to
// rounding, not to the bit.  Pinned vertices stay bit-frozen.

#include <cuda_runtime.h>

#include "lattice_common.cuh"

namespace {

// Scalars of one substep, computed by the wrapper in double from SimConfig
// and rounded once to float, as the plain version's Python scalars are.
struct Params {
  float dt;
  float damping;        // spring-axis damper coefficient
  float gx, gy, gz;     // gravity
  float decay;          // 1 - global_damping * dt
  float restitution;    // plane bounce factor
  float restitution1;   // 1 + restitution (sphere bounce)
  float keep;           // 1 - friction
  float vol_stiff;      // volume_stiffness
};

__device__ __forceinline__ void contact(Vec3& x, Vec3& v, const Colliders& c,
                                        const Params& p) {
  resolve_velocity_contact(x.x, x.y, x.z, v.x, v.y, v.z, c, p.restitution,
                           p.restitution1, p.keep);
}

// x, v, x_out, v_out are [3, n] planes; edges is [n_edge, 3] rows of
// (delta, k, rest).  finish = 1 when the substep has no volume projection.
// kDrag: the wind's drag, drag (velocity - v), is added to the springs.
template <bool kDrag>
__global__ void __launch_bounds__(256) lattice_euler_integrate_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    float* __restrict__ x_out, float* __restrict__ v_out,
    const float* __restrict__ inv_mass, const unsigned* __restrict__ bits,
    const float* __restrict__ edges, int n_edge, Colliders col, int finish,
    Wind wind, int n, Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Vec3 xi = load3(x, i, n);
  const Vec3 vi = load3(v, i, n);
  Vec3 f = banded_spring_sum(
      x, [&](int j) { return load3(v, j, n); }, bits, edges, n_edge,
      p.damping, i, n, xi, vi);
  if (kDrag) f = add_drag(f, vi, wind);
  const float im = inv_mass[i];
  const bool movable = im > 0.0f;
  Vec3 vn = {(vi.x + p.dt * (p.gx + f.x * im)) * p.decay,
             (vi.y + p.dt * (p.gy + f.y * im)) * p.decay,
             (vi.z + p.dt * (p.gz + f.z * im)) * p.decay};
  if (!movable) vn = {0.0f, 0.0f, 0.0f};
  Vec3 xn = {xi.x + p.dt * vn.x, xi.y + p.dt * vn.y, xi.z + p.dt * vn.z};
  if (finish && movable) contact(xn, vn, col, p);
  store3(x_out, i, n, xn);
  store3(v_out, i, n, vn);
}

// xs, vs are the integrated planes; tets is [n_tet, 4] rows of
// (d1, d2, d3, rest volume); cnt is each vertex's tet count, at least 1.
__global__ void __launch_bounds__(256) lattice_euler_volume_kernel(
    const float* __restrict__ xs, const float* __restrict__ vs,
    float* __restrict__ x_out, float* __restrict__ v_out,
    const float* __restrict__ inv_mass, const unsigned* __restrict__ bits,
    const float* __restrict__ tets, int n_tet, const float* __restrict__ cnt,
    Colliders col, int n, Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Vec3 xn = load3(xs, i, n);
  Vec3 vn = load3(vs, i, n);
  if (inv_mass[i] > 0.0f) {
    const Vec3 s = banded_tet_sum(
        {0.0f, 0.0f, 0.0f}, [&](int j) { return load3(xs, j, n); }, inv_mass,
        bits, tets, n_tet, 0.0f, nullptr, nullptr, i, n);
    const float c = cnt[i];
    const Vec3 dx = {p.vol_stiff * s.x / c, p.vol_stiff * s.y / c,
                     p.vol_stiff * s.z / c};
    xn = {xn.x + dx.x, xn.y + dx.y, xn.z + dx.z};
    vn = {vn.x + dx.x / p.dt, vn.y + dx.y / p.dt, vn.z + dx.z / p.dt};
    contact(xn, vn, col, p);
  }
  store3(x_out, i, n, xn);
  store3(v_out, i, n, vn);
}

unsigned blocks_of(int n) { return (n + 255) / 256; }

}  // namespace

// Launch the integrate pass of one substep on `stream`; returns the
// cudaError_t of the launch (0 = cudaSuccess).  Allocates nothing and does
// not synchronise.
extern "C" int lattice_euler_integrate(
    const float* x, const float* v, float* x_out, float* v_out,
    const float* inv_mass, const unsigned* bits, const float* edges,
    int n_edge, COLLIDER_PARAMS, int finish, int drag_on, float wvx, float wvy, float wvz,
    float drag, int n, float dt, float damping, float gx, float gy, float gz,
    float decay, float restitution, float restitution1, float keep,
    void* stream) {
  const Params p{dt,    damping,     gx,           gy,   gz,
                 decay, restitution, restitution1, keep, 0.0f};
  const Colliders col = COLLIDERS;
  const Wind wind{wvx, wvy, wvz, drag, 0.0f};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (drag_on)
    lattice_euler_integrate_kernel<true><<<blocks_of(n), 256, 0, st>>>(
        x, v, x_out, v_out, inv_mass, bits, edges, n_edge, col, finish, wind,
        n, p);
  else
    lattice_euler_integrate_kernel<false><<<blocks_of(n), 256, 0, st>>>(
        x, v, x_out, v_out, inv_mass, bits, edges, n_edge, col, finish, wind,
        n, p);
  return static_cast<int>(cudaGetLastError());
}

// Launch the volume pass of one substep on `stream`; returns the
// cudaError_t of the launch.  Allocates nothing and does not synchronise.
extern "C" int lattice_euler_volume(
    const float* xs, const float* vs, float* x_out, float* v_out,
    const float* inv_mass, const unsigned* bits, const float* tets, int n_tet,
    const float* cnt, COLLIDER_PARAMS, int n, float dt, float vol_stiff, float restitution,
    float restitution1, float keep, void* stream) {
  const Params p{dt,          0.0f,         0.0f, 0.0f,     0.0f,
                 1.0f,        restitution,  restitution1, keep, vol_stiff};
  const Colliders col = COLLIDERS;
  lattice_euler_volume_kernel<<<blocks_of(n), 256, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      xs, vs, x_out, v_out, inv_mass, bits, tets, n_tet, cnt, col, n, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lattice_euler_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
