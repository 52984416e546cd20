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
// Design.  As lattice_euler.cu: flat [3, N] planes, neighbours at i +
// delta, and a kernel boundary before the volume projection, which reads
// the neighbours' integrated positions.  One C call (lattice_verlet_substep)
// launches a substep, three launches:
//   integrate  one thread per vertex: springs and the damped update from
//              (x, xp), written to a scratch plane xs (with no volume
//              projection it also runs the contact, and xs is the
//              substep's result);
//   tet        each tet evaluated once over xs (lattice_common.cuh::
//              lattice_tet_kernel), its terms into float4 scratch planes;
//   gather     one thread per vertex sums the terms of its tets in the
//              plain version's order (lattice_common.cuh::tet_gather),
//              count-averaged and scaled by volume_stiffness, then the
//              contact and friction against the substep's start x; written
//              over xp, which no thread of this launch reads.
// The springs' damper reads every neighbour's velocity estimate (x - xp) /
// dt.  A ve plane holds it: whichever pass writes a substep's final x also
// writes (x_out - x) / dt, the same floats the next substep's (x - xp) / dt
// gives, into the other of two ve planes, and the integrate reads its
// neighbours' from the current one.  The first substep of a call takes its
// plane from the state's (x, x_prev), by one launch of
// lattice_verlet_velocity_kernel.  Nothing may overwrite x, xp or ve
// during the integrate launch: the call rotates three x planes and the
// two ve planes (LatticeVerletPlanes).
//
// What bounds it.  One substep must read x, xp, inv_mass, the ownership
// word and the tet count and write x: 48 B per vertex, 3.1 MB at 64k,
// ~0.9 us at 3.35 TB/s, and ~55 MFLOP (~0.8 us): bound by bytes.  As with
// the Euler kernel the recomputed spring reactions (2x), the neighbour
// gathers, the tet pass's arithmetic and scratch writes, the gather's
// scratch reads and three launches per substep keep it well above that.
//
// Rounding.  sqrtf and IEEE divides in the plain version's order; FMA
// contraction makes the agreement one of rounding.  The ve plane, the tet
// and the gather passes give the earlier one-pass kernels' results to the
// bit.  Pinned vertices keep x bit for bit.

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

// The velocity estimate (x - xp) / dt of the first substep of a call.
__global__ void __launch_bounds__(256) lattice_verlet_velocity_kernel(
    const float* __restrict__ x, const float* __restrict__ xp,
    float* __restrict__ ve, int n, float dt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store3(ve, i, n, velocity_estimate(load3(x, i, n), load3(xp, i, n), dt));
}

// x, xp, ve, xs, ve_out are [3, n] planes; edges is [n_edge, 3] rows of
// (delta, k, rest).  finish = 1 when the substep has no volume projection:
// then the contact runs here and the next substep's velocity estimate goes
// to ve_out.  kDrag: the wind's drag at the velocity estimate is added to
// the springs.
template <bool kDrag>
__global__ void __launch_bounds__(256) lattice_verlet_integrate_kernel(
    const float* __restrict__ x, const float* __restrict__ xp,
    const float* __restrict__ ve, float* __restrict__ xs,
    float* __restrict__ ve_out, const float* __restrict__ inv_mass,
    const unsigned* __restrict__ bits, const float* __restrict__ edges,
    int n_edge, Colliders col, int finish, Wind wind, int n, Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Vec3 xi = load3(x, i, n);
  const Vec3 vi = load3(ve, i, n);
  Vec3 f = banded_spring_sum(
      x, [&](int j) { return load3(ve, j, n); }, bits, edges, n_edge,
      p.damping, i, n, xi, vi);
  if (kDrag) f = add_drag(f, vi, wind);
  const float im = inv_mass[i];
  Vec3 xn = xi;                // pinned: x stays, bit for bit
  if (im > 0.0f) {
    const Vec3 pi = load3(xp, i, n);
    const float ax = p.gx + f.x * im, ay = p.gy + f.y * im,
                az = p.gz + f.z * im;
    xn = {xi.x + (xi.x - pi.x) * p.decay + ax * p.dt * p.dt,
          xi.y + (xi.y - pi.y) * p.decay + ay * p.dt * p.dt,
          xi.z + (xi.z - pi.z) * p.decay + az * p.dt * p.dt};
    if (finish) xn = contact(xn, xi, col, p);
  }
  store3(xs, i, n, xn);
  if (finish) store3(ve_out, i, n, velocity_estimate(xn, xi, p.dt));
}

// xs is the integrated plane, x the substep's start, tscr the tet pass's
// terms; tets is [n_tet, 4] rows of (d1, d2, d3, rest volume); cnt is each
// vertex's tet count, at least 1.  Writes the substep's x to out and the
// next substep's velocity estimate to ve_out.
__global__ void __launch_bounds__(256) lattice_verlet_gather_kernel(
    const float* __restrict__ xs, const float* __restrict__ x,
    float* __restrict__ out, float* __restrict__ ve_out,
    const float* __restrict__ inv_mass, const float* __restrict__ tets,
    int n_tet, const float4* __restrict__ tscr,
    const float* __restrict__ cnt, Colliders col, int n, Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Vec3 xn = load3(xs, i, n);
  const Vec3 x0 = load3(x, i, n);
  const float wi = inv_mass[i];
  if (wi > 0.0f) {
    const Vec3 s =
        tet_gather({0.0f, 0.0f, 0.0f}, tscr, tets, n_tet, wi, i, n);
    const float c = cnt[i];
    xn = {xn.x + p.vol_stiff * s.x / c, xn.y + p.vol_stiff * s.y / c,
          xn.z + p.vol_stiff * s.z / c};
    xn = contact(xn, x0, col, p);
  }
  store3(out, i, n, xn);
  store3(ve_out, i, n, velocity_estimate(xn, x0, p.dt));
}

unsigned blocks_of(int n) { return (n + 255) / 256; }

}  // namespace

// What one substep launches with, fixed over a call of the step function:
// softbodyunity_torch/kernels/lattice_verlet.py::_Substep mirrors it field
// by field (lattice_verlet_substep_size checks the two agree).
struct LatticeVerletSubstep {
  const float* inv_mass;    // [n]
  const unsigned* bits;     // [n]
  const float* edges;       // [n_edge, 3]
  const float* tets;        // [n_tet, 4]; n_tet = 0 without volume
  const float* cnt;         // [n]
  float4* tscr;             // [n_tet * 3, n], the tet pass's terms
  void* stream;
  int n_edge, n_tet, n;
  int drag_on;
  Colliders col;
  Wind wind;
  Params p;
};

// The [3, n] planes of a call: a substep starts from (x, xp) and the
// velocity estimate ve and leaves its result in (x, xp, ve) again; xs
// holds the integrated positions between the passes, ve_out the next
// substep's estimate.  lattice_verlet.py::_Planes mirrors it.
struct LatticeVerletPlanes {
  float* x;
  float* xp;
  float* xs;
  float* ve;
  float* ve_out;
};

extern "C" int lattice_verlet_substep_size() {
  return static_cast<int>(sizeof(LatticeVerletSubstep));
}

// Launch one substep on s->stream: with first = 1 (a call's first substep)
// the velocity estimate from (x, xp), then the integrate pass and, with the
// volume constraint (n_tet > 0), the tet and gather passes; the call then
// rotates q's planes.  *launches counts the kernels launched; returns the
// first launch's cudaError_t that is not cudaSuccess, after which it
// launches nothing more.  Allocates nothing and does not synchronise.
extern "C" int lattice_verlet_substep(const LatticeVerletSubstep* s,
                                      LatticeVerletPlanes* q, int first,
                                      int* launches) {
  const cudaStream_t st = static_cast<cudaStream_t>(s->stream);
  const int n = s->n;
  const int finish = s->n_tet == 0;
  *launches = 0;
  auto done = [&]() {
    ++*launches;
    return static_cast<int>(cudaGetLastError());
  };
  if (first) {
    lattice_verlet_velocity_kernel<<<blocks_of(n), 256, 0, st>>>(
        q->x, q->xp, q->ve, n, s->p.dt);
    if (int err = done()) return err;
  }
  if (s->drag_on)
    lattice_verlet_integrate_kernel<true><<<blocks_of(n), 256, 0, st>>>(
        q->x, q->xp, q->ve, q->xs, q->ve_out, s->inv_mass, s->bits,
        s->edges, s->n_edge, s->col, finish, s->wind, n, s->p);
  else
    lattice_verlet_integrate_kernel<false><<<blocks_of(n), 256, 0, st>>>(
        q->x, q->xp, q->ve, q->xs, q->ve_out, s->inv_mass, s->bits,
        s->edges, s->n_edge, s->col, finish, s->wind, n, s->p);
  if (int err = done()) return err;
  float* const x0 = q->x;
  if (finish) {              // xs is the new x
    q->x = q->xs;
    q->xs = q->xp;
  } else {
    lattice_tet_kernel<<<blocks_of(s->n_tet * n), 256, 0, st>>>(
        q->xs, s->inv_mass, s->bits, s->tets, s->n_tet, s->tscr, n);
    if (int err = done()) return err;
    lattice_verlet_gather_kernel<<<blocks_of(n), 256, 0, st>>>(
        q->xs, q->x, q->xp, q->ve_out, s->inv_mass, s->tets, s->n_tet,
        s->tscr, s->cnt, s->col, n, s->p);
    if (int err = done()) return err;
    q->x = q->xp;            // the gather wrote the new x over xp
  }
  q->xp = x0;
  float* const ve = q->ve;
  q->ve = q->ve_out;
  q->ve_out = ve;
  return 0;
}

extern "C" const char* lattice_verlet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
