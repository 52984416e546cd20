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
// memory (1.5 MB at 64k vertices, resident in the 50 MB L2) and the
// neighbour across a band is simply i + delta (lattice_common.cuh).  The
// volume projection reads the neighbours' integrated positions, and with no
// grid-wide barrier that takes a kernel boundary.  One C call
// (lattice_euler_substep) launches a substep, three launches:
//   integrate  one thread per vertex: springs, the velocity and position
//              update, pinning; writes x*, v* (with no volume projection it
//              also runs the contact and writes the substep's x, v: one
//              launch a substep);
//   tet        one thread per (tet group, base vertex), each tet evaluated
//              once over x* (lattice_common.cuh::lattice_tet_kernel), its
//              gradients and multiplier into float4 scratch planes;
//   gather     one thread per vertex sums the terms of its tets in the
//              plain version's order (lattice_common.cuh::tet_gather),
//              count-averaged and scaled by volume_stiffness, x += dx,
//              v += dx / dt, then the contact.
// The call rotates the planes (LatticeEulerPlanes): the substep leaves its
// x, v where it found them.  The 9 edge and 10 tet ownership bits of a
// vertex are one packed word.
//
// What bounds it.  One substep must read x, v, inv_mass, the ownership word
// and the tet count and write x, v: 60 B per vertex, 3.8 MB at 64k, ~1.2 us
// at 3.35 TB/s, and ~53 MFLOP (~0.8 us at 67 TFLOP/s): bound by bytes.  The
// kernels do more: the integrate recomputes the reaction of each edge it
// shares (about 2x the spring arithmetic) and gathers its neighbours from
// L1/L2; the tet pass is bound by its instructions and the 30.7 MB of
// scratch it writes, the gather by the scratch it reads, 6 float4 a tet
// group and vertex from L2 and device memory (the scratch does not stay
// in L2); and three launches a substep each pay the launch latency.  A
// fourth plane a tet group, (g0, dlam), saves the gather two loads of its
// own tet but measured 2.2x slower a gather (PERF.md).
//
// Rounding.  sqrtf and IEEE divides in the plain version's order; nvcc
// contracts a * b + c into FMAs, so kernel and plain version agree to
// rounding, not to the bit.  The tet and gather passes give the earlier
// one-pass volume kernel's results to the bit (the same products in the
// same order).  Pinned vertices stay bit-frozen.

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

// xs, vs are the integrated planes and tscr the tet pass's terms; tets is
// [n_tet, 4] rows of (d1, d2, d3, rest volume); cnt is each vertex's tet
// count, at least 1.
__global__ void __launch_bounds__(256) lattice_euler_gather_kernel(
    const float* __restrict__ xs, const float* __restrict__ vs,
    float* __restrict__ x_out, float* __restrict__ v_out,
    const float* __restrict__ inv_mass, const float* __restrict__ tets,
    int n_tet, const float4* __restrict__ tscr,
    const float* __restrict__ cnt, Colliders col, int n, Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Vec3 xn = load3(xs, i, n);
  Vec3 vn = load3(vs, i, n);
  const float wi = inv_mass[i];
  if (wi > 0.0f) {
    const Vec3 s =
        tet_gather({0.0f, 0.0f, 0.0f}, tscr, tets, n_tet, wi, i, n);
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

// What one substep launches with, fixed over a call of the step function:
// softbodyunity_torch/kernels/lattice_euler.py::_Substep mirrors it field by
// field (lattice_euler_substep_size checks the two agree).
struct LatticeEulerSubstep {
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

// The [3, n] planes of a call: a substep starts from (x, v) and leaves its
// result there; (x_out, v_out) hold the integrated planes between the
// passes.  lattice_euler.py::_Planes mirrors it.
struct LatticeEulerPlanes {
  float* x;
  float* v;
  float* x_out;
  float* v_out;
};

extern "C" int lattice_euler_substep_size() {
  return static_cast<int>(sizeof(LatticeEulerSubstep));
}

// Launch one substep on s->stream: the integrate pass, then with the
// volume constraint (n_tet > 0) the tet and gather passes; without it the
// integrate runs the contact and the call swaps q's planes.  *launches
// counts the kernels launched; returns the first launch's cudaError_t that
// is not cudaSuccess, after which it launches nothing more.  Allocates
// nothing and does not synchronise.
extern "C" int lattice_euler_substep(const LatticeEulerSubstep* s,
                                     LatticeEulerPlanes* q, int* launches) {
  const cudaStream_t st = static_cast<cudaStream_t>(s->stream);
  const int n = s->n;
  const int finish = s->n_tet == 0;
  *launches = 0;
  auto done = [&]() {
    ++*launches;
    return static_cast<int>(cudaGetLastError());
  };
  if (s->drag_on)
    lattice_euler_integrate_kernel<true><<<blocks_of(n), 256, 0, st>>>(
        q->x, q->v, q->x_out, q->v_out, s->inv_mass, s->bits, s->edges,
        s->n_edge, s->col, finish, s->wind, n, s->p);
  else
    lattice_euler_integrate_kernel<false><<<blocks_of(n), 256, 0, st>>>(
        q->x, q->v, q->x_out, q->v_out, s->inv_mass, s->bits, s->edges,
        s->n_edge, s->col, finish, s->wind, n, s->p);
  if (int err = done()) return err;
  if (finish) {
    float* t = q->x;
    q->x = q->x_out;
    q->x_out = t;
    t = q->v;
    q->v = q->v_out;
    q->v_out = t;
    return 0;
  }
  lattice_tet_kernel<<<blocks_of(s->n_tet * n), 256, 0, st>>>(
      q->x_out, s->inv_mass, s->bits, s->tets, s->n_tet, s->tscr, n);
  if (int err = done()) return err;
  lattice_euler_gather_kernel<<<blocks_of(n), 256, 0, st>>>(
      q->x_out, q->v_out, q->x, q->v, s->inv_mass, s->tets, s->n_tet,
      s->tscr, s->cnt, s->col, n, s->p);
  return done();
}

// One thread a stride of the 2^32 float bit patterns: counts the x for
// which lattice_common.cuh::div6(x) is not x / 6.0f to the bit (a NaN
// matches a NaN).
__global__ void __launch_bounds__(256) lattice_div6_check_kernel(
    unsigned long long* __restrict__ mismatches) {
  const unsigned long long stride =
      static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  unsigned long long bad = 0;
  for (unsigned long long u = blockIdx.x * blockDim.x + threadIdx.x;
       u < (1ull << 32); u += stride) {
    const float x = __uint_as_float(static_cast<unsigned>(u));
    const float a = div6(x), b = x / 6.0f;
    bad += !((isnan(a) && isnan(b)) ||
             __float_as_uint(a) == __float_as_uint(b));
  }
  if (bad) atomicAdd(mismatches, bad);
}

// Launch the exhaustive check of div6 on `stream`, adding the count of
// mismatches to *mismatches (device memory, zeroed by the caller); returns
// the launch's cudaError_t.  For the card tests.
extern "C" int lattice_euler_div6_mismatches(unsigned long long* mismatches,
                                             void* stream) {
  lattice_div6_check_kernel<<<132 * 16, 256, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      mismatches);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lattice_euler_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
