// Fused XPBD substep for banded tet lattices, for Hopper (sm_90a).  Built
// by softbodyunity_torch/kernels/build.py, wrapped by
// softbodyunity_torch/kernels/lattice_xpbd.py; its plain PyTorch version is
// softbodyunity_torch/solver/step.py::substep_xpbd (its sweep
// solver/banded.py::xpbd_iteration_banded).
//
// Replaces the TPU kernel softbodyunity_tpu/kernels/pallas_lattice.py
// ::_make_xpbd_kernel, launched by ::_pallas_lattice_xpbd_substeps through
// pl.pallas_call, for the branches the tet-cube XPBD path runs: predict
// (gravity, global damping, pinning), n_iterations Jacobi sweeps over the
// banded distance constraints and the banded tet-volume constraints, both
// with compliance and per-group lambda planes, count-averaged and
// under-relaxed, plane, sphere, capsule and oriented-box contact projected
// inside the loop, their friction once after it, v = delta / dt, and the
// wind's drag in the predict (the kDrag instantiation; lift is gated off
// lattices).
//
// Design.  A Jacobi sweep reads every neighbour's evaluation point, so each
// sweep needs a grid-wide barrier; here that barrier is a kernel boundary.
// Each constraint is evaluated once per sweep, by one thread, and a second
// pass gathers the terms at each vertex.  One C call (lattice_xpbd_substep)
// launches a substep, 1 + 2 n_iterations launches, over flat [3, N] planes:
//   predict     one thread per vertex: v <- (v + dt g)(1 - gdamp dt), 0 on
//               pins; delta <- dt v; the edge and tet lambda planes and the
//               contact flag <- 0.  x is the substep's start xp and stays
//               read-only.
//   constraint  one thread per (constraint group, base vertex), masked by
//               the owner's bit: at the evaluation points xe (xp + delta
//               on a substep's first sweep, else the plane the last gather
//               wrote), the edge's dlam and unit direction n
//               (grid_common.cuh::xpbd_dlam) or the tet's dlam and
//               gradients g1, g2, g3 (lattice_common.cuh::tet_term); the
//               new lambda back into the owner's entry, in place (no other
//               thread reads it), and the terms into the scratch planes,
//               zeros where the vertex owns no such constraint.
//   gather      one thread per vertex sums, in the plain version's order,
//               per edge group -(w dlam) n of the edge it owns and
//               +(w dlam) n of the edge owned by i - d, then per tet group
//               (w dlam) g0 of its own tet, g0 = -(g1 + g2 + g3) summed as
//               tet_term sums it, and (w dlam) g_k as corner k = 1, 2, 3 of
//               the tet based at i - d_k (a zero term adds a signed zero,
//               which leaves dx as skipping it would); delta += relaxation
//               dx / count; then the plane clamp as plane - xp (OR'd into
//               the contact flag), the sphere push-out as a delta and the
//               capsules' and boxes' as another (grid_common.cuh::
//               project_delta); delta, in place, and xe = xp + delta out
//               (a gather reads only its own vertex's delta and flag).
//   epilogue    run by the last gather: plane friction on the OR'd flag,
//               sphere and capsule/box friction (grid_common.cuh::
//               friction_delta), pins masked, x = xp + delta into the other
//               x buffer, v = delta / dt in place.  With n_iterations = 0
//               a gather with project = 0 runs it alone (2 launches).
// Delta form: the loop carries the substep's position change and never a
// rounded x (the f32 drift bound depends on it).
//
// Scratch.  An edge's (n, dlam) sits in a float4 plane a group and a tet's
// (g1, dlam), (g2, dlam), (g3, dlam) in three, [Ge, N] and [Gt * 3, N]
// float4 (a corner's term is one 16-byte load): 9.2 MB + 30.7 MB at 40^3
// (9 edge and 10 tet groups), 47 MB a sweep with the lambdas, delta, xe, x
// and the masks.  That is about the whole 50 MB L2, whose two halves each
// serve half the SMs, and the gather reads the terms at i - d_k (d_k up to
// 1,641 vertices back) after other SMs wrote them, so the scratch does not
// stay in L2: part of it goes to device memory and back each sweep.  A
// narrower form that kept dlam alone and had the gather recompute each
// owned direction and gradient measured 1.7x slower a sweep (PERF.md).
//
// What bounds it.  One substep must read x, v, inv_mass, the ownership word
// and the constraint count and write x, v: 60 B per vertex, 3.8 MB at 64k,
// ~1.2 us at 3.35 TB/s; 8 sweeps over 370k distance and 297k volume
// constraints are ~430 MFLOP, ~6.4 us at 67 TFLOP/s: bound by operations.
// On the card the constraint pass is bound by its instructions (a tet's
// ten divides by 6 are lattice_common.cuh::div6, a product and two FMAs)
// and the gather by the scratch it reads, ~290 floats a vertex from L2 and
// device memory.
//
// Rounding.  sqrtf and IEEE divides in the plain version's order: the
// products keep the order (w dlam) n and (w dlam) g_k of the earlier
// one-pass kernel and the plain version, whose results these passes give
// to the bit; FMA contraction makes the agreement with the plain version
// one of rounding.  Pinned vertices keep x bit for bit (their
// delta is masked to 0 and xp + 0 == xp).

#include <cuda_runtime.h>

#include "lattice_common.cuh"

namespace {

// Scalars of one substep, computed by the wrapper in double from SimConfig
// and rounded once to float, as the plain version's Python scalars are.
struct Params {
  float dt;
  float gx, gy, gz;   // gravity
  float decay;        // 1 - global_damping * dt
  float mu;           // friction
  float keep;         // 1 - friction
  float shell;        // SPHERE_CONTACT_SHELL
  float relax;        // xpbd.relaxation
  float alpha_v;      // compliance_volume / dt^2
};

// kDrag: the wind's drag enters the acceleration as g + drag (velocity -
// v) w (pallas_lattice.py:521).
template <bool kDrag>
__global__ void __launch_bounds__(256) lattice_xpbd_predict_kernel(
    const float* __restrict__ v, float* __restrict__ delta,
    float* __restrict__ lam, int n_lam, unsigned char* __restrict__ flag,
    const float* __restrict__ inv_mass, Wind wind, int n, Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Vec3 vi = load3(v, i, n);
  if (kDrag) {
    const float w = inv_mass[i];
    const Vec3 f = add_drag({0.0f, 0.0f, 0.0f}, vi, wind);
    vi = {(vi.x + p.dt * (p.gx + f.x * w)) * p.decay,
          (vi.y + p.dt * (p.gy + f.y * w)) * p.decay,
          (vi.z + p.dt * (p.gz + f.z * w)) * p.decay};
  } else {
    vi = {(vi.x + p.dt * p.gx) * p.decay, (vi.y + p.dt * p.gy) * p.decay,
          (vi.z + p.dt * p.gz) * p.decay};
  }
  if (!(inv_mass[i] > 0.0f)) vi = {0.0f, 0.0f, 0.0f};
  store3(delta, i, n, {p.dt * vi.x, p.dt * vi.y, p.dt * vi.z});
  for (int g = 0; g < n_lam; ++g) lam[g * n + i] = 0.0f;
  flag[i] = 0;
}

// One constraint pass: thread t evaluates constraint group t / n (edge
// groups first) at base vertex t % n, at the evaluation points xe, [3, n]
// (the last gather's; the first sweep of a substep passes null and reads
// xp + delta, the same float sums).  lam is [n_edge + n_tet, n] and
// updated in place where the vertex owns the constraint; edges is
// [n_edge, 3] rows of (delta, rest, alpha / dt^2), tets [n_tet, 4] rows of
// (d1, d2, d3, rest volume); escr is [n_edge, n] float4 (n, dlam), tscr
// [n_tet * 3, n] float4 (g_k, dlam).  A vertex that does not own the
// constraint writes zeros, so that the gather reads every entry without the
// ownership word; the corners' loads do not wait for that word either (a
// corner out of range reads the base vertex, and the result is dropped).
__global__ void __launch_bounds__(256) lattice_xpbd_constraint_kernel(
    const float* __restrict__ xp, const float* __restrict__ delta,
    const float* __restrict__ xe, float* __restrict__ lam,
    const float* __restrict__ inv_mass, const unsigned* __restrict__ bits,
    const float* __restrict__ edges, int n_edge,
    const float* __restrict__ tets, int n_tet, float4* __restrict__ escr,
    float4* __restrict__ tscr, float alpha_v, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = t / n;
  const int i = t - g * n;
  if (g >= n_edge + n_tet) return;
  auto clamp = [&](int j) { return in_range(j, n) ? j : i; };
  auto xe_of = [&](int j) {
    return xe ? load3(xe, j, n) : eval_point(xp, delta, j, n);
  };
  const unsigned bi = bits[i];
  const float lam_i = lam[t];
  if (g < n_edge) {
    const int nb = clamp(i + static_cast<int>(edges[3 * g]));
    Vec3 nrm;
    float dlam = xpbd_dlam(xe_of(i), xe_of(nb), inv_mass[i], inv_mass[nb],
                           edges[3 * g + 2], edges[3 * g + 1], lam_i, nrm);
    if (has_bit(bi, g)) {
      lam[t] = lam_i + dlam;
    } else {
      dlam = 0.0f;
      nrm = {0.0f, 0.0f, 0.0f};
    }
    escr[t] = make_float4(nrm.x, nrm.y, nrm.z, dlam);
    return;
  }
  const int tg = g - n_edge;
  const int b1 = clamp(i + static_cast<int>(tets[4 * tg]));
  const int b2 = clamp(i + static_cast<int>(tets[4 * tg + 1]));
  const int b3 = clamp(i + static_cast<int>(tets[4 * tg + 2]));
  TetTerm tt = tet_term(xe_of(i), xe_of(b1), xe_of(b2), xe_of(b3),
                        inv_mass[i], inv_mass[b1], inv_mass[b2], inv_mass[b3],
                        tets[4 * tg + 3], alpha_v, lam_i);
  if (has_bit(bi, kTetBit + tg)) {
    lam[t] = lam_i + tt.dlam;
  } else {
    tt.dlam = 0.0f;
    tt.g1 = tt.g2 = tt.g3 = {0.0f, 0.0f, 0.0f};
  }
  store_tet_term(tscr, tg, i, n, tt);
}

// One gather pass (project = 1) and, on the last sweep (last = 1), the
// substep's epilogue; with project = 0 the epilogue alone.  xp, delta,
// xe_out, x_out, v are [3, n] planes (delta updated in place; a sweep but
// the last writes the next constraint pass's evaluation points xp + delta
// to xe_out); the scratch as the constraint pass wrote it (zeros where a
// vertex owns no constraint: such a term adds a signed zero, which leaves
// dx as skipping it would), so no ownership word is read; cnt is the
// constraint count, at least 1.
__global__ void __launch_bounds__(256) lattice_xpbd_gather_kernel(
    const float* __restrict__ xp, float* __restrict__ delta,
    unsigned char* __restrict__ flag, const float* __restrict__ inv_mass,
    const float* __restrict__ edges, int n_edge,
    const float* __restrict__ tets, int n_tet,
    const float4* __restrict__ escr, const float4* __restrict__ tscr,
    const float* __restrict__ cnt, Colliders col, int project, int last,
    float* __restrict__ xe_out, float* __restrict__ x_out,
    float* __restrict__ v, int n, Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Vec3 xpi = load3(xp, i, n);
  Vec3 dl = load3(delta, i, n);
  const float wi = inv_mass[i];
  const bool movable = wi > 0.0f;

  if (project) {
    Vec3 dx = {0.0f, 0.0f, 0.0f};
    for (int g = 0; g < n_edge; ++g) {
      // the edge this vertex owns, to i + d: -(w dlam) n
      float4 e = escr[g * n + i];
      add_scaled(dx, -(wi * e.w), {e.x, e.y, e.z});
      // the edge owned by i - d: +(w dlam) n here
      const int o = i - static_cast<int>(edges[3 * g]);
      if (in_range(o, n)) {
        e = escr[g * n + o];
        add_scaled(dx, wi * e.w, {e.x, e.y, e.z});
      }
    }
    dx = tet_gather(dx, tscr, tets, n_tet, wi, i, n);
    const float c = cnt[i];
    dl = {dl.x + p.relax * dx.x / c, dl.y + p.relax * dx.y / c,
          dl.z + p.relax * dx.z / c};
    if (movable) project_delta(dl, xpi, flag + i, col);
    if (!last) {
      store3(delta, i, n, dl);
      store3(xe_out, i, n, {xpi.x + dl.x, xpi.y + dl.y, xpi.z + dl.z});
      return;
    }
  }

  // epilogue: friction once, pins masked, x and v out
  dl = friction_delta(dl, xpi, movable, flag[i], col, p.mu, p.keep, p.dt,
                      p.shell);
  store3(x_out, i, n, {xpi.x + dl.x, xpi.y + dl.y, xpi.z + dl.z});
  store3(v, i, n, {dl.x / p.dt, dl.y / p.dt, dl.z / p.dt});
}

unsigned blocks_of(int n) { return (n + 255) / 256; }

}  // namespace

// What one substep launches with, fixed over a call of the step function:
// softbodyunity_torch/kernels/lattice_xpbd.py::_Substep mirrors it field by
// field (lattice_xpbd_substep_size checks the two agree).
struct LatticeXpbdSubstep {
  float* v;                 // [3, n], in place
  float* delta;             // [3, n], in place
  float* xe;                // [3, n] the evaluation points after a sweep
  float* lam;               // [n_edge + n_tet, n]
  unsigned char* flag;      // [n]
  const float* inv_mass;    // [n]
  const unsigned* bits;     // [n]
  const float* edges;       // [n_edge, 3]
  const float* tets;        // [n_tet, 4]
  const float* cnt;         // [n]
  float4* escr;             // the scratch planes (kernel notes above)
  float4* tscr;
  void* stream;
  int n_edge, n_tet, n;
  int n_iterations;
  int drag_on;
  Colliders col;
  Wind wind;
  Params p;
};

extern "C" int lattice_xpbd_substep_size() {
  return static_cast<int>(sizeof(LatticeXpbdSubstep));
}

// Launch one substep on s->stream: the predict, then per Jacobi sweep a
// constraint and a gather pass, the last gather running the epilogue (with
// no sweep, one gather runs the epilogue alone).  x is the substep's start,
// x_out receives its end.  *launches counts the kernels launched; returns
// the first launch's cudaError_t that is not cudaSuccess, after which it
// launches nothing more.  Allocates nothing and does not synchronise.
extern "C" int lattice_xpbd_substep(const LatticeXpbdSubstep* s,
                                    const float* x, float* x_out,
                                    int* launches) {
  const cudaStream_t st = static_cast<cudaStream_t>(s->stream);
  const int n = s->n, n_lam = s->n_edge + s->n_tet;
  *launches = 0;
  auto done = [&]() {
    ++*launches;
    return static_cast<int>(cudaGetLastError());
  };
  if (s->drag_on)
    lattice_xpbd_predict_kernel<true><<<blocks_of(n), 256, 0, st>>>(
        s->v, s->delta, s->lam, n_lam, s->flag, s->inv_mass, s->wind, n,
        s->p);
  else
    lattice_xpbd_predict_kernel<false><<<blocks_of(n), 256, 0, st>>>(
        s->v, s->delta, s->lam, n_lam, s->flag, s->inv_mass, s->wind, n,
        s->p);
  if (int err = done()) return err;
  const int sweeps = s->n_iterations > 0 ? s->n_iterations : 1;
  const int project = s->n_iterations > 0;
  for (int it = 0; it < sweeps; ++it) {
    const int last = it == sweeps - 1;
    if (project) {
      lattice_xpbd_constraint_kernel<<<blocks_of(n_lam * n), 256, 0, st>>>(
          x, s->delta, it ? s->xe : nullptr, s->lam, s->inv_mass, s->bits,
          s->edges, s->n_edge, s->tets, s->n_tet, s->escr, s->tscr,
          s->p.alpha_v, n);
      if (int err = done()) return err;
    }
    lattice_xpbd_gather_kernel<<<blocks_of(n), 256, 0, st>>>(
        x, s->delta, s->flag, s->inv_mass, s->edges, s->n_edge, s->tets,
        s->n_tet, s->escr, s->tscr, s->cnt, s->col, project, last, s->xe,
        x_out, s->v, n, s->p);
    if (int err = done()) return err;
  }
  return 0;
}

extern "C" const char* lattice_xpbd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
