// Fused XPBD substep for banded tet lattices, for Hopper (sm_90a).  Built
// by softbodyunity_torch/kernels/build.py, wrapped by
// softbodyunity_torch/kernels/lattice_xpbd.py; its plain PyTorch version is
// softbodyunity_torch/solver/step.py::substep_xpbd.
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
// Design.  A Jacobi sweep reads every neighbour's evaluation point and
// lambdas, so each sweep needs a grid-wide barrier; here that barrier is a
// kernel boundary, as in grid_xpbd.cu.  A substep is 1 + n_iterations
// launches over flat [3, N] planes, one thread per vertex:
//   predict   v <- (v + dt g)(1 - gdamp dt), 0 on pins; delta <- dt v; the
//             edge and tet lambda planes and the contact flag <- 0.  x is
//             the substep's start xp and stays read-only.
//   sweep     (n_iterations launches) at the evaluation point xe = xp +
//             delta: per edge group, dlam of the edge the vertex owns and,
//             from the same device function, argument order and old
//             lambda, dlam of the edge owned by i - d; per tet group, its
//             own tet and its share as corner k of the tet based at i - d_k
//             (lattice_common.cuh); the vertex writes only its own new
//             lambdas; delta += relaxation dx / count; then the plane clamp
//             as plane - xp (OR'd into the contact flag), the sphere
//             push-out as a delta and the capsules' and boxes' as another
//             (grid_common.cuh::project_delta).  delta and the lambda
//             planes ping-pong;
//             the flag is the vertex's own and stays in place.
//   epilogue  run by the last sweep: plane friction on the OR'd flag,
//             sphere and capsule/box friction
//             (grid_common.cuh::friction_delta), pins masked, x = xp +
//             delta into the other x buffer, v = delta / dt in place.
// Delta form: the loop carries the substep's position change and never a
// rounded x (the f32 drift bound depends on it).
//
// What bounds it.  One substep must read x, v, inv_mass, the ownership word
// and the constraint count and write x, v: 60 B per vertex, 3.8 MB at 64k,
// ~1.2 us at 3.35 TB/s; 8 sweeps over 370k distance and 297k volume
// constraints are ~430 MFLOP, ~6.4 us at 67 TFLOP/s: bound by operations.
// Each sweep moves the 19 lambda planes and delta through L2 (~12 MB at
// 64k), recomputes the shared constraints (2x edges, 4x tets), and 9
// launches per substep each pay the launch latency.
//
// Rounding.  sqrtf and IEEE divides in the plain version's order; FMA
// contraction makes the agreement one of rounding.  Pinned vertices keep x
// bit for bit (their delta is masked to 0 and xp + 0 == xp).

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

// One Jacobi sweep (project = 1) and, on the last sweep (last = 1), the
// substep's epilogue.  xp, delta_*, x_out, v are [3, n] planes; lam_* are
// [n_edge + n_tet, n] (edge groups first); edges is [n_edge, 3] rows of
// (delta, rest, alpha / dt^2); tets is [n_tet, 4] rows of (d1, d2, d3,
// rest volume); cnt is the constraint count, at least 1.  With
// n_iterations = 0 the wrapper launches one sweep with project = 0, which
// runs only the epilogue.
__global__ void __launch_bounds__(256) lattice_xpbd_sweep_kernel(
    const float* __restrict__ xp, const float* __restrict__ delta_in,
    float* __restrict__ delta_out, const float* __restrict__ lam_in,
    float* __restrict__ lam_out, unsigned char* __restrict__ flag,
    const float* __restrict__ inv_mass, const unsigned* __restrict__ bits,
    const float* __restrict__ edges, int n_edge,
    const float* __restrict__ tets, int n_tet, const float* __restrict__ cnt,
    Colliders col, int project, int last, float* __restrict__ x_out,
    float* __restrict__ v, int n, Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Vec3 xpi = load3(xp, i, n);
  Vec3 dl = load3(delta_in, i, n);
  const float wi = inv_mass[i];
  const bool movable = wi > 0.0f;

  if (project) {
    auto xe_of = [&](int j) { return eval_point(xp, delta_in, j, n); };
    const Vec3 xe = {xpi.x + dl.x, xpi.y + dl.y, xpi.z + dl.z};
    const unsigned bi = bits[i];
    Vec3 dx = {0.0f, 0.0f, 0.0f};
    for (int g = 0; g < n_edge; ++g) {
      const int d = static_cast<int>(edges[3 * g]);
      const float rest = edges[3 * g + 1];
      const float at = edges[3 * g + 2];
      Vec3 nrm;
      // the edge this vertex owns, to i + d: lambda and -w dlam n
      float lam = lam_in[g * n + i];
      if (has_bit(bi, g)) {
        const int nb = i + d;
        const float dlam = xpbd_dlam(xe, xe_of(nb), wi, inv_mass[nb], at,
                                     rest, lam, nrm);
        lam += dlam;
        add_scaled(dx, -(wi * dlam), nrm);
      }
      lam_out[g * n + i] = lam;
      // the edge owned by i - d, recomputed: +w dlam n here
      const int o = i - d;
      if (in_range(o, n) && has_bit(bits[o], g)) {
        const float dlam = xpbd_dlam(xe_of(o), xe, inv_mass[o], wi, at, rest,
                                     lam_in[g * n + o], nrm);
        add_scaled(dx, wi * dlam, nrm);
      }
    }
    dx = banded_tet_sum(dx, xe_of, inv_mass, bits, tets, n_tet, p.alpha_v,
                        lam_in + n_edge * n, lam_out + n_edge * n, i, n);
    const float c = cnt[i];
    dl = {dl.x + p.relax * dx.x / c, dl.y + p.relax * dx.y / c,
          dl.z + p.relax * dx.z / c};
    if (movable) project_delta(dl, xpi, flag + i, col);
    if (!last) {
      store3(delta_out, i, n, dl);
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

// Launch the predict pass of one substep on `stream`; returns the
// cudaError_t of the launch (0 = cudaSuccess).  Allocates nothing and does
// not synchronise.
extern "C" int lattice_xpbd_predict(const float* v, float* delta, float* lam,
                                    int n_lam, unsigned char* flag,
                                    const float* inv_mass, int drag_on,
                                    float wvx, float wvy, float wvz,
                                    float drag, int n, float dt, float gx,
                                    float gy, float gz, float decay,
                                    void* stream) {
  const Params p{dt, gx, gy, gz, decay, 0.0f, 1.0f, 1.0f, 1.0f, 0.0f};
  const Wind wind{wvx, wvy, wvz, drag, 0.0f};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (drag_on)
    lattice_xpbd_predict_kernel<true><<<blocks_of(n), 256, 0, st>>>(
        v, delta, lam, n_lam, flag, inv_mass, wind, n, p);
  else
    lattice_xpbd_predict_kernel<false><<<blocks_of(n), 256, 0, st>>>(
        v, delta, lam, n_lam, flag, inv_mass, wind, n, p);
  return static_cast<int>(cudaGetLastError());
}

// Launch one Jacobi sweep (and, with last = 1, the epilogue) on `stream`;
// returns the cudaError_t of the launch.  Allocates nothing and does not
// synchronise.
extern "C" int lattice_xpbd_sweep(
    const float* xp, const float* delta_in, float* delta_out,
    const float* lam_in, float* lam_out, unsigned char* flag,
    const float* inv_mass, const unsigned* bits, const float* edges,
    int n_edge, const float* tets, int n_tet, const float* cnt,
    COLLIDER_PARAMS, int project, int last, float* x_out,
    float* v, int n, float dt, float mu, float keep, float shell, float relax,
    float alpha_v, void* stream) {
  const Params p{dt, 0.0f, 0.0f, 0.0f, 1.0f, mu, keep, shell, relax, alpha_v};
  const Colliders col = COLLIDERS;
  lattice_xpbd_sweep_kernel<<<blocks_of(n), 256, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      xp, delta_in, delta_out, lam_in, lam_out, flag, inv_mass, bits, edges,
      n_edge, tets, n_tet, cnt, col, project, last, x_out, v, n, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lattice_xpbd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
