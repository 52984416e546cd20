// Fused XPBD substep for structured grid cloth, for Hopper (sm_90a).  Built
// by softbodyunity_torch/kernels/build.py, wrapped by
// softbodyunity_torch/kernels/grid_xpbd.py; its plain PyTorch version is
// softbodyunity_torch/kernels/stencil.py::xpbd_substep_grid (with
// update_features, in the launch-start order of
// softbodyunity_torch/kernels/grid_features.py).
//
// Replaces two TPU kernels of softbodyunity_tpu/kernels/: the whole-VMEM
// pallas_xpbd.py::_make_kernel, launched by ::_pallas_xpbd_substeps through
// pl.pallas_call, and the row-tiled pallas_tiled.py::_make_xpbd_tiled_kernel,
// launched by ::_tiled_xpbd_substeps (grids past the whole-VMEM cap).  It
// runs their branches of the grid-cloth XPBD path: predict (gravity, global
// damping, pinning), n_iterations Jacobi sweeps of distance constraints
// with compliance over the six grid offsets, with per-offset lambda planes,
// count-averaged and under-relaxed, plane, sphere, capsule and oriented-box
// contact projected inside the loop in delta form, their friction once
// after it, the velocity recovered from the position change, and the
// tear-liveness and plastic rest-scale planes (the kFeat instantiations),
// the wind's drag and lift in the predict (the kWind instantiation), and
// the strain limit's sweeps after the Jacobi loop (grid_common.cuh::grid_strain_sweep_kernel; its last
// sweep runs one more contact projection and the epilogue:
// XpbdStrainEpilogue below).
//
// Design.  A Jacobi sweep reads every neighbour's evaluation point, so each
// sweep needs a grid-wide barrier; here that barrier is a kernel boundary.
// The row-tiled TPU kernel instead runs a whole substep per tile on halos
// of reach x n_iterations rows, recomputing the overlap; global Jacobi with
// one launch per sweep is what that computes.
// A substep is 1 + n_iterations launches, one thread per vertex each:
//   predict   v <- (v + dt g)(1 - gdamp dt), 0 on pins; delta <- dt v; the
//             lambda planes and the contact flag <- 0.  x is the substep's
//             start position xp and stays read-only until the next substep.
//             An optional external force plane f (the self-collision
//             repulsion at xp, block_pairs.cu) enters here as
//             g + f inv_mass, as solver/step.py::substep_xpbd takes it;
//             the sweeps cover only the springs.  kFeat: the feature update
//             of the launch-start form (grid_euler.cu) runs here, from xp,
//             unless it is the frame's first substep; the predict writes
//             the substep's tear and plastic planes and, under tearing,
//             the Jacobi weights inv_cnt from the updated liveness: the
//             count of live edges at a vertex changes as edges tear.  The
//             plastic rest scales stay constant over the substep.
//   sweep     (n_iterations launches) evaluate xe = xp + delta at the
//             vertex and its 12 neighbours; per offset, dlam of the edge the
//             vertex owns and, from the same device function, argument order
//             and old lambda, dlam of the edge owned by p - o; write only the
//             vertex's own new lambdas; delta += dx * inv_cnt; then the
//             plane clamp in ``plane - xp`` form (OR'd into the contact
//             flag), the sphere push-out as a delta, then the capsules'
//             and boxes' as another (grid_common.cuh::project_delta).
//             delta and the lambda planes ping-pong between sweeps (an
//             in-place update would let thread p - o overwrite the lambda
//             thread p still reads); the contact flag is the vertex's own
//             and stays put.
//             kFeat: a torn edge is skipped and a plastic one's rest is
//             rest * scale, both read from the predict's planes.
//   epilogue  run by the last sweep for its own vertex: plane friction on
//             the OR'd flag, sphere and capsule/box friction
//             (grid_common.cuh::friction_delta), pins masked, x = xp + delta
//             written to the other x buffer, v = delta / dt in place.
//   strain    under the strain limit, iterations more launches after the
//             Jacobi sweeps (which then all store delta): the strain sweeps
//             on xp + delta, and the last of them adds its change to delta,
//             projects the contact once more (its plane clamp ORed into the
//             flag) and runs the epilogue instead of the last Jacobi sweep.
// Delta form: the loop carries the substep's position change and never a
// rounded x (the f32 drift bound depends on it).  Without tearing, inv_cnt
// = relaxation / max(count, 1) is computed once per scene, as
// pallas_xpbd.py does.
//
// What bounds it.  At 64k vertices one substep must read x, v and inv_mass
// and write x and v (3.4 MB, ~1.0 us at 3.35 TB/s), and does ~36 flops per
// edge and sweep: 8 sweeps over 391k edges are ~120 MFLOP, ~1.8 us at the
// 67 TFLOP/s float32 peak, so the work is bound by operations.  Each sweep
// launch moves ~6 MB through L2 (xp, delta, lambdas), and 9 launches per
// substep each cost several microseconds of launch latency: at 64k the path
// is bound by launches, not by the card.  A cooperative single-launch form
// or a CUDA graph is later work.
//
// Rounding.  sqrtf and IEEE divides in the plain version's order (the
// divide-form norm d / max(len, 1e-12)); FMA contraction and the folded
// relaxation make the agreement one of rounding, except in the feature
// update, rounded as the plain version rounds it (grid_common.cuh).  Pinned
// vertices keep x bit for bit (their delta is masked to 0 and xp + 0 == xp).

#include <cuda_runtime.h>

#include "grid_common.cuh"

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
};

// kExt: f_ext, [3, ny, nx], is added to the predict's acceleration as
// f_ext * inv_mass; the instantiation without it is the kernel as it was
// before the plane existed.  kWind: the wind force at x and v enters the
// acceleration the same way, before f_ext.  kFeat: the tear and plastic
// planes (as grid_euler.cu's) are updated from x, the substep's start,
// unless `first`, and written to *_out; under tearing (inv_cnt_out not
// null) the predict also writes relaxation / max(count of live edges, 1).
// offsets is [n_off, 4] rows of (di, dj, alpha / dt^2, rest).
template <bool kExt, bool kFeat, bool kWind>
__global__ void __launch_bounds__(256) grid_xpbd_predict_kernel(
    const float* __restrict__ v, float* __restrict__ delta,
    float* __restrict__ lam, int n_off, unsigned char* __restrict__ flag,
    const float* __restrict__ inv_mass, const float* __restrict__ f_ext,
    const float* __restrict__ x, const float* __restrict__ offsets,
    const float* __restrict__ alive_in, float* __restrict__ alive_out,
    const float* __restrict__ scale_in, float* __restrict__ scale_out,
    const float* __restrict__ tear_limits, int first, FeatParams fp,
    float relaxation, float* __restrict__ inv_cnt_out, Wind wind, int ny,
    int nx, Params p) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  const int ps = ny * nx;
  const int idx = i * nx + j;
  Vec3 vi = load3(v, idx, ps);
  if (kWind) {  // g + f_wind w (+ f_ext w), as substep_xpbd sums them
    const float w = inv_mass[idx];
    const Vec3 fw = wind_force(x, i, j, ny, nx, ps, vi, wind);
    Vec3 a = {p.gx + fw.x * w, p.gy + fw.y * w, p.gz + fw.z * w};
    if (kExt) {
      const Vec3 f = load3(f_ext, idx, ps);
      a = {a.x + f.x * w, a.y + f.y * w, a.z + f.z * w};
    }
    vi = {(vi.x + p.dt * a.x) * p.decay, (vi.y + p.dt * a.y) * p.decay,
          (vi.z + p.dt * a.z) * p.decay};
  } else if (kExt) {
    const float w = inv_mass[idx];
    const Vec3 f = load3(f_ext, idx, ps);
    vi = {(vi.x + p.dt * (p.gx + f.x * w)) * p.decay,
          (vi.y + p.dt * (p.gy + f.y * w)) * p.decay,
          (vi.z + p.dt * (p.gz + f.z * w)) * p.decay};
  } else {
    vi = {(vi.x + p.dt * p.gx) * p.decay, (vi.y + p.dt * p.gy) * p.decay,
          (vi.z + p.dt * p.gz) * p.decay};
  }
  if (!(inv_mass[idx] > 0.0f)) vi = {0.0f, 0.0f, 0.0f};
  store3(delta, idx, ps, {p.dt * vi.x, p.dt * vi.y, p.dt * vi.z});
  for (int o = 0; o < n_off; ++o) lam[o * ps + idx] = 0.0f;
  flag[idx] = 0;

  if (kFeat) {
    const Vec3 xi = load3(x, idx, ps);
    float cnt = 0.0f;   // live edges at this vertex, owned and owning it
    for (int o = 0; o < n_off; ++o) {
      const int di = static_cast<int>(offsets[4 * o]);
      const int dj = static_cast<int>(offsets[4 * o + 1]);
      const float rest = offsets[4 * o + 3];
      int ii = i + di, jj = j + dj;
      if (ii >= 0 && ii < ny && jj >= 0 && jj < nx) {
        float a, s;
        edge_features(alive_in, scale_in, o * ps + idx, xi,
                      load3(x, ii * nx + jj, ps), rest, tear_limits[o], fp,
                      first, a, s);
        if (alive_out) alive_out[o * ps + idx] = a;
        if (scale_out) scale_out[o * ps + idx] = s;
        cnt += a;
      } else {   // no edge here: the entry is carried, unread
        if (alive_out) alive_out[o * ps + idx] = alive_in[o * ps + idx];
        if (scale_out) scale_out[o * ps + idx] = scale_in[o * ps + idx];
      }
      ii = i - di;
      jj = j - dj;
      if (inv_cnt_out && ii >= 0 && ii < ny && jj >= 0 && jj < nx) {
        const int nb = ii * nx + jj;
        float a, s;
        edge_features(alive_in, scale_in, o * ps + nb, load3(x, nb, ps), xi,
                      rest, tear_limits[o], fp, first, a, s);
        cnt += a;
      }
    }
    if (inv_cnt_out) inv_cnt_out[idx] = relaxation / fmaxf(cnt, 1.0f);
  }
}

// The substep's epilogue for vertex idx: friction once
// (grid_common.cuh::friction_delta, the plane's on the OR'd contact flag),
// pins masked, x = xp + delta to x_out, v = delta / dt.
__device__ __forceinline__ void finish(Vec3 dl, Vec3 xpi, int idx, int ps,
                                       bool movable, unsigned char flag,
                                       const Colliders& col,
                                       float* __restrict__ x_out,
                                       float* __restrict__ v,
                                       const Params& p) {
  dl = friction_delta(dl, xpi, movable, flag, col, p.mu, p.keep, p.dt,
                      p.shell);
  store3(x_out, idx, ps, {xpi.x + dl.x, xpi.y + dl.y, xpi.z + dl.z});
  store3(v, idx, ps, {dl.x / p.dt, dl.y / p.dt, dl.z / p.dt});
}

// One Jacobi sweep (project = 1) and, on the last sweep (last = 1), the
// substep's epilogue.  xp, delta_*, x_out, v are [3, ny, nx] planes;
// lam_* are [n_off, ny, nx]; offsets is [n_off, 4] rows of
// (di, dj, alpha / dt^2, rest); col holds the collider rows
// (grid_common.cuh).  With n_iterations = 0 the wrapper launches one sweep
// with project = 0, which runs only the epilogue.  kFeat: alive and scale
// (either may be null: that feature is off) are the substep's planes,
// written by the predict.
template <bool kFeat>
__global__ void __launch_bounds__(256) grid_xpbd_sweep_kernel(
    const float* __restrict__ xp, const float* __restrict__ delta_in,
    float* __restrict__ delta_out, const float* __restrict__ lam_in,
    float* __restrict__ lam_out, unsigned char* __restrict__ flag,
    const float* __restrict__ inv_mass, const float* __restrict__ inv_cnt,
    const float* __restrict__ offsets, int n_off, Colliders col,
    int project, int last, float* __restrict__ x_out, float* __restrict__ v,
    const float* __restrict__ alive, const float* __restrict__ scale,
    int ny, int nx, Params p) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  const int ps = ny * nx;
  const int idx = i * nx + j;
  const Vec3 xpi = load3(xp, idx, ps);
  Vec3 dl = load3(delta_in, idx, ps);
  const float wi = inv_mass[idx];
  const bool movable = wi > 0.0f;

  if (project) {
    const Vec3 xe = {xpi.x + dl.x, xpi.y + dl.y, xpi.z + dl.z};
    float dx = 0.0f, dy = 0.0f, dz = 0.0f;
    for (int o = 0; o < n_off; ++o) {
      const int di = static_cast<int>(offsets[4 * o]);
      const int dj = static_cast<int>(offsets[4 * o + 1]);
      const float at = offsets[4 * o + 2];
      const float rest = offsets[4 * o + 3];
      Vec3 n;
      // the edge this vertex owns, to (i + di, j + dj): lambda and -w dlam n
      float lam = lam_in[o * ps + idx];
      int ii = i + di, jj = j + dj;
      if (ii >= 0 && ii < ny && jj >= 0 && jj < nx &&
          (!kFeat || !alive || alive[o * ps + idx] != 0.0f)) {
        const int nb = ii * nx + jj;
        const float r = kFeat && scale ? __fmul_rn(rest, scale[o * ps + idx])
                                       : rest;
        const float dlam = xpbd_dlam(xe, eval_point(xp, delta_in, nb, ps),
                                     wi, inv_mass[nb], at, r, lam, n);
        lam += dlam;
        const float s = -(wi * dlam);
        dx += s * n.x;
        dy += s * n.y;
        dz += s * n.z;
      }
      lam_out[o * ps + idx] = lam;
      // the edge owned by (i - di, j - dj), recomputed: +w dlam n here
      ii = i - di;
      jj = j - dj;
      if (ii >= 0 && ii < ny && jj >= 0 && jj < nx) {
        const int nb = ii * nx + jj;
        if (kFeat && alive && alive[o * ps + nb] == 0.0f) continue;
        const float r = kFeat && scale ? __fmul_rn(rest, scale[o * ps + nb])
                                       : rest;
        const float dlam = xpbd_dlam(eval_point(xp, delta_in, nb, ps), xe,
                                     inv_mass[nb], wi, at, r,
                                     lam_in[o * ps + nb], n);
        const float s = wi * dlam;
        dx += s * n.x;
        dy += s * n.y;
        dz += s * n.z;
      }
    }
    const float c = inv_cnt[idx];
    dl = {dl.x + dx * c, dl.y + dy * c, dl.z + dz * c};
    if (movable) project_delta(dl, xpi, flag + idx, col);
    if (!last) {
      store3(delta_out, idx, ps, dl);
      return;
    }
  }
  finish(dl, xpi, idx, ps, movable, flag[idx], col, x_out, v, p);
}

// The last strain sweep's epilogue (stencil.py::xpbd_substep_grid): the
// change x_new - x0 from the sweeps' start x0 = xp + delta goes into delta,
// the contact is projected once more (the plane clamp ORed into the flag),
// and the epilogue of the last Jacobi sweep follows.
struct XpbdStrainEpilogue {
  const float* xp;
  const float* delta;
  unsigned char* flag;
  const float* inv_mass;
  Colliders col;
  float* x_out;
  float* v;
  int ps;
  Params p;

  __device__ void operator()(int idx, Vec3 xn) const {
    const Vec3 xpi = load3(xp, idx, ps);
    Vec3 dl = load3(delta, idx, ps);
    const Vec3 x0 = {xpi.x + dl.x, xpi.y + dl.y, xpi.z + dl.z};
    dl = {dl.x + (xn.x - x0.x), dl.y + (xn.y - x0.y), dl.z + (xn.z - x0.z)};
    const bool movable = inv_mass[idx] > 0.0f;
    if (movable) project_delta(dl, xpi, flag + idx, col);
    finish(dl, xpi, idx, ps, movable, flag[idx], col, x_out, v, p);
  }
};

dim3 grid_of(int ny, int nx, dim3 block) {
  return dim3((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y);
}

}  // namespace

// Launch the predict pass of one substep on `stream`; returns the
// cudaError_t of the launch (0 = cudaSuccess).  f_ext may be null (no
// external force plane).  With feat = 1 the predict also runs the feature
// update from x (a null alive_* or scale_* pair turns that feature off;
// inv_cnt_out is null without tearing).  Allocates nothing and does not
// synchronise.
extern "C" int grid_xpbd_predict(
    const float* v, float* delta, float* lam, int n_off, unsigned char* flag,
    const float* inv_mass, const float* f_ext, const float* x,
    const float* offsets, int feat, const float* alive_in, float* alive_out,
    const float* scale_in, float* scale_out, const float* tear_limits,
    int first, float strain1, float yield_strain, float creep,
    float min_scale, float max_scale, float relaxation, float* inv_cnt_out,
    int wind_on, float wvx, float wvy, float wvz, float drag, float lift,
    int ny, int nx, float dt, float gx, float gy, float gz, float decay,
    void* stream) {
  const Params p{dt, gx, gy, gz, decay, 0.0f, 1.0f, 1.0f};
  const FeatParams fp{strain1, yield_strain, creep, min_scale, max_scale};
  const Wind wind{wvx, wvy, wvz, drag, lift};
  const dim3 block(32, 8);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GRID_XPBD_PREDICT(EXT, FEAT, WIND)                                  \
  grid_xpbd_predict_kernel<EXT, FEAT, WIND>                                 \
      <<<grid_of(ny, nx, block), block, 0, st>>>(                           \
          v, delta, lam, n_off, flag, inv_mass, f_ext, x, offsets,          \
          alive_in, alive_out, scale_in, scale_out, tear_limits, first, fp, \
          relaxation, inv_cnt_out, wind, ny, nx, p)
#define GRID_XPBD_WIND(EXT, FEAT)           \
  do {                                      \
    if (wind_on)                            \
      GRID_XPBD_PREDICT(EXT, FEAT, true);   \
    else                                    \
      GRID_XPBD_PREDICT(EXT, FEAT, false);  \
  } while (0)
  if (f_ext && feat)
    GRID_XPBD_WIND(true, true);
  else if (f_ext)
    GRID_XPBD_WIND(true, false);
  else if (feat)
    GRID_XPBD_WIND(false, true);
  else
    GRID_XPBD_WIND(false, false);
#undef GRID_XPBD_WIND
#undef GRID_XPBD_PREDICT
  return static_cast<int>(cudaGetLastError());
}

// Launch one Jacobi sweep (and, with last = 1, the epilogue) on `stream`;
// returns the cudaError_t of the launch.  feat = 1 reads the substep's
// alive and scale planes (either may be null).  Allocates nothing and does
// not synchronise.
extern "C" int grid_xpbd_sweep(
    const float* xp, const float* delta_in, float* delta_out,
    const float* lam_in, float* lam_out, unsigned char* flag,
    const float* inv_mass, const float* inv_cnt, const float* offsets,
    int n_off, COLLIDER_PARAMS, int project, int last, float* x_out,
    float* v, int feat, const float* alive,
    const float* scale, int ny, int nx, float dt, float mu, float keep,
    float shell, void* stream) {
  const Params p{dt, 0.0f, 0.0f, 0.0f, 1.0f, mu, keep, shell};
  const dim3 block(32, 8);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Colliders col = COLLIDERS;
#define GRID_XPBD_SWEEP(FEAT)                                               \
  grid_xpbd_sweep_kernel<FEAT><<<grid_of(ny, nx, block), block, 0, st>>>(   \
      xp, delta_in, delta_out, lam_in, lam_out, flag, inv_mass, inv_cnt,    \
      offsets, n_off, col, project, last, x_out, v, alive, scale, ny, nx,   \
      p)
  if (feat)
    GRID_XPBD_SWEEP(true);
  else
    GRID_XPBD_SWEEP(false);
#undef GRID_XPBD_SWEEP
  return static_cast<int>(cudaGetLastError());
}

// Launch one strain-limit sweep (grid_common.cuh::grid_strain_sweep_kernel)
// on `stream`, and with last = 1 the XPBD epilogue: xp is the substep's
// start, delta the Jacobi loop's result (the first sweep's positions are
// xp + delta), x_out receives the substep's positions and v its velocity.
// Returns the cudaError_t of the launch.  Allocates nothing and does not
// synchronise.
extern "C" int grid_xpbd_strain(
    const float* base, const float* add, float* xs_out,
    const float* inv_mass, const float* offsets, const float* limits,
    int n_off, const float* alive, const float* scale, float stretch1,
    float compress1, int compress_on, int project, int last, const float* xp,
    const float* delta, unsigned char* flag, COLLIDER_PARAMS, float* x_out,
    float* v, int ny, int nx, float dt, float mu, float keep, float shell,
    void* stream) {
  const Params p{dt, 0.0f, 0.0f, 0.0f, 1.0f, mu, keep, shell};
  const XpbdStrainEpilogue epi{xp,    delta, flag,    inv_mass, COLLIDERS,
                               x_out, v,     ny * nx, p};
  return launch_strain_sweep(base, add, xs_out, inv_mass, offsets, limits,
                             n_off, alive, scale,
                             StrainParams{stretch1, compress1, compress_on},
                             project, last, ny, nx, epi, stream);
}

// Launch the frame-end feature update over the final positions x
// (grid_common.cuh::grid_feature_finish_kernel); returns the cudaError_t.
extern "C" int grid_xpbd_features(
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

extern "C" const char* grid_xpbd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
