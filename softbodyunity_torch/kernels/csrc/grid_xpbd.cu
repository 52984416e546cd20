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
// the strain limit's sweeps after the Jacobi loop, all in one cooperative
// launch (grid_common.cuh::grid_strain_sweep_kernel; its last sweep runs
// one more contact projection and the epilogue: XpbdStrainEpilogue below).
//
// Design.  A Jacobi sweep reads every neighbour's evaluation point, so each
// sweep needs a grid-wide barrier; here that barrier is a kernel boundary.
// The row-tiled TPU kernel instead runs a whole substep per tile on halos
// of reach x n_iterations rows, recomputing the overlap; global Jacobi with
// one launch per sweep is what that computes.  One C call
// (grid_xpbd_substep) launches a substep, 1 + n_iterations launches:
//   predict   one thread per vertex: v <- (v + dt g)(1 - gdamp dt), 0 on
//             pins; delta <- dt v; the
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
//   sweep     (n_iterations launches) a CTA owns a 32 x 8 tile of the grid
//             (the fastest of 32 x 8, 16 x 16 and 64 x 4 at 64k and at
//             262k, PERF.md), one thread per tile
//             vertex, and is compiled for the offsets' pattern (structural,
//             with shear, with bend, with both: grid_common.cuh's Pattern
//             and Tile, shared with grid_euler.cu and the strain sweeps),
//             so that its indices are constants.  It stages xe = xp +
//             delta and the inverse mass of the tile and a frame of H rows
//             and columns around it (H = the largest |di|, |dj|: 2 with
//             bend springs) in shared memory;
//             evaluates each edge with an endpoint in the tile once
//             (grid_common.cuh::xpbd_dlam: dlam and the unit direction n
//             into shared memory), each thread its own vertex's entry of
//             every offset and the frame-owned rest spread one a thread;
//             writes the new lambdas of the tile's own edges only; then
//             each vertex sums, per offset, -(w dlam) n of the edge it owns
//             and +(w dlam) n of the edge owned by p - o, the plain
//             version's order and the one-pass kernel's products, so the
//             result is that kernel's to the bit; delta += dx * inv_cnt;
//             then the plane clamp in ``plane - xp`` form (OR'd into the
//             contact flag), the sphere push-out as a delta, then the
//             capsules' and boxes' as another (grid_common.cuh::
//             project_delta).  Only the edges owned by the frame's
//             vertices are evaluated again, by the neighbouring tile (13 %
//             past one evaluation an edge at 32 x 8).  delta and the lambda
//             planes ping-pong between sweeps (a tile reads the lambdas of
//             its frame's owners, which the neighbouring tile writes); the
//             contact flag is the vertex's own and stays put.
//             kFeat: a torn edge is skipped and a plastic one's rest is
//             rest * scale, both read from the predict's planes.
//   epilogue  run by the last sweep for its own vertex: plane friction on
//             the OR'd flag, sphere and capsule/box friction
//             (grid_common.cuh::friction_delta), pins masked, x = xp + delta
//             written to the other x buffer, v = delta / dt in place.
//   strain    under the strain limit, one more launch after the Jacobi
//             sweeps (which then all store delta), from its own ctypes
//             call: the strain sweeps on xp + delta, separated by a grid
//             barrier, the last of which adds its change to delta,
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
// 67 TFLOP/s float32 peak, so the work is bound by operations.  A sweep
// moves ~6 MB through L2 (xp, delta, lambdas).  What a sweep costs on the
// card is instructions at low occupancy: at 64k an SM holds two CTAs, and
// a sweep's index arithmetic, bounds tests and IEEE divides issue from few
// warps.  Evaluating each edge once halves the divides, which pays only
// when the indices are constants and no warp evaluates more than about
// one entry past its own: with per-offset loops, rectangles sized at run
// time or more threads a vertex the tiled sweep measured slower than the
// one-pass kernel it replaces (PERF.md).  The C-side loop takes the host's
// ctypes call out of every launch but one a substep.
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
// substep's epilogue, on a CTA of TX x TY threads that owns a TX x TY
// (kTileX x kTileY) tile of the grid.  xp, delta_*, x_out, v are [3, ny, nx] planes; lam_* are
// [n_off, ny, nx]; offsets is [n_off, 4] rows of (di, dj, alpha / dt^2,
// rest), di and dj those of pattern P; col holds the collider rows
// (grid_common.cuh).  With n_iterations = 0 the wrapper launches one sweep
// with project = 0, which runs only the epilogue.  kFeat: alive and scale
// (either may be null: that feature is off) are the substep's planes,
// written by the predict.
//
// Each edge with an endpoint in the tile is evaluated once into shared
// memory, (dlam, n) as a float4, zeros where there is no edge; the tile
// writes its own edges' lambdas; then each vertex sums its terms.  At 64k
// vertices an SM holds about two CTAs: a thread that evaluated a strip
// entry in every offset that has one (lanes 0-1 of every warp, warps 0-1)
// would cost about as much as recomputing every edge from both ends, so
// the strips are spread one entry a thread, and the lambdas of each
// thread's own entries load before the first barrier.
template <int P, bool kFeat>
__global__ void __launch_bounds__(kTileX * kTileY) grid_xpbd_sweep_kernel(
    const float* __restrict__ xp, const float* __restrict__ delta_in,
    float* __restrict__ delta_out, const float* __restrict__ lam_in,
    float* __restrict__ lam_out, unsigned char* __restrict__ flag,
    const float* __restrict__ inv_mass, const float* __restrict__ inv_cnt,
    const float* __restrict__ offsets, Colliders col, int project, int last,
    float* __restrict__ x_out, float* __restrict__ v,
    const float* __restrict__ alive, const float* __restrict__ scale,
    int ny, int nx, Params p) {
  using O = Offsets<P>;
  using T = Tile<P>;
  constexpr int TX = T::TX, TY = T::TY;
  constexpr int kN = O::n;
  using Seq = std::make_integer_sequence<int, kN>;
  __shared__ float4 frame[T::FH * T::FW];   // xe, w
  __shared__ float4 terms[T::B(kN)];        // dlam, n
  const int x = threadIdx.x, y = threadIdx.y;
  const int i0 = blockIdx.y * TY, j0 = blockIdx.x * TX;
  const int i = i0 + y, j = j0 + x;
  const int ps = ny * nx;
  const int idx = i * nx + j;
  auto in_grid = [&](int a, int b) {
    return a >= 0 && a < ny && b >= 0 && b < nx;
  };
  const bool mine = in_grid(i, j);
  // the vertex's own inputs first: their loads overlap the staging's
  Vec3 xpi{}, dl{};
  float wi = 0.0f, c = 0.0f;
  if (mine) {
    xpi = load3(xp, idx, ps);
    dl = load3(delta_in, idx, ps);
    wi = inv_mass[idx];
    if (project) c = inv_cnt[idx];
  }

  if (project) {
    // the owner of rectangle entry (r, cc) of offset o, in the grid
    auto owner = [&](auto oc, int r, int cc, int& qi, int& qj) {
      constexpr int o = decltype(oc)::value;
      qi = i0 + min0(-O::di(o)) + r;
      qj = j0 + min0(-O::dj(o)) + cc;
      return in_grid(qi, qj);
    };
    // the lambda (and feature values) of entry (y, x) of every offset
    float lam0[kN], alive0[kN], scale0[kN];
    each_offset([&](auto oc) {
      constexpr int o = decltype(oc)::value;
      int qi, qj;
      lam0[o] = 0.0f;
      alive0[o] = scale0[o] = 1.0f;
      if (!owner(oc, y, x, qi, qj)) return;
      const int q = o * ps + qi * nx + qj;
      lam0[o] = lam_in[q];
      if (kFeat && alive) alive0[o] = alive[q];
      if (kFeat && scale) scale0[o] = scale[q];
    }, Seq{});
    // stage the frame's evaluation points xe = xp + delta and masses
#pragma unroll
    for (int k = 0; k < (T::FH * T::FW + TX * TY - 1) / (TX * TY); ++k) {
      const int cell = y * TX + x + k * TX * TY;
      if (cell >= T::FH * T::FW) break;
      const int gi = i0 - T::H + cell / T::FW, gj = j0 - T::H + cell % T::FW;
      if (!in_grid(gi, gj)) continue;
      const int q = gi * nx + gj;
      const Vec3 e = eval_point(xp, delta_in, q, ps);
      frame[cell] = make_float4(e.x, e.y, e.z, inv_mass[q]);
    }
    __syncthreads();
    // rectangle entry (r, cc) of offset o: (dlam, n) or zeros, the tile's
    // own lambdas out; `own` marks the thread's entry (y, x)
    auto evaluate = [&](auto oc, int r, int cc, bool own) {
      constexpr int o = decltype(oc)::value;
      int qi, qj;
      float4 term = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (owner(oc, r, cc, qi, qj)) {
        const int q = o * ps + qi * nx + qj;
        const int bi = qi + O::di(o), bj = qj + O::dj(o);
        float lam = own ? lam0[o] : lam_in[q];
        float a = 1.0f, sc = 1.0f;
        if (kFeat && alive) a = own ? alive0[o] : alive[q];
        if (kFeat && scale) sc = own ? scale0[o] : scale[q];
        if (in_grid(bi, bj) && a != 0.0f) {
          const float4 pa =
              frame[(qi - i0 + T::H) * T::FW + (qj - j0 + T::H)];
          const float4 pb =
              frame[(bi - i0 + T::H) * T::FW + (bj - j0 + T::H)];
          const float rest = offsets[4 * o + 3];
          const float rr = kFeat && scale ? __fmul_rn(rest, sc) : rest;
          Vec3 nrm;
          const float dlam =
              xpbd_dlam({pa.x, pa.y, pa.z}, {pb.x, pb.y, pb.z}, pa.w, pb.w,
                        offsets[4 * o + 2], rr, lam, nrm);
          lam += dlam;
          term = make_float4(dlam, nrm.x, nrm.y, nrm.z);
        }
        if (qi >= i0 && qi < i0 + TY && qj >= j0 && qj < j0 + TX)
          lam_out[q] = lam;
      }
      terms[T::B(o) + r * T::NC(o) + cc] = term;
    };
    each_offset([&](auto oc) { evaluate(oc, y, x, true); }, Seq{});
    // the strips, rows past TY (all NC columns) then columns past TX
#pragma unroll
    for (int e0 = y * TX + x; e0 < T::SB(kN); e0 += TX * TY) {
      each_offset([&](auto oc) {
        constexpr int o = decltype(oc)::value;
        const int e = e0 - T::SB(o);
        if (e >= 0 && e < T::S(o))
          evaluate(oc, T::strip_row(o, e), T::strip_col(o, e), false);
      }, Seq{});
    }
    __syncthreads();
    if (!mine) return;
    float dx = 0.0f, dy = 0.0f, dz = 0.0f;
    each_offset([&](auto oc) {
      constexpr int o = decltype(oc)::value;
      constexpr int di = O::di(o), dj = O::dj(o);
      constexpr int r0 = min0(-di), c0 = min0(-dj);
      // the edge this vertex owns: -(w dlam) n (zeros where it has none)
      const float4 a = terms[T::B(o) + (y - r0) * T::NC(o) + (x - c0)];
      float s = -(wi * a.x);
      dx += s * a.y;
      dy += s * a.z;
      dz += s * a.w;
      // the edge owned by (i - di, j - dj): +(w dlam) n here
      const float4 b =
          terms[T::B(o) + (y - di - r0) * T::NC(o) + (x - dj - c0)];
      s = wi * b.x;
      dx += s * b.y;
      dy += s * b.z;
      dz += s * b.w;
    }, Seq{});
    dl = {dl.x + dx * c, dl.y + dy * c, dl.z + dz * c};
    if (wi > 0.0f) project_delta(dl, xpi, flag + idx, col);
    if (!last) {
      store3(delta_out, idx, ps, dl);
      return;
    }
  }
  if (!mine) return;
  finish(dl, xpi, idx, ps, wi > 0.0f, flag[idx], col, x_out, v, p);
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

// What one substep launches with, fixed over a call of the step function:
// softbodyunity_torch/kernels/grid_xpbd.py::_Substep mirrors it field by
// field (grid_xpbd_substep_size checks the two agree).
struct GridXpbdSubstep {
  float* v;                   // [3, ny, nx], in place
  float* delta[2];            // [3, ny, nx] ping-pong
  float* lam[2];              // [n_off, ny, nx] ping-pong
  unsigned char* flag;        // [ny, nx]
  const float* inv_mass;      // [ny, nx]
  const float* inv_cnt;       // [ny, nx] the sweeps' Jacobi weights
  float* inv_cnt_out;         // where the predict writes them under
                              // tearing (= inv_cnt), else null
  const float* offsets;       // [n_off, 4]
  const float* tear_limits;   // [n_off] (feat)
  void* stream;
  int n_off;
  int pattern;                // the offsets' Pattern
  int feat, wind_on;
  int n_sweeps;               // Jacobi sweep launches
  int project;                // 0: n_iterations = 0, the epilogue alone
  int epilogue;               // the last sweep runs the epilogue (else the
                              // strain sweeps that follow do)
  int ny, nx;
  float relaxation;
  FeatParams fp;
  Colliders col;
  Wind wind;
  Params p;
};

extern "C" int grid_xpbd_substep_size() {
  return static_cast<int>(sizeof(GridXpbdSubstep));
}

// The sweeps of one substep on pattern P: s->n_sweeps launches from
// delta[0] and lam[0], ping-pong; the last runs the epilogue unless the
// strain sweeps follow.
template <int P>
int launch_sweeps(const GridXpbdSubstep* s, cudaStream_t st, const float* x,
                  float* x_out, const float* alive, const float* scale,
                  int* launches) {
  const dim3 block(kTileX, kTileY);
  const dim3 grid = grid_of(s->ny, s->nx, block);
  for (int it = 0; it < s->n_sweeps; ++it) {
    const int a = it % 2, b = 1 - a;
    const int last = s->epilogue && it == s->n_sweeps - 1;
#define GRID_XPBD_SWEEP(FEAT)                                             \
  grid_xpbd_sweep_kernel<P, FEAT><<<grid, block, 0, st>>>(                \
      x, s->delta[a], s->delta[b], s->lam[a], s->lam[b], s->flag,         \
      s->inv_mass, s->inv_cnt, s->offsets, s->col, s->project, last,      \
      x_out, s->v, alive, scale, s->ny, s->nx, s->p)
    if (s->feat)
      GRID_XPBD_SWEEP(true);
    else
      GRID_XPBD_SWEEP(false);
#undef GRID_XPBD_SWEEP
    ++*launches;
    if (int err = static_cast<int>(cudaGetLastError())) return err;
  }
  return 0;
}

// Launch one substep on s->stream: the predict, then s->n_sweeps Jacobi
// sweeps, the last running the epilogue unless the strain sweeps follow
// (then every sweep stores delta, into s->delta[n_sweeps % 2]).  x is the
// substep's start, x_out receives its end; f_ext may be null (no external
// force plane).  With s->feat the predict also runs the feature update from
// x unless `first`, from the *_in planes into the *_out planes (a null pair
// turns that feature off), which the sweeps then read.  *launches counts
// the kernels launched; returns the first launch's cudaError_t that is not
// cudaSuccess, after which it launches nothing more.  Allocates nothing and
// does not synchronise.
extern "C" int grid_xpbd_substep(const GridXpbdSubstep* s, const float* x,
                                 float* x_out, const float* f_ext,
                                 const float* alive_in, float* alive_out,
                                 const float* scale_in, float* scale_out,
                                 int first, int* launches) {
  const cudaStream_t st = static_cast<cudaStream_t>(s->stream);
  const int ny = s->ny, nx = s->nx;
  *launches = 0;
  auto done = [&]() {
    ++*launches;
    return static_cast<int>(cudaGetLastError());
  };
  const dim3 block(32, 8);
#define GRID_XPBD_PREDICT(EXT, FEAT, WIND)                                  \
  grid_xpbd_predict_kernel<EXT, FEAT, WIND>                                 \
      <<<grid_of(ny, nx, block), block, 0, st>>>(                           \
          s->v, s->delta[0], s->lam[0], s->n_off, s->flag, s->inv_mass,     \
          f_ext, x, s->offsets, alive_in, alive_out, scale_in, scale_out,   \
          s->tear_limits, first, s->fp, s->relaxation, s->inv_cnt_out,      \
          s->wind, ny, nx, s->p)
#define GRID_XPBD_WIND(EXT, FEAT)           \
  do {                                      \
    if (s->wind_on)                         \
      GRID_XPBD_PREDICT(EXT, FEAT, true);   \
    else                                    \
      GRID_XPBD_PREDICT(EXT, FEAT, false);  \
  } while (0)
  if (f_ext && s->feat)
    GRID_XPBD_WIND(true, true);
  else if (f_ext)
    GRID_XPBD_WIND(true, false);
  else if (s->feat)
    GRID_XPBD_WIND(false, true);
  else
    GRID_XPBD_WIND(false, false);
#undef GRID_XPBD_WIND
#undef GRID_XPBD_PREDICT
  if (int err = done()) return err;

  switch (s->pattern) {
    case kStructural:
      return launch_sweeps<kStructural>(s, st, x, x_out, alive_out, scale_out,
                                        launches);
    case kShear:
      return launch_sweeps<kShear>(s, st, x, x_out, alive_out, scale_out,
                                   launches);
    case kBend:
      return launch_sweeps<kBend>(s, st, x, x_out, alive_out, scale_out,
                                  launches);
    case kShearBend:
      return launch_sweeps<kShearBend>(s, st, x, x_out, alive_out, scale_out,
                                       launches);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int grid_xpbd_strain_size() {
  return static_cast<int>(sizeof(StrainSweeps));
}

// Launch one substep's strain-limit sweeps (grid_common.cuh::
// grid_strain_sweep_kernel, one cooperative launch) on `stream`, the last
// running the XPBD epilogue: xp is the substep's start, delta the Jacobi
// loop's result (the first sweep's positions are xp + delta), x_out
// receives the substep's positions and v its velocity.  Returns the
// cudaError_t of the launch.  Allocates nothing and does not synchronise.
extern "C" int grid_xpbd_strain(
    const StrainSweeps* s, const float* alive, const float* scale,
    const float* xp, const float* delta, unsigned char* flag,
    COLLIDER_PARAMS, float* x_out, float* v, float dt, float mu, float keep,
    float shell, void* stream) {
  const Params p{dt, 0.0f, 0.0f, 0.0f, 1.0f, mu, keep, shell};
  const XpbdStrainEpilogue epi{xp,    delta, flag,    s->inv_mass, COLLIDERS,
                               x_out, v,     s->ny * s->nx, p};
  return launch_strain_sweeps(*s, xp, delta, alive, scale, epi, stream);
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
