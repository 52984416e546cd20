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
// Design.  A Jacobi sweep reads its neighbours' evaluation points of the
// sweep before, so each sweep waits for the tiles around it.  The row-tiled
// TPU kernel instead runs a whole substep per tile on halos of reach x
// n_iterations rows, recomputing the overlap; global Jacobi is what that
// computes.  One C call (grid_xpbd_substep) runs a substep on one of two
// schedules of the same stages, bit for bit, which the wrapper plans from
// the grid's tiles and the card's occupancy:
//   resident  where every tile's CTA fits on the card at once (the 64k
//             curtain's 256 tiles at two CTAs an SM) and n_iterations > 0:
//             one cooperative launch, a CTA a tile through the predict, the
//             sweeps and the epilogue, its state kept in registers across
//             them, the order between tiles kept by per-tile stage flags in
//             place of kernel boundaries (grid_xpbd_sweep_kernel_resident
//             below);
//   per sweep elsewhere (grids past the card's resident tiles, no sweep):
//             1 + n_iterations launches, a kernel boundary between sweeps:
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
// ctypes call out of every launch but one a substep; the resident launch
// takes out the launches themselves, their ramps and tails, and the
// reloads of what a tile alone reads.
//
// Rounding.  sqrtf and IEEE divides in the plain version's order (the
// divide-form norm d / max(len, 1e-12)); FMA contraction and the folded
// relaxation make the agreement one of rounding, except in the feature
// update, rounded as the plain version rounds it (grid_common.cuh).  Pinned
// vertices keep x bit for bit (their delta is masked to 0 and xp + 0 == xp).
//
// Counting.  The kCount instantiation of the sweep, launched only for a
// substep's last Jacobi sweep and only while the program's recorder is on
// (softbodyunity_torch/utils/profiling.py), also counts, into int64
// `counters` (the order of Counter below), the live constraints it
// evaluates and, of those, the ones unmet by more than a thousandth of
// their rest length, |C| > 1e-3 rest, at its evaluation point: what the
// sweeps before it leave for it to do.  A CTA counts the constraints its
// tile owns (each is evaluated once, by the tile of its owner), each warp
// adds its lanes' counts into shared memory, and thread 0 adds the CTA's
// sums with one atomic per counter.  The counts sit beside the arithmetic,
// never in it, so the positions are the plain instantiation's to the bit.

#include <cuda_runtime.h>

#include "grid_common.cuh"

namespace {

enum Counter {
  kEdgesChecked,   // live constraints the last sweep evaluated
  kEdgesUnmet,     // of those, |C| > 1e-3 rest at its evaluation point
  kFlagPolls,      // resident launch: neighbour-flag polls past the first
  kCounters
};

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

// The predict of vertex (i, j) (in the grid): v <- (v + dt a) decay with a
// = g (+ f_wind w with kWind, + f_ext w with kExt, f_ext [3, ny, nx]), 0 on
// pins; returns its delta dt v.  kFeat: the tear and plastic planes (as
// grid_euler.cu's) are updated from x, the substep's start, unless
// `first`, and written to *_out; with `tearing` (inv_cnt_out not null) *w
// takes relaxation / max(count of live edges, 1).  offsets is [n_off, 4]
// rows of (di, dj, alpha / dt^2, rest).  Both schedules of the substep run
// it: the predict launch and stage 0 of the resident launch.
template <bool kExt, bool kFeat, bool kWind>
__device__ __forceinline__ Vec3 predict_vertex(
    int i, int j, int ny, int nx, const float* __restrict__ v,
    const float* __restrict__ inv_mass, const float* __restrict__ f_ext,
    const float* __restrict__ x, const float* __restrict__ offsets,
    int n_off, const float* __restrict__ alive_in,
    float* __restrict__ alive_out, const float* __restrict__ scale_in,
    float* __restrict__ scale_out, const float* __restrict__ tear_limits,
    int first, const FeatParams& fp, float relaxation, bool tearing,
    float* w_cnt, const Wind& wind, const Params& p) {
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
      if (tearing && ii >= 0 && ii < ny && jj >= 0 && jj < nx) {
        const int nb = ii * nx + jj;
        float a, s;
        edge_features(alive_in, scale_in, o * ps + nb, load3(x, nb, ps), xi,
                      rest, tear_limits[o], fp, first, a, s);
        cnt += a;
      }
    }
    if (tearing) *w_cnt = relaxation / fmaxf(cnt, 1.0f);
  }
  return {p.dt * vi.x, p.dt * vi.y, p.dt * vi.z};
}

// The predict launch, one thread per vertex (predict_vertex): delta <- dt v,
// the lambda planes and the contact flag <- 0, and under tearing the
// substep's Jacobi weights to inv_cnt_out.  kExt: f_ext is not null; the
// instantiation without it is the kernel as it was before the plane existed.
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
  float w_cnt = 0.0f;
  store3(delta, idx, ps,
         predict_vertex<kExt, kFeat, kWind>(
             i, j, ny, nx, v, inv_mass, f_ext, x, offsets, n_off, alive_in,
             alive_out, scale_in, scale_out, tear_limits, first, fp,
             relaxation, inv_cnt_out != nullptr, &w_cnt, wind, p));
  for (int o = 0; o < n_off; ++o) lam[o * ps + idx] = 0.0f;
  flag[idx] = 0;
  if (kFeat && inv_cnt_out) inv_cnt_out[idx] = w_cnt;
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

// Rectangle entry of offset o whose owner (qi, qj) lies in the grid, from
// the frame the tile at (i0, j0) staged (xe, w): (dlam, n) of its edge, or
// zeros where the edge leaves the grid or is torn (a = 0); lam is the
// edge's lambda, in and out.  scaled: the rest is rest * sc (plasticity).
// With count (kCount) a constraint the tile owns adds to checked and, when
// |C| > 1e-3 rest at its evaluation point, to unmet.  Both schedules of the
// sweep evaluate every entry here.
template <int P, int o, bool kCount>
__device__ __forceinline__ float4 edge_term(
    int qi, int qj, int i0, int j0, int ny, int nx, const float4* frame,
    const float* __restrict__ offsets, float a, float sc, bool scaled,
    bool count, float& lam, unsigned int& checked, unsigned int& unmet) {
  using O = Offsets<P>;
  using T = Tile<P>;
  float4 term = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int bi = qi + O::di(o), bj = qj + O::dj(o);
  if (bi >= 0 && bi < ny && bj >= 0 && bj < nx && a != 0.0f) {
    const float4 pa = frame[(qi - i0 + T::H) * T::FW + (qj - j0 + T::H)];
    const float4 pb = frame[(bi - i0 + T::H) * T::FW + (bj - j0 + T::H)];
    const float rest = offsets[4 * o + 3];
    const float rr = scaled ? __fmul_rn(rest, sc) : rest;
    Vec3 nrm;
    const float dlam =
        xpbd_dlam({pa.x, pa.y, pa.z}, {pb.x, pb.y, pb.z}, pa.w, pb.w,
                  offsets[4 * o + 2], rr, lam, nrm);
    lam += dlam;
    term = make_float4(dlam, nrm.x, nrm.y, nrm.z);
    if constexpr (kCount) {
      // |C| as xpbd_dlam forms it, for the tile's own constraints
      if (count && qi >= i0 && qi < i0 + T::TY && qj >= j0 &&
          qj < j0 + T::TX) {
        const Vec3 d = {pb.x - pa.x, pb.y - pa.y, pb.z - pa.z};
        const float c = sqrtf(dot3(d, d)) - rr;
        ++checked;
        unmet += fabsf(c) > 1e-3f * rr;
      }
    }
  }
  return term;
}

// The Jacobi update of tile vertex (y, x) with inverse mass wi and weight
// c from the tile's terms: per offset, -(w dlam) n of the edge it owns and
// +(w dlam) n of the edge owned by p - o, summed in the plain version's
// order, then dl + sum * c.
template <int P>
__device__ __forceinline__ Vec3 jacobi_update(const float4* terms, int y,
                                              int x, float wi, float c,
                                              Vec3 dl) {
  using O = Offsets<P>;
  using T = Tile<P>;
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
  }, std::make_integer_sequence<int, O::n>{});
  return {dl.x + dx * c, dl.y + dy * c, dl.z + dz * c};
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
// memory (edge_term), (dlam, n) as a float4, zeros where there is no edge;
// the tile writes its own edges' lambdas; then each vertex sums its terms
// (jacobi_update).  At 64k
// vertices an SM holds about two CTAs: a thread that evaluated a strip
// entry in every offset that has one (lanes 0-1 of every warp, warps 0-1)
// would cost about as much as recomputing every edge from both ends, so
// the strips are spread one entry a thread, and the lambdas of each
// thread's own entries load before the first barrier.
template <int P, bool kFeat, bool kCount>
__global__ void __launch_bounds__(kTileX * kTileY) grid_xpbd_sweep_kernel(
    const float* __restrict__ xp, const float* __restrict__ delta_in,
    float* __restrict__ delta_out, const float* __restrict__ lam_in,
    float* __restrict__ lam_out, unsigned char* __restrict__ flag,
    const float* __restrict__ inv_mass, const float* __restrict__ inv_cnt,
    const float* __restrict__ offsets, Colliders col, int project, int last,
    float* __restrict__ x_out, float* __restrict__ v,
    const float* __restrict__ alive, const float* __restrict__ scale,
    unsigned long long* __restrict__ counters, int ny, int nx, Params p) {
  using O = Offsets<P>;
  using T = Tile<P>;
  constexpr int TX = T::TX, TY = T::TY;
  constexpr int kN = O::n;
  using Seq = std::make_integer_sequence<int, kN>;
  __shared__ float4 frame[T::FH * T::FW];   // xe, w
  __shared__ float4 terms[T::B(kN)];        // dlam, n
  __shared__ unsigned int cnt[kCounters];   // kCount: this CTA's sums
  const int x = threadIdx.x, y = threadIdx.y;
  unsigned int checked = 0, unmet = 0;      // kCount: this thread's
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
    if constexpr (kCount) {
      if (y == 0 && x < kCounters) cnt[x] = 0;   // before the staging barrier
    }
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
        float lam = own ? lam0[o] : lam_in[q];
        float a = 1.0f, sc = 1.0f;
        if (kFeat && alive) a = own ? alive0[o] : alive[q];
        if (kFeat && scale) sc = own ? scale0[o] : scale[q];
        term = edge_term<P, o, kCount>(qi, qj, i0, j0, ny, nx, frame,
                                       offsets, a, sc, kFeat && scale, true,
                                       lam, checked, unmet);
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
    if constexpr (kCount) {
      // a warp is one row of the tile: its lanes' sums, then the CTA's
      checked = __reduce_add_sync(0xffffffffu, checked);
      unmet = __reduce_add_sync(0xffffffffu, unmet);
      if (x == 0) {
        atomicAdd(&cnt[kEdgesChecked], checked);
        atomicAdd(&cnt[kEdgesUnmet], unmet);
      }
    }
    __syncthreads();
    if constexpr (kCount) {
      if (x == 0 && y == 0) {
        atomicAdd(&counters[kEdgesChecked], cnt[kEdgesChecked]);
        atomicAdd(&counters[kEdgesUnmet], cnt[kEdgesUnmet]);
      }
    }
    if (!mine) return;
    dl = jacobi_update<P>(terms, y, x, wi, c, dl);
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
  long long* counters;        // int64 [kCounters]: the last sweep counts
                              // (the kCount instantiation), else null
  int resident;               // the wrapper's plan: one resident launch a
                              // substep (grid_xpbd_resident_slots), else
                              // 1 + n_sweeps launches
  unsigned int* flags;        // [tiles] the resident launch's stage flags
  unsigned int* epoch;        // host: resident launches on these flags so
                              // far; each launch advances it
  float relaxation;
  FeatParams fp;
  Colliders col;
  Wind wind;
  Params p;
};

extern "C" int grid_xpbd_substep_size() {
  return static_cast<int>(sizeof(GridXpbdSubstep));
}

namespace {

// --- the resident substep: one launch, stages ordered by neighbour flags ---
//
// The same substep as the predict launch and the n_sweeps sweep launches,
// in one cooperative launch of one CTA a tile (the sweep's tile and
// threads).  Stage 0 is the predict of the tile (predict_vertex), stages 1
// .. n the Jacobi sweeps (edge_term, jacobi_update, project_delta), the
// last running the epilogue (finish) or, under the strain limit, storing
// delta and the contact flag for the strain launch.  What only the tile
// reads stays in registers across the stages: each thread's xp, inverse
// mass, Jacobi weight, running delta and contact flag, the lambdas of its
// entries that the tile owns and the feature values of its entries; the
// xp and mass of its halo cell.  Only what a neighbour reads goes through
// device memory, ping-pong as between the sweep launches: the tile's
// border delta (H rows and columns) and its own edges' lambdas.  The
// values and the order of every operation are the sweep launches', so the
// result is theirs to the bit.
//
// Ordering: stage k of a tile reads its neighbours' stage k - 1 output, and
// writes the ping-pong plane that they read at their stage k - 1, so one
// wait covers both: before stage k, each of the <= 8 neighbour tiles has
// published a stage >= k - 1.  A tile publishes stage k (k < n) after its
// stores and a barrier: thread 0 release-stores base + k into its flag;
// lanes of warp 0 poll the neighbours' flags with acquire loads,
// then a barrier.  base = epoch * (n + 1) with the host's epoch advanced
// every launch, so a flag holds a value of this launch only once its tile
// has published, and a value is ready when base + k - 1 <= flag <= base +
// n (unsigned, so the compare survives wrapping): the flags need no reset.
// Data written inside the launch is read past L1 (__ldcg).  The launch is
// cooperative, so every CTA is resident and a wait cannot deadlock; the
// wrapper plans it only where the tiles fit the card (tiles <= CTAs an SM
// x SMs, grid_xpbd_resident_slots), and the kCount instantiation (the
// recorder) counts the failed polls (kFlagPolls).

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned int* p,
                                              unsigned int v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// Before stage k: wait until every neighbour tile of (bx, by) has
// published a stage in [k - 1, n] of this launch; polls counts the loads
// that found one not ready.  A stage takes microseconds: a wait past
// kMaxPolls loads (seconds) can only be a fault, and traps (the launch
// fails with an error) rather than hang the card.
constexpr unsigned int kMaxPolls = 1u << 24;

__device__ __forceinline__ void wait_neighbours(const unsigned int* flags,
                                                int tiles_x, int tiles_y,
                                                unsigned int base,
                                                unsigned int k, unsigned int n,
                                                unsigned int& polls) {
  const int l = threadIdx.x;
  if (threadIdx.y == 0 && l < 9 && l != 4) {
    const int tx = static_cast<int>(blockIdx.x) + l % 3 - 1;
    const int ty = static_cast<int>(blockIdx.y) + l / 3 - 1;
    if (tx >= 0 && tx < tiles_x && ty >= 0 && ty < tiles_y) {
      const unsigned int* f = flags + ty * tiles_x + tx;
      unsigned int spins = 0;
      while (load_acquire(f) - base - (k - 1) > n - (k - 1)) {
        if (++spins > kMaxPolls) __trap();
      }
      polls += spins;
    }
  }
  __syncthreads();
}

// After the tile's stores of stage k: publish it to the neighbours.  The
// barrier orders every thread's stores before thread 0's release store,
// which makes them visible at device scope to an acquire that reads it
// (CUTLASS's semaphore release: no fence besides the release).
__device__ __forceinline__ void publish(unsigned int* flag, unsigned int v) {
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) store_release(flag, v);
}

// The resident launch's inputs besides the substep struct.
struct Resident {
  const float* x;          // xp, the substep's start (read only)
  float* x_out;
  const float* f_ext;      // or null
  const float* alive_in;   // kFeat: the planes in and the substep's planes
  float* alive_out;        // out (a null pair: that feature is off)
  const float* scale_in;
  float* scale_out;
  int first;
  unsigned int base;       // epoch * (n_sweeps + 1): this launch's stage 0
};

template <int P, bool kFeat, bool kCount>
__global__ void __launch_bounds__(kTileX * kTileY, 2)
    grid_xpbd_sweep_kernel_resident(const GridXpbdSubstep s, const Resident r) {
  using O = Offsets<P>;
  using T = Tile<P>;
  constexpr int TX = T::TX, TY = T::TY, H = T::H, FW = T::FW, NT = TX * TY;
  constexpr int kN = O::n;
  constexpr int kHalo = T::FH * T::FW - NT;
  using Seq = std::make_integer_sequence<int, kN>;
  static_assert(T::SB(kN) <= NT, "a strip entry a thread at most");
  static_assert(kHalo <= NT, "a halo cell a thread at most");
  __shared__ float4 frame[T::FH * T::FW];   // xe, w
  __shared__ float4 terms[T::B(kN)];        // dlam, n
  __shared__ unsigned int cnt[kCounters];   // kCount: this CTA's sums
  const int x = threadIdx.x, y = threadIdx.y, tid = y * TX + x;
  const int ny = s.ny, nx = s.nx, ps = ny * nx;
  const int tiles_x = gridDim.x, tiles_y = gridDim.y;
  const int i0 = blockIdx.y * TY, j0 = blockIdx.x * TX;
  const int i = i0 + y, j = j0 + x;
  const int idx = i * nx + j;
  const unsigned int n = static_cast<unsigned int>(s.n_sweeps);
  unsigned int* const own_flag = s.flags + blockIdx.y * tiles_x + blockIdx.x;
  auto in_grid = [&](int a, int b) {
    return a >= 0 && a < ny && b >= 0 && b < nx;
  };
  auto in_tile = [&](int a, int b) {
    return a >= i0 && a < i0 + TY && b >= j0 && b < j0 + TX;
  };
  const bool mine = in_grid(i, j);
  // a neighbour's halo holds the vertices within H of the tile's edge
  const bool border = y < H || y >= TY - H || x < H || x >= TX - H;
  unsigned int checked = 0, unmet = 0, polls = 0;   // kCount: this thread's
  if constexpr (kCount) {
    if (y == 0 && x < kCounters) cnt[x] = 0;
  }

  // stage 0: the predict
  Vec3 xpi{}, dl{};
  float wi = 0.0f, c = 0.0f;
  unsigned char contact = 0;
  if (mine) {
    xpi = load3(r.x, idx, ps);
    wi = s.inv_mass[idx];
    const bool tearing = kFeat && s.inv_cnt_out;
#define GRID_XPBD_PREDICT_VERTEX(EXT, WIND)                                   \
  predict_vertex<EXT, kFeat, WIND>(                                           \
      i, j, ny, nx, s.v, s.inv_mass, r.f_ext, r.x, s.offsets, s.n_off,        \
      r.alive_in, r.alive_out, r.scale_in, r.scale_out, s.tear_limits,        \
      r.first, s.fp, s.relaxation, tearing, &c, s.wind, s.p)
    if (r.f_ext && s.wind_on)
      dl = GRID_XPBD_PREDICT_VERTEX(true, true);
    else if (r.f_ext)
      dl = GRID_XPBD_PREDICT_VERTEX(true, false);
    else if (s.wind_on)
      dl = GRID_XPBD_PREDICT_VERTEX(false, true);
    else
      dl = GRID_XPBD_PREDICT_VERTEX(false, false);
#undef GRID_XPBD_PREDICT_VERTEX
    if (!tearing) c = s.inv_cnt[idx];
    if (border) store3(s.delta[0], idx, ps, dl);
  }
  // the thread's halo cell: its xp and mass, fixed over the substep
  int hcell = -1, hq = 0;
  Vec3 hxp{};
  float hw = 0.0f;
  if (tid < kHalo) {
    int row, col;
    if (tid < 2 * H * FW) {   // the H rows above, then the H rows below
      row = tid < H * FW ? tid / FW : TY + tid / FW;
      col = tid % FW;
    } else {                  // the H columns left and right of each row
      const int h = tid - 2 * H * FW;
      row = H + h / (2 * H);
      col = h % (2 * H) < H ? h % (2 * H) : TX + h % (2 * H);
    }
    const int gi = i0 - H + row, gj = j0 - H + col;
    if (in_grid(gi, gj)) {
      hcell = row * FW + col;
      hq = gi * nx + gj;
      hxp = load3(r.x, hq, ps);
      hw = s.inv_mass[hq];
    }
  }
  publish(own_flag, r.base);

  // the thread's entries: (y, x) of every offset, and at most one strip
  // entry, offset so_ at rectangle row sr, column sc_
  float lam0[kN], alive0[kN], scale0[kN];
  each_offset([&](auto oc) {
    constexpr int o = decltype(oc)::value;
    lam0[o] = 0.0f;
    alive0[o] = scale0[o] = 1.0f;
  }, Seq{});
  int so_ = -1, sr = 0, sc_ = 0;
  float slam = 0.0f, salive = 1.0f, sscale = 1.0f;
  each_offset([&](auto oc) {
    constexpr int o = decltype(oc)::value;
    const int e = tid - T::SB(o);
    if (e >= 0 && e < T::S(o)) {
      so_ = o;
      sr = T::strip_row(o, e);
      sc_ = T::strip_col(o, e);
    }
  }, Seq{});

  // the ping-pong planes of stage k (k % 2) and of the stage before it,
  // picked without indexing the parameter's arrays (which would copy the
  // struct to local memory)
  auto plane = [](float* a, float* b, unsigned int k) {
    return k % 2 ? b : a;
  };
  for (unsigned int k = 1; k <= n; ++k) {
    const bool last = k == n;
    const float* lam_in = plane(s.lam[0], s.lam[1], k - 1);
    float* lam_out = plane(s.lam[0], s.lam[1], k);
    wait_neighbours(s.flags, tiles_x, tiles_y, r.base, k, n, polls);
    // what rectangle entry (rr, cc) of offset o reads from the neighbours,
    // loaded with the halo's delta before the staging barrier: at stage 1
    // the predict's feature planes (fixed over the substep), after it the
    // stage k - 1 lambda of an edge a neighbour owns; lam, a and sc are
    // the thread's copies of the entry's lambda and feature values
    auto fetch = [&](auto oc, int rr, int cc, float& lam, float& a,
                     float& sc) {
      constexpr int o = decltype(oc)::value;
      const int qi = i0 + min0(-O::di(o)) + rr;
      const int qj = j0 + min0(-O::dj(o)) + cc;
      if (!in_grid(qi, qj)) return;
      const int q = o * ps + qi * nx + qj;
      if (k == 1) {
        if (kFeat && r.alive_out) a = __ldcg(r.alive_out + q);
        if (kFeat && r.scale_out) sc = __ldcg(r.scale_out + q);
      } else if (!in_tile(qi, qj)) {
        lam = __ldcg(lam_in + q);
      }
    };
    // rectangle entry (rr, cc) of offset o: (dlam, n) or zeros, the
    // tile's own lambdas out
    auto evaluate = [&](auto oc, int rr, int cc, float& lam, float a,
                        float sc) {
      constexpr int o = decltype(oc)::value;
      const int qi = i0 + min0(-O::di(o)) + rr;
      const int qj = j0 + min0(-O::dj(o)) + cc;
      float4 term = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (in_grid(qi, qj)) {
        term = edge_term<P, o, kCount>(qi, qj, i0, j0, ny, nx, frame,
                                       s.offsets, a, sc,
                                       kFeat && r.scale_out, last, lam,
                                       checked, unmet);
        if (!last && in_tile(qi, qj)) lam_out[o * ps + qi * nx + qj] = lam;
      }
      terms[T::B(o) + rr * T::NC(o) + cc] = term;
    };
    each_offset([&](auto oc) {
      constexpr int o = decltype(oc)::value;
      fetch(oc, y, x, lam0[o], alive0[o], scale0[o]);
    }, Seq{});
    each_offset([&](auto oc) {
      constexpr int o = decltype(oc)::value;
      if (so_ == o) fetch(oc, sr, sc_, slam, salive, sscale);
    }, Seq{});
    // stage the frame: the tile's points from registers, the halo's xp +
    // the neighbours' delta of stage k - 1
    if (mine)
      frame[(y + H) * FW + x + H] =
          make_float4(xpi.x + dl.x, xpi.y + dl.y, xpi.z + dl.z, wi);
    if (hcell >= 0) {
      const float* d = plane(s.delta[0], s.delta[1], k - 1);
      frame[hcell] =
          make_float4(hxp.x + __ldcg(d + hq), hxp.y + __ldcg(d + ps + hq),
                      hxp.z + __ldcg(d + 2 * ps + hq), hw);
    }
    __syncthreads();
    each_offset([&](auto oc) {
      constexpr int o = decltype(oc)::value;
      evaluate(oc, y, x, lam0[o], alive0[o], scale0[o]);
    }, Seq{});
    each_offset([&](auto oc) {
      constexpr int o = decltype(oc)::value;
      if (so_ == o) evaluate(oc, sr, sc_, slam, salive, sscale);
    }, Seq{});
    if constexpr (kCount) {
      if (last) {   // a warp is one row of the tile
        checked = __reduce_add_sync(0xffffffffu, checked);
        unmet = __reduce_add_sync(0xffffffffu, unmet);
        if (x == 0) {
          atomicAdd(&cnt[kEdgesChecked], checked);
          atomicAdd(&cnt[kEdgesUnmet], unmet);
        }
      }
    }
    __syncthreads();
    if (mine) {
      dl = jacobi_update<P>(terms, y, x, wi, c, dl);
      if (wi > 0.0f) project_delta(dl, xpi, &contact, s.col);
    }
    if (!last) {
      if (mine && border)
        store3(plane(s.delta[0], s.delta[1], k), idx, ps, dl);
      publish(own_flag, r.base + k);
    }
  }

  if (mine) {
    if (s.epilogue) {
      finish(dl, xpi, idx, ps, wi > 0.0f, contact, s.col, r.x_out, s.v, s.p);
    } else {   // the strain launch reads delta and the flag
      store3(plane(s.delta[0], s.delta[1], n), idx, ps, dl);
      s.flag[idx] = contact;
    }
  }
  if constexpr (kCount) {
    if (y == 0) {
      polls = __reduce_add_sync(0xffffffffu, polls);
      if (x == 0) {
        atomicAdd(reinterpret_cast<unsigned long long*>(s.counters) +
                      kEdgesChecked,
                  cnt[kEdgesChecked]);
        atomicAdd(reinterpret_cast<unsigned long long*>(s.counters) +
                      kEdgesUnmet,
                  cnt[kEdgesUnmet]);
        atomicAdd(reinterpret_cast<unsigned long long*>(s.counters) +
                      kFlagPolls,
                  static_cast<unsigned long long>(polls));
      }
    }
  }
}

template <int P, bool kFeat, bool kCount>
int resident_per_sm(int* per_sm, int* sms) {
  const Occupancy o =
      occupancy(grid_xpbd_sweep_kernel_resident<P, kFeat, kCount>,
                kTileX * kTileY);
  if (o.err) return o.err;
  *per_sm = o.per_sm < *per_sm ? o.per_sm : *per_sm;
  *sms = o.sms;
  return 0;
}

template <int P>
int resident_pattern(int* per_sm, int* sms) {
  int err = resident_per_sm<P, false, false>(per_sm, sms);
  if (!err) err = resident_per_sm<P, false, true>(per_sm, sms);
  if (!err) err = resident_per_sm<P, true, false>(per_sm, sms);
  if (!err) err = resident_per_sm<P, true, true>(per_sm, sms);
  return err;
}

}  // namespace

// The CTAs the card holds resident of every instantiation of the resident
// kernel, the fewest an SM of any times the SMs, asked once a process of
// the current device: a grid of at most that many 32 x 8 tiles runs a
// substep as one resident launch, whatever the pattern, the features and
// the recorder.  Returns the cudaError_t of the queries.
extern "C" int grid_xpbd_resident_slots(int* slots) {
  static int cached = -1, err = 0;
  if (cached < 0 && !err) {
    int per_sm = 1 << 30, sms = 0;
    err = resident_pattern<kStructural>(&per_sm, &sms);
    if (!err) err = resident_pattern<kShear>(&per_sm, &sms);
    if (!err) err = resident_pattern<kBend>(&per_sm, &sms);
    if (!err) err = resident_pattern<kShearBend>(&per_sm, &sms);
    if (!err) cached = per_sm * sms;
  }
  *slots = cached < 0 ? 0 : cached;
  return err;
}

// One substep as one cooperative launch of the resident kernel on pattern
// P, the kCount instantiation with s->counters.
template <int P>
int launch_resident(const GridXpbdSubstep* s, cudaStream_t st,
                    const Resident& r) {
  const dim3 block(kTileX, kTileY);
  const dim3 grid((s->nx + kTileX - 1) / kTileX, (s->ny + kTileY - 1) / kTileY);
  void* args[] = {const_cast<GridXpbdSubstep*>(s), const_cast<Resident*>(&r)};
  const void* kernel =
      s->feat ? (s->counters
                     ? reinterpret_cast<const void*>(
                           grid_xpbd_sweep_kernel_resident<P, true, true>)
                     : reinterpret_cast<const void*>(
                           grid_xpbd_sweep_kernel_resident<P, true, false>))
              : (s->counters
                     ? reinterpret_cast<const void*>(
                           grid_xpbd_sweep_kernel_resident<P, false, true>)
                     : reinterpret_cast<const void*>(
                           grid_xpbd_sweep_kernel_resident<P, false, false>));
  return static_cast<int>(
      cudaLaunchCooperativeKernel(kernel, grid, block, args, 0, st));
}

// The sweeps of one substep on pattern P: s->n_sweeps launches from
// delta[0] and lam[0], ping-pong; the last runs the epilogue unless the
// strain sweeps follow, and with s->counters it is the kCount
// instantiation.
template <int P>
int launch_sweeps(const GridXpbdSubstep* s, cudaStream_t st, const float* x,
                  float* x_out, const float* alive, const float* scale,
                  int* launches) {
  const dim3 block(kTileX, kTileY);
  const dim3 grid = grid_of(s->ny, s->nx, block);
  for (int it = 0; it < s->n_sweeps; ++it) {
    const int a = it % 2, b = 1 - a;
    const int last = s->epilogue && it == s->n_sweeps - 1;
    unsigned long long* counters =
        it == s->n_sweeps - 1
            ? reinterpret_cast<unsigned long long*>(s->counters)
            : nullptr;
#define GRID_XPBD_SWEEP(FEAT, COUNT)                                      \
  grid_xpbd_sweep_kernel<P, FEAT, COUNT><<<grid, block, 0, st>>>(         \
      x, s->delta[a], s->delta[b], s->lam[a], s->lam[b], s->flag,         \
      s->inv_mass, s->inv_cnt, s->offsets, s->col, s->project, last,      \
      x_out, s->v, alive, scale, counters, s->ny, s->nx, s->p)
    if (s->feat && counters)
      GRID_XPBD_SWEEP(true, true);
    else if (s->feat)
      GRID_XPBD_SWEEP(true, false);
    else if (counters)
      GRID_XPBD_SWEEP(false, true);
    else
      GRID_XPBD_SWEEP(false, false);
#undef GRID_XPBD_SWEEP
    ++*launches;
    if (int err = static_cast<int>(cudaGetLastError())) return err;
  }
  return 0;
}

// Launch one substep on s->stream: the predict, then s->n_sweeps Jacobi
// sweeps, the last running the epilogue unless the strain sweeps follow
// (then every sweep stores delta, into s->delta[n_sweeps % 2]); with
// s->resident (the wrapper's plan, never with n_iterations = 0) all of it
// as one cooperative launch of the resident kernel, which advances
// *s->epoch.  x is the
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
  if (s->resident && s->project && s->n_sweeps > 0) {
    const unsigned int epoch = ++*s->epoch;
    const Resident r{x,        x_out, f_ext,    alive_in,
                     alive_out, scale_in, scale_out, first,
                     epoch * static_cast<unsigned int>(s->n_sweeps + 1)};
    int err = static_cast<int>(cudaErrorInvalidValue);
    switch (s->pattern) {
      case kStructural: err = launch_resident<kStructural>(s, st, r); break;
      case kShear: err = launch_resident<kShear>(s, st, r); break;
      case kBend: err = launch_resident<kBend>(s, st, r); break;
      case kShearBend: err = launch_resident<kShearBend>(s, st, r); break;
    }
    if (err)
      cudaGetLastError();   // a refused launch leaves no error for the next
    else
      *launches = 1;
    return err;
  }
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
