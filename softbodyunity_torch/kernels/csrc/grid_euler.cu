// Fused semi-implicit Euler substep for structured grid cloth, for Hopper
// (sm_90a).  Built by softbodyunity_torch/kernels/build.py, wrapped by
// softbodyunity_torch/kernels/grid_euler.py; its plain PyTorch version is
// softbodyunity_torch/kernels/stencil.py::euler_substep_grid (with
// update_features, in the launch-start order of
// softbodyunity_torch/kernels/grid_features.py).
//
// Replaces two TPU kernels of softbodyunity_tpu/kernels/: the whole-VMEM
// pallas_substep.py::_make_kernel, launched by ::_pallas_substeps through
// pl.pallas_call (up to 128k vertices, 64k with tear or plastic planes),
// and the row-tiled pallas_tiled.py::_make_kernel, launched by
// ::_tiled_substeps (grids past that cap).  It runs their branches of the
// grid-cloth Euler path: the six-offset spring stencil (Hooke + axial
// damper), gravity, global damping and pinning, plane, sphere, capsule and
// oriented-box contact with the colliders' kinematic velocities
// (grid_common.cuh::resolve_velocity_contact), the tear-liveness and
// plastic rest-scale planes (the kFeat instantiation), the wind's drag and
// lift along the grid's vertex normals (the kWind instantiation), and the
// strain limit's Jacobi sweeps (grid_common.cuh::grid_strain_sweep_kernel,
// one cooperative launch a substep, its last sweep running this solver's
// epilogue).  An optional external force plane (the self-collision
// repulsion, block_pairs.cu) is added to the spring forces, where the JAX
// package's general path adds self_collision_force
// (solver/step.py::total_forces); the TPU routes such scenes off these
// kernels.
//
// Design.  The TPU's whole-VMEM kernel keeps the state in VMEM and runs
// every substep of a frame in one launch, which caps it at 128k vertices;
// past the cap its row-tiled kernel runs one substep per launch on row
// tiles with DMA'd 8-row halos.  An SM's 227 KB of shared memory cannot
// hold even the 64k-vertex state (x and v are 1.5 MB), but the 50 MB L2
// holds it from one launch to the next at 64k, and device memory at any
// size.  So here a substep is one launch, reading the (x, v) planes of one
// buffer and writing the other: ping-pong, because an in-place update would
// race with the neighbours' reads.  One C call (grid_euler_substeps) runs a
// frame's substeps: their launches, the buffer swaps and the frame-end
// feature update, from a struct built once a call (GridEulerFrame); only
// self-collision, whose force plane comes from PyTorch ops each substep,
// makes one call a substep.  What the row-tiled kernel computes beyond the
// whole-VMEM one is the launch-start form of the feature planes: a substep
// that is one launch with no grid-wide barrier cannot tear an edge from
// its neighbours' new positions, so each launch but a frame's first
// updates the planes from its INPUT positions (the previous substep's
// output) before it uses them, and one frame-end update
// (grid_common.cuh::grid_feature_finish_kernel) follows the last substep.
// kFeat is that form here.  The strain limit needs a grid-wide barrier
// between its sweeps, so under it a substep is 2 launches: this kernel
// integrates with the contact left out, and one cooperative launch runs
// the sweeps, the last adding the change to the velocity and running the
// contact (EulerStrainEpilogue below).
//
// The tile.  A CTA owns a 32 x 8 tile of the grid (grid_common.cuh::Tile,
// shared with grid_xpbd.cu and the strain sweeps; its staging and springs,
// stage_frame, tile_spring_terms and tile_spring_force, with
// grid_verlet.cu), one thread a vertex, and is compiled for the offsets'
// pattern (structural, with shear, with bend, with both), so that every
// index is a constant.  It stages x and v of the tile and a frame of H
// rows and columns around it (H = 2 with bend springs) in shared memory,
// evaluates each spring with an endpoint in the tile once
// (grid_common.cuh::edge_terms: the force's magnitude and unit
// direction into shared memory; each thread its own entry of every
// offset's rectangle, the frame-owned rest one entry a thread), then each
// vertex sums, per offset in table order, + fmag n of the edge it owns and
// - fmag n of the edge owned by p - o: the products and the order of the
// one-pass kernel this replaced, which evaluated each edge at both ends,
// so x and v are that kernel's to the bit.  Under kFeat the edge's feature
// update (grid_common.cuh::edge_features) runs once with it, and the tile
// writes the plane entries of the edges its vertices own.  f_ext and the
// wind stay per vertex; the wind's normal reads the 1-ring from the frame.
// A grid of more tiles than the card holds CTAs at once (262k and 1m
// vertices) is latency-bound with five CTAs an SM, so a plain substep there
// takes the offsets' terms in two halves, eight CTAs an SM
// (grid_euler_wide_kernel): the launch chooses from the grid and the
// card's occupancy.
//
// What bounds it.  Per vertex and substep it reads x, v and inv_mass once
// and writes x and v: 52 bytes, 3.4 MB at 64k vertices, ~1.0 us at the
// card's 3.35 TB/s, and ~35 flops an edge (~14 MFLOP at 64k, 0.2 us at the
// 67 TFLOP/s float32 peak): bound by bytes.  The feature planes add 4
// bytes in and out per offset and plane, the wind ~76 flops a vertex and no
// bytes.  At 64k vertices a launch holds two CTAs an SM and is bound by its
// latency (staging, one sqrtf and IEEE divide an edge, two barriers); the
// one-pass kernel evaluated each edge at both ends and tested every
// neighbour's bounds through a run-time offset loop (PERF.md).  At 262k and
// 1m vertices (12.6 MB of x, 50 MB for ping-pong x and v) it is bound by
// the latency of its loads, at a third of the card's bandwidth.
//
// Rounding.  sqrtf and IEEE divides, in the plain version's order.  nvcc
// contracts a * b + c into FMAs where torch rounds twice, so kernel and plain
// version agree to rounding, not to the bit; the feature update alone is
// rounded as the plain version rounds it (grid_common.cuh).  Pinned vertices
// stay bit-frozen: their velocity is zeroed and x + dt * 0 == x.

#include <cuda_runtime.h>

#include "grid_common.cuh"

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
};

// The velocity and position update of vertex idx under force f, then its
// contact, written to x_out and v_out (stencil.py::euler_substep_grid).
__device__ __forceinline__ void euler_update(
    Vec3 xi, Vec3 vi, float fx, float fy, float fz, float im, int idx,
    int ps, const Colliders& col, const Params& p, float* __restrict__ x_out,
    float* __restrict__ v_out) {
  const bool movable = im > 0.0f;
  float vx = (vi.x + p.dt * (p.gx + fx * im)) * p.decay;
  float vy = (vi.y + p.dt * (p.gy + fy * im)) * p.decay;
  float vz = (vi.z + p.dt * (p.gz + fz * im)) * p.decay;
  if (!movable) vx = vy = vz = 0.0f;
  float px = xi.x + p.dt * vx;
  float py = xi.y + p.dt * vy;
  float pz = xi.z + p.dt * vz;

  if (movable)
    resolve_velocity_contact(px, py, pz, vx, vy, vz, col, p.restitution,
                             p.restitution1, p.keep);

  x_out[idx] = px;
  x_out[ps + idx] = py;
  x_out[2 * ps + idx] = pz;
  v_out[idx] = vx;
  v_out[ps + idx] = vy;
  v_out[2 * ps + idx] = vz;
}

// One substep on a CTA that owns a kTileX x kTileY tile of the [ny, nx]
// grid, one thread a vertex, compiled for the offsets' pattern P.  x, v,
// x_out and v_out are [3, ny, nx] component planes; offsets is [n_off, 4]
// rows of (di, dj, k, rest), di and dj those of P; col holds the collider
// rows (grid_common.cuh).  kExt: f_ext, [3, ny, nx], is added to the spring
// forces; the instantiation without it is the kernel as it was before the
// plane existed.  kFeat: the tear and plastic planes, [n_off, ny, nx], are
// read from *_in (null: the feature is off), updated at the launch's start
// unless `first`, used by the springs and written to *_out; tear_limits[o]
// is rest * (1 + strain_limit).  kWind: the wind force, at x and v, is
// added after f_ext.
template <int P, bool kExt, bool kFeat, bool kWind>
__global__ void __launch_bounds__(kTileX * kTileY) grid_euler_substep_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    float* __restrict__ x_out, float* __restrict__ v_out,
    const float* __restrict__ inv_mass, const float* __restrict__ offsets,
    Colliders col, const float* __restrict__ f_ext,
    const float* __restrict__ alive_in, float* __restrict__ alive_out,
    const float* __restrict__ scale_in, float* __restrict__ scale_out,
    const float* __restrict__ tear_limits, int first, FeatParams fp,
    Wind wind, int ny, int nx, Params p) {
  using T = Tile<P>;
  __shared__ float4 sx[T::FH * T::FW];   // x of the tile and its frame
  __shared__ float4 sv[T::FH * T::FW];   // v
  __shared__ float4 terms[T::B(Offsets<P>::n)];   // (fmag, n) of each edge
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i0 = blockIdx.y * T::TY, j0 = blockIdx.x * T::TX;
  const int ps = ny * nx;
  stage_frame<T>(x, v, 0.0f, sx, sv, i0, j0, ny, nx);
  __syncthreads();
  tile_spring_terms<P, kFeat>(sx, sv, terms, offsets, alive_in, alive_out,
                              scale_in, scale_out, tear_limits, first, fp,
                              p.damping, i0, j0, ny, nx);
  __syncthreads();

  const int i = i0 + ty, j = j0 + tx;
  if (i >= ny || j >= nx) return;
  const int idx = i * nx + j;
  const int c = (ty + T::H) * T::FW + (tx + T::H);
  const float4 xs = sx[c], vs = sv[c];
  const Vec3 xi = {xs.x, xs.y, xs.z}, vi = {vs.x, vs.y, vs.z};
  const Vec3 fs = tile_spring_force<P>(terms, ty, tx);
  float fx = fs.x, fy = fs.y, fz = fs.z;

  if (kExt) {   // springs + f_ext, as total_forces sums them
    fx += f_ext[idx];
    fy += f_ext[ps + idx];
    fz += f_ext[2 * ps + idx];
  }
  if (kWind) {  // + wind, as total_forces sums them
    const Vec3 fw =
        wind_force_at(FrameAt<T>{sx, i0, j0}, i, j, ny, nx, vi, wind);
    fx += fw.x;
    fy += fw.y;
    fz += fw.z;
  }
  euler_update(xi, vi, fx, fy, fz, inv_mass[idx], idx, ps, col, p, x_out,
               v_out);
}

// The plain substep (no force plane, feature planes or wind) of
// grid_euler_substep_kernel for a grid of more tiles than the card holds
// CTAs of that kernel at once, where five CTAs an SM leave its latency
// exposed (the 262k and 1m curtains): the offsets in two groups, [0, n / 2)
// and [n / 2, n), through one buffer of terms as large as the larger
// group's, each group evaluated, then summed at each vertex, the first
// before the second, so that each vertex still sums per offset in table
// order, to the bit.  Half the terms and 32 registers fit eight CTAs an
// SM; its two more barriers cost a grid the card holds at once, and the
// feature update spills at 32 registers (PERF.md).
template <int P>
__global__ void __launch_bounds__(kTileX * kTileY, 8) grid_euler_wide_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    float* __restrict__ x_out, float* __restrict__ v_out,
    const float* __restrict__ inv_mass, const float* __restrict__ offsets,
    Colliders col, int ny, int nx, Params p) {
  using O = Offsets<P>;
  using T = Tile<P>;
  constexpr int TX = T::TX, TY = T::TY, NT = TX * TY;
  constexpr int kN = O::n, kA = kN / 2;
  constexpr int kTerms = T::B(kA) > T::B(kN) - T::B(kA) ? T::B(kA)
                                                         : T::B(kN) - T::B(kA);
  __shared__ float4 sx[T::FH * T::FW];
  __shared__ float4 sv[T::FH * T::FW];
  __shared__ float4 terms[kTerms];       // (fmag, n) of a group's edges
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i0 = blockIdx.y * TY, j0 = blockIdx.x * TX;
  const int i = i0 + ty, j = j0 + tx;
  const int ps = ny * nx;
  auto in_grid = [&](int a, int b) {
    return a >= 0 && a < ny && b >= 0 && b < nx;
  };
  auto cell = [&](int a, int b) {
    return (a - i0 + T::H) * T::FW + (b - j0 + T::H);
  };
  const bool mine = in_grid(i, j);
  stage_frame<T>(x, v, 0.0f, sx, sv, i0, j0, ny, nx);
  __syncthreads();
  float fx = 0.0f, fy = 0.0f, fz = 0.0f;
  // offsets [A, B): each edge with an endpoint in the tile evaluated once
  // into the terms, then summed at each vertex
  auto group = [&](auto a, auto b) {
    constexpr int A = decltype(a)::value, B = decltype(b)::value;
    using Seq = std::make_integer_sequence<int, B - A>;
    auto evaluate = [&](auto oc, int r, int cc) {
      constexpr int o = decltype(oc)::value;
      const int qi = i0 + min0(-O::di(o)) + r;
      const int qj = j0 + min0(-O::dj(o)) + cc;
      const int bi = qi + O::di(o), bj = qj + O::dj(o);
      float4 term = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (in_grid(qi, qj) && in_grid(bi, bj)) {
        const float4 pa = sx[cell(qi, qj)], pb = sx[cell(bi, bj)];
        const float4 va = sv[cell(qi, qj)], vb = sv[cell(bi, bj)];
        term = edge_terms({pa.x, pa.y, pa.z}, {va.x, va.y, va.z},
                          {pb.x, pb.y, pb.z}, {vb.x, vb.y, vb.z},
                          offsets[4 * o + 2], offsets[4 * o + 3], p.damping);
      }
      terms[T::B(o) - T::B(A) + r * T::NC(o) + cc] = term;
    };
    each_offset_from<A>([&](auto oc) { evaluate(oc, ty, tx); }, Seq{});
#pragma unroll
    for (int e0 = ty * TX + tx; e0 < T::SB(B) - T::SB(A); e0 += NT) {
      each_offset_from<A>([&](auto oc) {
        constexpr int o = decltype(oc)::value;
        const int e = e0 - (T::SB(o) - T::SB(A));
        if (e >= 0 && e < T::S(o))
          evaluate(oc, T::strip_row(o, e), T::strip_col(o, e));
      }, Seq{});
    }
    __syncthreads();
    if (!mine) return;
    each_offset_from<A>([&](auto oc) {
      constexpr int o = decltype(oc)::value;
      constexpr int di = O::di(o), dj = O::dj(o);
      constexpr int r0 = min0(-di), c0 = min0(-dj);
      constexpr int base = T::B(o) - T::B(A);
      const float4 t = terms[base + (ty - r0) * T::NC(o) + (tx - c0)];
      fx += t.x * t.y;
      fy += t.x * t.z;
      fz += t.x * t.w;
      const float4 u =
          terms[base + (ty - di - r0) * T::NC(o) + (tx - dj - c0)];
      fx -= u.x * u.y;
      fy -= u.x * u.z;
      fz -= u.x * u.w;
    }, Seq{});
  };
  group(std::integral_constant<int, 0>{}, std::integral_constant<int, kA>{});
  __syncthreads();   // the first group's terms are summed
  group(std::integral_constant<int, kA>{}, std::integral_constant<int, kN>{});
  if (!mine) return;
  const int idx = i * nx + j;
  const float4 xs = sx[cell(i, j)], vs = sv[cell(i, j)];
  euler_update({xs.x, xs.y, xs.z}, {vs.x, vs.y, vs.z}, fx, fy, fz,
               inv_mass[idx], idx, ps, col, p, x_out, v_out);
}

// The strain sweeps' epilogue (stencil.py::euler_substep_grid): the change
// dxl = x_new - x0 from the integrated positions x0 goes into x and, over
// dt, into the integrated velocity v (in place: each thread touches its own
// vertex only), then the velocity-level contact of a movable vertex; x is
// written to x_out.
struct EulerStrainEpilogue {
  const float* x0;
  float* x_out;
  float* v;
  const float* inv_mass;
  Colliders col;
  int ps;
  Params p;

  __device__ void operator()(int idx, Vec3 xn) const {
    const Vec3 a = load3(x0, idx, ps);
    const Vec3 d = sub3(xn, a);
    float px = a.x + d.x, py = a.y + d.y, pz = a.z + d.z;
    const Vec3 vi = load3(v, idx, ps);
    float vx = vi.x + d.x / p.dt, vy = vi.y + d.y / p.dt,
          vz = vi.z + d.z / p.dt;
    if (inv_mass[idx] > 0.0f)
      resolve_velocity_contact(px, py, pz, vx, vy, vz, col, p.restitution,
                               p.restitution1, p.keep);
    store3(x_out, idx, ps, {px, py, pz});
    store3(v, idx, ps, {vx, vy, vz});
  }
};

}  // namespace

// What a frame launches with, fixed over a call of the step function:
// softbodyunity_torch/kernels/grid_euler.py::_Frame mirrors it field by
// field (grid_euler_frame_size checks the two agree).
struct GridEulerFrame {
  float* x[2];                // [3, ny, nx] ping-pong; under the strain
                              // limit x[0] is every substep's start and
                              // x[1] its integrated positions
  float* v[2];                // [3, ny, nx] ping-pong
  float* alive[2];            // [n_off, ny, nx] ping-pong tear planes, or
                              // null (tearing off)
  float* scale[2];            // the same for the plastic rest scales
  const float* inv_mass;      // [ny, nx]
  const float* offsets;       // [n_off, 4]
  const float* tear_limits;   // [n_off] (feat)
  void* stream;
  int n_off;
  int pattern;                // the offsets' Pattern
  int feat, wind_on, strain;
  int ny, nx;
  FeatParams fp;
  Colliders col;
  Wind wind;
  Params p;
  StrainSweeps sweeps;        // (strain)
};

extern "C" int grid_euler_frame_size() {
  return static_cast<int>(sizeof(GridEulerFrame));
}

extern "C" int grid_euler_strain_size() {
  return static_cast<int>(sizeof(StrainSweeps));
}

namespace {

// One substep launch on pattern P, from buffer a of the ping-pong planes
// into buffer b; returns the launch's cudaError_t.  A plain substep (no
// force plane, feature planes or wind) on a grid of more tiles than the
// card holds CTAs of grid_euler_substep_kernel at once takes
// grid_euler_wide_kernel.
template <int P>
int launch_substep(const GridEulerFrame* s, cudaStream_t st, const float* x,
                   const float* v, float* x_out, float* v_out, int a,
                   const float* f_ext, int first) {
  const dim3 block(kTileX, kTileY);
  const dim3 grid((s->nx + kTileX - 1) / kTileX,
                  (s->ny + kTileY - 1) / kTileY);
  const Colliders col = s->strain ? kNoContact : s->col;
  const float* alive_in = s->alive[a];
  float* alive_out = s->alive[1 - a];
  const float* scale_in = s->scale[a];
  float* scale_out = s->scale[1 - a];
#define GRID_EULER_LAUNCH(EXT, FEAT, WIND)                                   \
  grid_euler_substep_kernel<P, EXT, FEAT, WIND><<<grid, block, 0, st>>>(     \
      x, v, x_out, v_out, s->inv_mass, s->offsets, col, f_ext, alive_in,     \
      alive_out, scale_in, scale_out, s->tear_limits, first, s->fp, s->wind, \
      s->ny, s->nx, s->p)
#define GRID_EULER_WIND(EXT, FEAT)          \
  do {                                      \
    if (s->wind_on)                         \
      GRID_EULER_LAUNCH(EXT, FEAT, true);   \
    else                                    \
      GRID_EULER_LAUNCH(EXT, FEAT, false);  \
  } while (0)
  if (f_ext && s->feat) {
    GRID_EULER_WIND(true, true);
  } else if (f_ext) {
    GRID_EULER_WIND(true, false);
  } else if (s->feat) {
    GRID_EULER_WIND(false, true);
  } else if (s->wind_on) {
    GRID_EULER_LAUNCH(false, false, true);
  } else {
    static const Occupancy one = occupancy(
        grid_euler_substep_kernel<P, false, false, false>, kTileX * kTileY);
    if (one.err) return one.err;
    if (static_cast<long>(grid.x) * grid.y >
        static_cast<long>(one.per_sm) * one.sms)
      grid_euler_wide_kernel<P><<<grid, block, 0, st>>>(
          x, v, x_out, v_out, s->inv_mass, s->offsets, col, s->ny, s->nx,
          s->p);
    else
      GRID_EULER_LAUNCH(false, false, false);
  }
#undef GRID_EULER_WIND
#undef GRID_EULER_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Run substeps k0 .. k0 + n - 1 of a frame on s->stream.  Substep k reads
// buffer k % 2 of v and of the feature planes and writes the other; x
// likewise without the strain limit, and under it reads x[0], integrates
// into x[1] with the contact left out, and the strain launch (its sweeps
// from x[1]) writes the substep's end into x[0] and its velocity in place.
// The feature update at a launch's start is skipped for substep 0, the
// frame's first.  With `finish` and features, the frame-end update
// follows, from buffer (k0 + n) % 2 of the planes into the other.  f_ext
// (the self-collision force plane, or null) enters every substep run: the
// caller that has one runs one substep a call.  *launches counts the
// kernels launched; returns the first launch's cudaError_t that is not
// cudaSuccess, after which it launches nothing more.  Allocates nothing
// and does not synchronise.
extern "C" int grid_euler_substeps(const GridEulerFrame* s, int k0, int n,
                                   int finish, const float* f_ext,
                                   int* launches) {
  const cudaStream_t st = static_cast<cudaStream_t>(s->stream);
  const int ps = s->ny * s->nx;
  *launches = 0;
  for (int k = k0; k < k0 + n; ++k) {
    const int a = k % 2, b = 1 - a;
    const float* x = s->strain ? s->x[0] : s->x[a];
    float* x_out = s->strain ? s->x[1] : s->x[b];
    int err;
    switch (s->pattern) {
      case kStructural:
        err = launch_substep<kStructural>(s, st, x, s->v[a], x_out, s->v[b],
                                          a, f_ext, k == 0);
        break;
      case kShear:
        err = launch_substep<kShear>(s, st, x, s->v[a], x_out, s->v[b], a,
                                     f_ext, k == 0);
        break;
      case kBend:
        err = launch_substep<kBend>(s, st, x, s->v[a], x_out, s->v[b], a,
                                    f_ext, k == 0);
        break;
      case kShearBend:
        err = launch_substep<kShearBend>(s, st, x, s->v[a], x_out, s->v[b],
                                         a, f_ext, k == 0);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    ++*launches;
    if (err) return err;
    if (s->strain) {
      const EulerStrainEpilogue epi{x_out, s->x[0], s->v[b], s->inv_mass,
                                    s->col, ps,       s->p};
      err = launch_strain_sweeps(s->sweeps, x_out, nullptr, s->alive[b],
                                 s->scale[b], epi, s->stream);
      ++*launches;
      if (err) return err;
    }
  }
  if (finish && s->feat && n > 0) {
    const int a = (k0 + n) % 2;
    const float* x = s->strain ? s->x[0] : s->x[a];
    ++*launches;
    return launch_feature_finish(x, s->alive[a], s->alive[1 - a],
                                 s->scale[a], s->scale[1 - a], s->offsets,
                                 s->tear_limits, s->n_off, s->ny, s->nx,
                                 s->fp, s->stream);
  }
  return 0;
}

// Launch one substep's strain-limit sweeps alone (one cooperative launch)
// on `stream`, with the Euler epilogue and the contact off: x0 is where the
// sweeps start, x_out receives x0 + dxl, v takes dxl / dt in place (dt =
// 1, restitution 0, keep 1 run no contact).  Returns the cudaError_t of the
// launch.  Allocates nothing and does not synchronise.
extern "C" int grid_euler_strain(const StrainSweeps* s, const float* alive,
                                 const float* scale, const float* x0,
                                 float* x_out, float* v, void* stream) {
  const Params p{1.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 1.0f, 1.0f};
  const EulerStrainEpilogue epi{x0,         x_out, v, s->inv_mass,
                                kNoContact, s->ny * s->nx, p};
  return launch_strain_sweeps(*s, x0, nullptr, alive, scale, epi, stream);
}

// Launch the frame-end feature update over the final positions x
// (grid_common.cuh::grid_feature_finish_kernel); returns the cudaError_t.
extern "C" int grid_euler_features(
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

extern "C" const char* grid_euler_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
