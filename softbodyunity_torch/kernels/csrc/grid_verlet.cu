// Fused position-Verlet substep for structured grid cloth, for Hopper
// (sm_90a).  Built by softbodyunity_torch/kernels/build.py, wrapped by
// softbodyunity_torch/kernels/grid_verlet.py; its plain PyTorch version is
// softbodyunity_torch/kernels/stencil.py::verlet_substep_grid (with
// update_features, in the launch-start order of
// softbodyunity_torch/kernels/grid_features.py).
//
// Replaces two TPU kernels of softbodyunity_tpu/kernels/: the whole-VMEM
// pallas_substep.py::_make_verlet_kernel, launched by
// ::_pallas_verlet_substeps through pl.pallas_call, and the row-tiled
// pallas_tiled.py::_make_verlet_kernel, launched by
// ::_tiled_verlet_substeps (grids past the whole-VMEM cap).  It runs their
// branches of the grid-cloth Verlet path: the six-offset spring stencil on
// the velocity estimate (x - xp) / dt, the damped position update,
// pinning, position-only plane, sphere, capsule and oriented-box contact,
// their friction (grid_common.cuh::position_contact), the tear-liveness
// and plastic rest-scale planes (the kFeat instantiation, in the row-tiled
// kernel's launch-start form: see grid_euler.cu), the wind's drag and lift
// at the velocity estimate (the kWind instantiation), and the strain
// limit's sweeps, one cooperative launch a substep
// (grid_common.cuh::grid_strain_sweep_kernel, position only, the last
// sweep running the contact chain: VerletStrainEpilogue below), with an
// optional external force plane (the self-collision repulsion at x,
// block_pairs.cu) added to the spring forces as solver/step.py::
// verlet_integrate adds it.
//
// Design.  As grid_euler.cu: one launch per substep on CTAs that own a 32 x
// 8 tile of the grid, one thread a vertex, compiled for the offsets'
// pattern; the state in L2 or device memory between launches, no vertex
// cap, the feature planes updated at each launch's start from its input
// positions (the frame's first launch excepted) and once more at the
// frame's end; one C call (grid_verlet_substeps) runs a frame's substeps
// from a struct built once a call (GridVerletFrame), one call a substep
// with self-collision.  The tile stages x and the velocity estimate of the
// tile and its frame in shared memory (grid_common.cuh::stage_frame under
// kVerlet: the divide once a vertex, by the thread that stages it, the
// same IEEE divide of the same operands as a per-edge estimate), evaluates
// each spring with an endpoint in the tile once (tile_spring_terms), and
// each vertex sums + fmag n of the edge it owns and - fmag n of the edge
// owned by p - o, per offset in table order (tile_spring_force): the
// products and the order of the one-pass kernel this replaced, which
// evaluated each edge at both ends and each neighbour's estimate per edge,
// so x and x_prev are that kernel's to the bit.  f_ext and the wind stay
// per vertex (the wind's normal reads the 1-ring from the frame), and so do
// the damped update, pinning and the contact chain.  The damper reads each
// neighbour's velocity estimate, so a neighbour's xp is read while the
// owner writes its new position: writing the new x over xp would race.
// The frame therefore rotates three buffers, (x, xp, out) <- (out, x, xp)
// after each substep; under the strain limit the integrate launch writes
// out with the contact left out, and the last sweep writes the substep's
// end over xp, so (x, xp) <- (xp, x) and out stays.  No wide form: no main
// path runs plain Verlet on more tiles than the card holds CTAs at once
// (grid_euler.cu's grid_euler_wide_kernel is the candidate should one).
//
// What bounds it.  Per vertex and substep it reads x, xp and inv_mass and
// writes x: 40 bytes, 2.6 MB at 64k vertices, ~0.8 us at 3.35 TB/s, and
// ~300 flops; the feature planes add 4 bytes in and out per offset and
// plane.  As with the Euler kernel, at 64k a launch holds two CTAs an SM
// and is bound by its latency (staging, one sqrtf and IEEE divide an edge
// and three divides a frame vertex, two barriers), not bandwidth.
//
// Rounding.  sqrtf and IEEE divides (the velocity estimate is a divide by
// dt) in the plain version's order; FMA contraction makes the agreement one
// of rounding, except in the feature update, rounded as the plain version
// rounds it.  Pinned vertices keep x bit for bit.

#include <cuda_runtime.h>

#include "grid_common.cuh"

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
};

// One substep on a CTA that owns a kTileX x kTileY tile of the [ny, nx]
// grid, one thread a vertex, compiled for the offsets' pattern P.  x, xp
// and out are [3, ny, nx] planes; offsets is [n_off, 4] rows of (di, dj,
// k, rest), di and dj those of P; col holds the collider rows
// (grid_common.cuh; its friction flags are 0 when friction is 0 or the
// collider is off).  kExt: f_ext, [3, ny, nx], is added to the spring
// forces; the instantiation without it is the kernel as it was before the
// plane existed.  kFeat: the tear and plastic planes, as grid_euler.cu's.
// kWind: the wind force at x and the velocity estimate, added after f_ext.
template <int P, bool kExt, bool kFeat, bool kWind>
__global__ void __launch_bounds__(kTileX * kTileY) grid_verlet_substep_kernel(
    const float* __restrict__ x, const float* __restrict__ xp,
    float* __restrict__ out, const float* __restrict__ inv_mass,
    const float* __restrict__ offsets, Colliders col,
    const float* __restrict__ f_ext, const float* __restrict__ alive_in,
    float* __restrict__ alive_out, const float* __restrict__ scale_in,
    float* __restrict__ scale_out, const float* __restrict__ tear_limits,
    int first, FeatParams fp, Wind wind, int ny, int nx, Params p) {
  using T = Tile<P>;
  __shared__ float4 sx[T::FH * T::FW];   // x of the tile and its frame
  __shared__ float4 sv[T::FH * T::FW];   // the velocity estimate
  __shared__ float4 terms[T::B(Offsets<P>::n)];   // (fmag, n) of each edge
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i0 = blockIdx.y * T::TY, j0 = blockIdx.x * T::TX;
  const int ps = ny * nx;
  stage_frame<T, true>(x, xp, p.dt, sx, sv, i0, j0, ny, nx);
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

  const float im = inv_mass[idx];
  if (!(im > 0.0f)) {          // pinned: x stays, bit for bit
    store3(out, idx, ps, xi);
    return;
  }
  const Vec3 pi = load3(xp, idx, ps);
  const float ax = p.gx + fx * im, ay = p.gy + fy * im, az = p.gz + fz * im;
  Vec3 xnew = {xi.x + (xi.x - pi.x) * p.decay + ax * p.dt * p.dt,
               xi.y + (xi.y - pi.y) * p.decay + ay * p.dt * p.dt,
               xi.z + (xi.z - pi.z) * p.decay + az * p.dt * p.dt};
  store3(out, idx, ps,
         position_contact(xnew, xi, col, p.mu, p.keep, p.dt, p.shell));
}

// The last strain sweep's epilogue (stencil.py::verlet_substep_grid): the
// change x_new - x0 from the integrated positions x0 goes into x, then a
// movable vertex takes the position-level contact and friction against the
// substep's start x_start; x is written to out.
struct VerletStrainEpilogue {
  const float* x0;
  const float* x_start;
  float* out;
  const float* inv_mass;
  Colliders col;
  int ps;
  Params p;

  __device__ void operator()(int idx, Vec3 xn) const {
    const Vec3 a = load3(x0, idx, ps);
    const Vec3 d = sub3(xn, a);
    Vec3 x = {a.x + d.x, a.y + d.y, a.z + d.z};
    if (inv_mass[idx] > 0.0f)
      x = position_contact(x, load3(x_start, idx, ps), col, p.mu, p.keep,
                           p.dt, p.shell);
    store3(out, idx, ps, x);
  }
};

}  // namespace

// What a frame launches with, fixed over a call of the step function:
// softbodyunity_torch/kernels/grid_verlet.py::_Frame mirrors it field by
// field (grid_verlet_frame_size checks the two agree).
struct GridVerletFrame {
  float* x[3];                // [3, ny, nx] the rotating buffers: substep k
                              // reads x and xp and writes out, in the
                              // buffers that verlet_buffers names
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

extern "C" int grid_verlet_frame_size() {
  return static_cast<int>(sizeof(GridVerletFrame));
}

extern "C" int grid_verlet_strain_size() {
  return static_cast<int>(sizeof(StrainSweeps));
}

namespace {

// The buffers (x, xp, out) of substep k (grid_verlet.py::buffers): without
// the strain limit the rotation (x, xp, out) <- (out, x, xp) has period 3,
// (r, r + 1, r + 2) mod 3 with r = -k mod 3; under it (x, xp) <- (xp, x),
// (k mod 2, 1 - k mod 2, 2).
struct Buffers {
  int x, xp, out;
};

Buffers verlet_buffers(int k, int strain) {
  if (strain) return {k % 2, 1 - k % 2, 2};
  const int r = (3 - k % 3) % 3;
  return {r, (r + 1) % 3, (r + 2) % 3};
}

// One substep launch on pattern P from (x, xp) into out, the feature
// planes from buffer a into the other; returns the launch's cudaError_t.
template <int P>
int launch_substep(const GridVerletFrame* s, cudaStream_t st, const float* x,
                   const float* xp, float* out, int a, const float* f_ext,
                   int first) {
  const dim3 block(kTileX, kTileY);
  const dim3 grid((s->nx + kTileX - 1) / kTileX,
                  (s->ny + kTileY - 1) / kTileY);
  const Colliders col = s->strain ? kNoContact : s->col;
  const float* alive_in = s->alive[a];
  float* alive_out = s->alive[1 - a];
  const float* scale_in = s->scale[a];
  float* scale_out = s->scale[1 - a];
#define GRID_VERLET_LAUNCH(EXT, FEAT, WIND)                                  \
  grid_verlet_substep_kernel<P, EXT, FEAT, WIND><<<grid, block, 0, st>>>(    \
      x, xp, out, s->inv_mass, s->offsets, col, f_ext, alive_in, alive_out,  \
      scale_in, scale_out, s->tear_limits, first, s->fp, s->wind, s->ny,     \
      s->nx, s->p)
#define GRID_VERLET_WIND(EXT, FEAT)          \
  do {                                       \
    if (s->wind_on)                          \
      GRID_VERLET_LAUNCH(EXT, FEAT, true);   \
    else                                     \
      GRID_VERLET_LAUNCH(EXT, FEAT, false);  \
  } while (0)
  if (f_ext && s->feat)
    GRID_VERLET_WIND(true, true);
  else if (f_ext)
    GRID_VERLET_WIND(true, false);
  else if (s->feat)
    GRID_VERLET_WIND(false, true);
  else
    GRID_VERLET_WIND(false, false);
#undef GRID_VERLET_WIND
#undef GRID_VERLET_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Run substeps k0 .. k0 + n - 1 of a frame on s->stream.  Substep k reads
// buffers x and xp of verlet_buffers(k) and writes out, with buffer k % 2
// of the feature planes in and the other out; under the strain limit out
// holds the integrated positions, with the contact left out, and the
// strain launch (its sweeps from out, against the substep's start x)
// writes the substep's end over xp.  The feature update at a launch's
// start is skipped for substep 0, the frame's first.  With `finish` and
// features, the frame-end update follows, over the final x, from buffer
// (k0 + n) % 2 of the planes into the other.  f_ext (the self-collision
// force plane, or null) enters every substep run: the caller that has one
// runs one substep a call.  *launches counts the kernels launched; returns
// the first launch's cudaError_t that is not cudaSuccess, after which it
// launches nothing more.  Allocates nothing and does not synchronise.
extern "C" int grid_verlet_substeps(const GridVerletFrame* s, int k0, int n,
                                    int finish, const float* f_ext,
                                    int* launches) {
  const cudaStream_t st = static_cast<cudaStream_t>(s->stream);
  const int ps = s->ny * s->nx;
  *launches = 0;
  for (int k = k0; k < k0 + n; ++k) {
    const Buffers b = verlet_buffers(k, s->strain);
    const float* x = s->x[b.x];
    const float* xp = s->x[b.xp];
    float* out = s->x[b.out];
    const int a = k % 2;
    int err;
    switch (s->pattern) {
      case kStructural:
        err = launch_substep<kStructural>(s, st, x, xp, out, a, f_ext,
                                          k == 0);
        break;
      case kShear:
        err = launch_substep<kShear>(s, st, x, xp, out, a, f_ext, k == 0);
        break;
      case kBend:
        err = launch_substep<kBend>(s, st, x, xp, out, a, f_ext, k == 0);
        break;
      case kShearBend:
        err = launch_substep<kShearBend>(s, st, x, xp, out, a, f_ext,
                                         k == 0);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    ++*launches;
    if (err) return err;
    if (s->strain) {
      const VerletStrainEpilogue epi{out,    x,  s->x[b.xp], s->inv_mass,
                                     s->col, ps, s->p};
      err = launch_strain_sweeps(s->sweeps, out, nullptr, s->alive[1 - a],
                                 s->scale[1 - a], epi, s->stream);
      ++*launches;
      if (err) return err;
    }
  }
  if (finish && s->feat && n > 0) {
    const int a = (k0 + n) % 2;
    ++*launches;
    return launch_feature_finish(
        s->x[verlet_buffers(k0 + n, s->strain).x], s->alive[a],
        s->alive[1 - a], s->scale[a], s->scale[1 - a], s->offsets,
        s->tear_limits, s->n_off, s->ny, s->nx, s->fp, s->stream);
  }
  return 0;
}

// Launch the frame-end feature update over the final positions x
// (grid_common.cuh::grid_feature_finish_kernel); returns the cudaError_t.
extern "C" int grid_verlet_features(
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

extern "C" const char* grid_verlet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
