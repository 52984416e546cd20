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
// one launch per sweep, its last running this solver's epilogue).  An
// optional external force plane (the self-collision repulsion,
// block_pairs.cu) is added to the spring forces, where the JAX package's
// general path adds self_collision_force (solver/step.py::total_forces);
// the TPU routes such scenes off these kernels.
//
// Design.  The TPU's whole-VMEM kernel keeps the state in VMEM and runs
// every substep of a frame in one launch, which caps it at 128k vertices;
// past the cap its row-tiled kernel runs one substep per launch on row
// tiles with DMA'd 8-row halos.  An SM's 227 KB of shared memory cannot
// hold even the 64k-vertex state (x and v are 1.5 MB), but the 50 MB L2
// holds it from one launch to the next at 64k, and device memory at any
// size.  So here a substep is one launch with one thread per vertex,
// reading the (x, v) planes of one buffer and writing the other: ping-pong,
// because an in-place update would race with the neighbours' reads.  The
// host loops over substeps.  That is the row-tiled kernel's form without
// its tiles: the bounds checks below replace its halos and global-row
// masks, and no vertex cap applies.  What the row-tiled kernel computes
// beyond the whole-VMEM one is the launch-start form of the feature
// planes: a substep that is one launch with no grid-wide barrier cannot
// tear an edge from its neighbours' new positions, so each launch but a
// frame's first updates the planes from its INPUT positions (the previous
// substep's output) before it uses them, and the wrapper launches one
// frame-end update (grid_common.cuh::grid_feature_finish_kernel) after the
// last substep.  kFeat is that form here.  The strain limit needs a
// grid-wide barrier between its sweeps, so under it a substep is 1 +
// iterations launches: this kernel integrates with the contact left out,
// each sweep launch moves the positions, and the last sweep adds the change
// to the velocity and runs the contact (EulerStrainEpilogue below).
//
// Spring forces are a gather.  For each offset o a vertex adds the force of
// the edge it owns (to p + o) and subtracts the force of the edge owned by
// p - o, recomputed rather than scattered: no atomics, a deterministic sum,
// and both copies of an edge force come from one function
// (grid_common.cuh::edge_force, shared with grid_verlet.cu), so they are
// identical.  Under kFeat both threads of an edge also recompute its
// feature update from the same inputs (grid_common.cuh::edge_features), so
// they agree on whether it tore; each writes only the planes of the edges
// it owns.
//
// What bounds it.  Per vertex and substep a thread reads its own x and v
// (24 bytes), the same for 12 neighbours (nearly all hits in L1/L2), and
// writes 24 bytes: about 3 MB of device-memory traffic per substep at 64k
// vertices, around a microsecond at the card's 3.35 TB/s, and ~300 flops per
// vertex; the feature planes add 4 bytes in and out per offset and plane,
// the wind ~100 flops and no bytes (its normal reads the 1-ring the springs
// load), and each strain sweep reads and writes 12 bytes of positions.
// A launch costs several microseconds of host and device time, so at 64k
// vertices the kernel is bound by launch overhead and latency, not by
// bandwidth or arithmetic; at 262k and 1m vertices (12.6 MB of x, 50 MB
// for ping-pong x and v) it nears the bytes it must move.  Capturing a
// frame's launches in a CUDA graph, or a persistent kernel with a
// grid-wide barrier per substep, is the next step.
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

// One thread per vertex (i, j) of the [ny, nx] grid.  x, v, x_out and v_out
// are [3, ny, nx] component planes; offsets is [n_off, 4] rows of
// (di, dj, k, rest); col holds the collider rows (grid_common.cuh).
// kExt: f_ext, [3, ny, nx], is added to the spring forces; the
// instantiation without it is the kernel as it was before the plane
// existed.  kFeat: the tear and plastic planes, [n_off, ny, nx], are read from *_in (null: the feature is
// off), updated at the launch's start unless `first`, used by the springs
// and written to *_out; tear_limits[o] is rest * (1 + strain_limit).  kWind:
// the wind force, at x and v, is added after f_ext.
template <bool kExt, bool kFeat, bool kWind>
__global__ void __launch_bounds__(256) grid_euler_substep_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    float* __restrict__ x_out, float* __restrict__ v_out,
    const float* __restrict__ inv_mass, const float* __restrict__ offsets,
    int n_off, Colliders col, const float* __restrict__ f_ext, const float* __restrict__ alive_in,
    float* __restrict__ alive_out, const float* __restrict__ scale_in,
    float* __restrict__ scale_out, const float* __restrict__ tear_limits,
    int first, FeatParams fp, Wind wind, int ny, int nx, Params p) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  const int ps = ny * nx;
  const int idx = i * nx + j;
  const Vec3 xi = load3(x, idx, ps);
  const Vec3 vi = load3(v, idx, ps);

  float fx = 0.0f, fy = 0.0f, fz = 0.0f;
  for (int o = 0; o < n_off; ++o) {
    const int di = static_cast<int>(offsets[4 * o]);
    const int dj = static_cast<int>(offsets[4 * o + 1]);
    const float k = offsets[4 * o + 2];
    const float rest = offsets[4 * o + 3];
    // the edge this vertex owns, to (i + di, j + dj)
    int ii = i + di, jj = j + dj;
    if (ii >= 0 && ii < ny && jj >= 0 && jj < nx) {
      const int nb = ii * nx + jj;
      const Vec3 xn = load3(x, nb, ps);
      float a = 1.0f, s = 1.0f;
      if (kFeat) {
        edge_features(alive_in, scale_in, o * ps + idx, xi, xn, rest,
                      tear_limits[o], fp, first, a, s);
        if (alive_out) alive_out[o * ps + idx] = a;
        if (scale_out) scale_out[o * ps + idx] = s;
      }
      if (a != 0.0f) {
        const Vec3 e = edge_force(xi, vi, xn, load3(v, nb, ps), k,
                                  kFeat ? scaled_rest(rest, s, scale_in)
                                        : rest,
                                  p.damping);
        fx += e.x;
        fy += e.y;
        fz += e.z;
      }
    } else if (kFeat) {   // no edge here: the entry is carried, unread
      if (alive_out) alive_out[o * ps + idx] = alive_in[o * ps + idx];
      if (scale_out) scale_out[o * ps + idx] = scale_in[o * ps + idx];
    }
    // the reaction of the edge owned by (i - di, j - dj)
    ii = i - di;
    jj = j - dj;
    if (ii >= 0 && ii < ny && jj >= 0 && jj < nx) {
      const int nb = ii * nx + jj;
      const Vec3 xn = load3(x, nb, ps);
      float a = 1.0f, s = 1.0f;
      if (kFeat)
        edge_features(alive_in, scale_in, o * ps + nb, xn, xi, rest,
                      tear_limits[o], fp, first, a, s);
      if (a != 0.0f) {
        const Vec3 e = edge_force(xn, load3(v, nb, ps), xi, vi, k,
                                  kFeat ? scaled_rest(rest, s, scale_in)
                                        : rest,
                                  p.damping);
        fx -= e.x;
        fy -= e.y;
        fz -= e.z;
      }
    }
  }

  if (kExt) {   // springs + f_ext, as total_forces sums them
    fx += f_ext[idx];
    fy += f_ext[ps + idx];
    fz += f_ext[2 * ps + idx];
  }
  if (kWind) {  // + wind, as total_forces sums them
    const Vec3 fw = wind_force(x, i, j, ny, nx, ps, vi, wind);
    fx += fw.x;
    fy += fw.y;
    fz += fw.z;
  }

  const float im = inv_mass[idx];
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

// The last strain sweep's epilogue (stencil.py::euler_substep_grid): the
// change dxl = x_new - x0 from the integrated positions x0 goes into x and,
// over dt, into the integrated velocity v (in place: each thread touches
// its own vertex only), then the velocity-level contact of a movable
// vertex; x is written to x_out.
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

// Launch one substep on `stream`; returns the cudaError_t of the launch
// (0 = cudaSuccess).  f_ext may be null (no external force plane).  With
// feat = 0 the feature pointers are ignored; with feat = 1 a null pair
// (alive_* or scale_*) turns that feature off.  Allocates nothing and does
// not synchronise.
extern "C" int grid_euler_substep(
    const float* x, const float* v, float* x_out, float* v_out,
    const float* inv_mass, const float* offsets, int n_off, COLLIDER_PARAMS,
    const float* f_ext, int feat, const float* alive_in, float* alive_out,
    const float* scale_in, float* scale_out, const float* tear_limits,
    int first, float strain1, float yield_strain, float creep,
    float min_scale, float max_scale, int wind_on, float wvx, float wvy,
    float wvz, float drag, float lift, int ny, int nx, float dt,
    float damping, float gx, float gy, float gz, float decay,
    float restitution, float restitution1, float keep, void* stream) {
  const Params p{dt, damping, gx, gy, gz, decay, restitution, restitution1,
                 keep};
  const FeatParams fp{strain1, yield_strain, creep, min_scale, max_scale};
  const Wind wind{wvx, wvy, wvz, drag, lift};
  const dim3 block(32, 8);
  const dim3 grid((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Colliders col = COLLIDERS;
#define GRID_EULER_LAUNCH(EXT, FEAT, WIND)                                  \
  grid_euler_substep_kernel<EXT, FEAT, WIND><<<grid, block, 0, st>>>(       \
      x, v, x_out, v_out, inv_mass, offsets, n_off, col, f_ext, alive_in,   \
      alive_out, scale_in, scale_out, tear_limits, first, fp, wind, ny, nx, \
      p)
#define GRID_EULER_WIND(EXT, FEAT)          \
  do {                                      \
    if (wind_on)                            \
      GRID_EULER_LAUNCH(EXT, FEAT, true);   \
    else                                    \
      GRID_EULER_LAUNCH(EXT, FEAT, false);  \
  } while (0)
  if (f_ext && feat)
    GRID_EULER_WIND(true, true);
  else if (f_ext)
    GRID_EULER_WIND(true, false);
  else if (feat)
    GRID_EULER_WIND(false, true);
  else
    GRID_EULER_WIND(false, false);
#undef GRID_EULER_WIND
#undef GRID_EULER_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// Launch one strain-limit sweep (grid_common.cuh::grid_strain_sweep_kernel)
// on `stream`, and with last = 1 the Euler epilogue: x0 and v are the
// integrate launch's outputs, x_out receives the substep's positions (v is
// updated in place).  Returns the cudaError_t of the launch.  Allocates
// nothing and does not synchronise.
extern "C" int grid_euler_strain(
    const float* base, const float* add, float* xs_out,
    const float* inv_mass, const float* offsets, const float* limits,
    int n_off, const float* alive, const float* scale, float stretch1,
    float compress1, int compress_on, int project, int last, const float* x0,
    float* x_out, float* v, COLLIDER_PARAMS, int ny, int nx, float dt,
    float restitution, float restitution1, float keep, void* stream) {
  const Params p{dt,  0.0f,        0.0f,         0.0f, 0.0f,
                 1.0f, restitution, restitution1, keep};
  const EulerStrainEpilogue epi{x0, x_out, v, inv_mass, COLLIDERS, ny * nx,
                                p};
  return launch_strain_sweep(base, add, xs_out, inv_mass, offsets, limits,
                             n_off, alive, scale,
                             StrainParams{stretch1, compress1, compress_on},
                             project, last, ny, nx, epi, stream);
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
