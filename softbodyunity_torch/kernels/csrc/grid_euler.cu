// Fused semi-implicit Euler substep for structured grid cloth, for Hopper
// (sm_90a).  Built by softbodyunity_torch/kernels/build.py, wrapped by
// softbodyunity_torch/kernels/grid_euler.py; its plain PyTorch version is
// softbodyunity_torch/kernels/stencil.py::euler_substep_grid.
//
// Replaces the TPU kernel softbodyunity_tpu/kernels/pallas_substep.py
// ::_make_kernel, launched by ::_pallas_substeps through pl.pallas_call, for
// the branches the grid-cloth Euler path runs: the six-offset spring stencil
// (Hooke + axial damper), gravity, global damping and pinning, plane contact
// and sphere contact, with the colliders' kinematic velocities.  An optional
// external force plane (the self-collision repulsion, block_pairs.cu) is
// added to the spring forces, where the JAX package's general path adds
// self_collision_force (solver/step.py::total_forces); the TPU routes such
// scenes off this kernel.  Its wind,
// strain-limit, capsule/box, plastic and tear branches are not ported yet;
// the wrapper refuses configs that enable them.
//
// Design.  The TPU kernel keeps the whole state in VMEM and runs every
// substep of a frame in one launch, which caps it at 128k vertices.  An SM's
// 227 KB of shared memory cannot hold the 64k-vertex state (x and v are
// 1.5 MB), but the 50 MB L2 holds it from one launch to the next.  So here a
// substep is one launch with one thread per vertex, reading the (x, v) planes
// of one buffer and writing the other: ping-pong, because an in-place update
// would race with the neighbours' reads.  The host loops over substeps.  The
// design needs no vertex cap and no row-tiled variant.
//
// Spring forces are a gather.  For each offset o a vertex adds the force of
// the edge it owns (to p + o) and subtracts the force of the edge owned by
// p - o, recomputed rather than scattered: no atomics, a deterministic sum,
// and both copies of an edge force come from one function
// (grid_common.cuh::edge_force, shared with grid_verlet.cu), so they are
// identical.  Grid bounds checks replace the TPU kernel's wrap-around roll
// and edge-ownership masks.
//
// What bounds it.  Per vertex and substep a thread reads its own x and v
// (24 bytes), the same for 12 neighbours (nearly all hits in L1/L2), and
// writes 24 bytes: about 3 MB of device-memory traffic per substep at 64k
// vertices, around a microsecond at the card's 3.35 TB/s, and ~300 flops per
// vertex.  A launch costs several microseconds of host and device time, so at
// 64k vertices the kernel is bound by launch overhead and latency, not by
// bandwidth or arithmetic.  Capturing a frame's launches in a CUDA graph, or
// a persistent kernel with a grid-wide barrier per substep, is the next step.
//
// Rounding.  sqrtf and IEEE divides, in the plain version's order.  nvcc
// contracts a * b + c into FMAs where torch rounds twice, so kernel and plain
// version agree to rounding, not to the bit.  Pinned vertices stay
// bit-frozen: their velocity is zeroed and x + dt * 0 == x.

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
// (di, dj, k, rest); plane is (height, surface velocity xyz); spheres is
// [n_spheres, 7] rows of (center xyz, radius, velocity xyz).  kExt: f_ext,
// [3, ny, nx], is added to the spring forces; the instantiation without it
// is the kernel as it was before the plane existed.
template <bool kExt>
__global__ void __launch_bounds__(256) grid_euler_substep_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    float* __restrict__ x_out, float* __restrict__ v_out,
    const float* __restrict__ inv_mass, const float* __restrict__ offsets,
    int n_off, const float* __restrict__ plane, int plane_on,
    const float* __restrict__ spheres, int n_spheres,
    const float* __restrict__ f_ext, int ny, int nx, Params p) {
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
      const Vec3 e = edge_force(xi, vi, load3(x, nb, ps), load3(v, nb, ps),
                                k, rest, p.damping);
      fx += e.x;
      fy += e.y;
      fz += e.z;
    }
    // the reaction of the edge owned by (i - di, j - dj)
    ii = i - di;
    jj = j - dj;
    if (ii >= 0 && ii < ny && jj >= 0 && jj < nx) {
      const int nb = ii * nx + jj;
      const Vec3 e = edge_force(load3(x, nb, ps), load3(v, nb, ps), xi, vi,
                                k, rest, p.damping);
      fx -= e.x;
      fy -= e.y;
      fz -= e.z;
    }
  }

  if (kExt) {   // springs + f_ext, as total_forces sums them
    fx += f_ext[idx];
    fy += f_ext[ps + idx];
    fz += f_ext[2 * ps + idx];
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
    resolve_velocity_contact(px, py, pz, vx, vy, vz, plane, plane_on, spheres,
                             n_spheres, p.restitution, p.restitution1, p.keep);

  x_out[idx] = px;
  x_out[ps + idx] = py;
  x_out[2 * ps + idx] = pz;
  v_out[idx] = vx;
  v_out[ps + idx] = vy;
  v_out[2 * ps + idx] = vz;
}

}  // namespace

// Launch one substep on `stream`; returns the cudaError_t of the launch
// (0 = cudaSuccess).  f_ext may be null (no external force plane).
// Allocates nothing and does not synchronise.
extern "C" int grid_euler_substep(
    const float* x, const float* v, float* x_out, float* v_out,
    const float* inv_mass, const float* offsets, int n_off,
    const float* plane, int plane_on, const float* spheres, int n_spheres,
    const float* f_ext, int ny, int nx, float dt, float damping, float gx,
    float gy, float gz, float decay, float restitution, float restitution1,
    float keep, void* stream) {
  const Params p{dt, damping, gx, gy, gz, decay, restitution, restitution1,
                 keep};
  const dim3 block(32, 8);
  const dim3 grid((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f_ext)
    grid_euler_substep_kernel<true><<<grid, block, 0, st>>>(
        x, v, x_out, v_out, inv_mass, offsets, n_off, plane, plane_on,
        spheres, n_spheres, f_ext, ny, nx, p);
  else
    grid_euler_substep_kernel<false><<<grid, block, 0, st>>>(
        x, v, x_out, v_out, inv_mass, offsets, n_off, plane, plane_on,
        spheres, n_spheres, f_ext, ny, nx, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* grid_euler_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
