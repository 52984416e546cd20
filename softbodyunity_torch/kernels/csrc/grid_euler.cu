// Fused semi-implicit Euler substep for structured grid cloth, for Hopper
// (sm_90a).  Built by softbodyunity_torch/kernels/build.py, wrapped by
// softbodyunity_torch/kernels/grid_euler.py; its plain PyTorch version is
// softbodyunity_torch/kernels/stencil.py::euler_substep_grid.
//
// Replaces the TPU kernel softbodyunity_tpu/kernels/pallas_substep.py
// ::_make_kernel, launched by ::_pallas_substeps through pl.pallas_call, for
// the branches the grid-cloth Euler path runs: the six-offset spring stencil
// (Hooke + axial damper), gravity, global damping and pinning, plane contact
// and sphere contact, with the colliders' kinematic velocities.  Its wind,
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
// and both copies of an edge force come from one function, so they are
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

namespace {

struct Vec3 {
  float x, y, z;
};

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

__device__ __forceinline__ Vec3 load3(const float* __restrict__ p, int idx,
                                      int plane) {
  return {p[idx], p[plane + idx], p[2 * plane + idx]};
}

// Hooke + axial damper force on endpoint a of the edge a -> b, toward b.
__device__ __forceinline__ Vec3 edge_force(Vec3 xa, Vec3 va, Vec3 xb,
                                           Vec3 vb, float k, float rest,
                                           float damping) {
  const float dx = xb.x - xa.x, dy = xb.y - xa.y, dz = xb.z - xa.z;
  const float len = sqrtf(dx * dx + dy * dy + dz * dz);
  const float inv_len = 1.0f / fmaxf(len, 1e-12f);
  const float nx = dx * inv_len, ny = dy * inv_len, nz = dz * inv_len;
  const float rel_v =
      (vb.x - va.x) * nx + (vb.y - va.y) * ny + (vb.z - va.z) * nz;
  const float fmag = k * (len - rest) + damping * rel_v;
  return {fmag * nx, fmag * ny, fmag * nz};
}

// One thread per vertex (i, j) of the [ny, nx] grid.  x, v, x_out and v_out
// are [3, ny, nx] component planes; offsets is [n_off, 4] rows of
// (di, dj, k, rest); plane is (height, surface velocity xyz); spheres is
// [n_spheres, 7] rows of (center xyz, radius, velocity xyz).
__global__ void __launch_bounds__(256) grid_euler_substep_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    float* __restrict__ x_out, float* __restrict__ v_out,
    const float* __restrict__ inv_mass, const float* __restrict__ offsets,
    int n_off, const float* __restrict__ plane, int plane_on,
    const float* __restrict__ spheres, int n_spheres, int ny, int nx,
    Params p) {
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

  const float im = inv_mass[idx];
  const bool movable = im > 0.0f;
  float vx = (vi.x + p.dt * (p.gx + fx * im)) * p.decay;
  float vy = (vi.y + p.dt * (p.gy + fy * im)) * p.decay;
  float vz = (vi.z + p.dt * (p.gz + fz * im)) * p.decay;
  if (!movable) vx = vy = vz = 0.0f;
  float px = xi.x + p.dt * vx;
  float py = xi.y + p.dt * vy;
  float pz = xi.z + p.dt * vz;

  if (plane_on && movable && py < plane[0]) {
    const float wx = plane[1], wy = plane[2], wz = plane[3];
    py = plane[0];
    const float uy = vy - wy;
    if (uy < 0.0f) vy = wy - p.restitution * uy;
    vx = wx + (vx - wx) * p.keep;
    vz = wz + (vz - wz) * p.keep;
  }

  for (int s = 0; s < n_spheres && movable; ++s) {
    const float* sp = spheres + 7 * s;
    const float dx = px - sp[0], dy = py - sp[1], dz = pz - sp[2];
    const float dist = sqrtf(dx * dx + dy * dy + dz * dz);
    const float pen = sp[3] - dist;
    if (!(pen > 0.0f)) continue;
    const float m = fmaxf(dist, 1e-12f);
    const float nx_ = dx / m, ny_ = dy / m, nz_ = dz / m;
    px += pen * nx_;
    py += pen * ny_;
    pz += pen * nz_;
    const float wx = sp[4], wy = sp[5], wz = sp[6];
    const float un = (vx - wx) * nx_ + (vy - wy) * ny_ + (vz - wz) * nz_;
    if (un < 0.0f) {
      const float r = p.restitution1 * un;
      vx -= r * nx_;
      vy -= r * ny_;
      vz -= r * nz_;
    }
    const float ux = vx - wx, uy = vy - wy, uz = vz - wz;
    const float un2 = ux * nx_ + uy * ny_ + uz * nz_;
    const float n2x = un2 * nx_, n2y = un2 * ny_, n2z = un2 * nz_;
    vx = wx + n2x + (ux - n2x) * p.keep;
    vy = wy + n2y + (uy - n2y) * p.keep;
    vz = wz + n2z + (uz - n2z) * p.keep;
  }

  x_out[idx] = px;
  x_out[ps + idx] = py;
  x_out[2 * ps + idx] = pz;
  v_out[idx] = vx;
  v_out[ps + idx] = vy;
  v_out[2 * ps + idx] = vz;
}

}  // namespace

// Launch one substep on `stream`; returns the cudaError_t of the launch
// (0 = cudaSuccess).  Allocates nothing and does not synchronise.
extern "C" int grid_euler_substep(
    const float* x, const float* v, float* x_out, float* v_out,
    const float* inv_mass, const float* offsets, int n_off,
    const float* plane, int plane_on, const float* spheres, int n_spheres,
    int ny, int nx, float dt, float damping, float gx, float gy, float gz,
    float decay, float restitution, float restitution1, float keep,
    void* stream) {
  const Params p{dt, damping, gx, gy, gz, decay, restitution, restitution1,
                 keep};
  const dim3 block(32, 8);
  const dim3 grid((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y);
  grid_euler_substep_kernel<<<grid, block, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      x, v, x_out, v_out, inv_mass, offsets, n_off, plane, plane_on, spheres,
      n_spheres, ny, nx, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* grid_euler_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
