// Device helpers shared by the substep kernels: the grid-cloth kernels
// (grid_euler.cu, grid_verlet.cu, grid_xpbd.cu), one thread per vertex of a
// [ny, nx] grid whose state lies in [3, ny, nx] component planes, and the
// tet-lattice kernels (lattice_*.cu, through lattice_common.cuh), one thread
// per vertex of [3, N] planes.  Every helper reads or writes one vertex.
// Two kernels live here, each instantiated by every grid library: the
// frame-end feature update and the strain limit's sweep.
//
// Rounding: sqrtf and IEEE divides in the order of the plain PyTorch
// versions (softbodyunity_torch/kernels/stencil.py,
// softbodyunity_torch/solver/collide.py); nvcc contracts a * b + c into FMAs,
// so the kernels agree with them to rounding.

#pragma once

#include <cuda_runtime.h>

namespace {

struct Vec3 {
  float x, y, z;
};

__device__ __forceinline__ Vec3 load3(const float* __restrict__ p, int idx,
                                      int plane) {
  return {p[idx], p[plane + idx], p[2 * plane + idx]};
}

__device__ __forceinline__ void store3(float* __restrict__ p, int idx,
                                       int plane, Vec3 v) {
  p[idx] = v.x;
  p[plane + idx] = v.y;
  p[2 * plane + idx] = v.z;
}

__device__ __forceinline__ float dot3(Vec3 a, Vec3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// Hooke + axial damper force on endpoint a of the edge a -> b, toward b
// (stencil.py::stencil_spring_forces: multiply by 1 / max(len, 1e-12)).
// Both the owner's force and the recomputed reaction come from here, so the
// two copies of an edge force are identical.
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

// Velocity-level contact of a movable vertex at position p with velocity v
// (the Euler solver; collide.py::resolve_velocity_level): clamp onto the
// plane (plane[0] is its height, plane[1..3] its surface velocity), bounce
// the normal velocity relative to the surface by restitution and keep
// `keep` = 1 - friction of the tangential part; then each sphere in turn:
// push out, bounce by restitution1 = 1 + restitution, damp the tangential
// part.
__device__ __forceinline__ void resolve_velocity_contact(
    float& px, float& py, float& pz, float& vx, float& vy, float& vz,
    const float* __restrict__ plane, int plane_on,
    const float* __restrict__ spheres, int n_spheres, float restitution,
    float restitution1, float keep) {
  if (plane_on && py < plane[0]) {
    const float wx = plane[1], wy = plane[2], wz = plane[3];
    py = plane[0];
    const float uy = vy - wy;
    if (uy < 0.0f) vy = wy - restitution * uy;
    vx = wx + (vx - wx) * keep;
    vz = wz + (vz - wz) * keep;
  }

  for (int s = 0; s < n_spheres; ++s) {
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
      const float r = restitution1 * un;
      vx -= r * nx_;
      vy -= r * ny_;
      vz -= r * nz_;
    }
    const float ux = vx - wx, uy = vy - wy, uz = vz - wz;
    const float un2 = ux * nx_ + uy * ny_ + uz * nz_;
    const float n2x = un2 * nx_, n2y = un2 * ny_, n2z = un2 * nz_;
    vx = wx + n2x + (ux - n2x) * keep;
    vy = wy + n2y + (uy - n2y) * keep;
    vz = wz + n2z + (uz - n2z) * keep;
  }
}

// Position-only sphere push-out of a movable vertex, sphere by sphere
// (stencil.py::_push_out_spheres).  spheres is [n, 7] rows of
// (center xyz, radius, velocity xyz).
__device__ __forceinline__ Vec3 push_out_spheres(Vec3 x,
                                                 const float* __restrict__ spheres,
                                                 int n_spheres) {
  for (int s = 0; s < n_spheres; ++s) {
    const float* sp = spheres + 7 * s;
    const Vec3 d = {x.x - sp[0], x.y - sp[1], x.z - sp[2]};
    const float dist = sqrtf(dot3(d, d));
    const float pen = sp[3] - dist;
    if (!(pen > 0.0f)) continue;
    const float m = fmaxf(dist, 1e-12f);
    x.x += pen * (d.x / m);
    x.y += pen * (d.y / m);
    x.z += pen * (d.z / m);
  }
  return x;
}

// Position-only contact of a movable vertex (stencil.py::
// _project_positions_grid): clamp to the plane (plane[0] is its height),
// then push out of the spheres.  Returns whether the plane clamp fired, the
// pre-clamp contact that the plane friction reads.
__device__ __forceinline__ bool project_plane_spheres(
    Vec3& x, const float* __restrict__ plane, int plane_on,
    const float* __restrict__ spheres, int n_spheres) {
  const bool contact = plane_on && x.y < plane[0];
  if (contact) x.y = plane[0];
  x = push_out_spheres(x, spheres, n_spheres);
  return contact;
}

// Sphere friction of a movable vertex that ends the substep at x, having
// started it at x0 (stencil.py::_sphere_friction_grid): within each
// sphere's contact shell radius * shell, the tangential part of the
// displacement relative to the sphere's velocity is damped by (1 - mu).
__device__ __forceinline__ Vec3 sphere_friction(Vec3 x, Vec3 x0,
                                                const float* __restrict__ spheres,
                                                int n_spheres, float mu,
                                                float dt, float shell) {
  for (int s = 0; s < n_spheres; ++s) {
    const float* sp = spheres + 7 * s;
    const Vec3 d = {x.x - sp[0], x.y - sp[1], x.z - sp[2]};
    const float dist = sqrtf(dot3(d, d));
    if (!(dist <= sp[3] * shell)) continue;
    const float m = fmaxf(dist, 1e-12f);
    const Vec3 n = {d.x / m, d.y / m, d.z / m};
    const Vec3 rel = {(x.x - x0.x) - sp[4] * dt, (x.y - x0.y) - sp[5] * dt,
                      (x.z - x0.z) - sp[6] * dt};
    const float rn = dot3(rel, n);
    x.x = x.x - mu * (rel.x - rn * n.x);
    x.y = x.y - mu * (rel.y - rn * n.y);
    x.z = x.z - mu * (rel.z - rn * n.z);
  }
  return x;
}

// Verlet velocity estimate (x - xp) / dt, a divide as in the plain versions.
__device__ __forceinline__ Vec3 velocity_estimate(Vec3 x, Vec3 xp, float dt) {
  return {(x.x - xp.x) / dt, (x.y - xp.y) / dt, (x.z - xp.z) / dt};
}

// Lambda change of the XPBD distance constraint on the edge a -> b with the
// compliance term at = alpha / dt^2; n is the unit direction a -> b
// (stencil.py::xpbd_substep_grid, banded.py::xpbd_iteration_banded:
// divide-form norm).
__device__ __forceinline__ float xpbd_dlam(Vec3 xa, Vec3 xb, float wa,
                                           float wb, float at, float rest,
                                           float lam, Vec3& n) {
  const Vec3 d = {xb.x - xa.x, xb.y - xa.y, xb.z - xa.z};
  const float len = sqrtf(dot3(d, d));
  const float m = fmaxf(len, 1e-12f);
  n = {d.x / m, d.y / m, d.z / m};
  const float c = len - rest;
  const float denom = fmaxf(wa + wb + at, 1e-12f);
  return -(c + at * lam) / denom;
}

// XPBD evaluation point xp + delta of vertex idx (never stored).
__device__ __forceinline__ Vec3 eval_point(const float* __restrict__ xp,
                                           const float* __restrict__ delta,
                                           int idx, int ps) {
  const Vec3 a = load3(xp, idx, ps), b = load3(delta, idx, ps);
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}

// --- tearing and plasticity: the per-edge feature update -------------------
//
// Tear liveness and plastic rest scales live in [n_off, ny, nx] planes, the
// entry of edge (p -> p + o) at its owner p.  A kernel updates them at the
// start of every launch but a frame's first, from its input positions
// (softbodyunity_torch/kernels/grid_features.py), and the thread of the
// owner and the thread that takes the edge's reaction each recompute the
// update.  Both must decide alike, or one side of an edge tears and the
// other does not: so both call edge_feature_update on the same inputs in
// the same argument order, and every operation of it is rounded as the
// plain version rounds it (kernels/stencil.py::update_features): no FMA
// contraction (the _rn intrinsics), IEEE sqrtf and division.  One update
// from identical positions then gives masks and scales bit-equal to the
// plain version's.

// Scalars of the feature updates, from SimConfig, rounded once to float.
struct FeatParams {
  float strain1;        // 1 + tear.strain_limit
  float yield_strain;   // plasticity
  float creep;
  float min_scale;
  float max_scale;
};

// |b - a|, with |d|^2 summed (d0^2 + d1^2) + d2^2 as the plain version sums
// it (stencil.py::_edge_lengths).
__device__ __forceinline__ float edge_length_rn(Vec3 a, Vec3 b) {
  const float dx = b.x - a.x, dy = b.y - a.y, dz = b.z - a.z;
  return sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                         __fmul_rn(dz, dz)));
}

// Plastic flow of one edge's rest scale (stencil.py::plastic_update_grid):
// past the yield strain the scale creeps toward the deformed length, then
// is clipped to [min_scale, max_scale].
__device__ __forceinline__ float plastic_flow(float len, float rest,
                                              float scale,
                                              const FeatParams& f) {
  const float rest_eff = fmaxf(__fmul_rn(rest, scale), 1e-12f);
  const float strain = __fdiv_rn(__fsub_rn(len, rest_eff), rest_eff);
  const float sgn = strain > 0.0f ? 1.0f : (strain < 0.0f ? -1.0f : 0.0f);
  const float excess =
      __fmul_rn(sgn, fmaxf(__fsub_rn(fabsf(strain), f.yield_strain), 0.0f));
  const float s = __fmul_rn(scale, __fadd_rn(1.0f, __fmul_rn(f.creep, excess)));
  return fminf(fmaxf(s, f.min_scale), f.max_scale);
}

// The feature update of the edge from xa (its owner) to xb
// (stencil.py::update_features): plastic flow first (scale != nullptr
// means plasticity is on), then the tear check against the flowed rest
// (alive != nullptr means tearing is on).  The tear threshold is
// tear_limit = rest * (1 + strain_limit), rounded once from double, without
// plasticity, else (rest * scale) * (1 + strain_limit) in float.  An edge
// past it dies for good: alive * 0.
__device__ __forceinline__ void edge_feature_update(
    Vec3 xa, Vec3 xb, float rest, float tear_limit, const FeatParams& f,
    float* alive, float* scale) {
  const float len = edge_length_rn(xa, xb);
  if (scale) *scale = plastic_flow(len, rest, *scale, f);
  if (alive) {
    const float limit =
        scale ? __fmul_rn(__fmul_rn(rest, *scale), f.strain1) : tear_limit;
    if (!(len <= limit)) *alive = 0.0f;
  }
}

// The feature planes of the edge owned by vertex `own` at offset o, to
// vertex `nb`: read the old values (1 for a feature that is off), update
// them from positions xa (own) and xb (nb) unless `first`, and return them.
// alive_in/scale_in are null for a feature that is off.
__device__ __forceinline__ void edge_features(
    const float* __restrict__ alive_in, const float* __restrict__ scale_in,
    int plane_idx, Vec3 xa, Vec3 xb, float rest, float tear_limit,
    const FeatParams& f, int first, float& alive, float& scale) {
  alive = alive_in ? alive_in[plane_idx] : 1.0f;
  scale = scale_in ? scale_in[plane_idx] : 1.0f;
  if (!first)
    edge_feature_update(xa, xb, rest, tear_limit, f,
                        alive_in ? &alive : nullptr,
                        scale_in ? &scale : nullptr);
}

// The rest length an edge's force or constraint uses: rest * scale under
// plasticity, rounded apart so that nvcc cannot fuse it into the length
// difference (the plain version rounds it, then subtracts).
__device__ __forceinline__ float scaled_rest(float rest, float scale,
                                             const float* scale_in) {
  return scale_in ? __fmul_rn(rest, scale) : rest;
}

// The frame-end update (grid_features.py::FeaturePlanes.finish): one
// thread per vertex updates the n_off edges it owns from the final
// positions x, reading *_in and writing *_out (either pair may be null:
// that feature is off).  A vertex whose neighbour at offset o lies outside
// the grid owns no edge there and copies its entry, which nothing reads.
// table rows are (di, dj, _, rest); tear_limits[o] is offset o's
// rest * (1 + strain_limit).
__global__ void __launch_bounds__(256) grid_feature_finish_kernel(
    const float* __restrict__ x, const float* __restrict__ alive_in,
    float* __restrict__ alive_out, const float* __restrict__ scale_in,
    float* __restrict__ scale_out, const float* __restrict__ table,
    const float* __restrict__ tear_limits, int n_off, int ny, int nx,
    FeatParams f) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  const int ps = ny * nx;
  const int idx = i * nx + j;
  const Vec3 xi = load3(x, idx, ps);
  for (int o = 0; o < n_off; ++o) {
    const int ii = i + static_cast<int>(table[4 * o]);
    const int jj = j + static_cast<int>(table[4 * o + 1]);
    const int q = o * ps + idx;
    float a = alive_in ? alive_in[q] : 1.0f;
    float s = scale_in ? scale_in[q] : 1.0f;
    if (ii >= 0 && ii < ny && jj >= 0 && jj < nx)
      edge_features(alive_in, scale_in, q, xi, load3(x, ii * nx + jj, ps),
                    table[4 * o + 3], tear_limits[o], f, 0, a, s);
    if (alive_out) alive_out[q] = a;
    if (scale_out) scale_out[q] = s;
  }
}

// --- wind: drag, and lift along the grid's vertex normals ------------------
//
// The WindParams force at one vertex (stencil.py::wind_forces_grid): with
// r = velocity - v, f = drag r, plus lift (r . n) n when lift is on, n the
// unit area-weighted vertex normal of the grid's triangles
// (stencil.py::grid_vertex_normals).  The normal reads the vertex's 1-ring,
// (i +- 1, j), (i, j +- 1), (i + 1, j - 1) and (i - 1, j + 1), which the
// spring stencil's structural and shear offsets load already: no new
// device-memory traffic.

// Scalars of the wind, rounded once to float.
struct Wind {
  float vx, vy, vz;   // wind velocity
  float drag;
  float lift;
};

__device__ __forceinline__ Vec3 sub3(Vec3 a, Vec3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}

__device__ __forceinline__ Vec3 cross3(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

// The face normals (unnormalised) of grid cell (a, b): f1 of the triangle
// (p(a,b), p(a+1,b), p(a,b+1)), f2 of (p(a,b+1), p(a+1,b), p(a+1,b+1)).  A
// cell outside [0, ny - 1) x [0, nx - 1) has none: zero, as the plain
// version's masked face planes are.
__device__ __forceinline__ Vec3 face1(const float* __restrict__ x, int a,
                                      int b, int ny, int nx, int ps) {
  if (a < 0 || b < 0 || a + 1 >= ny || b + 1 >= nx) return {0.0f, 0.0f, 0.0f};
  const Vec3 p = load3(x, a * nx + b, ps);
  return cross3(sub3(load3(x, (a + 1) * nx + b, ps), p),
                sub3(load3(x, a * nx + b + 1, ps), p));
}

__device__ __forceinline__ Vec3 face2(const float* __restrict__ x, int a,
                                      int b, int ny, int nx, int ps) {
  if (a < 0 || b < 0 || a + 1 >= ny || b + 1 >= nx) return {0.0f, 0.0f, 0.0f};
  const Vec3 pi = load3(x, (a + 1) * nx + b, ps);
  const Vec3 pj = load3(x, a * nx + b + 1, ps);
  return cross3(sub3(pi, pj), sub3(load3(x, (a + 1) * nx + b + 1, ps), pj));
}

// The unit normal of vertex (i, j): the six faces around it summed in the
// plain version's order, f1 + f1(-1,0) + f1(0,-1) + f2(0,-1) + f2(-1,0) +
// f2(-1,-1), divided by max(|sum|, 1e-12).
__device__ __forceinline__ Vec3 vertex_normal(const float* __restrict__ x,
                                              int i, int j, int ny, int nx,
                                              int ps) {
  Vec3 a = face1(x, i, j, ny, nx, ps);
  Vec3 f = face1(x, i - 1, j, ny, nx, ps);
  a = {a.x + f.x, a.y + f.y, a.z + f.z};
  f = face1(x, i, j - 1, ny, nx, ps);
  a = {a.x + f.x, a.y + f.y, a.z + f.z};
  f = face2(x, i, j - 1, ny, nx, ps);
  a = {a.x + f.x, a.y + f.y, a.z + f.z};
  f = face2(x, i - 1, j, ny, nx, ps);
  a = {a.x + f.x, a.y + f.y, a.z + f.z};
  f = face2(x, i - 1, j - 1, ny, nx, ps);
  a = {a.x + f.x, a.y + f.y, a.z + f.z};
  const float m = fmaxf(sqrtf(dot3(a, a)), 1e-12f);
  return {a.x / m, a.y / m, a.z / m};
}

// The wind force on vertex (i, j) of positions x, moving at v.
__device__ __forceinline__ Vec3 wind_force(const float* __restrict__ x, int i,
                                           int j, int ny, int nx, int ps,
                                           Vec3 v, const Wind& w) {
  const Vec3 r = {w.vx - v.x, w.vy - v.y, w.vz - v.z};
  Vec3 f = {w.drag * r.x, w.drag * r.y, w.drag * r.z};
  if (w.lift != 0.0f) {
    const Vec3 n = vertex_normal(x, i, j, ny, nx, ps);
    const float s = w.lift * dot3(r, n);
    f = {f.x + s * n.x, f.y + s * n.y, f.z + s * n.z};
  }
  return f;
}

// --- the strain limit: one Jacobi sweep per launch --------------------------
//
// StrainLimitParams (stencil.py::strain_limit_planes, TPU
// pallas_substep.py::_strain_limit_planes): each sweep projects every live
// edge whose length lies outside [lo, hi] = rest * [1 - max_compress,
// 1 + max_stretch] back onto the nearer bound, the endpoints weighted by
// inverse mass, and moves each vertex by the sum of its edges' corrections
// over its count of live edges, owned and owning.  A sweep reads every
// neighbour's result of the sweep before, and nothing but a kernel boundary
// gives that grid-wide barrier, so a sweep is one launch, one thread per
// vertex, reading one position buffer and writing another (ping-pong).  A
// thread evaluates its n_off owned edges and the n_off edges owned by
// p - o, whose reaction it takes, through strain_corr with the owner's
// argument order, so both ends of an edge compute the same correction; no
// atomics.  The count comes from the same liveness tests.  The last sweep
// runs the solver's epilogue for its own vertex (the Epilogue functor of
// each solver's .cu file), so strain limiting adds no launch beyond its
// sweeps.

// Scalars of the strain limit, rounded once to float.
struct StrainParams {
  float stretch1;    // 1 + max_stretch
  float compress1;   // 1 - max_compress
  int compress_on;   // max_compress >= 0 (else the lower bound is 0)
};

// The correction factor C / max(wa + wb, 1e-12) of the edge a -> b, with
// C = len - clip(len, lo, hi), and its unit direction n (the divide-form
// norm d / max(len, 1e-12)).
__device__ __forceinline__ float strain_corr(Vec3 xa, Vec3 xb, float wa,
                                             float wb, float lo, float hi,
                                             Vec3& n) {
  const Vec3 d = sub3(xb, xa);
  const float len = sqrtf(dot3(d, d));
  const float m = fmaxf(len, 1e-12f);
  n = {d.x / m, d.y / m, d.z / m};
  const float c = len - fminf(fmaxf(len, lo), hi);
  return c / fmaxf(wa + wb, 1e-12f);
}

// The band [lo, hi] of the edge owned at plane entry q of offset o: from
// limits[o] = (hi, lo), rest * (1 + max_stretch) and rest * (1 -
// max_compress) or 0 rounded once from double, without plasticity; from
// rest * scale[q] in float, as the plain version rounds it, with it.
__device__ __forceinline__ void strain_band(const float* __restrict__ limits,
                                            const float* __restrict__ scale,
                                            float rest, int o, int q,
                                            const StrainParams& sp, float& lo,
                                            float& hi) {
  if (scale) {
    const float r = __fmul_rn(rest, scale[q]);
    hi = __fmul_rn(r, sp.stretch1);
    lo = sp.compress_on ? __fmul_rn(r, sp.compress1) : 0.0f;
  } else {
    hi = limits[2 * o];
    lo = limits[2 * o + 1];
  }
}

// One strain-limit sweep (project = 1) of vertex (i, j), and on the last
// sweep (last = 1) the solver's epilogue.  A sweep's positions are base, or
// base + add where add is not null (XPBD's first sweep: xp + delta);
// table is [n_off, 4] rows of (di, dj, _, rest); alive and scale are the
// substep's tear and plastic planes, [n_off, ny, nx] (null: the feature is
// off).  A sweep that is not the last writes the new positions to xs_out;
// the last hands them to epi(idx, x_new), which writes the substep's
// result.  With iterations = 0 the wrapper launches one sweep with
// project = 0: the epilogue alone, on unchanged positions.
template <class Epilogue>
__global__ void __launch_bounds__(256) grid_strain_sweep_kernel(
    const float* __restrict__ base, const float* __restrict__ add,
    float* __restrict__ xs_out, const float* __restrict__ inv_mass,
    const float* __restrict__ table, const float* __restrict__ limits,
    int n_off, const float* __restrict__ alive,
    const float* __restrict__ scale, StrainParams sp, int project, int last,
    int ny, int nx, Epilogue epi) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  const int ps = ny * nx;
  const int idx = i * nx + j;
  auto pos = [&](int q) {
    const Vec3 a = load3(base, q, ps);
    if (!add) return a;
    const Vec3 b = load3(add, q, ps);
    return Vec3{a.x + b.x, a.y + b.y, a.z + b.z};
  };
  const Vec3 xi = pos(idx);
  Vec3 xn = xi;
  if (project) {
    const float wi = inv_mass[idx];
    float dx = 0.0f, dy = 0.0f, dz = 0.0f, cnt = 0.0f;
    for (int o = 0; o < n_off; ++o) {
      const int di = static_cast<int>(table[4 * o]);
      const int dj = static_cast<int>(table[4 * o + 1]);
      const float rest = table[4 * o + 3];
      float lo, hi;
      Vec3 n;
      // the edge this vertex owns, to (i + di, j + dj): + w_i corr n
      int ii = i + di, jj = j + dj;
      if (ii >= 0 && ii < ny && jj >= 0 && jj < nx &&
          (!alive || alive[o * ps + idx] != 0.0f)) {
        const int nb = ii * nx + jj;
        strain_band(limits, scale, rest, o, o * ps + idx, sp, lo, hi);
        const float s =
            wi * strain_corr(xi, pos(nb), wi, inv_mass[nb], lo, hi, n);
        dx += s * n.x;
        dy += s * n.y;
        dz += s * n.z;
        cnt += 1.0f;
      }
      // the edge owned by (i - di, j - dj), recomputed: - w_i corr n here
      ii = i - di;
      jj = j - dj;
      if (ii >= 0 && ii < ny && jj >= 0 && jj < nx) {
        const int nb = ii * nx + jj;
        if (alive && alive[o * ps + nb] == 0.0f) continue;
        strain_band(limits, scale, rest, o, o * ps + nb, sp, lo, hi);
        const float s =
            wi * strain_corr(pos(nb), xi, inv_mass[nb], wi, lo, hi, n);
        dx -= s * n.x;
        dy -= s * n.y;
        dz -= s * n.z;
        cnt += 1.0f;
      }
    }
    const float c = 1.0f / fmaxf(cnt, 1.0f);
    xn = {xi.x + dx * c, xi.y + dy * c, xi.z + dz * c};
  }
  if (!last) {
    store3(xs_out, idx, ps, xn);
    return;
  }
  epi(idx, xn);
}

// Launch one strain sweep with epilogue `epi` on `stream`; returns the
// cudaError_t of the launch.
template <class Epilogue>
int launch_strain_sweep(const float* base, const float* add, float* xs_out,
                        const float* inv_mass, const float* table,
                        const float* limits, int n_off, const float* alive,
                        const float* scale, StrainParams sp, int project,
                        int last, int ny, int nx, Epilogue epi,
                        void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y);
  grid_strain_sweep_kernel<Epilogue>
      <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
          base, add, xs_out, inv_mass, table, limits, n_off, alive, scale,
          sp, project, last, ny, nx, epi);
  return static_cast<int>(cudaGetLastError());
}

// Launch the frame-end update on `stream`; returns the cudaError_t of the
// launch.  Each kernel library exports it under its own name.
inline int launch_feature_finish(const float* x, const float* alive_in,
                                 float* alive_out, const float* scale_in,
                                 float* scale_out, const float* table,
                                 const float* tear_limits, int n_off, int ny,
                                 int nx, FeatParams f, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y);
  grid_feature_finish_kernel<<<grid, block, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      x, alive_in, alive_out, scale_in, scale_out, table, tear_limits, n_off,
      ny, nx, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
