// Device helpers shared by the substep kernels: the grid-cloth kernels
// (grid_euler.cu, grid_verlet.cu, grid_xpbd.cu), one thread per vertex of a
// [ny, nx] grid whose state lies in [3, ny, nx] component planes, and the
// tet-lattice kernels (lattice_*.cu, through lattice_common.cuh), one thread
// per vertex of [3, N] planes.  Every helper reads or writes one vertex.
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

}  // namespace
