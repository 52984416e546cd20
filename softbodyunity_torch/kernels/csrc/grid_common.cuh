// Device helpers shared by the grid-cloth substep kernels (grid_euler.cu,
// grid_verlet.cu, grid_xpbd.cu).  Each kernel is one thread per vertex of a
// [ny, nx] grid whose state lies in [3, ny, nx] component planes.
//
// Rounding: sqrtf and IEEE divides in the order of the plain PyTorch
// versions (softbodyunity_torch/kernels/stencil.py); nvcc contracts a * b + c
// into FMAs, so the kernels agree with them to rounding.

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

}  // namespace
