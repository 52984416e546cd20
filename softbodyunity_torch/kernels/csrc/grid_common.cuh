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

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

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
// (stencil.py::stencil_spring_forces: multiply by 1 / max(len, 1e-12)), as
// its magnitude fmag and unit direction n: (fmag, n.x, n.y, n.z).  The force
// is fmag * n; a kernel that evaluates each edge once keeps the pair and
// forms the products where it sums them, as a kernel that recomputes each
// edge at both ends forms them (edge_force), so the two agree to the bit.
__device__ __forceinline__ float4 edge_terms(Vec3 xa, Vec3 va, Vec3 xb,
                                             Vec3 vb, float k, float rest,
                                             float damping) {
  const float dx = xb.x - xa.x, dy = xb.y - xa.y, dz = xb.z - xa.z;
  const float len = sqrtf(dx * dx + dy * dy + dz * dz);
  const float inv_len = 1.0f / fmaxf(len, 1e-12f);
  const float nx = dx * inv_len, ny = dy * inv_len, nz = dz * inv_len;
  const float rel_v =
      (vb.x - va.x) * nx + (vb.y - va.y) * ny + (vb.z - va.z) * nz;
  const float fmag = k * (len - rest) + damping * rel_v;
  return make_float4(fmag, nx, ny, nz);
}

// The same force as a vector.  Both the owner's force and the recomputed
// reaction come from here, so the two copies of an edge force are
// identical.
__device__ __forceinline__ Vec3 edge_force(Vec3 xa, Vec3 va, Vec3 xb,
                                           Vec3 vb, float k, float rest,
                                           float damping) {
  const float4 t = edge_terms(xa, va, xb, vb, k, rest, damping);
  return {t.x * t.y, t.x * t.z, t.x * t.w};
}

// --- the colliders ----------------------------------------------------------
//
// Every collider's rows lie in device memory, read through const __restrict__
// pointers: every thread of a warp reads the same row, a broadcast.  The
// wrappers pack them from the topology of each call
// (kernels/grid_scene.py::ColliderRows), so a collider moved between frames
// (api.move_colliders) needs no new step function.  A count of 0 (the
// collider is off, or the scene has none) skips its loop.
struct Colliders {
  const float* plane;     // [1, 4] height, surface (conveyor) velocity xyz
  int plane_on;
  int plane_fric;         // position-level plane friction is on
  const float* spheres;   // [S, 7] center xyz, radius, velocity xyz
  int n_spheres;          // 0 when spheres are off
  int sphere_fric;        // position-level sphere friction is on
  const float* capsules;  // [C, 10] p0 xyz, p1 xyz, radius, velocity xyz
  int n_capsules;         // 0 when capsules are off
  const float* boxes;     // [B, 18] center xyz, half extents xyz, R
                          // row-major (R[c][i] = row[6 + 3c + i], columns =
                          // the box's axes), velocity xyz
  int n_boxes;            // 0 when boxes are off
  int rest_fric;          // position-level capsule/box friction is on
};

// The collider arguments of every launch function's C interface, in the
// order of kernels/grid_scene.py::COLLIDER_ARGTYPES, and the struct made of
// them.
#define COLLIDER_PARAMS                                                     \
  const float *plane, int plane_on, int plane_fric, const float *spheres,  \
      int n_spheres, int sphere_fric, const float *capsules,               \
      int n_capsules, const float *boxes, int n_boxes, int rest_fric
#define COLLIDERS                                                           \
  Colliders {                                                               \
    plane, plane_on, plane_fric, spheres, n_spheres, sphere_fric, capsules, \
        n_capsules, boxes, n_boxes, rest_fric                               \
  }

// The no-contact collider set, for an integrate launch under the strain
// limit (the last sweep runs the contact).
constexpr Colliders kNoContact = {nullptr, 0, 0, nullptr, 0, 0,
                                  nullptr, 0, nullptr, 0, 0};

// Capsule and box math (collide.py's component primitives, the JAX
// package's collide.py:30-117): the closest point on a capsule's segment,
// t = (x - p0) . ax / max(|ax|^2, 1e-12) clipped to [0, 1], and its
// outward normal n = d * (1 / max(|d|, 1e-12)); a box's local coordinates
// q_i = sum_c d_c R[c][i], its penetrations pen_i = half_i - |q_i|, and its
// exit face, the axis of least penetration with ties broken x < y < z, on
// the side q_k >= 0 ? +1 : -1 (a -0 gives +1, as the plain version's
// where(q >= 0) does; copysignf would give -1).

__device__ __forceinline__ Vec3 capsule_closest(Vec3 x, const float* cp) {
  const Vec3 ax = {cp[3] - cp[0], cp[4] - cp[1], cp[5] - cp[2]};
  const float l2 = ax.x * ax.x + ax.y * ax.y + ax.z * ax.z;
  const Vec3 dp = {x.x - cp[0], x.y - cp[1], x.z - cp[2]};
  const float t = fminf(
      fmaxf((dp.x * ax.x + dp.y * ax.y + dp.z * ax.z) / fmaxf(l2, 1e-12f),
            0.0f),
      1.0f);
  return {cp[0] + t * ax.x, cp[1] + t * ax.y, cp[2] + t * ax.z};
}

// |x - c| and the unit direction n from c toward x.
__device__ __forceinline__ float radial(Vec3 x, Vec3 c, Vec3& n) {
  const Vec3 d = {x.x - c.x, x.y - c.y, x.z - c.z};
  const float dist = sqrtf(d.x * d.x + d.y * d.y + d.z * d.z);
  const float inv = 1.0f / fmaxf(dist, 1e-12f);
  n = {d.x * inv, d.y * inv, d.z * inv};
  return dist;
}

struct BoxFace {
  float pen[3];   // half_i - |q_i|
  int k;          // the exit face's axis
  float sgn;      // its side
};

__device__ __forceinline__ BoxFace box_face(Vec3 x, const float* b) {
  const Vec3 d = {x.x - b[0], x.y - b[1], x.z - b[2]};
  float q[3];
  BoxFace f;
  for (int i = 0; i < 3; ++i) {
    q[i] = d.x * b[6 + i] + d.y * b[9 + i] + d.z * b[12 + i];
    f.pen[i] = b[3 + i] - fabsf(q[i]);
  }
  const bool k0 = f.pen[0] <= f.pen[1] && f.pen[0] <= f.pen[2];
  const bool k1 = !k0 && f.pen[1] <= f.pen[2];
  f.k = k0 ? 0 : (k1 ? 1 : 2);
  f.sgn = q[f.k] >= 0.0f ? 1.0f : -1.0f;
  return f;
}

__device__ __forceinline__ bool box_inside(const BoxFace& f) {
  return f.pen[0] > 0.0f && f.pen[1] > 0.0f && f.pen[2] > 0.0f;
}

// The exit face's outward normal: column k of R, times its side.
__device__ __forceinline__ Vec3 box_normal(const BoxFace& f, const float* b) {
  return {f.sgn * b[6 + f.k], f.sgn * b[9 + f.k], f.sgn * b[12 + f.k]};
}

// Velocity-level response of a contact with penetration pen along n, the
// collider moving at w (collide.py::_normal_velocity_response): push out,
// bounce the inward normal velocity relative to w by restitution1 = 1 +
// restitution, then keep `keep` = 1 - friction of the relative tangential
// velocity.
__device__ __forceinline__ void normal_response(
    float& px, float& py, float& pz, float& vx, float& vy, float& vz,
    float pen, Vec3 n, const float* w, float restitution1, float keep) {
  px += pen * n.x;
  py += pen * n.y;
  pz += pen * n.z;
  const float wx = w[0], wy = w[1], wz = w[2];
  const float un = (vx - wx) * n.x + (vy - wy) * n.y + (vz - wz) * n.z;
  if (un < 0.0f) {
    const float r = restitution1 * un;
    vx -= r * n.x;
    vy -= r * n.y;
    vz -= r * n.z;
  }
  const float ux = vx - wx, uy = vy - wy, uz = vz - wz;
  const float un2 = ux * n.x + uy * n.y + uz * n.z;
  const float n2x = un2 * n.x, n2y = un2 * n.y, n2z = un2 * n.z;
  vx = wx + n2x + (ux - n2x) * keep;
  vy = wy + n2y + (uy - n2y) * keep;
  vz = wz + n2z + (uz - n2z) * keep;
}

// Velocity-level contact of a movable vertex with every capsule in turn
// (collide.py::resolve_capsules_boxes_components, its capsule loop).
__device__ __forceinline__ void capsule_resolve(
    float& px, float& py, float& pz, float& vx, float& vy, float& vz,
    const Colliders& c, float restitution1, float keep) {
  for (int s = 0; s < c.n_capsules; ++s) {
    const float* cp = c.capsules + 10 * s;
    Vec3 n;
    const float pen = cp[6] - radial({px, py, pz},
                                     capsule_closest({px, py, pz}, cp), n);
    if (pen > 0.0f)
      normal_response(px, py, pz, vx, vy, vz, pen, n, cp + 7, restitution1,
                      keep);
  }
}

// Velocity-level contact of a movable vertex with every box in turn, after
// the capsules.
__device__ __forceinline__ void box_resolve(float& px, float& py, float& pz,
                                            float& vx, float& vy, float& vz,
                                            const Colliders& c,
                                            float restitution1, float keep) {
  for (int s = 0; s < c.n_boxes; ++s) {
    const float* b = c.boxes + 18 * s;
    const BoxFace f = box_face({px, py, pz}, b);
    if (box_inside(f))
      normal_response(px, py, pz, vx, vy, vz, f.pen[f.k], box_normal(f, b),
                      b + 15, restitution1, keep);
  }
}

// Position-only push-out of a movable vertex out of every capsule, then
// every box (collide.py::project_capsules_boxes_components).
__device__ __forceinline__ Vec3 capsule_box_project(Vec3 x,
                                                    const Colliders& c) {
  for (int s = 0; s < c.n_capsules; ++s) {
    const float* cp = c.capsules + 10 * s;
    Vec3 n;
    const float pen = cp[6] - radial(x, capsule_closest(x, cp), n);
    if (pen > 0.0f) x = {x.x + pen * n.x, x.y + pen * n.y, x.z + pen * n.z};
  }
  for (int s = 0; s < c.n_boxes; ++s) {
    const float* b = c.boxes + 18 * s;
    const BoxFace f = box_face(x, b);
    if (!box_inside(f)) continue;
    const Vec3 n = box_normal(f, b);
    const float pen = f.pen[f.k];
    x = {x.x + pen * n.x, x.y + pen * n.y, x.z + pen * n.z};
  }
  return x;
}

// The same in XPBD's delta form (collide.py::project_positions_delta): the
// push-out at the evaluation point xp + dl, added to dl as a displacement.
// Without capsules and boxes dl is returned untouched.
__device__ __forceinline__ Vec3 capsule_box_project_delta(
    Vec3 dl, Vec3 xp, const Colliders& c) {
  if (c.n_capsules + c.n_boxes == 0) return dl;
  const Vec3 e = {xp.x + dl.x, xp.y + dl.y, xp.z + dl.z};
  const Vec3 q = capsule_box_project(e, c);
  return {dl.x + (q.x - e.x), dl.y + (q.y - e.y), dl.z + (q.z - e.z)};
}

// Position-level friction of the tangential displacement x - x0 relative
// to a collider moving at w, along the unit normal n
// (collide.py::_friction_tangent_components).
__device__ __forceinline__ Vec3 friction_tangent(Vec3 x, Vec3 x0, Vec3 n,
                                                 const float* w, float mu,
                                                 float dt) {
  const Vec3 rel = {x.x - x0.x - w[0] * dt, x.y - x0.y - w[1] * dt,
                    x.z - x0.z - w[2] * dt};
  const float rn = rel.x * n.x + rel.y * n.y + rel.z * n.z;
  return {x.x - mu * (rel.x - rn * n.x), x.y - mu * (rel.y - rn * n.y),
          x.z - mu * (rel.z - rn * n.z)};
}

// The contact tests of the friction, rounded as the plain version rounds
// them (one rounding per operation, no FMA): a vertex that a projection
// has just put on a surface sits within ulps of it, and the shells exist
// for that; a test rounded otherwise could take a vertex the plain version
// leaves (or the other way round).
__device__ __forceinline__ float dot3_rn(Vec3 a, Vec3 b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                   __fmul_rn(a.z, b.z));
}

// |x - closest point of the capsule's segment|, every step rounded.
__device__ __forceinline__ float capsule_distance_rn(Vec3 x,
                                                     const float* cp) {
  const Vec3 ax = {__fsub_rn(cp[3], cp[0]), __fsub_rn(cp[4], cp[1]),
                   __fsub_rn(cp[5], cp[2])};
  const Vec3 dp = {__fsub_rn(x.x, cp[0]), __fsub_rn(x.y, cp[1]),
                   __fsub_rn(x.z, cp[2])};
  const float t = fminf(
      fmaxf(__fdiv_rn(dot3_rn(dp, ax), fmaxf(dot3_rn(ax, ax), 1e-12f)),
            0.0f),
      1.0f);
  const Vec3 d = {__fsub_rn(x.x, __fadd_rn(cp[0], __fmul_rn(t, ax.x))),
                  __fsub_rn(x.y, __fadd_rn(cp[1], __fmul_rn(t, ax.y))),
                  __fsub_rn(x.z, __fadd_rn(cp[2], __fmul_rn(t, ax.z)))};
  return sqrtf(dot3_rn(d, d));
}

// min_i (half_i - |q_i|) of a box, every step rounded.
__device__ __forceinline__ float box_min_pen_rn(Vec3 x, const float* b) {
  const Vec3 d = {__fsub_rn(x.x, b[0]), __fsub_rn(x.y, b[1]),
                  __fsub_rn(x.z, b[2])};
  float mn = 0.0f;
  for (int i = 0; i < 3; ++i) {
    const float q = dot3_rn(d, {b[6 + i], b[9 + i], b[12 + i]});
    const float pen = __fsub_rn(b[3 + i], fabsf(q));
    mn = i == 0 ? pen : fminf(mn, pen);
  }
  return mn;
}

// Capsule, then box, position-level friction of a movable vertex that ends
// the substep at x, having started it at x0
// (collide.py::rest_friction_components): within a capsule's shell
// radius * shell (SPHERE_CONTACT_SHELL) of its segment, or within
// 1e-5 * max(half) (BOX_CONTACT_SHELL) of a box's nearest face, the
// tangential displacement relative to the collider's velocity is damped by
// 1 - mu.  Each collider reads the previous one's output.
__device__ __forceinline__ Vec3 capsule_box_friction(Vec3 x, Vec3 x0,
                                                     const Colliders& c,
                                                     float mu, float dt,
                                                     float shell) {
  for (int s = 0; s < c.n_capsules; ++s) {
    const float* cp = c.capsules + 10 * s;
    if (!(capsule_distance_rn(x, cp) <= __fmul_rn(cp[6], shell))) continue;
    Vec3 n;
    radial(x, capsule_closest(x, cp), n);
    x = friction_tangent(x, x0, n, cp + 7, mu, dt);
  }
  for (int s = 0; s < c.n_boxes; ++s) {
    const float* b = c.boxes + 18 * s;
    const float mn = box_min_pen_rn(x, b);
    const float sh = __fmul_rn(1e-5f, fmaxf(fmaxf(b[3], b[4]), b[5]));
    if (!(mn >= -sh && mn <= sh)) continue;
    x = friction_tangent(x, x0, box_normal(box_face(x, b), b), b + 15, mu,
                         dt);
  }
  return x;
}

// Velocity-level contact of a movable vertex at position p with velocity v
// (the Euler solver; collide.py::resolve_velocity_level): clamp onto the
// plane (plane[0] is its height, plane[1..3] its surface velocity), bounce
// the normal velocity relative to the surface by restitution and keep
// `keep` = 1 - friction of the tangential part; then each sphere in turn:
// push out, bounce by restitution1 = 1 + restitution, damp the tangential
// part; then each capsule and each box in turn, the same way.
__device__ __forceinline__ void resolve_velocity_contact(
    float& px, float& py, float& pz, float& vx, float& vy, float& vz,
    const Colliders& c, float restitution, float restitution1, float keep) {
  const float* __restrict__ plane = c.plane;
  const float* __restrict__ spheres = c.spheres;
  const int n_spheres = c.n_spheres;
  if (c.plane_on && py < plane[0]) {
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
  capsule_resolve(px, py, pz, vx, vy, vz, c, restitution1, keep);
  box_resolve(px, py, pz, vx, vy, vz, c, restitution1, keep);
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
// then push out of the spheres, the capsules and the boxes.  Returns
// whether the plane clamp fired, the pre-clamp contact that the plane
// friction reads.
__device__ __forceinline__ bool project_contact(Vec3& x, const Colliders& c) {
  const bool contact = c.plane_on && x.y < c.plane[0];
  if (contact) x.y = c.plane[0];
  x = push_out_spheres(x, c.spheres, c.n_spheres);
  x = capsule_box_project(x, c);
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

// The position-level contact chain of a movable vertex that ends the
// substep at x, having started it at x0 (the Verlet solver;
// stencil.py::verlet_substep_grid, step.py::verlet_contact_project): the
// projection, then the plane friction where the clamp fired (mu, keep =
// 1 - mu), the sphere friction within the shell, the capsule/box friction.
__device__ __forceinline__ Vec3 position_contact(Vec3 x, Vec3 x0,
                                                 const Colliders& c,
                                                 float mu, float keep,
                                                 float dt, float shell) {
  const bool hit = project_contact(x, c);
  if (c.plane_fric && hit) {
    // toward the substep start moved with the plane's surface velocity
    const float tx = x0.x + c.plane[1] * dt;
    const float tz = x0.z + c.plane[3] * dt;
    x.x = tx + (x.x - tx) * keep;
    x.z = tz + (x.z - tz) * keep;
  }
  if (c.sphere_fric)
    x = sphere_friction(x, x0, c.spheres, c.n_spheres, mu, dt, shell);
  if (c.rest_fric) x = capsule_box_friction(x, x0, c, mu, dt, shell);
  return x;
}

// XPBD's contact inside the loop, in delta form, of a movable vertex that
// started the substep at xp (collide.py::project_positions_delta): the
// plane clamp as plane - xp (its pre-clamp contact sets *flag), then the
// spheres' push-out as a displacement, then the capsules' and boxes'.
__device__ __forceinline__ void project_delta(Vec3& dl, Vec3 xp,
                                              unsigned char* flag,
                                              const Colliders& c) {
  if (c.plane_on && xp.y + dl.y < c.plane[0]) {
    dl.y = c.plane[0] - xp.y;
    *flag = 1;
  }
  if (c.n_spheres > 0) {
    const Vec3 e = {xp.x + dl.x, xp.y + dl.y, xp.z + dl.z};
    const Vec3 q = push_out_spheres(e, c.spheres, c.n_spheres);
    dl = {dl.x + (q.x - e.x), dl.y + (q.y - e.y), dl.z + (q.z - e.z)};
  }
  dl = capsule_box_project_delta(dl, xp, c);
}

// XPBD's friction, once per substep, of the delta dl of a vertex that
// started at xp: the plane's where the OR'd flag is set, then the sphere
// and capsule/box friction at xp + dl, added to dl as one displacement
// (stencil.py::xpbd_substep_grid).  Pinned vertices take a zero delta.
__device__ __forceinline__ Vec3 friction_delta(Vec3 dl, Vec3 xp,
                                               bool movable,
                                               unsigned char flag,
                                               const Colliders& c, float mu,
                                               float keep, float dt,
                                               float shell) {
  if (!movable) return {0.0f, 0.0f, 0.0f};
  if (c.plane_fric && flag) {
    const float wdx = c.plane[1] * dt, wdz = c.plane[3] * dt;
    dl.x = wdx + (dl.x - wdx) * keep;
    dl.z = wdz + (dl.z - wdz) * keep;
  }
  if (c.sphere_fric || c.rest_fric) {
    const Vec3 e = {xp.x + dl.x, xp.y + dl.y, xp.z + dl.z};
    Vec3 f = e;
    if (c.sphere_fric)
      f = sphere_friction(f, xp, c.spheres, c.n_spheres, mu, dt, shell);
    if (c.rest_fric) f = capsule_box_friction(f, xp, c, mu, dt, shell);
    dl = {dl.x + (f.x - e.x), dl.y + (f.y - e.y), dl.z + (f.z - e.z)};
  }
  return dl;
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

// Positions of grid vertex (a, b) read from device memory: the accessor
// the one-pass kernels hand to the normal below.  A tiled kernel hands one
// that reads its staged frame.
struct PlaneAt {
  const float* __restrict__ x;
  int nx, ps;
  __device__ __forceinline__ Vec3 operator()(int a, int b) const {
    return load3(x, a * nx + b, ps);
  }
};

// The face normals (unnormalised) of grid cell (a, b): f1 of the triangle
// (p(a,b), p(a+1,b), p(a,b+1)), f2 of (p(a,b+1), p(a+1,b), p(a+1,b+1)).  A
// cell outside [0, ny - 1) x [0, nx - 1) has none: zero, as the plain
// version's masked face planes are.  at(a, b) is the position of vertex
// (a, b).
template <class At>
__device__ __forceinline__ Vec3 face1(const At& at, int a, int b, int ny,
                                      int nx) {
  if (a < 0 || b < 0 || a + 1 >= ny || b + 1 >= nx) return {0.0f, 0.0f, 0.0f};
  const Vec3 p = at(a, b);
  return cross3(sub3(at(a + 1, b), p), sub3(at(a, b + 1), p));
}

template <class At>
__device__ __forceinline__ Vec3 face2(const At& at, int a, int b, int ny,
                                      int nx) {
  if (a < 0 || b < 0 || a + 1 >= ny || b + 1 >= nx) return {0.0f, 0.0f, 0.0f};
  const Vec3 pi = at(a + 1, b);
  const Vec3 pj = at(a, b + 1);
  return cross3(sub3(pi, pj), sub3(at(a + 1, b + 1), pj));
}

// The unit normal of vertex (i, j): the six faces around it summed in the
// plain version's order, f1 + f1(-1,0) + f1(0,-1) + f2(0,-1) + f2(-1,0) +
// f2(-1,-1), divided by max(|sum|, 1e-12).
template <class At>
__device__ __forceinline__ Vec3 vertex_normal(const At& at, int i, int j,
                                              int ny, int nx) {
  Vec3 a = face1(at, i, j, ny, nx);
  Vec3 f = face1(at, i - 1, j, ny, nx);
  a = {a.x + f.x, a.y + f.y, a.z + f.z};
  f = face1(at, i, j - 1, ny, nx);
  a = {a.x + f.x, a.y + f.y, a.z + f.z};
  f = face2(at, i, j - 1, ny, nx);
  a = {a.x + f.x, a.y + f.y, a.z + f.z};
  f = face2(at, i - 1, j, ny, nx);
  a = {a.x + f.x, a.y + f.y, a.z + f.z};
  f = face2(at, i - 1, j - 1, ny, nx);
  a = {a.x + f.x, a.y + f.y, a.z + f.z};
  const float m = fmaxf(sqrtf(dot3(a, a)), 1e-12f);
  return {a.x / m, a.y / m, a.z / m};
}

// The wind force on vertex (i, j), at(a, b) the positions, moving at v.
template <class At>
__device__ __forceinline__ Vec3 wind_force_at(const At& at, int i, int j,
                                              int ny, int nx, Vec3 v,
                                              const Wind& w) {
  const Vec3 r = {w.vx - v.x, w.vy - v.y, w.vz - v.z};
  Vec3 f = {w.drag * r.x, w.drag * r.y, w.drag * r.z};
  if (w.lift != 0.0f) {
    const Vec3 n = vertex_normal(at, i, j, ny, nx);
    const float s = w.lift * dot3(r, n);
    f = {f.x + s * n.x, f.y + s * n.y, f.z + s * n.z};
  }
  return f;
}

// The wind force on vertex (i, j) of the positions x in device memory.
__device__ __forceinline__ Vec3 wind_force(const float* __restrict__ x, int i,
                                           int j, int ny, int nx, int ps,
                                           Vec3 v, const Wind& w) {
  return wind_force_at(PlaneAt{x, nx, ps}, i, j, ny, nx, v, w);
}

// --- tiles: a CTA owns a tile of the grid, each edge evaluated once ------
//
// The grid's offset patterns, in the order of the offsets tables
// (kernels/stencil.py::_offsets and ::_xpbd_offsets list them alike):
// structural (0, 1), (1, 0), then shear (1, 1), (1, -1), then bend (0, 2),
// (2, 0).  A tiled kernel is compiled for each pattern, so that every index
// is a constant: evaluating each edge once pays only then (grid_xpbd.cu).
enum Pattern { kStructural, kShear, kBend, kShearBend };

// Offset o of pattern P as (di, dj): the structural two, then the shear
// two unless P is kBend, then the bend two.
template <int P>
struct Offsets {
  static constexpr int n = P == kShearBend ? 6 : (P == kStructural ? 2 : 4);
  // o's place in the six offsets of kShearBend
  __host__ __device__ static constexpr int six(int o) {
    return P == kBend && o >= 2 ? o + 2 : o;
  }
  __host__ __device__ static constexpr int di(int o) {
    switch (six(o)) {
      case 0: case 4: return 0;
      case 5: return 2;
      default: return 1;
    }
  }
  __host__ __device__ static constexpr int dj(int o) {
    switch (six(o)) {
      case 0: case 2: return 1;
      case 3: return -1;
      case 4: return 2;
      default: return 0;
    }
  }
};

__host__ __device__ constexpr int abs_c(int a) { return a < 0 ? -a : a; }
__host__ __device__ constexpr int min0(int a) { return a < 0 ? a : 0; }

// The tile, columns x rows, one thread a vertex.
constexpr int kTileX = 32, kTileY = 8;

// A CTA's tile, TX x TY vertices, and its frame of H vertices around (H =
// the largest |di|, |dj|).  Offset o's rectangle holds the edges owned by a
// vertex q with q or q + o in the tile: NR(o) x NC(o) owners from row
// min(0, -di), column min(0, -dj) of the tile, its entries from B(o) on.
// Thread (x, y) evaluates entry (y, x) of every rectangle; the rest of each
// rectangle, the strips past row TY and column TX (S(o) entries, from SB(o)
// on in one list), goes one entry a thread.
template <int P, int TX_ = kTileX, int TY_ = kTileY>
struct Tile {
  using O = Offsets<P>;
  static constexpr int TX = TX_, TY = TY_;
  static constexpr int H = P == kBend || P == kShearBend ? 2 : 1;
  static constexpr int FW = TX + 2 * H, FH = TY + 2 * H;
  __host__ __device__ static constexpr int NR(int o) {
    return TY + abs_c(O::di(o));
  }
  __host__ __device__ static constexpr int NC(int o) {
    return TX + abs_c(O::dj(o));
  }
  __host__ __device__ static constexpr int B(int o) {
    int b = 0;
    for (int k = 0; k < o; ++k) b += NR(k) * NC(k);
    return b;
  }
  __host__ __device__ static constexpr int S(int o) {
    return abs_c(O::di(o)) * NC(o) + TY * abs_c(O::dj(o));
  }
  __host__ __device__ static constexpr int SB(int o) {
    int b = 0;
    for (int k = 0; k < o; ++k) b += S(k);
    return b;
  }
  // strip entry e of offset o (0 <= e < S(o)) as its rectangle row and
  // column: rows past TY (all NC columns), then columns past TX
  __host__ __device__ static constexpr int strip_rows(int o) {
    return abs_c(O::di(o)) * NC(o);
  }
  __host__ __device__ static constexpr int strip_cols(int o) {
    return abs_c(O::dj(o)) > 0 ? abs_c(O::dj(o)) : 1;
  }
  __host__ __device__ static constexpr int strip_row(int o, int e) {
    return e < strip_rows(o) ? TY + e / NC(o)
                             : (e - strip_rows(o)) / strip_cols(o);
  }
  __host__ __device__ static constexpr int strip_col(int o, int e) {
    return e < strip_rows(o) ? e % NC(o)
                             : TX + (e - strip_rows(o)) % strip_cols(o);
  }
};

// f(std::integral_constant<int, A + o>) for o = 0 .. n - 1, unrolled.
template <int A, class F, int... O>
__device__ __forceinline__ void each_offset_from(
    F&& f, std::integer_sequence<int, O...>) {
  (f(std::integral_constant<int, A + O>{}), ...);
}

// f(std::integral_constant<int, o>) for o = 0 .. n - 1, unrolled.
template <class F, class Seq>
__device__ __forceinline__ void each_offset(F&& f, Seq seq) {
  each_offset_from<0>(static_cast<F&&>(f), seq);
}

// Positions of grid vertex (a, b) from a tile's staged frame.
template <class T>
struct FrameAt {
  const float4* f;
  int i0, j0;
  __device__ __forceinline__ Vec3 operator()(int a, int b) const {
    const float4 p = f[(a - i0 + T::H) * T::FW + (b - j0 + T::H)];
    return {p.x, p.y, p.z};
  }
};

// Stage the positions x of the tile at (i0, j0) of the [ny, nx] grid and
// its frame of T::H vertices into sx, and the rates the damper reads into
// sv: the velocity planes r (Euler), or under kVerlet the velocity
// estimate (x - r) / dt from the previous positions r, one IEEE divide a
// component (velocity_estimate).  One frame cell a thread at a time; cells
// outside the grid stay unwritten (nothing reads them).
template <class T, bool kVerlet = false>
__device__ __forceinline__ void stage_frame(const float* __restrict__ x,
                                            const float* __restrict__ r,
                                            float dt, float4* sx, float4* sv,
                                            int i0, int j0, int ny, int nx) {
  constexpr int NT = T::TX * T::TY;
  const int ps = ny * nx;
#pragma unroll
  for (int k = 0; k < (T::FH * T::FW + NT - 1) / NT; ++k) {
    const int c = threadIdx.y * T::TX + threadIdx.x + k * NT;
    if (c >= T::FH * T::FW) break;
    const int gi = i0 - T::H + c / T::FW, gj = j0 - T::H + c % T::FW;
    if (gi < 0 || gi >= ny || gj < 0 || gj >= nx) continue;
    const int q = gi * nx + gj;
    const Vec3 xq = load3(x, q, ps);
    Vec3 rq = load3(r, q, ps);
    if (kVerlet) rq = velocity_estimate(xq, rq, dt);
    sx[c] = make_float4(xq.x, xq.y, xq.z, 0.0f);
    sv[c] = make_float4(rq.x, rq.y, rq.z, 0.0f);
  }
}

// The springs of the tile at (i0, j0) of the [ny, nx] grid, each edge with
// an endpoint in the tile evaluated once (grid_euler.cu, grid_verlet.cu),
// from the staged frame: sx the positions, sv the rates the damper reads
// (v, or Verlet's velocity estimate).  Rectangle entry (r, cc) of offset o
// is (fmag, n) of the edge its owner q has there (edge_terms), or zeros (no
// edge, or a torn one); thread (x, y) takes entry (y, x) of every
// rectangle, and the strips, rows past TY (all NC columns) then columns
// past TX, go one entry a thread.  Under kFeat the edge's feature update
// (edge_features) runs once with it, and the tile writes the plane entries
// of the edges its vertices own.  The caller puts a barrier before (the
// staging) and after (the sums of tile_spring_force).
template <int P, bool kFeat>
__device__ __forceinline__ void tile_spring_terms(
    const float4* sx, const float4* sv, float4* terms,
    const float* __restrict__ offsets, const float* __restrict__ alive_in,
    float* __restrict__ alive_out, const float* __restrict__ scale_in,
    float* __restrict__ scale_out, const float* __restrict__ tear_limits,
    int first, const FeatParams& fp, float damping, int i0, int j0, int ny,
    int nx) {
  using O = Offsets<P>;
  using T = Tile<P>;
  constexpr int TX = T::TX, TY = T::TY, NT = TX * TY;
  constexpr int kN = O::n;
  using Seq = std::make_integer_sequence<int, kN>;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ps = ny * nx;
  auto in_grid = [&](int a, int b) {
    return a >= 0 && a < ny && b >= 0 && b < nx;
  };
  auto cell = [&](int a, int b) {
    return (a - i0 + T::H) * T::FW + (b - j0 + T::H);
  };
  auto evaluate = [&](auto oc, int r, int cc) {
    constexpr int o = decltype(oc)::value;
    const int qi = i0 + min0(-O::di(o)) + r;
    const int qj = j0 + min0(-O::dj(o)) + cc;
    const int bi = qi + O::di(o), bj = qj + O::dj(o);
    float4 term = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (in_grid(qi, qj)) {
      const int q = o * ps + qi * nx + qj;
      const bool own =
          kFeat && qi >= i0 && qi < i0 + TY && qj >= j0 && qj < j0 + TX;
      if (in_grid(bi, bj)) {
        const float4 pa = sx[cell(qi, qj)], pb = sx[cell(bi, bj)];
        const Vec3 xa = {pa.x, pa.y, pa.z}, xb = {pb.x, pb.y, pb.z};
        const float rest = offsets[4 * o + 3];
        float a = 1.0f, s = 1.0f;
        if (kFeat) {
          edge_features(alive_in, scale_in, q, xa, xb, rest, tear_limits[o],
                        fp, first, a, s);
          if (own && alive_out) alive_out[q] = a;
          if (own && scale_out) scale_out[q] = s;
        }
        if (a != 0.0f) {
          const float4 va = sv[cell(qi, qj)], vb = sv[cell(bi, bj)];
          term = edge_terms(xa, {va.x, va.y, va.z}, xb, {vb.x, vb.y, vb.z},
                            offsets[4 * o + 2],
                            kFeat ? scaled_rest(rest, s, scale_in) : rest,
                            damping);
        }
      } else if (own) {   // no edge here: the entry is carried, unread
        if (alive_out) alive_out[q] = alive_in[q];
        if (scale_out) scale_out[q] = scale_in[q];
      }
    }
    terms[T::B(o) + r * T::NC(o) + cc] = term;
  };
  each_offset([&](auto oc) { evaluate(oc, ty, tx); }, Seq{});
#pragma unroll
  for (int e0 = ty * TX + tx; e0 < T::SB(kN); e0 += NT) {
    each_offset([&](auto oc) {
      constexpr int o = decltype(oc)::value;
      const int e = e0 - T::SB(o);
      if (e >= 0 && e < T::S(o))
        evaluate(oc, T::strip_row(o, e), T::strip_col(o, e));
    }, Seq{});
  }
}

// The spring force on tile vertex (ty, tx) from tile_spring_terms' terms:
// per offset in table order, + fmag n of the edge it owns, then - fmag n
// of the edge owned by p - o.  These are the products and the order of a
// one-pass kernel that evaluates each edge at both ends (edge_force), so
// the force is that kernel's to the bit.
template <int P>
__device__ __forceinline__ Vec3 tile_spring_force(const float4* terms, int ty,
                                                  int tx) {
  using O = Offsets<P>;
  using T = Tile<P>;
  using Seq = std::make_integer_sequence<int, O::n>;
  float fx = 0.0f, fy = 0.0f, fz = 0.0f;
  each_offset([&](auto oc) {
    constexpr int o = decltype(oc)::value;
    constexpr int di = O::di(o), dj = O::dj(o);
    constexpr int r0 = min0(-di), c0 = min0(-dj);
    // the edge this vertex owns, to (i + di, j + dj)
    const float4 a = terms[T::B(o) + (ty - r0) * T::NC(o) + (tx - c0)];
    fx += a.x * a.y;
    fy += a.x * a.z;
    fz += a.x * a.w;
    // the reaction of the edge owned by (i - di, j - dj)
    const float4 b =
        terms[T::B(o) + (ty - di - r0) * T::NC(o) + (tx - dj - c0)];
    fx -= b.x * b.y;
    fy -= b.x * b.z;
    fz -= b.x * b.w;
  }, Seq{});
  return {fx, fy, fz};
}

// --- the strain limit: a substep's sweeps in one cooperative launch --------
//
// StrainLimitParams (stencil.py::strain_limit_planes, TPU
// pallas_substep.py::_strain_limit_planes): each sweep projects every live
// edge whose length lies outside [lo, hi] = rest * [1 - max_compress,
// 1 + max_stretch] back onto the nearer bound, the endpoints weighted by
// inverse mass, and moves each vertex by the sum of its edges' corrections
// over its count of live edges, owned and owning.  A sweep reads every
// neighbour's result of the sweep before.  The TPU runs the sweeps inside
// its one substep kernel; here one cooperative launch runs them all
// (grid_strain_sweep_kernel): its CTAs are all resident (the grid is sized
// from the occupancy the card reports, at most one CTA a tile), each loops
// over tiles of the pattern's Tile, and cooperative_groups' grid barrier
// separates the sweeps, which ping-pong through two scratch position planes
// in device memory.  Per tile and sweep the CTA stages the positions and
// inverse masses of the tile and its frame in shared memory, evaluates each
// edge with an endpoint in the tile once (strain_corr with the owner's
// argument order: the correction factor and the unit direction), then each
// vertex sums, per offset in table order, + w corr n of the edge it owns
// and - w corr n of the edge owned by p - o: the products and the order of
// the one-pass kernel that evaluated each edge at both ends, so the result
// is that kernel's to the bit.  The count of live edges, and 1 / max(count,
// 1), come once a substep, in the first sweep (liveness is fixed within a
// substep).  The last sweep runs the solver's epilogue for its own vertex
// (the Epilogue functor of each solver's .cu file).

}  // namespace

// The strain sweeps' scalars and launch struct have external linkage (the
// anonymous namespace closed around them): each library's extern "C" strain
// entry takes the struct by pointer, and a parameter of a type with
// internal linkage would keep that entry out of the library's symbols.

// Scalars of the strain limit, rounded once to float.
struct StrainParams {
  float stretch1;    // 1 + max_stretch
  float compress1;   // 1 - max_compress
  int compress_on;   // max_compress >= 0 (else the lower bound is 0)
};

// What a substep's sweeps launch with, fixed over a call of the step
// function: softbodyunity_torch/kernels/grid_strain.py::SweepsStruct
// mirrors it field by field (each library's grid_<solver>_strain_size
// checks the two agree).
struct StrainSweeps {
  const float* inv_mass;   // [ny, nx]
  const float* table;      // [n_off, 4] rows of (di, dj, _, rest)
  const float* limits;     // [n_off, 2] rows of (hi, lo)
  float* scratch[2];       // [3, ny, nx] the positions of the sweeps before
                           // the last, ping-pong
  float* inv_cnt;          // [ny, nx] 1 / max(live edges, 1), written by the
                           // first sweep, read by the others
  int pattern;             // the offsets' Pattern
  int n_sweeps;            // max(iterations, 1)
  int project;             // iterations > 0; else the epilogue alone
  int ny, nx;
  StrainParams sp;
};

namespace {

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

// A substep's s.n_sweeps strain-limit sweeps (s.project = 1) and, in the
// last, the solver's epilogue, on CTAs of kTileX x kTileY threads that loop
// over the grid's tiles.  The first sweep's positions are base, or base +
// add where add is not null (XPBD: xp + delta); a sweep that is not the last
// writes its positions to s.scratch[sweep % 2], and the last hands them to
// epi(idx, x_new), which writes the substep's result.  alive and scale are
// the substep's tear and plastic planes, [n_off, ny, nx] (null: the feature
// is off).  With s.project = 0 (iterations = 0) one sweep runs the epilogue
// alone, on unchanged positions.  Positions that other CTAs wrote in this
// launch are read past L1 (__ldcg), after the grid barrier.
template <int P, class Epilogue>
__global__ void __launch_bounds__(kTileX * kTileY) grid_strain_sweep_kernel(
    const float* base, const float* add, const float* __restrict__ alive,
    const float* __restrict__ scale, StrainSweeps s, Epilogue epi) {
  using O = Offsets<P>;
  using T = Tile<P>;
  constexpr int TX = T::TX, TY = T::TY;
  constexpr int kN = O::n;
  using Seq = std::make_integer_sequence<int, kN>;
  __shared__ float4 frame[T::FH * T::FW];   // x, w
  __shared__ float4 terms[T::B(kN)];        // corr, n
  const int x = threadIdx.x, y = threadIdx.y;
  const int ny = s.ny, nx = s.nx, ps = ny * nx;
  const int tiles_x = (nx + TX - 1) / TX;
  const int n_tiles = tiles_x * ((ny + TY - 1) / TY);
  auto in_grid = [&](int a, int b) {
    return a >= 0 && a < ny && b >= 0 && b < nx;
  };
  for (int sweep = 0; sweep < s.n_sweeps; ++sweep) {
    const bool last = sweep == s.n_sweeps - 1;
    const float* in = sweep == 0 ? base : s.scratch[(sweep - 1) % 2];
    const float* in_add = sweep == 0 ? add : nullptr;
    float* out = s.scratch[sweep % 2];
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int i0 = t / tiles_x * TY, j0 = t % tiles_x * TX;
      const int i = i0 + y, j = j0 + x;
      const int idx = i * nx + j;
      __syncthreads();   // the CTA's previous tile is summed
      // stage the frame's positions and masses
#pragma unroll
      for (int k = 0; k < (T::FH * T::FW + TX * TY - 1) / (TX * TY); ++k) {
        const int cell = y * TX + x + k * TX * TY;
        if (cell >= T::FH * T::FW) break;
        const int ci = cell / T::FW - T::H, cj = cell % T::FW - T::H;
        const int gi = i0 + ci, gj = j0 + cj;
        if (!in_grid(gi, gj)) continue;
        const int q = gi * nx + gj;
        Vec3 e = {__ldcg(in + q), __ldcg(in + ps + q),
                  __ldcg(in + 2 * ps + q)};
        if (in_add)
          e = {e.x + __ldcg(in_add + q), e.y + __ldcg(in_add + ps + q),
               e.z + __ldcg(in_add + 2 * ps + q)};
        frame[cell] = make_float4(e.x, e.y, e.z, s.inv_mass[q]);
      }
      __syncthreads();
      if (s.project) {
        // rectangle entry (r, cc) of offset o: (corr, n), or zeros where
        // the owner has no live edge there
        auto evaluate = [&](auto oc, int r, int cc) {
          constexpr int o = decltype(oc)::value;
          const int qi = i0 + min0(-O::di(o)) + r;
          const int qj = j0 + min0(-O::dj(o)) + cc;
          const int bi = qi + O::di(o), bj = qj + O::dj(o);
          float4 term = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (in_grid(qi, qj) && in_grid(bi, bj)) {
            const int q = o * ps + qi * nx + qj;
            if (!alive || alive[q] != 0.0f) {
              float lo, hi;
              strain_band(s.limits, scale, s.table[4 * o + 3], o, q, s.sp,
                          lo, hi);
              const float4 pa =
                  frame[(qi - i0 + T::H) * T::FW + (qj - j0 + T::H)];
              const float4 pb =
                  frame[(bi - i0 + T::H) * T::FW + (bj - j0 + T::H)];
              Vec3 n;
              const float corr = strain_corr({pa.x, pa.y, pa.z},
                                             {pb.x, pb.y, pb.z}, pa.w, pb.w,
                                             lo, hi, n);
              term = make_float4(corr, n.x, n.y, n.z);
            }
          }
          terms[T::B(o) + r * T::NC(o) + cc] = term;
        };
        each_offset([&](auto oc) { evaluate(oc, y, x); }, Seq{});
#pragma unroll
        for (int e0 = y * TX + x; e0 < T::SB(kN); e0 += TX * TY) {
          each_offset([&](auto oc) {
            constexpr int o = decltype(oc)::value;
            const int e = e0 - T::SB(o);
            if (e >= 0 && e < T::S(o))
              evaluate(oc, T::strip_row(o, e), T::strip_col(o, e));
          }, Seq{});
        }
        __syncthreads();
      }
      if (!in_grid(i, j)) continue;
      const float4 own = frame[(y + T::H) * T::FW + (x + T::H)];
      const Vec3 xi = {own.x, own.y, own.z};
      Vec3 xn = xi;
      if (s.project) {
        float c;
        if (sweep == 0) {
          float cnt = 0.0f;   // live edges at this vertex, owned and owning
          each_offset([&](auto oc) {
            constexpr int o = decltype(oc)::value;
            constexpr int di = O::di(o), dj = O::dj(o);
            if (in_grid(i + di, j + dj) &&
                (!alive || alive[o * ps + idx] != 0.0f))
              cnt += 1.0f;
            if (in_grid(i - di, j - dj) &&
                (!alive || alive[o * ps + idx - di * nx - dj] != 0.0f))
              cnt += 1.0f;
          }, Seq{});
          c = 1.0f / fmaxf(cnt, 1.0f);
          if (!last) s.inv_cnt[idx] = c;
        } else {
          c = s.inv_cnt[idx];
        }
        const float wi = own.w;
        float dx = 0.0f, dy = 0.0f, dz = 0.0f;
        each_offset([&](auto oc) {
          constexpr int o = decltype(oc)::value;
          constexpr int di = O::di(o), dj = O::dj(o);
          constexpr int r0 = min0(-di), c0 = min0(-dj);
          // the edge this vertex owns: + w corr n (zeros where it has none)
          const float4 a = terms[T::B(o) + (y - r0) * T::NC(o) + (x - c0)];
          float sw = wi * a.x;
          dx += sw * a.y;
          dy += sw * a.z;
          dz += sw * a.w;
          // the edge owned by (i - di, j - dj): - w corr n here
          const float4 b =
              terms[T::B(o) + (y - di - r0) * T::NC(o) + (x - dj - c0)];
          sw = wi * b.x;
          dx -= sw * b.y;
          dy -= sw * b.z;
          dz -= sw * b.w;
        }, Seq{});
        xn = {xi.x + dx * c, xi.y + dy * c, xi.z + dz * c};
      }
      if (last) {
        epi(idx, xn);
      } else {
        store3(out, idx, ps, xn);
      }
    }
    if (!last) cooperative_groups::this_grid().sync();
  }
}

// The occupancy of a cooperative kernel, asked once a kernel and process:
// CTAs an SM and the card's SMs (err: the query's cudaError_t).
struct Occupancy {
  int per_sm, sms, err;
};

template <class K>
Occupancy occupancy(K kernel, int threads) {
  Occupancy r{0, 0, 0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&r.sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r.per_sm, kernel,
                                                      threads, 0);
  r.err = static_cast<int>(e);
  return r;
}

template <int P, class Epilogue>
int launch_strain_pattern(const StrainSweeps& s, const float* base,
                          const float* add, const float* alive,
                          const float* scale, const Epilogue& epi,
                          cudaStream_t st) {
  using T = Tile<P>;
  auto kernel = grid_strain_sweep_kernel<P, Epilogue>;
  static const Occupancy occ = occupancy(kernel, T::TX * T::TY);
  if (occ.err) return occ.err;
  if (occ.per_sm < 1)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int n_tiles =
      ((s.nx + T::TX - 1) / T::TX) * ((s.ny + T::TY - 1) / T::TY);
  const int ctas = n_tiles < occ.per_sm * occ.sms ? n_tiles
                                                  : occ.per_sm * occ.sms;
  void* args[] = {const_cast<float**>(&base), const_cast<float**>(&add),
                  const_cast<float**>(&alive), const_cast<float**>(&scale),
                  const_cast<StrainSweeps*>(&s), const_cast<Epilogue*>(&epi)};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(ctas), dim3(T::TX, T::TY),
      args, 0, st));
}

// Launch a substep's strain sweeps with epilogue `epi` on `stream`: one
// cooperative launch, compiled for the offsets' pattern.  Returns its
// cudaError_t (a grid the card cannot hold resident is refused, never run
// another way).  Allocates nothing and does not synchronise.
template <class Epilogue>
int launch_strain_sweeps(const StrainSweeps& s, const float* base,
                         const float* add, const float* alive,
                         const float* scale, const Epilogue& epi,
                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (s.pattern) {
    case kStructural:
      return launch_strain_pattern<kStructural>(s, base, add, alive, scale,
                                                epi, st);
    case kShear:
      return launch_strain_pattern<kShear>(s, base, add, alive, scale, epi,
                                           st);
    case kBend:
      return launch_strain_pattern<kBend>(s, base, add, alive, scale, epi,
                                          st);
    case kShearBend:
      return launch_strain_pattern<kShearBend>(s, base, add, alive, scale,
                                               epi, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
