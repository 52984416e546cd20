// Device helpers of the tet-lattice substep kernels (lattice_euler.cu,
// lattice_verlet.cu, lattice_xpbd.cu): the banded springs and the banded
// tet-volume constraint of softbodyunity_torch/solver/banded.py, one thread
// per vertex of [3, N] component planes (plane stride N).
//
// A lattice's springs fall into a few edge groups, each of one index delta
// d (vertex i owns the edge (i, i + d)), and its tets into a few tet
// groups, each of one corner-delta pattern (d1, d2, d3) (vertex i is the
// base corner of the tet (i, i + d1, i + d2, i + d3)).  bits[i] holds vertex
// i's ownership: bit g for edge group g, bit kTetBit + t for tet group t.
// An edge or tet exists only where its far corners are in range, so a
// thread reads a neighbour only under the owner's bit and needs no wrap
// logic; a constraint whose bit is clear is skipped, not multiplied by 0.
//
// No atomics: thread i computes every term that lands on vertex i, its own
// edges and tets and, recomputed from the same device function with the
// owner's argument order, the reaction of the edge owned by i - d and its
// share as corner k of the tet based at i - d_k.  The two copies of a term
// are identical; the tet arithmetic runs about 4x.
//
// Rounding: sqrtf and IEEE divides in the order of banded.py; nvcc
// contracts a * b + c into FMAs, so the kernels agree with it to rounding.

#pragma once

#include "grid_common.cuh"

namespace {

// Bit of tet group t in a vertex's ownership word; edge groups take bits
// 0..15 (softbodyunity_torch/kernels/lattice.py packs at most 16 of each).
constexpr int kTetBit = 16;

__device__ __forceinline__ bool has_bit(unsigned bits, int b) {
  return (bits >> b) & 1u;
}

__device__ __forceinline__ bool in_range(int j, int n) {
  return j >= 0 && j < n;
}

// f + drag (velocity - v): the wind's drag (solver/step.py::wind_drag; the
// lattice kernels run no lift, grid_common.cuh::Wind's lift is unused).
__device__ __forceinline__ Vec3 add_drag(Vec3 f, Vec3 v, const Wind& w) {
  return {f.x + w.drag * (w.vx - v.x), f.y + w.drag * (w.vy - v.y),
          f.z + w.drag * (w.vz - v.z)};
}

__device__ __forceinline__ void add_scaled(Vec3& acc, float s, Vec3 g) {
  acc.x += s * g.x;
  acc.y += s * g.y;
  acc.z += s * g.z;
}

// Hooke + axial damper force on endpoint a of the edge a -> b, toward b
// (banded.py::banded_spring_forces: the unit direction is d / max(len,
// 1e-12), a divide).
__device__ __forceinline__ Vec3 banded_edge_force(Vec3 xa, Vec3 va, Vec3 xb,
                                                  Vec3 vb, float k,
                                                  float rest, float damping) {
  const Vec3 d = {xb.x - xa.x, xb.y - xa.y, xb.z - xa.z};
  const float len = sqrtf(dot3(d, d));
  const float m = fmaxf(len, 1e-12f);
  const Vec3 n = {d.x / m, d.y / m, d.z / m};
  const float rel =
      (vb.x - va.x) * n.x + (vb.y - va.y) * n.y + (vb.z - va.z) * n.z;
  const float fmag = k * (len - rest) + damping * rel;
  return {fmag * n.x, fmag * n.y, fmag * n.z};
}

// Spring force on vertex i, group by group: the edge it owns (+) and the
// reaction of the edge owned by i - d (-).  edges is [n_edge, 3] rows of
// (delta, k, rest); vel(j) is vertex j's velocity (Euler: v, Verlet: the
// estimate (x - xp) / dt).
template <class Vel>
__device__ __forceinline__ Vec3 banded_spring_sum(
    const float* __restrict__ x, Vel vel, const unsigned* __restrict__ bits,
    const float* __restrict__ edges, int n_edge, float damping, int i, int n,
    Vec3 xi, Vec3 vi) {
  const unsigned bi = bits[i];
  float fx = 0.0f, fy = 0.0f, fz = 0.0f;
  for (int g = 0; g < n_edge; ++g) {
    const int d = static_cast<int>(edges[3 * g]);
    const float k = edges[3 * g + 1];
    const float rest = edges[3 * g + 2];
    if (has_bit(bi, g)) {
      const int nb = i + d;
      const Vec3 e = banded_edge_force(xi, vi, load3(x, nb, n), vel(nb), k,
                                       rest, damping);
      fx += e.x;
      fy += e.y;
      fz += e.z;
    }
    const int o = i - d;
    if (in_range(o, n) && has_bit(bits[o], g)) {
      const Vec3 e = banded_edge_force(load3(x, o, n), vel(o), xi, vi, k,
                                       rest, damping);
      fx -= e.x;
      fy -= e.y;
      fz -= e.z;
    }
  }
  return {fx, fy, fz};
}

// Volume constraint of the tet (p0, p1, p2, p3) with inverse masses w0..w3:
// its gradients g0..g3 and its multiplier change
//   dlam = -(C + alpha lam) / max(sum_k w_k |g_k|^2 + alpha, 1e-12),
// C = vol - rest_vol (banded.py::_tet_gradients, _tet_denominator).  With
// alpha = lam = 0 this is the PBD scale of banded_volume_projection.
struct TetTerm {
  Vec3 g0, g1, g2, g3;
  float dlam;
};

__device__ __forceinline__ TetTerm tet_term(Vec3 p0, Vec3 p1, Vec3 p2,
                                            Vec3 p3, float w0, float w1,
                                            float w2, float w3,
                                            float rest_vol, float alpha,
                                            float lam) {
  const Vec3 e1 = {p1.x - p0.x, p1.y - p0.y, p1.z - p0.z};
  const Vec3 e2 = {p2.x - p0.x, p2.y - p0.y, p2.z - p0.z};
  const Vec3 e3 = {p3.x - p0.x, p3.y - p0.y, p3.z - p0.z};
  const Vec3 c23 = cross3(e2, e3), c31 = cross3(e3, e1), c12 = cross3(e1, e2);
  TetTerm t;
  t.g1 = {c23.x / 6.0f, c23.y / 6.0f, c23.z / 6.0f};
  t.g2 = {c31.x / 6.0f, c31.y / 6.0f, c31.z / 6.0f};
  t.g3 = {c12.x / 6.0f, c12.y / 6.0f, c12.z / 6.0f};
  t.g0 = {-(t.g1.x + t.g2.x + t.g3.x), -(t.g1.y + t.g2.y + t.g3.y),
          -(t.g1.z + t.g2.z + t.g3.z)};
  const float c = dot3(c12, e3) / 6.0f - rest_vol;
  const float denom = w0 * dot3(t.g0, t.g0) + w1 * dot3(t.g1, t.g1) +
                      w2 * dot3(t.g2, t.g2) + w3 * dot3(t.g3, t.g3);
  t.dlam = -(c + alpha * lam) / fmaxf(denom + alpha, 1e-12f);
  return t;
}

// The tet of group t based at vertex b; pos(j) is vertex j's position.
template <class Pos>
__device__ __forceinline__ TetTerm tet_at(Pos pos,
                                          const float* __restrict__ w,
                                          const float* __restrict__ tets,
                                          int t, int b, float alpha,
                                          float lam) {
  const int d1 = static_cast<int>(tets[4 * t]);
  const int d2 = static_cast<int>(tets[4 * t + 1]);
  const int d3 = static_cast<int>(tets[4 * t + 2]);
  return tet_term(pos(b), pos(b + d1), pos(b + d2), pos(b + d3), w[b],
                  w[b + d1], w[b + d2], w[b + d3], tets[4 * t + 3], alpha,
                  lam);
}

// dx plus the volume corrections (w_i dlam) g_k that land on vertex i,
// group by group: as corner 0 of its own tet, then as corner k = 1, 2, 3 of
// the tet based at i - d_k (banded.py::_scatter_corners).  tets is
// [n_tet, 4] rows of (d1, d2, d3, rest volume).  PBD passes alpha = 0 and
// no lambda planes.  XPBD passes lam_in, the [n_tet, N] lambda planes of
// the sweep, and lam_out, where vertex i's own updated lambdas go.
template <class Pos>
__device__ __forceinline__ Vec3 banded_tet_sum(
    Vec3 dx, Pos pos, const float* __restrict__ w,
    const unsigned* __restrict__ bits, const float* __restrict__ tets,
    int n_tet, float alpha, const float* __restrict__ lam_in,
    float* __restrict__ lam_out, int i, int n) {
  const unsigned bi = bits[i];
  const float wi = w[i];
  for (int t = 0; t < n_tet; ++t) {
    const int bit = kTetBit + t;
    float lam = lam_in ? lam_in[t * n + i] : 0.0f;
    if (has_bit(bi, bit)) {
      const TetTerm tt = tet_at(pos, w, tets, t, i, alpha, lam);
      lam += tt.dlam;
      add_scaled(dx, wi * tt.dlam, tt.g0);
    }
    if (lam_out) lam_out[t * n + i] = lam;
    for (int k = 1; k <= 3; ++k) {
      const int b = i - static_cast<int>(tets[4 * t + k - 1]);
      if (!(in_range(b, n) && has_bit(bits[b], bit))) continue;
      const TetTerm tt =
          tet_at(pos, w, tets, t, b, alpha, lam_in ? lam_in[t * n + b] : 0.0f);
      add_scaled(dx, wi * tt.dlam, k == 1 ? tt.g1 : (k == 2 ? tt.g2 : tt.g3));
    }
  }
  return dx;
}

}  // namespace
