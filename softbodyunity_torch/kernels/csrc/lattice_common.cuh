// Device helpers of the tet-lattice substep kernels (lattice_euler.cu,
// lattice_verlet.cu, lattice_xpbd.cu): the banded springs and the banded
// tet-volume constraint of softbodyunity_torch/solver/banded.py over [3, N]
// component planes (plane stride N).
//
// A lattice's springs fall into a few edge groups, each of one index delta
// d (vertex i owns the edge (i, i + d)), and its tets into a few tet
// groups, each of one corner-delta pattern (d1, d2, d3) (vertex i is the
// base corner of the tet (i, i + d1, i + d2, i + d3)).  bits[i] holds vertex
// i's ownership: bit g for edge group g, bit kTetBit + t for tet group t.
// An edge or tet exists only where its far corners are in range, so a
// thread reads a neighbour only under the owner's bit and needs no wrap
// logic.
//
// No atomics.  Springs: thread i computes every force on vertex i, its own
// edges and, recomputed from the same device function with the owner's
// argument order, the reaction of the edge owned by i - d (the two copies
// are identical).  Tets: each tet is evaluated once, by one thread of a tet
// pass (one thread per tet group and base vertex), which writes its terms
// into float4 scratch planes; a gather (tet_gather) then sums, at each
// vertex, the terms of the tets it is a corner of, in banded.py's order.
//
// Rounding: sqrtf and IEEE divides in the order of banded.py (the divides
// by 6 as div6, which rounds as the divide does); nvcc contracts a * b + c
// into FMAs, so the kernels agree with it to rounding.

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

// x / 6.0f, rounded as the IEEE divide rounds it: the product with the
// rounded reciprocal, then one correction by the exact residual
// (Markstein), the sign copied so that -0 stays -0.  That is the correctly
// rounded quotient wherever |x| is 0 or at least 2^-120 and finite; a
// subnormal quotient can differ, so a smaller nonzero or an infinite x
// takes the divide itself (a branch that real tets never take: exact zeros,
// frequent in an axis-aligned lattice, stay on the product's path).
// tests/test_torch_cuda.py::test_div6_is_the_ieee_quotient_on_card holds
// it to x / 6.0f on all 2^32 floats (through lattice_euler.cu::
// lattice_euler_div6_mismatches).  Ten a tet replace the IEEE divide's
// longer sequence.
__device__ __forceinline__ float div6(float x) {
  const unsigned u = __float_as_uint(x) & 0x7fffffffu;
  if (u - 1u < 0x037fffffu || u == 0x7f800000u) return x / 6.0f;
  constexpr float r = 1.0f / 6.0f;
  const float q = x * r;
  return copysignf(fmaf(fmaf(-q, 6.0f, x), r, q), x);
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
  t.g1 = {div6(c23.x), div6(c23.y), div6(c23.z)};
  t.g2 = {div6(c31.x), div6(c31.y), div6(c31.z)};
  t.g3 = {div6(c12.x), div6(c12.y), div6(c12.z)};
  t.g0 = {-(t.g1.x + t.g2.x + t.g3.x), -(t.g1.y + t.g2.y + t.g3.y),
          -(t.g1.z + t.g2.z + t.g3.z)};
  const float c = div6(dot3(c12, e3)) - rest_vol;
  const float denom = w0 * dot3(t.g0, t.g0) + w1 * dot3(t.g1, t.g1) +
                      w2 * dot3(t.g2, t.g2) + w3 * dot3(t.g3, t.g3);
  t.dlam = -(c + alpha * lam) / fmaxf(denom + alpha, 1e-12f);
  return t;
}

// float4 planes of one tet group in the scratch: (g1, dlam), (g2, dlam),
// (g3, dlam), so that a corner's term is one 16-byte load: [n_tet * 3, N]
// float4, 30.7 MB at 40^3 (10 tet groups).
constexpr int kTetPlanes = 3;

// Write the terms of tet group tg based at vertex i into the scratch.
__device__ __forceinline__ void store_tet_term(float4* __restrict__ tscr,
                                               int tg, int i, int n,
                                               const TetTerm& tt) {
  float4* s = tscr + kTetPlanes * tg * n + i;
  s[0] = make_float4(tt.g1.x, tt.g1.y, tt.g1.z, tt.dlam);
  s[n] = make_float4(tt.g2.x, tt.g2.y, tt.g2.z, tt.dlam);
  s[2 * n] = make_float4(tt.g3.x, tt.g3.y, tt.g3.z, tt.dlam);
}

// The PBD tet pass of lattice_euler.cu and lattice_verlet.cu: thread t
// evaluates tet group t / n at base vertex t % n over the integrated
// positions xs, [3, n], with alpha = lam = 0 (banded.py::
// banded_volume_projection's scale), and writes its terms; zeros where the
// vertex owns no such tet, so that the gather reads every entry without
// the ownership word.  The corners' loads do not wait for that word: a
// corner out of range reads the base vertex, and the result is dropped.
__global__ void __launch_bounds__(256) lattice_tet_kernel(
    const float* __restrict__ xs, const float* __restrict__ inv_mass,
    const unsigned* __restrict__ bits, const float* __restrict__ tets,
    int n_tet, float4* __restrict__ tscr, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int tg = t / n;
  const int i = t - tg * n;
  if (tg >= n_tet) return;
  auto clamp = [&](int j) { return in_range(j, n) ? j : i; };
  const int b1 = clamp(i + static_cast<int>(tets[4 * tg]));
  const int b2 = clamp(i + static_cast<int>(tets[4 * tg + 1]));
  const int b3 = clamp(i + static_cast<int>(tets[4 * tg + 2]));
  TetTerm tt = tet_term(load3(xs, i, n), load3(xs, b1, n), load3(xs, b2, n),
                        load3(xs, b3, n), inv_mass[i], inv_mass[b1],
                        inv_mass[b2], inv_mass[b3], tets[4 * tg + 3], 0.0f,
                        0.0f);
  if (!has_bit(bits[i], kTetBit + tg)) {
    tt.dlam = 0.0f;
    tt.g1 = tt.g2 = tt.g3 = {0.0f, 0.0f, 0.0f};
  }
  store_tet_term(tscr, tg, i, n, tt);
}

// dx plus the volume corrections (w_i dlam) g_k that land on vertex i,
// group by group, from the scratch a tet pass (or lattice_xpbd.cu's
// constraint pass) wrote: as corner 0 of its own tet, g0 = -(g1 + g2 + g3)
// summed as tet_term sums it, then as corner k = 1, 2, 3 of the tet based
// at i - d_k (banded.py::_scatter_corners).  tets is [n_tet, 4] rows of
// (d1, d2, d3, rest volume).  A tet the vertex is no corner of has zero
// terms, which add a signed zero: that leaves dx as skipping it would (a
// sum that starts at +0 never becomes -0), so no ownership word is read.
__device__ __forceinline__ Vec3 tet_gather(Vec3 dx,
                                           const float4* __restrict__ tscr,
                                           const float* __restrict__ tets,
                                           int n_tet, float wi, int i,
                                           int n) {
  for (int t = 0; t < n_tet; ++t) {
    // (dlam, g_k) of the tet based at b; k = 0 gives g0.  k is a constant
    // of each unrolled call, so only g_k is loaded
    auto corner = [&](int b, int k, Vec3& gk) {
      const float4* s = tscr + kTetPlanes * t * n + b;
      Vec3 g1{}, g2{}, g3{};
      float4 q;
      if (k != 2 && k != 3) q = s[0], g1 = {q.x, q.y, q.z};
      if (k != 1 && k != 3) q = s[n], g2 = {q.x, q.y, q.z};
      if (k != 1 && k != 2) q = s[2 * n], g3 = {q.x, q.y, q.z};
      gk = k == 0 ? Vec3{-(g1.x + g2.x + g3.x), -(g1.y + g2.y + g3.y),
                         -(g1.z + g2.z + g3.z)}
                  : (k == 1 ? g1 : (k == 2 ? g2 : g3));
      return q.w;
    };
    Vec3 gk;
    float dlam = corner(i, 0, gk);
    add_scaled(dx, wi * dlam, gk);
#pragma unroll
    for (int k = 1; k <= 3; ++k) {
      const int b = i - static_cast<int>(tets[4 * t + k - 1]);
      if (!in_range(b, n)) continue;
      dlam = corner(b, k, gk);
      add_scaled(dx, wi * dlam, gk);
    }
  }
  return dx;
}

}  // namespace
