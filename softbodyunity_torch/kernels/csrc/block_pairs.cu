// Block-sparse self-collision pair forces for Hopper (sm_90a).  Built by
// softbodyunity_torch/kernels/build.py, wrapped by
// softbodyunity_torch/kernels/blocks.py; its plain PyTorch versions are
// softbodyunity_torch/solver/blocksparse.py::self_collision_forces_block and
// ::self_collision_forces_block_dual.
//
// Replaces the TPU kernel softbodyunity_tpu/kernels/pallas_blocks.py
// ::_make_kernel, launched by ::_block_pairs_pallas through pl.pallas_call:
// for every Morton tile i of the sorted vertices and each of its first
// nvalid[i] partner tiles p, the repulsion of every vertex of tile i from
// every vertex of tile p,
//   f_i += w(d) (x_i - x_j),  w = max(k r / d - k, 0),  d = sqrt(max(d2, eps2)),
// which is k (r - d) / d for d < r and 0 beyond.  It also replaces the dual
// form, ::_block_pairs_dual_pallas (TPU kernel #11), which the row-sharded
// halo paths run (softbodyunity_tpu/parallel/halo.py::_self_collision_rows):
// the i-tiles are the Morton tiles of one rank's rows, the partner tiles
// those of the whole gathered cloth, two arrays in place of one.  The
// kernel body is the same; the single form passes one array as both.
// The Morton sort, the bounding-box partner search and the far-coordinate
// padding stay in PyTorch (solver/blocksparse.py), as they stay in XLA on
// the TPU.
//
// Design.  The TPU kernel is one program that walks all tiles in order with
// the whole tile array in VMEM.  Here a CTA of blk threads (one per vertex of
// tile i) takes a chunk of `chunk` consecutive partners of tile i: grid
// (B, ceil(K / chunk)), where K is the partner budget.  Per partner it stages
// the partner tile in shared memory as float4 (x, y, z, 0), one broadcast
// 16-byte load a pair, and every thread sweeps its partner vertices,
// accumulating w dx in registers.  CTAs whose chunk starts at or past
// nvalid[i] exit at once, so the work follows the sum of the interacting
// partners, not B x K.  Splitting a tile's partners over CTAs spreads a
// crowded tile (a 64k pile has tiles with ~70 partners against a mean of
// ~8) over many SMs.  Each thread loads its vertex of the next partner
// tile into registers before it sweeps the current one, so the load is in
// flight during the sweep (67 against 85 us on the 64k pile on an H100,
// PERF.md §6).
//
// The cull.  Only a few percent of the pairs of two interacting tiles lie
// within the radius, and a pair out of reach costs as much as one in it.
// So each warp (32 i-vertices) takes the bounding box of its vertices once
// (warp_box: __shfl_xor_sync min and max), and when a partner tile is
// staged each warp reduces the box of the 32-vertex slice it staged into
// shared memory; a warp then sweeps only the slices whose box gap to its
// own, squared, is at most reach2 = r^2 (1 + 2^-10).  The test is one per
// warp and slice, taken by the warp's 32 lanes together, against 32 x 32
// pair evaluations.  A box takes in the tiles' pads (+-1e6), so a warp or
// slice with a pad in it is swept as before; a non-finite coordinate makes
// its box infinite, so such a warp or slice never skips (the dense sweep's
// NaN stays).
//
// Why the cull is exact to the bit.  Rounding is monotone, so a pair (a, b)
// of two boxes has |fl(a_x - b_x)| >= the box gap fl(lo - hi) on every axis,
// and its d2 is at least the gap's squared sum to within a few float32
// roundings (well under 2^-20 relative); reach2 is 2^-10 above r^2, so a
// skipped pair has d2 > r^2 (1 + 2^-11).  There w == 0 exactly: c1
// rsqrtf(d2) - c2 = k (r rsqrtf(d2) - 1) up to the rounding of c1, c2 and
// rsqrtf's 2 ulps (~2^-21 relative), which is negative, so the max gives
// +0.  A skipped term w dx is then +0 or -0, and the running sum, which
// starts at +0 and under round-to-nearest is never -0, is unchanged by it:
// dropping those terms from an otherwise unchanged (partner, j) order
// leaves every output bit as the dense sweep's.  That needs stiffness >= 0
// (the wrapper refuses less).
//
// Determinism without atomics on the data: a tile with one chunk writes its
// forces directly; otherwise each chunk writes its partial sums to a scratch
// row, and the CTA that finishes last (a per-tile arrival counter) adds the
// rows in chunk order 0, 1, ... and writes the result.  The counter only
// elects that CTA, and resets itself for the next launch, so the sum and
// its rounding are the same on every run.  The result is written in vertex
// order through the sort permutation `order` (each vertex once), into
// [3, N] component planes: the grid kernels' force-plane input (the dual
// form: the rank's [3, ni] planes, through its own rows' permutation).
//
// Self pairs are not masked: a vertex meeting itself has dx exactly 0 and a
// finite w (the eps2 clamp), so it adds exactly 0.  Padded tile slots enter
// at +1e6: their distance to every real vertex exceeds r, so w = 0; their
// own rows are never written.  In the dual form the i-tiles' pads sit at
// -1e6 and the partner tiles' at +1e6, so pad meets pad 2e6 apart, as in
// the TPU kernel; either way w = 0 or dx = 0.  Built without fast-math, so
// 0 * w stays 0.
//
// What bounds it.  A pair costs ~16 operations (3 differences, the squared
// norm, max, rsqrt, w, three multiply-adds), so the dense sweep needs about
// 16 x 256^2 x sum(nvalid) operations: ~2.2 G at the 64k preset's ~2,100
// interacting tile pairs, ~33 us at the float32 peak, and it reads each
// tile once (0.8 MB at 64k): bound by operations.  After the cull the
// operations are those of the kept 32 x 32 sub-blocks
// (kernels/blocks.py::kept_sub_blocks counts them), plus the box tests.
//
// Rounding.  rsqrtf (as the TPU kernel's lax.rsqrt) and a sum in (partner,
// vertex) order: the plain version sums the other way and divides, so the
// two agree to rounding (tested at atol 5e-4, rtol 1e-3).

#include <cuda_runtime.h>

namespace {

// The bounding box of the 32 lanes' points (x, y, z), on every lane: lo
// and hi; a point with a non-finite coordinate makes the box infinite.
__device__ __forceinline__ void warp_box(float x, float y, float z,
                                         float4& lo, float4& hi) {
  const float kInf = __int_as_float(0x7f800000);
  const bool finite = isfinite(x) && isfinite(y) && isfinite(z);
  lo = finite ? make_float4(x, y, z, 0.0f)
              : make_float4(-kInf, -kInf, -kInf, 0.0f);
  hi = finite ? make_float4(x, y, z, 0.0f)
              : make_float4(kInf, kInf, kInf, 0.0f);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    lo.x = fminf(lo.x, __shfl_xor_sync(0xffffffffu, lo.x, m));
    lo.y = fminf(lo.y, __shfl_xor_sync(0xffffffffu, lo.y, m));
    lo.z = fminf(lo.z, __shfl_xor_sync(0xffffffffu, lo.z, m));
    hi.x = fmaxf(hi.x, __shfl_xor_sync(0xffffffffu, hi.x, m));
    hi.y = fmaxf(hi.y, __shfl_xor_sync(0xffffffffu, hi.y, m));
    hi.z = fmaxf(hi.z, __shfl_xor_sync(0xffffffffu, hi.z, m));
  }
}

// The squared gap between the boxes (lo_a, hi_a) and (lo_b, hi_b): 0 on an
// axis where they overlap.
__device__ __forceinline__ float box_gap2(float4 lo_a, float4 hi_a,
                                          float4 lo_b, float4 hi_b) {
  const float gx = fmaxf(fmaxf(lo_b.x - hi_a.x, lo_a.x - hi_b.x), 0.0f);
  const float gy = fmaxf(fmaxf(lo_b.y - hi_a.y, lo_a.y - hi_b.y), 0.0f);
  const float gz = fmaxf(fmaxf(lo_b.z - hi_a.z, lo_a.z - hi_b.z), 0.0f);
  return gx * gx + gy * gy + gz * gz;
}

__global__ void __launch_bounds__(1024) block_pairs_kernel(
    const float* __restrict__ xi_tiles,     // [B, 3, blk]: the i-tiles
    const float* __restrict__ xj_tiles,     // [Bj, 3, blk]: partner tiles
    const long long* __restrict__ nvalid,   // [B] interacting partners
    const long long* __restrict__ partners, // [B, >= K] ids into xj_tiles,
    int p_stride,                           //   row stride p_stride
    const long long* __restrict__ order,    // [N] sorted i slot -> vertex
    int n, int n_tiles, int chunk, int blk, float* __restrict__ partial,
    int* __restrict__ arrivals, float* __restrict__ f_out,   // [3, N]
    float eps2, float c1, float c2, float reach2) {
  extern __shared__ float4 smem[];
  float4* sj = smem;                        // [blk]: the partner tile
  float4* sbox = smem + blk;                // [blk / 32][2]: slice boxes
  __shared__ bool last;
  const int i = blockIdx.x;
  const int s = blockIdx.y;
  const int l = threadIdx.x;
  const int warp = l >> 5, n_slices = blk >> 5;
  const int nv = static_cast<int>(nvalid[i]);
  const int n_chunks = nv > 0 ? (nv + chunk - 1) / chunk : 1;
  if (s >= n_chunks) return;                // uniform over the CTA

  const float* xi_tile = xi_tiles + static_cast<size_t>(i) * 3 * blk;
  const float xi0 = xi_tile[l], xi1 = xi_tile[blk + l],
              xi2 = xi_tile[2 * blk + l];
  float4 lo, hi;                            // this warp's box
  warp_box(xi0, xi1, xi2, lo, hi);
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  const int k_end = min(s * chunk + chunk, nv);
  // vertex l of partner k into (x0, x1, x2)
  float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f;
  auto fetch = [&](int k) {
    const long long pk = partners[static_cast<size_t>(i) * p_stride + k];
    const float* xp = xj_tiles + static_cast<size_t>(pk) * 3 * blk;
    x0 = xp[l];
    x1 = xp[blk + l];
    x2 = xp[2 * blk + l];
  };
  if (s * chunk < k_end) fetch(s * chunk);
  for (int k = s * chunk; k < k_end; ++k) {
    __syncthreads();                        // the last sweep is done with sj
    sj[l] = make_float4(x0, x1, x2, 0.0f);
    float4 slo, shi;                        // the box of this warp's slice
    warp_box(x0, x1, x2, slo, shi);
    if ((l & 31) == 0) {
      sbox[2 * warp] = slo;
      sbox[2 * warp + 1] = shi;
    }
    __syncthreads();
    if (k + 1 < k_end) fetch(k + 1);        // in flight during the sweep
    for (int c = 0; c < n_slices; ++c) {
      // warp-uniform: a slice out of reach holds only pairs with w == 0
      if (box_gap2(lo, hi, sbox[2 * c], sbox[2 * c + 1]) > reach2) continue;
      const float4* sc = sj + 32 * c;
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const float4 q = sc[j];
        const float dx = xi0 - q.x;
        const float dy = xi1 - q.y;
        const float dz = xi2 - q.z;
        const float d2 = dx * dx + dy * dy + dz * dz;
        const float w = fmaxf(c1 * rsqrtf(fmaxf(d2, eps2)) - c2, 0.0f);
        ax += w * dx;
        ay += w * dy;
        az += w * dz;
      }
    }
  }

  const int row = i * blk + l;              // this thread's sorted slot
  if (n_chunks > 1) {
    // partial sums out; the last CTA of tile i to arrive adds them in order
    const size_t ps = static_cast<size_t>(n_tiles) * 3 * blk;
    float* mine = partial + s * ps + static_cast<size_t>(i) * 3 * blk;
    mine[l] = ax;
    mine[blk + l] = ay;
    mine[2 * blk + l] = az;
    __threadfence();                        // partials visible device-wide
    __syncthreads();
    if (l == 0) last = atomicAdd(&arrivals[i], 1) == n_chunks - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    ax = ay = az = 0.0f;
    for (int c = 0; c < n_chunks; ++c) {
      const float* src = partial + c * ps + static_cast<size_t>(i) * 3 * blk;
      ax += __ldcg(src + l);
      ay += __ldcg(src + blk + l);
      az += __ldcg(src + 2 * blk + l);
    }
    if (l == 0) arrivals[i] = 0;            // ready for the next launch
  }
  if (row < n) {
    const long long v = order[row];
    f_out[v] = ax;
    f_out[n + v] = ay;
    f_out[2 * static_cast<size_t>(n) + v] = az;
  }
}

}  // namespace

// Launch the pair forces on the n vertices of the i-tiles from the partner
// tiles on `stream` (the single form: the same tiles twice, pads at +1e6);
// returns the cudaError_t of the launch (0 = cudaSuccess).  `partial` holds
// ceil(k_budget / chunk) x n_tiles x 3 x blk floats; `arrivals` n_tiles
// ints, zero before the first launch (each launch leaves them zero), so a
// scratch serves one launch at a time.  reach2 is the cull's squared reach,
// r^2 (1 + 2^-10).  Allocates nothing and does not synchronise.
extern "C" int block_pairs_dual_forces(
    const float* xi_tiles, const float* xj_tiles, const long long* nvalid,
    const long long* partners, int p_stride, const long long* order, int n,
    int n_tiles, int k_budget, int chunk, int blk, float* partial,
    int* arrivals, float* f_out, float eps2, float c1, float c2,
    float reach2, void* stream) {
  const dim3 grid(n_tiles, (k_budget + chunk - 1) / chunk);
  const size_t smem = (static_cast<size_t>(blk) + 2 * (blk / 32)) *
                      sizeof(float4);
  block_pairs_kernel<<<grid, blk, smem, static_cast<cudaStream_t>(stream)>>>(
      xi_tiles, xj_tiles, nvalid, partners, p_stride, order, n, n_tiles,
      chunk, blk, partial, arrivals, f_out, eps2, c1, c2, reach2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* block_pairs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
