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
// The Morton sort, the tiles and the bounding-box partner search, which
// XLA runs around the Pallas kernel on the TPU, run here as the kernels of
// "The build" below, launched with the pair kernel from one C call
// (block_pairs_build_forces); their plain versions, bit for bit, are
// solver/blocksparse.py::_sorted_tiles and ::_tile_partners.
//
// Design.  The TPU kernel is one program that walks all tiles in order with
// the whole tile array in VMEM.  Here a CTA of blk threads (one per vertex of
// tile i) takes a chunk of `chunk` (at most kMaxChunk) consecutive partners
// of tile i: grid (B, ceil(K / chunk)), where K is the partner budget.  It
// stages the whole chunk once, each partner tile in shared memory as float4
// (x, y, z, far), one broadcast 16-byte load a pair, with the box of each
// 32-vertex slice, and then passes one barrier; after it each warp sweeps
// the chunk on its own, accumulating w dx in registers, and no warp waits
// at any partner for the busiest one.  CTAs whose chunk starts at or past
// nvalid[i] exit at once, so the work follows the sum of the interacting
// partners, not B x K.  Splitting a tile's partners over CTAs spreads a
// crowded tile (a 64k pile has tiles with ~80 partners against a median of
// ~25) over many SMs.  The chunk's 4 x 256 vertices are 16 KB.
//
// The cull.  Only a few tenths of a percent of the pairs of two interacting
// tiles lie within the radius, and a pair out of reach costs as much as one
// in it.  So each warp (32 i-vertices) takes the bounding box of its
// vertices once (warp_box: __shfl_xor_sync min and max) and narrows what
// it sweeps in three steps, each under reach2 = r^2 (1 + 2^-10):
//   1. the slices: lane b tests the box of slice b of the chunk (32
//      vertices of a partner tile; (partner, slice) order, 32 at a time)
//      against the warp's box, and __ballot_sync gives the slices kept;
//   2. in a kept slice, its vertices: lane t tests partner vertex t of the
//      slice as a point against the warp's box (point_gap2), and a ballot
//      gives the vertices kept, `m`;
//   3. the pairs: each lane takes the squared distance from its own vertex
//      to the vertices kept (all 32 in straight-line code where more than
//      kDenseSlice are kept, else only the kept ones), a bit for each at
//      most reach2, and then adds the full pair term of its set bits alone,
//      in ascending order (__ffs, then the lowest bit cleared), with the
//      dense sweep's code.
// The warp walks the kept slices of all its partners in order, so a warp
// that reaches little is done early.  Most kept pairs are out of reach: in
// the 64k pile a step-3 test costs about half a full pair term and no
// rsqrtf.  A partner vertex with a coordinate that is not finite or is at
// least 2^126 in magnitude (flagged `far` in the staged float4) is never
// skipped in a kept slice, and a lane whose own vertex is far sweeps every
// vertex step 2 kept (its warp keeps every vertex of its kept slices):
// every difference the sweep leaves out is then finite.  A box takes in
// the tiles' pads (+-1e6), so a warp or slice with a pad in it is tested as
// any other.  The dense instantiation (kCull false; launched only by
// block_pairs_sweep, for the tests and chip_smoke.py) sweeps every pair.
//
// Why the cull is exact to the bit.  Rounding is monotone, so a pair (a, b)
// drawn from two boxes (or a box and a point, a degenerate box) has
// |fl(a_x - b_x)| >= the gap fl(lo - hi) on every axis, and its d2 is at
// least the gap's squared sum to within a few float32 roundings (well under
// 2^-20 relative); step 3 forms d2 itself.  reach2 is 2^-10 above r^2, so
// a skipped pair has d2 > r^2 (1 + 2^-11).  There w == 0 exactly: c1
// rsqrtf(d2) - c2 = k (r rsqrtf(d2) - 1) up to the rounding of c1, c2 and
// rsqrtf's 2 ulps (~2^-21 relative), which is negative, so the max gives
// +0.  A skipped term w dx, dx finite, is then +0 or -0, and the running
// sum, which starts at +0 and under round-to-nearest is never -0, is
// unchanged by it: dropping those terms from an otherwise unchanged
// (chunk, partner, slice, j) order leaves every output bit as the dense
// sweep's, and as those of the slice test alone.  That needs stiffness >=
// 0 (the wrapper refuses less).
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
// 16 x 256^2 x sum(nvalid) operations: ~7 G at the 64k pile's ~6,600
// interacting tile pairs, ~100 us at the float32 peak, and it reads each
// tile once (0.8 MB at 64k): bound by operations.  After the cull the
// operations are step 3's squared distances, 32 for each partner vertex a
// warp keeps (kernels/blocks.py::kept_partner_vertices counts them), the
// full terms of the pairs within reach2 (~1 % of those), the slice boxes,
// the slice tests and a point test per vertex of each kept slice.  What
// holds it above that is the crowded chunks: a chunk whose four partners
// overlap its tile keeps nearly every slice and vertex, and its CTA runs
// several times the median's length.
//
// Rounding.  rsqrtf (as the TPU kernel's lax.rsqrt) and a sum in (partner,
// vertex) order: the plain version sums the other way and divides, so the
// two agree to rounding (tested at atol 5e-4, rtol 1e-3).
//
// Counting.  The kCount instantiation, launched only while the program's
// recorder is on (softbodyunity_torch/utils/profiling.py), also adds up
// what the sweep met, into int64 `counters` (the order of Counter below):
// each warp its sub-block pairs, those it kept and the partner vertices it
// kept in them (32 pairs to step 3 each), each lane its pairs with w > 0, each
// CTA its partners, and CTA (i, 0) the interacting tiles of row i of the
// partner search (`interact`) past its nvalid[i], the tile pairs the
// partner budget dropped.  Warps add into shared memory, and thread 0 of
// each CTA adds the CTA's sums with one atomic per counter.  The counts sit
// beside the arithmetic, never in it, so the forces are the plain
// instantiation's to the bit.
//
// The build.  Each substep the pair kernel's inputs are built on the card,
// from the positions where they lie (any strides: the grid paths pass their
// [3, ny, nx] planes transposed), on the caller's stream and with nothing
// synchronised, in four steps a side (the dual form sorts both):
//   1. axis_min_kernel: the per-axis minimum, a NaN winning as in
//      torch.amin, each CTA's from warp shuffles into a partial row and the
//      CTA that arrives last (a counter it resets for the next launch)
//      reducing the rows: origin = min - h, h = float(0.5 cell_size) as
//      torch rounds the Python scalar;
//   2. morton_keys_kernel: each vertex's 30-bit Morton key and its index,
//      as solver/blocksparse.py::morton_ids computes them on the card: an
//      IEEE subtract and divide (intrinsics, so no FMA forms), floorf, the
//      float-to-int32 conversion that torch's .to(torch.int32) compiles to
//      (cvt.rzi: saturating, NaN to 0), the clamp to [0, 1023];
//   3. cub::DeviceRadixSort::SortPairs over the 30 key bits, stable as
//      torch.argsort(stable=True) is, so the order is the plain one's to
//      the bit (a 64k pile holds ~1,000 vertices a Morton cell: the tie
//      order alone decides which share a tile);
//   4. gather_tiles_kernel: a CTA a tile and a thread a tile vertex, x in
//      sorted order into the [B, 3, blk] tiles with the tail at the pad
//      (+1e6; the dual form's i-tiles -1e6), the permutation as int64, and
//      the tile's box over its valid vertices, padded as _tile_partners
//      pads (+-1e18); min and max are exact, so the box is the plain amin
//      and amax but for the sign of a zero, which the gap's squares drop;
// then, once,
//   5. tile_partners_kernel: a CTA an i-tile, its threads over the partner
//      tiles in chunks of up to 1,024: the box gap per axis (a NaN wins, as
//      in torch.maximum and clamp_min), its squares summed in the plain
//      version's order with __fmul_rn / __fadd_rn, against r^2 rounded to
//      float32 as torch rounds the Python scalar; a CTA-wide count of the
//      interacting tiles, then a second sweep places them first, in
//      ascending order, then the rest: the stable argsort's row, all K
//      columns; nvalid = min(count, K).  The counting instantiation also
//      writes the row of interacting tiles that the counting
//      block_pairs_kernel reads for the pairs the budget dropped;
//   6. block_pairs_kernel, as above (block_pairs_sweep launches it alone).
// They are bound by their number, not their bytes: a 64k side reads its
// 768 KB of positions twice and moves ~2 MB of keys, values and tiles,
// under 2 us at 3.35 TB/s.  The wrapper (kernels/blocks.py::_pair_launch)
// allocates every buffer once, CUB's temporary storage sized by
// block_pairs_sort_bytes.

#include <cuda_runtime.h>

#include <algorithm>
#include <cub/device/device_radix_sort.cuh>

namespace {

enum Counter {
  kSubBlocks,          // 32 x 32 sub-block pairs of the partners swept
  kSubBlocksKept,      // those the slice test kept
  kPairsSwept,         // vertex pairs swept (kept partner vertices x 32)
  kPairsInReach,       // of those, pairs with w > 0: within the radius
  kPartnersSwept,      // partner tiles swept, the sum of nvalid
  kTilePairsDropped,   // interacting tile pairs past the partner budget
  kPartnerVerticesKept,  // partner vertices the point test kept, a warp each
  kCounters
};

// Partner tiles a CTA stages at most (kernels/blocks.py::CHUNK).
constexpr int kMaxChunk = 4;
// A kept slice with more kept vertices than this has each lane test all 32
// in straight-line code; one with fewer, only the kept ones.
constexpr int kDenseSlice = 12;
// A coordinate at least this large in magnitude, or not finite, is `far`:
// a difference of two coordinates below it is finite.
constexpr float kFar = 0x1p126f;

__device__ __forceinline__ bool far_point(float x, float y, float z) {
  return !(fabsf(x) < kFar && fabsf(y) < kFar && fabsf(z) < kFar);
}

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

// box_gap2 of the box (lo, hi) and the point q, each product and sum
// rounded on its own (no FMA), as kernels/blocks.py::kept_partner_vertices
// computes it.
__device__ __forceinline__ float point_gap2(float4 lo, float4 hi, float4 q) {
  const float gx = fmaxf(fmaxf(q.x - hi.x, lo.x - q.x), 0.0f);
  const float gy = fmaxf(fmaxf(q.y - hi.y, lo.y - q.y), 0.0f);
  const float gz = fmaxf(fmaxf(q.z - hi.z, lo.z - q.z), 0.0f);
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                   __fmul_rn(gz, gz));
}

template <bool kCount, bool kCull>
__global__ void __launch_bounds__(1024) block_pairs_kernel(
    const float* __restrict__ xi_tiles,     // [B, 3, blk]: the i-tiles
    const float* __restrict__ xj_tiles,     // [Bj, 3, blk]: partner tiles
    const long long* __restrict__ nvalid,   // [B] interacting partners
    const long long* __restrict__ partners, // [B, >= K] ids into xj_tiles,
    int p_stride,                           //   row stride p_stride
    const long long* __restrict__ order,    // [N] sorted i slot -> vertex
    int n, int n_tiles, int chunk, int blk, float* __restrict__ partial,
    int* __restrict__ arrivals, float* __restrict__ f_out,   // [3, N]
    float eps2, float c1, float c2, float reach2,
    unsigned long long* __restrict__ counters,   // kCount: [kCounters]
    const bool* __restrict__ interact,      // kCount: [B, >= Bj] rows,
    int i_stride, int n_j_tiles) {          //   row stride i_stride
  extern __shared__ float4 smem[];
  const int n_slices = blk >> 5;
  float4* sj = smem;                        // [chunk, blk]: partner tiles
  float4* sbox = smem + chunk * blk;        // [chunk, blk / 32, 2]: boxes
  __shared__ bool last;
  const int i = blockIdx.x;
  const int s = blockIdx.y;
  const int l = threadIdx.x;
  const int lane = l & 31, warp = l >> 5;
  const int nv = static_cast<int>(nvalid[i]);
  const int n_chunks = nv > 0 ? (nv + chunk - 1) / chunk : 1;
  if (s >= n_chunks) return;                // uniform over the CTA
  __shared__ unsigned int cnt[kCounters];   // kCount: this CTA's sums
  unsigned int kept = 0, kept_v = 0, in_reach = 0;  // kCount: warp's, lane's
  if constexpr (kCount) {
    if (l < kCounters) cnt[l] = 0;          // before the staging barrier
  }

  const float* xi_tile = xi_tiles + static_cast<size_t>(i) * 3 * blk;
  const float xi0 = xi_tile[l], xi1 = xi_tile[blk + l],
              xi2 = xi_tile[2 * blk + l];
  float4 lo, hi;                            // this warp's box
  warp_box(xi0, xi1, xi2, lo, hi);
  // a warp with a far vertex keeps every vertex of the slices it keeps,
  // and its far lanes sweep them all
  const bool far_i = far_point(xi0, xi1, xi2);
  const bool far_warp = __any_sync(0xffffffffu, far_i);

  // Stage the chunk: vertex l of each of its n_k partner tiles, all loads
  // issued before the first is used, then each warp's slice boxes.
  const int k0 = s * chunk, n_k = min(chunk, nv - k0);
  float xp[kMaxChunk][3];
#pragma unroll
  for (int t = 0; t < kMaxChunk; ++t) {
    if (t < n_k) {
      const long long pk = partners[static_cast<size_t>(i) * p_stride + k0 + t];
      const float* src = xj_tiles + static_cast<size_t>(pk) * 3 * blk;
      xp[t][0] = src[l];
      xp[t][1] = src[blk + l];
      xp[t][2] = src[2 * blk + l];
    }
  }
#pragma unroll
  for (int t = 0; t < kMaxChunk; ++t) {
    if (t < n_k) {                          // uniform over the CTA
      sj[t * blk + l] = make_float4(
          xp[t][0], xp[t][1], xp[t][2],
          far_point(xp[t][0], xp[t][1], xp[t][2]) ? 1.0f : 0.0f);
      if constexpr (kCull) {
        float4 slo, shi;                    // the box of this warp's slice
        warp_box(xp[t][0], xp[t][1], xp[t][2], slo, shi);
        if (lane == 0) {
          sbox[2 * (t * n_slices + warp)] = slo;
          sbox[2 * (t * n_slices + warp) + 1] = shi;
        }
      }
    }
  }
  __syncthreads();                          // the sweep's only barrier

  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  auto pair = [&](const float4 q) {
    const float dx = xi0 - q.x;
    const float dy = xi1 - q.y;
    const float dz = xi2 - q.z;
    const float d2 = dx * dx + dy * dy + dz * dz;
    const float w = fmaxf(c1 * rsqrtf(fmaxf(d2, eps2)) - c2, 0.0f);
    ax += w * dx;
    ay += w * dy;
    az += w * dz;
    if constexpr (kCount) in_reach += w > 0.0f;
  };
  // whether the pair with q may have w != 0: its d2 is at most reach2
  auto within = [&](const float4 q) {
    const float dx = xi0 - q.x;
    const float dy = xi1 - q.y;
    const float dz = xi2 - q.z;
    return dx * dx + dy * dy + dz * dz <= reach2;
  };
  // The chunk's slices in (partner, slice) order, 32 at a time: lane b
  // tests slice base + b's box against the warp's, and the warp sweeps the
  // slices kept, in order.  A slice out of reach holds only pairs with
  // w == 0.
  const int n_boxes = n_k * n_slices;
  for (int base = 0; base < n_boxes; base += 32) {
    const int own = base + lane;
    bool keep = own < n_boxes;
    if constexpr (kCull) {
      keep = keep && !(box_gap2(lo, hi, sbox[2 * own], sbox[2 * own + 1]) >
                       reach2);
    }
    unsigned int slices = __ballot_sync(0xffffffffu, keep);
    if constexpr (kCount) kept += __popc(slices);
    while (slices != 0) {                   // warp-uniform, ascending
      const float4* sc = sj + 32 * (base + __ffs(slices) - 1);
      slices &= slices - 1;
      if constexpr (kCull) {
        // and so does a vertex out of reach of the warp's box
        const float4 mine = sc[lane];
        const unsigned int m = __ballot_sync(
            0xffffffffu, far_warp || mine.w != 0.0f ||
                             point_gap2(lo, hi, mine) <= reach2);
        const unsigned int far_m = __ballot_sync(0xffffffffu, mine.w != 0.0f);
        const int n_q = __popc(m);
        if constexpr (kCount) kept_v += n_q;
        // of the kept vertices, those within reach2 of this lane's own
        unsigned int near = 0;
        if (n_q > kDenseSlice) {
#pragma unroll
          for (int j = 0; j < 32; ++j)
            near |= static_cast<unsigned int>(within(sc[j])) << j;
        } else {
          unsigned int rest = m;
#pragma unroll 4
          for (int u = 0; u < n_q; ++u) {   // the set bits, ascending
            const int j = __ffs(rest) - 1;
            rest &= rest - 1;
            near |= static_cast<unsigned int>(within(sc[j])) << j;
          }
        }
        near = far_i ? m : (near & m) | far_m;
        while (near != 0) {                 // this lane's, ascending
          const int j = __ffs(near) - 1;
          near &= near - 1;
          pair(sc[j]);
        }
      } else {
        if constexpr (kCount) kept_v += 32;
#pragma unroll 8
        for (int j = 0; j < 32; ++j) pair(sc[j]);
      }
    }
  }

  if constexpr (kCount) {
    const unsigned int swept = n_k;         // this CTA's partners
    in_reach = __reduce_add_sync(0xffffffffu, in_reach);
    unsigned int hits = 0;                  // row i of the partner search
    if (s == 0) {
      for (int j = l; j < n_j_tiles; j += blk)
        hits += interact[static_cast<size_t>(i) * i_stride + j];
      hits = __reduce_add_sync(0xffffffffu, hits);
    }
    if (lane == 0) {
      atomicAdd(&cnt[kSubBlocks], swept * n_slices);
      atomicAdd(&cnt[kSubBlocksKept], kept);
      atomicAdd(&cnt[kPartnerVerticesKept], kept_v);
      atomicAdd(&cnt[kPairsInReach], in_reach);
      atomicAdd(&cnt[kTilePairsDropped], hits);
    }
    __syncthreads();
    if (l == 0) {
      atomicAdd(&counters[kSubBlocks], cnt[kSubBlocks]);
      atomicAdd(&counters[kSubBlocksKept], cnt[kSubBlocksKept]);
      atomicAdd(&counters[kPartnerVerticesKept], cnt[kPartnerVerticesKept]);
      atomicAdd(&counters[kPairsSwept], 32ull * cnt[kPartnerVerticesKept]);
      atomicAdd(&counters[kPairsInReach], cnt[kPairsInReach]);
      atomicAdd(&counters[kPartnersSwept], swept);
      // nvalid[i] of the row's interacting tiles are swept; the rest dropped
      if (s == 0)
        atomicAdd(&counters[kTilePairsDropped],
                  cnt[kTilePairsDropped] - static_cast<unsigned int>(nv));
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

// ---- The build (see "The build" above) ------------------------------------

constexpr int kMortonBits = 10;            // blocksparse._MORTON_BITS
constexpr int kKeyBits = 3 * kMortonBits;
constexpr int kMinThreads = 256;
constexpr int kKeyThreads = 256;
constexpr int kMaxPartnerThreads = 1024;
constexpr float kBoxPad = 1e18f;           // _tile_partners' `big`

// torch.amin / amax / maximum on the card: a NaN wins
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// The per-axis minimum of m over the CTA, on thread 0 (its warp's lanes
// exchange first); sm holds a row a warp.  The caller syncs before sm is
// written again.
__device__ __forceinline__ void cta_min3(float (&m)[3], float (*sm)[3]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      m[c] = min_nan(m[c], __shfl_xor_sync(0xffffffffu, m[c], o));
  }
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) sm[w][c] = m[c];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int q = 1; q < static_cast<int>(blockDim.x >> 5); ++q) {
#pragma unroll
      for (int c = 0; c < 3; ++c) m[c] = min_nan(m[c], sm[q][c]);
    }
  }
}

// origin[c] = min over the n vertices of x[v * sv + c * sc], less
// half_cell.  `partial` holds a row of 3 a CTA; `arrivals` is zero before
// the launch and after it.
__global__ void __launch_bounds__(kMinThreads) axis_min_kernel(
    const float* __restrict__ x, long long sv, long long sc, int n,
    float half_cell, float* __restrict__ partial, int* __restrict__ arrivals,
    float* __restrict__ origin) {
  __shared__ float sm[kMinThreads / 32][3];
  __shared__ bool last;
  const float kInf = __int_as_float(0x7f800000);
  float m[3] = {kInf, kInf, kInf};
  for (long long v = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       v < n; v += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float* p = x + v * sv;
#pragma unroll
    for (int c = 0; c < 3; ++c) m[c] = min_nan(m[c], p[c * sc]);
  }
  cta_min3(m, sm);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) partial[3 * blockIdx.x + c] = m[c];
    __threadfence();                        // the row visible device-wide
    last = atomicAdd(arrivals, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int c = 0; c < 3; ++c) m[c] = kInf;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x);
       b += blockDim.x) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      m[c] = min_nan(m[c], __ldcg(partial + 3 * b + c));
  }
  cta_min3(m, sm);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) origin[c] = __fsub_rn(m[c], half_cell);
    *arrivals = 0;                          // ready for the next launch
  }
}

// Spread the low 10 bits of v two apart (blocksparse._part1by2).
__device__ __forceinline__ unsigned int part1by2(unsigned int v) {
  v &= 0x3FFu;
  v = (v | (v << 16)) & 0x30000FFu;
  v = (v | (v << 8)) & 0x300F00Fu;
  v = (v | (v << 4)) & 0x30C30C3u;
  v = (v | (v << 2)) & 0x9249249u;
  return v;
}

__global__ void __launch_bounds__(kKeyThreads) morton_keys_kernel(
    const float* __restrict__ x, long long sv, long long sc, int n,
    const float* __restrict__ origin, float cell,
    unsigned int* __restrict__ keys, int* __restrict__ vals) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  const float* p = x + v * sv;
  unsigned int key = 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float q = __fdiv_rn(__fsub_rn(p[c * sc], origin[c]), cell);
    const int cc = min(max(__float2int_rz(floorf(q)), 0),
                       (1 << kMortonBits) - 1);
    key |= part1by2(static_cast<unsigned int>(cc)) << c;
  }
  keys[v] = key;
  vals[v] = v;
}

// Tile t of the sorted vertices (`sorted`: slot -> vertex) into
// tiles[t] ([3, blk]), the tail at `pad`; its box over the valid slots
// into boxes[t] (lo xyz, hi xyz); with kOrder the permutation into `order`.
template <bool kOrder>
__global__ void __launch_bounds__(1024) gather_tiles_kernel(
    const float* __restrict__ x, long long sv, long long sc, int n, int blk,
    const int* __restrict__ sorted, float pad, float* __restrict__ tiles,
    float* __restrict__ boxes, long long* __restrict__ order) {
  __shared__ float sm[32][6];
  const int t = blockIdx.x, l = threadIdx.x;
  const int slot = t * blk + l;
  const bool valid = slot < n;
  float c[3] = {pad, pad, pad};
  if (valid) {
    const int v = sorted[slot];
    const float* p = x + v * sv;
    c[0] = p[0];
    c[1] = p[sc];
    c[2] = p[2 * sc];
    if constexpr (kOrder) order[slot] = v;
  }
  float* tile = tiles + static_cast<size_t>(t) * 3 * blk;
  tile[l] = c[0];
  tile[blk + l] = c[1];
  tile[2 * blk + l] = c[2];
  float b[6];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    b[k] = valid ? c[k] : kBoxPad;
    b[3 + k] = valid ? c[k] : -kBoxPad;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      b[k] = min_nan(b[k], __shfl_xor_sync(0xffffffffu, b[k], o));
      b[3 + k] = max_nan(b[3 + k],
                         __shfl_xor_sync(0xffffffffu, b[3 + k], o));
    }
  }
  if ((l & 31) == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) sm[l >> 5][k] = b[k];
  }
  __syncthreads();
  if (l == 0) {
    for (int q = 1; q < (blk >> 5); ++q) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        b[k] = min_nan(b[k], sm[q][k]);
        b[3 + k] = max_nan(b[3 + k], sm[q][3 + k]);
      }
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) boxes[6 * t + k] = b[k];
  }
}

// Whether the boxes (lo_i, hi_i) and box j of `boxes` interact: their
// squared gap, summed as _tile_partners sums it, is at most radius2.
__device__ __forceinline__ bool tiles_interact(const float (&lo_i)[3],
                                               const float (&hi_i)[3],
                                               const float* __restrict__ boxes,
                                               int j, float radius2) {
  float g[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float lo_j = boxes[6 * j + c], hi_j = boxes[6 * j + 3 + c];
    g[c] = max_nan(max_nan(__fsub_rn(lo_i[c], hi_j), __fsub_rn(lo_j, hi_i[c])),
                   0.0f);
  }
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(g[0], g[0]),
                                       __fmul_rn(g[1], g[1])),
                             __fmul_rn(g[2], g[2]));
  return d2 <= radius2;                     // false for a NaN
}

// Row i of the partner search: the K-column stable order of i's
// interacting partner tiles, then the rest, into partners[i]; nvalid[i];
// with kCount the row of interacting tiles into interact[i] ([Bj]).
template <bool kCount>
__global__ void __launch_bounds__(kMaxPartnerThreads) tile_partners_kernel(
    const float* __restrict__ box_i, const float* __restrict__ box_j,
    int n_j_tiles, int k_budget, float radius2,
    long long* __restrict__ partners, long long* __restrict__ nvalid,
    bool* __restrict__ interact) {
  __shared__ int warp_hits[kMaxPartnerThreads / 32];
  const int i = blockIdx.x, l = threadIdx.x, lane = l & 31, w = l >> 5;
  const int n_warps = blockDim.x >> 5;
  float lo_i[3], hi_i[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    lo_i[c] = box_i[6 * i + c];
    hi_i[c] = box_i[6 * i + 3 + c];
  }
  int total = 0;                            // the row's interacting tiles
  for (int base = 0; base < n_j_tiles; base += blockDim.x) {
    const int j = base + l;
    total += __syncthreads_count(
        j < n_j_tiles && tiles_interact(lo_i, hi_i, box_j, j, radius2));
  }
  long long* row = partners + static_cast<size_t>(i) * k_budget;
  int before = 0;                           // interacting tiles < base
  for (int base = 0; base < n_j_tiles; base += blockDim.x) {
    const int j = base + l;
    const bool in = j < n_j_tiles;
    const bool hit = in && tiles_interact(lo_i, hi_i, box_j, j, radius2);
    const unsigned int ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[w] = __popc(ballot);
    __syncthreads();
    int below = before + __popc(ballot & ((1u << lane) - 1u));
    int chunk_hits = 0;
    for (int q = 0; q < n_warps; ++q) {
      below += q < w ? warp_hits[q] : 0;
      chunk_hits += warp_hits[q];
    }
    if (in) {
      // `below` interacting tiles precede j: an interacting j sits at
      // `below`, the others after all `total` of them, in order
      const int pos = hit ? below : total + (j - below);
      if (pos < k_budget) row[pos] = j;
      if constexpr (kCount)
        interact[static_cast<size_t>(i) * n_j_tiles + j] = hit;
    }
    before += chunk_hits;
    __syncthreads();                        // warp_hits is read
  }
  if (l == 0) nvalid[i] = min(total, k_budget);
}

}  // namespace

// What the build launches with, fixed over a step function's life:
// softbodyunity_torch/kernels/blocks.py::_Build mirrors it field by field
// (block_pairs_build_size checks the two agree).  The scratch serves one
// call at a time; in the single form xj_tiles and box_j are xi_tiles and
// box_i.
struct PairBuild {
  float* min_partial;         // [min_ctas, 3]: axis_min_kernel's rows
  int* min_arrivals;          // [1], zero between launches
  float* origin;              // [3]
  unsigned int* keys[2];      // [max(n, n_j)] each: CUB's double buffers
  int* vals[2];
  void* sort_temp;            // CUB's temporary storage
  size_t sort_temp_bytes;
  float* xi_tiles;            // [n_tiles, 3, blk]
  float* xj_tiles;            // [n_j_tiles, 3, blk]
  float* box_i;               // [n_tiles, 6]
  float* box_j;               // [n_j_tiles, 6]
  long long* partners;        // [n_tiles, k_budget]
  long long* nvalid;          // [n_tiles]
  long long* order;           // [n]: the i side's sorted slot -> vertex
  float* partial;             // the pair kernel's partial rows
  int* arrivals;              // and its arrival counters
  int n, n_j, blk, n_tiles, n_j_tiles, k_budget, chunk, min_ctas;
  float half_cell, cell, radius2, eps2, c1, c2, reach2;
};

extern "C" int block_pairs_build_size() {
  return static_cast<int>(sizeof(PairBuild));
}

// CUB's temporary storage for sorting n keys (bytes), or -1 on an error.
extern "C" long long block_pairs_sort_bytes(int n) {
  size_t bytes = 0;
  cub::DoubleBuffer<unsigned int> keys(nullptr, nullptr);
  cub::DoubleBuffer<int> vals(nullptr, nullptr);
  if (cub::DeviceRadixSort::SortPairs(nullptr, bytes, keys, vals, n, 0,
                                      kKeyBits) != cudaSuccess)
    return -1;
  return static_cast<long long>(bytes);
}

// Steps 1-4 of the build for one side: the n vertices of x (element
// strides sv, sc) into `tiles` and `boxes`, the tail at `pad`, and, given
// `order`, the permutation.
static cudaError_t build_side(const PairBuild& b, const float* x,
                              long long sv, long long sc, int n, int n_tiles,
                              float pad, float* tiles, float* boxes,
                              long long* order, cudaStream_t st) {
  // a vertex a thread, as far as min_ctas partial rows reach
  const int min_ctas = std::max(
      1, std::min(b.min_ctas, (n + kMinThreads - 1) / kMinThreads));
  axis_min_kernel<<<min_ctas, kMinThreads, 0, st>>>(
      x, sv, sc, n, b.half_cell, b.min_partial, b.min_arrivals, b.origin);
  morton_keys_kernel<<<(n + kKeyThreads - 1) / kKeyThreads, kKeyThreads, 0,
                       st>>>(x, sv, sc, n, b.origin, b.cell, b.keys[0],
                             b.vals[0]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cub::DoubleBuffer<unsigned int> keys(b.keys[0], b.keys[1]);
  cub::DoubleBuffer<int> vals(b.vals[0], b.vals[1]);
  size_t bytes = b.sort_temp_bytes;
  err = cub::DeviceRadixSort::SortPairs(b.sort_temp, bytes, keys, vals, n, 0,
                                        kKeyBits, st);
  if (err != cudaSuccess) return err;
  if (order != nullptr)
    gather_tiles_kernel<true><<<n_tiles, b.blk, 0, st>>>(
        x, sv, sc, n, b.blk, vals.Current(), pad, tiles, boxes, order);
  else
    gather_tiles_kernel<false><<<n_tiles, b.blk, 0, st>>>(
        x, sv, sc, n, b.blk, vals.Current(), pad, tiles, boxes, nullptr);
  return cudaGetLastError();
}

// One launch of the pair kernel over the tiles, partners and order that
// b's scratch holds, into f_out; with `counters` the counting
// instantiation.
template <bool kCull>
static cudaError_t launch_pairs(const PairBuild& b, float* f_out,
                                long long* counters, const bool* interact,
                                cudaStream_t st) {
  if (b.chunk < 1 || b.chunk > kMaxChunk) return cudaErrorInvalidValue;
  const dim3 grid(b.n_tiles, (b.k_budget + b.chunk - 1) / b.chunk);
  const size_t smem = static_cast<size_t>(b.chunk) *
                      (b.blk + 2 * (b.blk / 32)) * sizeof(float4);
  auto kernel = counters != nullptr ? block_pairs_kernel<true, kCull>
                                    : block_pairs_kernel<false, kCull>;
  if (smem > 48 * 1024) {                   // block_size 736 and up
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, b.blk, smem, st>>>(
      b.xi_tiles, b.xj_tiles, b.nvalid, b.partners, b.k_budget, b.order, b.n,
      b.n_tiles, b.chunk, b.blk, b.partial, b.arrivals, f_out, b.eps2, b.c1,
      b.c2, b.reach2, reinterpret_cast<unsigned long long*>(counters),
      interact, b.n_j_tiles, b.n_j_tiles);
  return cudaGetLastError();
}

// The repulsion on the b.n vertices of xi (element strides si_v, si_c)
// from those of xj (the dual form: b.n_j vertices, strides sj_v, sj_c) or,
// with xj null, from xi itself, into f_out ([3, n], vertex order): the
// build, steps 1-5, and one launch of the culled pair kernel, on `stream`.
// With `counters` (int64 [7], the order of Counter) and `interact` (bool
// [n_tiles, n_j_tiles]) the partner search and the pair kernel are the
// counting instantiations, which add into `counters`; with both null, the
// plain ones.  Returns the first cudaError_t (0 = cudaSuccess); allocates
// nothing and does not synchronise.
extern "C" int block_pairs_build_forces(
    const PairBuild* build, const float* xi, long long si_v, long long si_c,
    const float* xj, long long sj_v, long long sj_c, float* f_out,
    long long* counters, bool* interact, void* stream) {
  const PairBuild& b = *build;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool counting = counters != nullptr && interact != nullptr;
  const bool dual = xj != nullptr;
  cudaError_t err = build_side(b, xi, si_v, si_c, b.n, b.n_tiles,
                               dual ? -1e6f : 1e6f, b.xi_tiles, b.box_i,
                               b.order, st);
  if (err == cudaSuccess && dual)
    err = build_side(b, xj, sj_v, sj_c, b.n_j, b.n_j_tiles, 1e6f, b.xj_tiles,
                     b.box_j, nullptr, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads =
      std::min(kMaxPartnerThreads, (b.n_j_tiles + 31) / 32 * 32);
  if (counting)
    tile_partners_kernel<true><<<b.n_tiles, threads, 0, st>>>(
        b.box_i, b.box_j, b.n_j_tiles, b.k_budget, b.radius2, b.partners,
        b.nvalid, interact);
  else
    tile_partners_kernel<false><<<b.n_tiles, threads, 0, st>>>(
        b.box_i, b.box_j, b.n_j_tiles, b.k_budget, b.radius2, b.partners,
        b.nvalid, nullptr);
  return static_cast<int>(launch_pairs<true>(
      b, f_out, counting ? counters : nullptr, interact, st));
}

// The pair kernel alone, over the tiles, partners and order the scratch
// holds (the tests put the plain build's there): culled, or with `dense`
// every pair of every partner tile swept.  `counters` and `interact` as in
// block_pairs_build_forces.
extern "C" int block_pairs_sweep(const PairBuild* build, int dense,
                                 float* f_out, long long* counters,
                                 bool* interact, void* stream) {
  const PairBuild& b = *build;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (counters == nullptr || interact == nullptr) counters = nullptr;
  return static_cast<int>(
      dense ? launch_pairs<false>(b, f_out, counters, interact, st)
            : launch_pairs<true>(b, f_out, counters, interact, st));
}

extern "C" const char* block_pairs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
