"""Block-sparse self-collision in plain PyTorch: Morton-sorted vertex tiles
gated by bounding boxes.

Counterpart of ``softbodyunity_tpu/solver/blocksparse.py``, with the same
operations in the same order:

1. sort the vertices by Morton (Z-order) cell id, so that the ``blk``-vertex
   **tiles** of the sorted array are spatially compact;
2. per tile, an axis-aligned bounding box;
3. tile pairs whose bbox gap exceeds ``radius`` contain no interacting pair
   and are skipped; each tile keeps its ``block_partners`` candidate tiles
   (a budget overflow is counted, :func:`dropped_pairs`, by
   :func:`self_collision_block_diagnostics` and the pair kernel's counting
   launch);
4. each surviving (tile, partner) pair runs the repulsion rule
   ``w(d) * (xi - xj)`` on its ``blk x blk`` vertex pairs.

The sort, the tiles and the partner search are the plain version of the
hand-written CUDA kernels that build the pair kernel's inputs on the card
(``kernels/csrc/block_pairs.cu``, "The build"; ``kernels/blocks.py``),
bit for bit; :func:`self_collision_forces_block` is the pair kernel's plain
version.  Both sorts are stable, as ``jnp.argsort`` is, so
the tile assignment, the partners and the overflow count are bit-equal to
the JAX package's (a 64k preset cell holds ~1,000 vertices, so the tie
order alone decides which vertices share a tile).
"""

from __future__ import annotations

import torch

from ..core.config import SelfCollisionParams
from ..utils import profiling

BLOCK = 256           # default vertices per tile (SelfCollisionParams.block_size)
_MORTON_BITS = 10     # 1024^3 virtual grid


def _part1by2(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of the int32 ``v`` two apart (Morton
    interleave step)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


def morton_ids(x: torch.Tensor, origin: torch.Tensor,
               cell_size: float) -> torch.Tensor:
    """Z-order curve id per vertex (30 bits, int32).  The cell size is a
    tensor on ``x``'s device, so the divide is an IEEE divide on every
    device (a Python scalar divisor becomes a reciprocal multiply on
    CUDA); it is filled there, since a copy from the host would wait for
    the device."""
    cell = torch.full((), cell_size, dtype=x.dtype, device=x.device)
    c = torch.floor((x - origin) / cell).to(torch.int32)
    c = torch.clamp(c, 0, (1 << _MORTON_BITS) - 1)
    return (_part1by2(c[:, 0]) | (_part1by2(c[:, 1]) << 1)
            | (_part1by2(c[:, 2]) << 2))


def _sorted_tiles(x: torch.Tensor, cell_size: float, blk: int = BLOCK):
    """Morton-sort ``x`` [N, 3] and fold it into [B, blk, 3] tiles
    (zero-padded).  Returns ``(tiles, valid [B, blk], order [N], B)``."""
    n = x.shape[0]
    b = -(-n // blk)
    npad = b * blk
    origin = torch.amin(x, dim=0) - 0.5 * cell_size
    order = torch.argsort(morton_ids(x, origin, cell_size), stable=True)
    xs = x[order]
    if npad != n:
        xs = torch.cat([xs, xs.new_zeros((npad - n, 3))])
    valid = (torch.arange(npad, device=x.device) < n).reshape(b, blk)
    return xs.reshape(b, blk, 3), valid, order, b


def _tile_boxes(xb, valid):
    """Each tile's bounding box over its valid vertices: ``(lo, hi)``,
    [B, 3] each (a NaN coordinate makes both NaN, as amin and amax
    propagate it)."""
    big = 1e18
    return (torch.amin(torch.where(valid[..., None], xb, big), dim=1),
            torch.amax(torch.where(valid[..., None], xb, -big), dim=1))


def _tile_partners(xb, valid, radius: float, k: int, xb_j=None,
                   valid_j=None):
    """Per-tile partner tiles by bbox gap: ``([B, K] ids, [B, K] valid,
    [B, Bj] interact)``.

    A tile pair is a candidate (``interact``) iff its per-axis bbox gap
    distance is at most ``radius`` (a superset of the interacting pairs).
    :func:`dropped_pairs` counts the candidate pairs the K budget drops
    (the JAX package's third result; 0: the force is exactly the dense
    rule's), only where it is read.  With ``xb_j``/``valid_j`` the search
    is rectangular: i-tiles from ``xb``, partners from the second tile
    array."""
    mn, mx = _tile_boxes(xb, valid)                                   # [B,3]
    mn_j, mx_j = (mn, mx) if xb_j is None else _tile_boxes(xb_j, valid_j)
    gap = torch.clamp_min(
        torch.maximum(mn[:, None, :] - mx_j[None, :, :],
                      mn_j[None, :, :] - mx[:, None, :]), 0.0)     # [B,Bj,3]
    # the three squares summed in axis order, as XLA reduces the last axis
    d2 = (gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1]
          + gap[..., 2] * gap[..., 2])
    interact = d2 <= radius * radius                               # [B,Bj]
    # a stable sort of ~interact puts the interacting tiles first, in
    # ascending tile order
    idx = torch.argsort((~interact).to(torch.int32), dim=1,
                        stable=True)[:, :k]                        # [B,K]
    pvalid = torch.gather(interact, 1, idx)
    return idx, pvalid, interact


def dropped_pairs(interact: torch.Tensor,
                  pvalid: torch.Tensor) -> torch.Tensor:
    """The candidate tile pairs of :func:`_tile_partners` that the partner
    budget left out, a 0-dim tensor on their device."""
    return interact.sum() - pvalid.sum()


def self_collision_forces_block(x: torch.Tensor,
                                p: SelfCollisionParams) -> torch.Tensor:
    """Block-sparse vertex-vertex repulsion forces, ``[N, 3]``: the dual
    form with both sides the same array.  The plain version of the CUDA pair
    kernel (``kernels/csrc/block_pairs.cu``)."""
    return self_collision_forces_block_dual(x, x, p)


def self_collision_forces_block_dual(xi: torch.Tensor, xall: torch.Tensor,
                                     p: SelfCollisionParams) -> torch.Tensor:
    """Repulsion forces on ``xi`` [ni, 3] from all of ``xall`` [N, 3]
    (``xi`` a subset of ``xall``).

    A vertex meeting itself adds exactly 0: ``diff`` is 0 and ``w`` finite
    by the eps clamp.  Pads sit at +1e6 on the partner side and -1e6 on the
    i side, so no pad pair is ever coincident and no real vertex is within
    ``radius`` of a pad."""
    ni = xi.shape[0]
    sp = profiling.begin("blocksparse.sort") if profiling.on else -1
    xb_i, valid_i, order_i, _ = _sorted_tiles(xi, p.cell_size, p.block_size)
    xb_g, valid_g, _, b_g = _sorted_tiles(xall, p.cell_size, p.block_size)
    if sp >= 0:
        profiling.end(sp)
    sp = profiling.begin("blocksparse.partners") if profiling.on else -1
    k = min(p.block_partners, b_g)
    partners, pvalid, _ = _tile_partners(
        xb_i, valid_i, p.radius, k, xb_j=xb_g, valid_j=valid_g)
    if sp >= 0:
        profiling.end(sp)
    eps = 1e-3 * p.radius
    xg = torch.where(valid_g[..., None], xb_g, 1e6)
    xiv = torch.where(valid_i[..., None], xb_i, -1e6)
    f = torch.zeros_like(xb_i)
    for kk in range(k):
        xj = xg[partners[:, kk]]                        # [Bi, blk, 3]
        diff = xiv[:, :, None, :] - xj[:, None, :, :]   # [Bi, blk, blk, 3]
        d2 = torch.sum(diff * diff, dim=-1)
        d = torch.sqrt(torch.clamp_min(d2, eps * eps))
        w = torch.where((d < p.radius) & pvalid[:, kk, None, None],
                        p.stiffness * (p.radius - d) / d, 0.0)
        f = f + torch.sum(w[..., None] * diff, dim=2)
    f_sorted = f.reshape(-1, 3)[:ni]
    return f_sorted[torch.argsort(order_i)]


def self_collision_block_diagnostics(x: torch.Tensor,
                                     p: SelfCollisionParams) -> dict:
    """``{'candidate_pairs', 'dropped_pairs'}`` as 0-dim tensors on ``x``'s
    device (nothing waits for the device here): ``dropped_pairs == 0``
    proves the force is exactly the dense rule's for this state."""
    xb, valid, _, b = _sorted_tiles(x, p.cell_size, p.block_size)
    k = min(p.block_partners, b)
    _, pvalid, interact = _tile_partners(xb, valid, p.radius, k)
    overflow = dropped_pairs(interact, pvalid)
    return {"candidate_pairs": pvalid.sum() + overflow,
            "dropped_pairs": overflow}


def self_collision_block_dual_diagnostics(xi: torch.Tensor,
                                          xall: torch.Tensor,
                                          p: SelfCollisionParams) -> dict:
    """:func:`self_collision_block_diagnostics` of the dual form (``xi``'s
    tiles against ``xall``'s), as 0-dim tensors on ``xi``'s device:
    ``{'candidate_pairs', 'dropped_pairs', 'sum_nvalid'}``, the last the
    interacting tile pairs that the pair kernel's dual form sweeps."""
    xb_i, valid_i, _, _ = _sorted_tiles(xi, p.cell_size, p.block_size)
    xb_g, valid_g, _, b_g = _sorted_tiles(xall, p.cell_size, p.block_size)
    k = min(p.block_partners, b_g)
    _, pvalid, interact = _tile_partners(xb_i, valid_i, p.radius, k,
                                         xb_j=xb_g, valid_j=valid_g)
    overflow = dropped_pairs(interact, pvalid)
    return {"candidate_pairs": pvalid.sum() + overflow,
            "dropped_pairs": overflow, "sum_nvalid": pvalid.sum()}
