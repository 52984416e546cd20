"""Wrapper of the hand-written block-sparse self-collision pair kernel,
``csrc/block_pairs.cu``, and the self-collision force plane of the grid
paths.

Counterpart of ``softbodyunity_tpu/kernels/pallas_blocks.py``: the Morton
sort, the tiles and the partner search run as PyTorch ops on the device
(:mod:`softbodyunity_torch.solver.blocksparse`, as they run in XLA around
the Pallas kernel), the tail of the last tile is padded at far coordinates,
and one launch of the pair kernel writes the forces straight into vertex
order.  Nothing here waits for the device: the partner counts stay on it and
the kernel reads them there.  The kernel's plain version is
:func:`softbodyunity_torch.solver.blocksparse.self_collision_forces_block`.
The dual form (:func:`make_block_pairs_dual`, TPU kernel #11) takes the
i-tiles from one rank's rows and the partner tiles from the whole gathered
cloth, for the row-sharded halo paths
(:mod:`softbodyunity_torch.parallel.halo`); its plain version is
``self_collision_forces_block_dual``.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from ..core.config import SelfCollisionParams, SimConfig
from ..solver.blocksparse import _sorted_tiles, _tile_partners
from ..solver.forces import self_collision_planes
from .grid_scene import check_input, check_launch

# Partner tiles one CTA takes: a crowded tile's partners spread over
# ceil(nvalid / CHUNK) CTAs (csrc/block_pairs.cu, "Design").
CHUNK = 4
# The cull's sub-blocks, 32 i-vertices (a warp) against 32 partner vertices
# (a slice), and its margin: a sub-block pair is swept unless the squared
# gap of its boxes exceeds r^2 (1 + CULL_MARGIN), far enough past r^2 that
# every pair it skips has w == 0 in the kernel's float32 arithmetic
# (csrc/block_pairs.cu, "Why the cull is exact to the bit").
SUB_BLOCK = 32
CULL_MARGIN = 2.0 ** -10

# launches of each form; the halo paths launch the dual form from one thread
# per rank (parallel/ring.py::LocalRing), hence the lock
_launches = {"block_pairs": 0, "block_pairs_dual": 0}
_count_lock = threading.Lock()


def launch_count(form: str = "block_pairs") -> int:
    """Launches of the single (``"block_pairs"``) or the dual
    (``"block_pairs_dual"``) form since the last
    :func:`reset_launch_count`."""
    return _launches[form]


def reset_launch_count() -> None:
    with _count_lock:
        for form in _launches:
            _launches[form] = 0


def _count(form: str) -> None:
    with _count_lock:
        _launches[form] += 1


@functools.cache
def _launcher():
    from .build import load_library

    lib = load_library("block_pairs")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.block_pairs_dual_forces
    fn.argtypes = [
        p, p, p, p, i, p,      # xi_tiles, xj_tiles, nvalid, partners,
                               # p_stride, order
        i, i, i, i, i,         # n, n_tiles, k_budget, chunk, blk
        p, p, p,               # partial, arrivals, f_out
        f, f, f, f,            # eps2, c1, c2, reach2
        p,                     # stream
    ]
    fn.restype = ctypes.c_int
    lib.block_pairs_error_string.argtypes = [ctypes.c_int]
    lib.block_pairs_error_string.restype = ctypes.c_char_p
    return fn, lib.block_pairs_error_string


def _pair_launch(p: SelfCollisionParams, n: int, n_j: int, device, form):
    """Check the parameters, allocate the scratch of one launch at a time
    for the tiles of ``n`` vertices against the partner tiles of ``n_j``,
    and return ``launch(xi_tiles, xj_tiles, nvalid, partners, order) ->
    [3, n]``, which launches the kernel once on the tensors' stream (its
    inputs: :func:`pair_inputs`)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the {form} kernel runs on a CUDA device, not "
                         f"{device}")
    blk = int(p.block_size)
    if blk % SUB_BLOCK != 0 or not SUB_BLOCK <= blk <= 1024:
        raise ValueError(f"block_size {blk}: the kernel takes a multiple of "
                         "32 from 32 to 1024 (one thread per tile vertex)")
    if not p.stiffness >= 0.0:
        raise ValueError(f"stiffness {p.stiffness}: the kernel's cull takes "
                         "stiffness >= 0 (w == 0 out of reach)")
    b, b_j = -(-n // blk), -(-n_j // blk)
    k = min(p.block_partners, b_j)
    n_chunks = -(-k // CHUNK)
    partial = torch.empty((n_chunks, b, 3, blk), dtype=torch.float32,
                          device=device)
    arrivals = torch.zeros((b,), dtype=torch.int32, device=device)
    eps2 = (1e-3 * p.radius) ** 2
    c1 = p.stiffness * p.radius
    c2 = p.stiffness
    reach2 = cull_reach2(p.radius)
    fn, error_string = _launcher()

    def launch(xi_tiles, xj_tiles, nvalid, partners, order):
        dev = xi_tiles.device
        check_input("xi_tiles", xi_tiles, (b, 3, blk), dev)
        check_input("xj_tiles", xj_tiles, (b_j, 3, blk), dev)
        if partners.stride(1) != 1 or order.stride(0) != 1:
            raise ValueError("partners and order must have unit inner stride")
        out = torch.empty((3, n), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            check_launch(fn(
                xi_tiles.data_ptr(), xj_tiles.data_ptr(), nvalid.data_ptr(),
                partners.data_ptr(), partners.stride(0), order.data_ptr(), n,
                b, k, CHUNK, blk, partial.data_ptr(), arrivals.data_ptr(),
                out.data_ptr(), eps2, c1, c2, reach2, stream), form,
                error_string)
        _count(form)
        return out

    return launch


def _check_positions(name: str, x: torch.Tensor, n: int, device) -> None:
    if x.device.type != "cuda" or (device.index is not None
                                   and x.device != device):
        raise ValueError(f"{name} is on {x.device}; the kernel runs on "
                         f"{device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} is {x.dtype}; the kernel takes float32 only")
    if tuple(x.shape) != (n, 3):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{(n, 3)}")
    if x.requires_grad:
        raise NotImplementedError(
            f"{name} requires grad; the backward kernel is not ported yet "
            "(ROADMAP Queue 1 item 9)")


def make_block_pairs(p: SelfCollisionParams, n: int, device):
    """Build ``fn(x [n, 3]) -> [3, n]`` float32 force planes, one launch of
    the pair kernel per call, for ``n`` vertices on the CUDA ``device``.
    ``x`` may be a view (the grid paths pass their ``[3, ny, nx]`` planes
    transposed).  The kernel's scratch is allocated once, here."""
    device = torch.device(device)
    launch = _pair_launch(p, n, n, device, "block_pairs")

    def fn(x: torch.Tensor) -> torch.Tensor:
        _check_positions("x", x, n, device)
        return launch(*pair_inputs(p, x))

    return fn


def pair_inputs(p: SelfCollisionParams, xi: torch.Tensor,
                xall: torch.Tensor | None = None):
    """The pair kernel's inputs for the forces on ``xi`` [ni, 3] from
    ``xall`` [N, 3] (the single form without it): ``(xi_tiles, xj_tiles,
    nvalid, partners, order)``, each side Morton-sorted into ``[B, 3, blk]``
    tiles (the TPU kernel's layout) with the tail of its last tile at far
    coordinates (+1e6; the dual form's i-tiles at -1e6), the partner tiles
    by bbox gap within the budget, and ``xi``'s sort order.  The single
    form's ``xj_tiles`` is ``xi_tiles``."""
    blk = int(p.block_size)
    xb_i, valid_i, order, _ = _sorted_tiles(xi, p.cell_size, blk)
    if xall is None:
        k = min(p.block_partners, xb_i.shape[0])
        partners, pvalid, _ = _tile_partners(xb_i, valid_i, p.radius, k)
        xi_tiles = torch.where(valid_i[..., None], xb_i, 1e6)
        xi_tiles = xi_tiles.transpose(1, 2).contiguous()
        return xi_tiles, xi_tiles, pvalid.sum(dim=1), partners, order
    xb_g, valid_g, _, b_g = _sorted_tiles(xall, p.cell_size, blk)
    partners, pvalid, _ = _tile_partners(
        xb_i, valid_i, p.radius, min(p.block_partners, b_g), xb_j=xb_g,
        valid_j=valid_g)
    xi_tiles = torch.where(valid_i[..., None], xb_i, -1e6)
    xj_tiles = torch.where(valid_g[..., None], xb_g, 1e6)
    return (xi_tiles.transpose(1, 2).contiguous(),
            xj_tiles.transpose(1, 2).contiguous(), pvalid.sum(dim=1),
            partners, order)


def cull_reach2(radius: float) -> float:
    """The cull's squared reach, r^2 (1 + CULL_MARGIN), in double; the
    kernel takes it rounded once to float32."""
    return radius * radius * (1.0 + CULL_MARGIN)


def _slice_boxes(tiles: torch.Tensor):
    """The bounding boxes of each 32-vertex slice of ``tiles`` [B, 3, blk]:
    ``(lo, hi)``, each [B, blk / 32, 3]; a vertex with a non-finite
    coordinate makes its slice's box infinite, as the kernel's warp_box
    does."""
    b, _, blk = tiles.shape
    t = tiles.reshape(b, 3, blk // SUB_BLOCK, SUB_BLOCK).permute(0, 2, 3, 1)
    finite = torch.isfinite(t).all(dim=-1, keepdim=True)
    inf = torch.tensor(float("inf"), dtype=t.dtype, device=t.device)
    return (torch.where(finite, t, -inf).amin(dim=2),
            torch.where(finite, t, inf).amax(dim=2))


def kept_sub_blocks(xi_tiles: torch.Tensor, xj_tiles: torch.Tensor,
                    nvalid: torch.Tensor, partners: torch.Tensor,
                    radius: float) -> torch.Tensor:
    """The 32 x 32 sub-block pairs the pair kernel sweeps (plain PyTorch,
    for ``chip_smoke.py``'s bound and the CPU tests; the main path never
    runs it): ``[B, K, S, S]`` bool, entry ``[i, k, a, c]`` whether warp
    ``a`` of i-tile ``i`` sweeps slice ``c`` of its ``k``-th partner tile,
    False for ``k >= nvalid[i]``.  The inputs are :func:`pair_inputs`'; the
    boxes' squared gap is summed in float32 in the kernel's axis order, and
    a sub-block is kept unless it exceeds ``cull_reach2(radius)`` rounded to
    float32."""
    lo_i, hi_i = _slice_boxes(xi_tiles)                   # [B, S, 3]
    lo_j, hi_j = _slice_boxes(xj_tiles)
    lo_p, hi_p = lo_j[partners], hi_j[partners]           # [B, K, S, 3]
    lo_a, hi_a = lo_i[:, None, :, None], hi_i[:, None, :, None]
    lo_c, hi_c = lo_p[:, :, None], hi_p[:, :, None]       # [B, K, 1, S, 3]
    gap = torch.clamp_min(torch.maximum(lo_c - hi_a, lo_a - hi_c), 0.0)
    g2 = (gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1]
          + gap[..., 2] * gap[..., 2])                    # [B, K, S, S]
    reach2 = torch.tensor(cull_reach2(radius), dtype=torch.float32)
    live = (torch.arange(partners.shape[1], device=partners.device)
            < nvalid[:, None])
    return (g2 <= reach2.to(g2.device)) & live[:, :, None, None]


def make_block_pairs_dual(p: SelfCollisionParams, ni: int, n: int, device):
    """Build ``fn(xi [ni, 3], xall [n, 3]) -> [3, ni]``: the repulsion on
    ``xi`` (one rank's rows of a row-sharded cloth) from every vertex of
    ``xall`` (the gathered cloth, ``xi`` among them), float32 planes in
    ``xi``'s vertex order, one launch of the pair kernel per call on the
    CUDA ``device``.  Counterpart of ``pallas_blocks.py:201-230``
    ``self_collision_forces_block_dual_pallas``: each side is Morton-sorted
    into its own tiles, the partner budget follows the gathered cloth's tile
    count, and the pads of the i-tiles sit at -1e6, those of the partner
    tiles at +1e6.  Its plain version is
    ``softbodyunity_torch.solver.blocksparse.
    self_collision_forces_block_dual``.
    The scratch is allocated here and serves one launch at a time: build one
    ``fn`` per rank."""
    device = torch.device(device)
    launch = _pair_launch(p, ni, n, device, "block_pairs_dual")

    def fn(xi: torch.Tensor, xall: torch.Tensor) -> torch.Tensor:
        _check_positions("xi", xi, ni, device)
        _check_positions("xall", xall, n, device)
        return launch(*pair_inputs(p, xi, xall))

    return fn


def self_collision_forces_block_cuda(x: torch.Tensor,
                                     p: SelfCollisionParams) -> torch.Tensor:
    """Block-sparse repulsion forces on ``x`` [N, 3] (float32, CUDA) from
    one launch of the pair kernel: ``[N, 3]``, as
    ``pallas_blocks.self_collision_forces_block_pallas`` returns."""
    return make_block_pairs(p, x.shape[0], x.device)(x).t()


def self_collision_forces_block_dual_cuda(xi: torch.Tensor, xall: torch.Tensor,
                                          p: SelfCollisionParams
                                          ) -> torch.Tensor:
    """Repulsion forces on ``xi`` [ni, 3] from all of ``xall`` [N, 3]
    (float32, CUDA) from one launch of the pair kernel's dual form:
    ``[ni, 3]``, as ``pallas_blocks.self_collision_forces_block_dual_pallas``
    returns."""
    return make_block_pairs_dual(p, xi.shape[0], xall.shape[0],
                                 xi.device)(xi, xall).t()


def self_collision_planes_cuda(cfg: SimConfig, ny: int, nx: int, device):
    """The CUDA grid step wrappers' ``fn(x3) -> [3, ny, nx]`` self-collision
    force planes of the positions ``x3`` [3, ny, nx], or None when
    self-collision is off.  Method ``block`` launches the pair kernel, built
    here once for the ``ny * nx`` vertices; any other method is
    :func:`softbodyunity_torch.solver.forces.self_collision_planes` (method
    ``dense`` is plain PyTorch, as the JAX package has no kernel for it)."""
    sc = cfg.self_collision
    if not sc.enabled or sc.method != "block":
        return self_collision_planes(cfg)
    pairs = make_block_pairs(sc, ny * nx, device)

    def planes(x3):
        return pairs(x3.reshape(3, -1).t()).reshape(x3.shape)

    return planes
