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
        f, f, f,               # eps2, c1, c2
        p,                     # stream
    ]
    fn.restype = ctypes.c_int
    lib.block_pairs_error_string.argtypes = [ctypes.c_int]
    lib.block_pairs_error_string.restype = ctypes.c_char_p
    return fn, lib.block_pairs_error_string


def _pair_launch(p: SelfCollisionParams, n: int, n_j: int, device, form):
    """Check the parameters, allocate the scratch of one launch at a time
    for the tiles of ``n`` vertices against the partner tiles of ``n_j``,
    and return ``(launch, blk, k)``: ``launch(xi_tiles, xj_tiles, nvalid,
    partners, order) -> [3, n]`` launches the kernel once on the tensors'
    stream."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the {form} kernel runs on a CUDA device, not "
                         f"{device}")
    blk = int(p.block_size)
    if blk % 32 != 0 or not 32 <= blk <= 1024:
        raise ValueError(f"block_size {blk}: the kernel takes a multiple of "
                         "32 from 32 to 1024 (one thread per tile vertex)")
    b, b_j = -(-n // blk), -(-n_j // blk)
    k = min(p.block_partners, b_j)
    n_chunks = -(-k // CHUNK)
    partial = torch.empty((n_chunks, b, 3, blk), dtype=torch.float32,
                          device=device)
    arrivals = torch.zeros((b,), dtype=torch.int32, device=device)
    eps2 = (1e-3 * p.radius) ** 2
    c1 = p.stiffness * p.radius
    c2 = p.stiffness
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
                out.data_ptr(), eps2, c1, c2, stream), form, error_string)
        _count(form)
        return out

    return launch, blk, k


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
    launch, blk, k = _pair_launch(p, n, n, device, "block_pairs")

    def fn(x: torch.Tensor) -> torch.Tensor:
        _check_positions("x", x, n, device)
        xb, valid, order, _ = _sorted_tiles(x, p.cell_size, blk)
        partners, pvalid, _ = _tile_partners(xb, valid, p.radius, k)
        nvalid = pvalid.sum(dim=1)
        # the tail of the last tile at far coordinates, in the TPU kernel's
        # [B, 3, blk] tile layout
        x_tiles = torch.where(valid[..., None], xb, 1e6).transpose(1, 2)
        x_tiles = x_tiles.contiguous()
        return launch(x_tiles, x_tiles, nvalid, partners, order)

    return fn


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
    launch, blk, k = _pair_launch(p, ni, n, device, "block_pairs_dual")

    def fn(xi: torch.Tensor, xall: torch.Tensor) -> torch.Tensor:
        _check_positions("xi", xi, ni, device)
        _check_positions("xall", xall, n, device)
        xb_i, valid_i, order_i, _ = _sorted_tiles(xi, p.cell_size, blk)
        xb_g, valid_g, _, _ = _sorted_tiles(xall, p.cell_size, blk)
        partners, pvalid, _ = _tile_partners(xb_i, valid_i, p.radius, k,
                                             xb_j=xb_g, valid_j=valid_g)
        nvalid = pvalid.sum(dim=1)
        xi_tiles = torch.where(valid_i[..., None], xb_i, -1e6)
        xj_tiles = torch.where(valid_g[..., None], xb_g, 1e6)
        return launch(xi_tiles.transpose(1, 2).contiguous(),
                      xj_tiles.transpose(1, 2).contiguous(), nvalid, partners,
                      order_i)

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
