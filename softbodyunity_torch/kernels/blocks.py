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
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.config import SelfCollisionParams, SimConfig
from ..solver.blocksparse import _sorted_tiles, _tile_partners
from ..solver.forces import self_collision_planes
from .grid_scene import check_input, check_launch

# Partner tiles one CTA takes: a crowded tile's partners spread over
# ceil(nvalid / CHUNK) CTAs (csrc/block_pairs.cu, "Design").
CHUNK = 4

_launches = 0


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


@functools.cache
def _launcher():
    from .build import load_library

    lib = load_library("block_pairs")
    fn = lib.block_pairs_forces
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [
        p, p, p, i, p,         # x_tiles, nvalid, partners, p_stride, order
        i, i, i, i, i,         # n, n_tiles, k_budget, chunk, blk
        p, p, p,               # partial, arrivals, f_out
        f, f, f,               # eps2, c1, c2
        p,                     # stream
    ]
    fn.restype = ctypes.c_int
    lib.block_pairs_error_string.argtypes = [ctypes.c_int]
    lib.block_pairs_error_string.restype = ctypes.c_char_p
    return fn, lib.block_pairs_error_string


def make_block_pairs(p: SelfCollisionParams, n: int, device):
    """Build ``fn(x [n, 3]) -> [3, n]`` float32 force planes, one launch of
    the pair kernel per call, for ``n`` vertices on the CUDA ``device``.
    ``x`` may be a view (the grid paths pass their ``[3, ny, nx]`` planes
    transposed).  The kernel's scratch is allocated once, here."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the block_pairs kernel runs on a CUDA device, not "
                         f"{device}")
    blk = int(p.block_size)
    if blk % 32 != 0 or not 32 <= blk <= 1024:
        raise ValueError(f"block_size {blk}: the kernel takes a multiple of "
                         "32 from 32 to 1024 (one thread per tile vertex)")
    b = -(-n // blk)
    k = min(p.block_partners, b)
    n_chunks = -(-k // CHUNK)
    partial = torch.empty((n_chunks, b, 3, blk), dtype=torch.float32,
                          device=device)
    arrivals = torch.zeros((b,), dtype=torch.int32, device=device)
    eps2 = (1e-3 * p.radius) ** 2
    c1 = p.stiffness * p.radius
    c2 = p.stiffness
    launch, error_string = _launcher()

    def fn(x: torch.Tensor) -> torch.Tensor:
        global _launches
        if x.device.type != "cuda" or (device.index is not None
                                       and x.device != device):
            raise ValueError(f"x is on {x.device}; the kernel runs on "
                             f"{device}")
        if x.dtype != torch.float32:
            raise TypeError(f"x is {x.dtype}; the kernel takes float32 only")
        if tuple(x.shape) != (n, 3):
            raise ValueError(f"x has shape {tuple(x.shape)}, expected {(n, 3)}")
        if x.requires_grad:
            raise NotImplementedError(
                "x requires grad; the backward kernel is not ported yet "
                "(ROADMAP Queue 1 item 9)")
        xb, valid, order, _ = _sorted_tiles(x, p.cell_size, blk)
        partners, pvalid, _ = _tile_partners(xb, valid, p.radius, k)
        nvalid = pvalid.sum(dim=1)
        # the tail of the last tile at far coordinates, in the TPU kernel's
        # [B, 3, blk] tile layout
        x_tiles = torch.where(valid[..., None], xb, 1e6).transpose(1, 2)
        x_tiles = x_tiles.contiguous()
        out = torch.empty((3, n), dtype=torch.float32, device=x.device)
        check_input("x_tiles", x_tiles, (b, 3, blk), x.device)
        if partners.stride(1) != 1 or order.stride(0) != 1:
            raise ValueError("partners and order must have unit inner stride")
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            check_launch(launch(
                x_tiles.data_ptr(), nvalid.data_ptr(), partners.data_ptr(),
                partners.stride(0), order.data_ptr(), n, b, k, CHUNK, blk,
                partial.data_ptr(), arrivals.data_ptr(), out.data_ptr(),
                eps2, c1, c2, stream), "block_pairs", error_string)
        _launches += 1
        return out

    return fn


def self_collision_forces_block_cuda(x: torch.Tensor,
                                     p: SelfCollisionParams) -> torch.Tensor:
    """Block-sparse repulsion forces on ``x`` [N, 3] (float32, CUDA) from
    one launch of the pair kernel: ``[N, 3]``, as
    ``pallas_blocks.self_collision_forces_block_pallas`` returns."""
    return make_block_pairs(p, x.shape[0], x.device)(x).t()


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
