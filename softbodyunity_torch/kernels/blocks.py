"""Wrapper of the hand-written block-sparse self-collision pair kernel,
``csrc/block_pairs.cu``, and the self-collision force plane of the grid
paths.

Counterpart of ``softbodyunity_tpu/kernels/pallas_blocks.py``.  Each call is
one ``ctypes`` call, ``block_pairs_build_forces``, which launches on the
card the Morton sort (an axis minimum, the keys, CUB's stable radix sort),
the tiles with the tail of the last at far coordinates, their bounding
boxes and the partner search, then the pair kernel, which writes the forces
straight into vertex order.  Nothing here waits for the device.  What those
kernels build is :func:`pair_inputs`' to the bit: the plain PyTorch version
(:mod:`softbodyunity_torch.solver.blocksparse`, as it runs in XLA around
the Pallas kernel), which the tests and ``chip_smoke.py`` read.  The pair
kernel's plain version is
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
import types

import torch

from ..core.config import SelfCollisionParams, SimConfig
from ..solver.blocksparse import _sorted_tiles, _tile_partners
from ..solver.forces import self_collision_planes
from ..utils import profiling
from .build import check_launch

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

# The two forms, each counting its launches under its name and its on-card
# builds of the inputs under "<form>.tiles"; the halo paths launch the dual
# form from one thread per rank (parallel/ring.py::LocalRing), and the
# recorder's counters are thread-safe.
FORMS = ("block_pairs", "block_pairs_dual")
# axis_min_kernel's CTAs at most, each a partial row (csrc/block_pairs.cu)
MIN_CTAS = 1024
# What the kernel's counting instantiation adds up while the recorder is on,
# under "<form>.<name>", in the order of csrc/block_pairs.cu's Counter: the
# 32 x 32 sub-block pairs of the partners swept and those the cull kept,
# the vertex pairs swept and those with w > 0 (within the radius), the
# partner tiles swept (the sum of nvalid) and the interacting tile pairs
# that the partner budget dropped.
COUNTERS = ("sub_blocks", "sub_blocks_kept", "pairs_swept",
            "pairs_in_reach", "partners_swept", "tile_pairs_dropped")


def launch_count(form: str = "block_pairs") -> int:
    """Launches of the single (``"block_pairs"``) or the dual
    (``"block_pairs_dual"``) form since the last
    :func:`reset_launch_count`."""
    return profiling.count(form)


def build_count(form: str = "block_pairs") -> int:
    """On-card builds of the pair kernel's inputs by ``form`` since the
    last :func:`reset_launch_count`: one a call, as its launches."""
    return profiling.count(f"{form}.tiles")


def reset_launch_count() -> None:
    profiling.reset_count(*FORMS, *(f"{form}.tiles" for form in FORMS))


def _count(form: str) -> None:
    profiling.add(form)


class _Build(ctypes.Structure):
    """``csrc/block_pairs.cu::PairBuild`` field by field."""

    _fields_ = [
        *[(name, ctypes.c_void_p) for name in (
            "min_partial", "min_arrivals", "origin")],
        *[(name, ctypes.c_void_p * 2) for name in ("keys", "vals")],
        ("sort_temp", ctypes.c_void_p),
        ("sort_temp_bytes", ctypes.c_size_t),
        *[(name, ctypes.c_void_p) for name in (
            "xi_tiles", "xj_tiles", "box_i", "box_j", "partners", "nvalid",
            "order", "partial", "arrivals")],
        *[(name, ctypes.c_int) for name in (
            "n", "n_j", "blk", "n_tiles", "n_j_tiles", "k_budget", "chunk",
            "min_ctas")],
        *[(name, ctypes.c_float) for name in (
            "half_cell", "cell", "radius2", "eps2", "c1", "c2", "reach2")],
    ]


@functools.cache
def _launcher():
    from .build import load_library

    lib = load_library("block_pairs")
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    size = lib.block_pairs_build_size
    size.restype = ctypes.c_int
    if size() != ctypes.sizeof(_Build):
        raise RuntimeError(
            f"block_pairs: the C build struct has {size()} bytes, its ctypes "
            f"mirror {ctypes.sizeof(_Build)}")
    fn = lib.block_pairs_build_forces
    fn.argtypes = [
        ctypes.POINTER(_Build),   # the struct
        p, ll, ll,                # xi, its vertex and coordinate strides
        p, ll, ll,                # xj (null: the single form), strides
        p,                        # f_out
        p, p,                     # counters, interact (or both null)
        p,                        # stream
    ]
    fn.restype = ctypes.c_int
    lib.block_pairs_sort_bytes.argtypes = [ctypes.c_int]
    lib.block_pairs_sort_bytes.restype = ll
    lib.block_pairs_error_string.argtypes = [ctypes.c_int]
    lib.block_pairs_error_string.restype = ctypes.c_char_p
    return fn, lib.block_pairs_sort_bytes, lib.block_pairs_error_string


def _pair_launch(p: SelfCollisionParams, n: int, n_j: int | None, device,
                 form):
    """Check the parameters, allocate the scratch of one call at a time for
    the tiles of ``n`` vertices against those of ``n_j`` (None: the single
    form, against themselves), and return ``launch(xi, xj) -> [3, n]``,
    which builds the inputs and launches the pair kernel from one C call on
    the current stream (``xj`` None in the single form).  ``launch.scratch``
    holds what the build wrote (``xi_tiles``, ``xj_tiles``, ``box_i``,
    ``box_j``, ``partners``, ``nvalid``, ``order`` and, once a counting call
    ran, ``interact``): :func:`pair_inputs`' tensors to the bit.
    ``launch.sweep(pair_inputs(...))`` runs the pair kernel alone over the
    plain build's tensors, copied into the scratch.  While the
    recorder is on (:mod:`softbodyunity_torch.utils.profiling`) the partner
    search and the pair kernel are their counting instantiations, which add
    :data:`COUNTERS` into a buffer allocated here; the forces are the same
    to the bit."""
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
    dual = n_j is not None
    n_j = n_j if dual else n
    b, b_j = -(-n // blk), -(-n_j // blk)
    k = min(p.block_partners, b_j)
    fn, sort_bytes, error_string = _launcher()
    with torch.cuda.device(device):
        temp = max(sort_bytes(n), sort_bytes(n_j))
    if temp < 0:
        raise RuntimeError(f"{form}: CUB's radix sort refused {max(n, n_j)} "
                           "keys")

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=device)

    n_max = max(n, n_j)
    s = types.SimpleNamespace(
        xi_tiles=empty(b, 3, blk), box_i=empty(b, 6),
        partners=empty(b, k, dtype=torch.int64),
        nvalid=empty(b, dtype=torch.int64), order=empty(n, dtype=torch.int64),
        interact=None,
        # the scratch only the card reads
        min_partial=empty(MIN_CTAS, 3),
        min_arrivals=torch.zeros(1, dtype=torch.int32, device=device),
        origin=empty(3),
        keys=[empty(n_max, dtype=torch.int32) for _ in range(2)],
        vals=[empty(n_max, dtype=torch.int32) for _ in range(2)],
        sort_temp=empty(max(temp, 1), dtype=torch.uint8),
        partial=empty(-(-k // CHUNK), b, 3, blk),
        arrivals=torch.zeros(b, dtype=torch.int32, device=device))
    s.xj_tiles = empty(b_j, 3, blk) if dual else s.xi_tiles
    s.box_j = empty(b_j, 6) if dual else s.box_i
    build = _Build(
        **{name: getattr(s, name).data_ptr() for name in (
            "min_partial", "min_arrivals", "origin", "sort_temp", "xi_tiles",
            "xj_tiles", "box_i", "box_j", "partners", "nvalid", "order",
            "partial", "arrivals")},
        keys=(ctypes.c_void_p * 2)(*(t.data_ptr() for t in s.keys)),
        vals=(ctypes.c_void_p * 2)(*(t.data_ptr() for t in s.vals)),
        sort_temp_bytes=temp,
        n=n, n_j=n_j, blk=blk, n_tiles=b, n_j_tiles=b_j, k_budget=k,
        chunk=CHUNK, min_ctas=MIN_CTAS, half_cell=0.5 * p.cell_size,
        cell=p.cell_size, radius2=p.radius * p.radius,
        eps2=(1e-3 * p.radius) ** 2, c1=p.stiffness * p.radius,
        c2=p.stiffness, reach2=cull_reach2(p.radius))
    s.build = build
    build_ref = ctypes.byref(build)
    counters = profiling.device_counters(
        [f"{form}.{name}" for name in COUNTERS], device)
    tiles = f"{form}.tiles"

    def run(dev, xi, xj):
        """One C call on ``dev``'s current stream: ``xi`` and ``xj`` are
        (pointer, vertex stride, coordinate stride), a null ``xi`` pointer
        leaving the build out."""
        counting = profiling.on
        if counting and s.interact is None:
            s.interact = empty(b, b_j, dtype=torch.bool)
        out = torch.empty((3, n), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            check_launch(fn(
                build_ref, *xi, *xj, out.data_ptr(),
                counters.data_ptr() if counting else None,
                s.interact.data_ptr() if counting else None,
                stream), form, error_string)
        return out

    def launch(xi, xj=None):
        sp = profiling.begin("blocks.launch") if profiling.on else -1
        out = run(xi.device, (xi.data_ptr(), *xi.stride()),
                  (xj.data_ptr(), *xj.stride()) if dual else (None, 0, 0))
        _count(form)
        profiling.add(tiles)
        if sp >= 0:
            profiling.end(sp)
        return out

    def sweep(inputs):
        """The pair kernel alone over ``inputs`` (:func:`pair_inputs`'),
        copied into the scratch: the forces of the plain build."""
        if profiling.on and s.interact is None:
            s.interact = empty(b, b_j, dtype=torch.bool)
        for name, t in zip(("xi_tiles", "xj_tiles", "nvalid", "partners",
                            "order", "interact"), inputs):
            if getattr(s, name) is not None:
                getattr(s, name).copy_(t)
        return run(device, (None, 0, 0), (None, 0, 0))

    launch.scratch, launch.sweep = s, sweep
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
    """Build ``fn(x [n, 3]) -> [3, n]`` float32 force planes, one
    ``ctypes`` call per call (the on-card build of the inputs and the pair
    kernel), for ``n`` vertices on the CUDA ``device``.  ``x`` may be any
    strided view (the grid paths pass their ``[3, ny, nx]`` planes
    transposed); the kernels read it where it lies.  The scratch is
    allocated once, here: ``fn.scratch`` holds what the last call built
    (:func:`_pair_launch`)."""
    device = torch.device(device)
    launch = _pair_launch(p, n, None, device, "block_pairs")

    def fn(x: torch.Tensor) -> torch.Tensor:
        _check_positions("x", x, n, device)
        return launch(x)

    fn.scratch, fn.sweep = launch.scratch, launch.sweep
    return fn


def pair_inputs(p: SelfCollisionParams, xi: torch.Tensor,
                xall: torch.Tensor | None = None):
    """The pair kernel's inputs for the forces on ``xi`` [ni, 3] from
    ``xall`` [N, 3] (the single form without it), in plain PyTorch:
    ``(xi_tiles, xj_tiles, nvalid, partners, order, interact)``, each side
    Morton-sorted into ``[B, 3, blk]`` tiles (the TPU kernel's layout) with
    the tail of its last tile at far coordinates (+1e6; the dual form's
    i-tiles at -1e6), the partner tiles by bbox gap within the budget,
    ``xi``'s sort order, and the ``[B, Bj]`` interacting tile pairs, from
    which the counting launch counts those the budget dropped.  The single
    form's ``xj_tiles`` is ``xi_tiles``.  What the card builds in each call
    of :func:`make_block_pairs` (its ``fn.scratch``) is this, to the bit;
    the tests and ``chip_smoke.py`` read it, the card path does not."""
    blk = int(p.block_size)
    xb_i, valid_i, order, _ = _sorted_tiles(xi, p.cell_size, blk)
    if xall is None:
        k = min(p.block_partners, xb_i.shape[0])
        partners, pvalid, interact = _tile_partners(xb_i, valid_i, p.radius,
                                                    k)
        xi_tiles = torch.where(valid_i[..., None], xb_i, 1e6)
        xi_tiles = xi_tiles.transpose(1, 2).contiguous()
        return xi_tiles, xi_tiles, pvalid.sum(dim=1), partners, order, interact
    xb_g, valid_g, _, b_g = _sorted_tiles(xall, p.cell_size, blk)
    partners, pvalid, interact = _tile_partners(
        xb_i, valid_i, p.radius, min(p.block_partners, b_g), xb_j=xb_g,
        valid_j=valid_g)
    xi_tiles = torch.where(valid_i[..., None], xb_i, -1e6)
    xj_tiles = torch.where(valid_g[..., None], xb_g, 1e6)
    return (xi_tiles.transpose(1, 2).contiguous(),
            xj_tiles.transpose(1, 2).contiguous(), pvalid.sum(dim=1),
            partners, order, interact)


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
    ``xi``'s vertex order, one ``ctypes`` call per call on the CUDA
    ``device``.  Counterpart of ``pallas_blocks.py:201-230``
    ``self_collision_forces_block_dual_pallas``: each side is Morton-sorted
    into its own tiles on the card, the partner search runs rectangular,
    its budget following the gathered cloth's tile count, and the pads of
    the i-tiles sit at -1e6, those of the partner tiles at +1e6.  Its plain
    version is ``softbodyunity_torch.solver.blocksparse.
    self_collision_forces_block_dual``.
    The scratch is allocated here and serves one call at a time: build one
    ``fn`` per rank.  ``fn.scratch`` holds what the last call built."""
    device = torch.device(device)
    launch = _pair_launch(p, ni, n, device, "block_pairs_dual")

    def fn(xi: torch.Tensor, xall: torch.Tensor) -> torch.Tensor:
        _check_positions("xi", xi, ni, device)
        _check_positions("xall", xall, n, device)
        return launch(xi, xall)

    fn.scratch, fn.sweep = launch.scratch, launch.sweep
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
        sp = profiling.begin("selfcollide") if profiling.on else -1
        f = pairs(x3.reshape(3, -1).t()).reshape(x3.shape)
        if sp >= 0:
            profiling.end(sp)
        return f

    return planes
