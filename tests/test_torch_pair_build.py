"""The pair kernel's inputs built on the card (``csrc/block_pairs.cu``, "The
build": the axis minimum, the Morton keys, CUB's stable radix sort, the
tiles and their boxes, the partner search) against their plain version,
``kernels/blocks.py::pair_inputs``, to the bit: the order, the tiles and
their pads, the boxes, all K columns of the partners, nvalid and, on the
counting path, the interacting tile pairs and the count the budget
dropped; on seeded clouds, a starved budget, vertices with non-finite
coordinates, the 64k pile and the dual form on 1, 2 and 4 row shards.  The
forces and a pile frame's state are those of the plain build swept by the
same pair kernel, and stay so over repeated calls from NaN-filled
allocations.  These tests skip without a CUDA device; the file imports no
jax, so on the card:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_pair_build.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import softbodyunity_torch as tsb
from softbodyunity_torch import api
from softbodyunity_torch.core.config import SelfCollisionParams
from softbodyunity_torch.kernels import blocks
from softbodyunity_torch.solver import blocksparse
from softbodyunity_torch.utils import profiling

# tests/test_torch_selfcollide.py's clouds: 500 / 1000 leave the last tile
# padded, 2048 makes many tiles, block 128 the tunable tile size
CLOUDS = [(100, 256), (500, 256), (1000, 256), (2048, 256), (100, 128),
          (500, 128), (1000, 128), (2048, 128)]
PILE_FRAMES = (0, 40, 110)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the "
                    "card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def pile():
    """``{frame: state}`` of cloth_selfcollide_64k at PILE_FRAMES, and its
    ``(top, cfg)``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the "
                    "card")
    host, cfg = tsb.presets.build("cloth_selfcollide_64k")
    top, state = tsb.init(host, device="cuda")
    states = {}
    for frame in range(max(PILE_FRAMES) + 1):
        if frame in PILE_FRAMES:
            states[frame] = state
        state = tsb.step(top, cfg, state)
    return states, top, cfg


@pytest.fixture
def recorder():
    profiling.disable()
    yield profiling
    profiling.disable()


def _params(**kw):
    """tests/test_torch_selfcollide.py's parameters."""
    base = dict(enabled=True, method="block", radius=0.05, stiffness=10.0,
                cell_size=0.05, block_partners=16)
    base.update(kw)
    return SelfCollisionParams(**base)


def _cloud(n, device, side=0.5, seed=None):
    rng = np.random.default_rng(n if seed is None else seed)
    return torch.tensor(rng.uniform(0, side, (n, 3)).astype(np.float32),
                        device=device)


def _bits(t):
    """``t``'s bits: floats as int32, so NaN equals NaN and -0 is not 0."""
    t = t.contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_bits_equal(got, want, what):
    assert tuple(got.shape) == tuple(want.shape), what
    assert torch.equal(_bits(got), _bits(want)), what


def _plain_boxes(x, p):
    """_tile_partners' tile boxes of ``x``: [B, 6], lo then hi."""
    xb, valid, _, _ = blocksparse._sorted_tiles(x, p.cell_size, p.block_size)
    return torch.cat(blocksparse._tile_boxes(xb, valid), dim=1)


def _counted(fn, *args):
    """``fn(*args)`` with the recorder on, and the counters it read."""
    profiling.enable()
    out = fn(*args)
    counters = profiling.read().counters
    profiling.disable()
    return out, counters


def _check_build(fn, p, xi, xall=None):
    """Call ``fn`` on ``xi`` (and ``xall``: the dual form) plain and
    counting, and hold what it built to :func:`blocks.pair_inputs`; returns
    the plain call's forces, which must be the plain build's swept by the
    same pair kernel, and the dropped count."""
    args = (xi,) if xall is None else (xi, xall)
    form = "block_pairs" if xall is None else "block_pairs_dual"
    forces = fn(*args)
    want = blocks.pair_inputs(p, xi, xall)
    s = fn.scratch
    for name, w in zip(("xi_tiles", "xj_tiles", "nvalid", "partners",
                        "order"), want):
        _assert_bits_equal(getattr(s, name), w, name)
    # min and max are exact: the boxes are the plain ones but for the sign
    # of a zero, which the gap's squares drop
    for got, x in ((s.box_i, xi), (s.box_j, xi if xall is None else xall)):
        torch.testing.assert_close(got, _plain_boxes(x, p), rtol=0, atol=0,
                                   equal_nan=True)
    counted, c = _counted(fn, *args)
    assert torch.equal(s.interact, want[5])
    dropped = int(want[5].sum() - want[2].sum())
    assert c[f"{form}.tile_pairs_dropped"] == dropped
    _assert_bits_equal(counted, forces, "forces, counting")
    _assert_bits_equal(fn.sweep(want), forces, "forces of the plain build")
    return forces, dropped


@pytest.mark.cuda
@pytest.mark.parametrize("n,blk", CLOUDS)
def test_build_bit_equal_on_clouds(cuda, recorder, n, blk):
    p = _params(block_size=blk, block_partners=min(8, -(-n // blk)))
    x = _cloud(n, cuda)
    forces, _ = _check_build(blocks.make_block_pairs(p, n, cuda), p, x)
    assert float(forces.abs().max()) > 0.0


@pytest.mark.cuda
def test_build_bit_equal_on_a_starved_budget(cuda, recorder):
    """tests/test_torch_selfcollide.py's starved budget: everything piled
    in one spot, one partner a tile, so the budget drops pairs."""
    n = 4 * blocksparse.BLOCK
    p = _params(block_partners=1)
    x = _cloud(n, cuda, side=0.02, seed=0)
    _, dropped = _check_build(blocks.make_block_pairs(p, n, cuda), p, x)
    assert dropped > 0


@pytest.mark.cuda
@pytest.mark.parametrize("value", [float("nan"), float("inf"),
                                   float("-inf")])
@pytest.mark.parametrize("axis", [0, 2])
def test_build_bit_equal_with_a_non_finite_coordinate(cuda, recorder, value,
                                                      axis):
    """A NaN makes the axis minimum NaN, so every key's bits on that axis 0,
    and its tile's box NaN, which meets no tile; an infinity saturates its
    cell or makes the origin infinite: the same keys, order and partners as
    the plain build, whatever they are."""
    n = 1000
    p = _params(block_partners=4)
    x = _cloud(n, cuda)
    x[17, axis] = value
    _check_build(blocks.make_block_pairs(p, n, cuda), p, x)


@pytest.mark.cuda
@pytest.mark.parametrize("frame", PILE_FRAMES)
@pytest.mark.parametrize("partners", [None, 8])
@pytest.mark.parametrize("layout", ["rows", "planes"])
def test_build_bit_equal_on_the_pile(pile, recorder, frame, partners,
                                     layout):
    """cloth_selfcollide_64k at frames 0, 40 and 110, at its budget and a
    starved one, from [n, 3] rows and from [3, n] planes transposed (as the
    grid paths pass them: the kernels read the strides)."""
    states, _, cfg = pile
    p = cfg.self_collision
    if partners is not None:
        p = dataclasses.replace(p, block_partners=partners)
    x = states[frame].x
    if layout == "planes":
        x = x.t().contiguous().t()
    fn = blocks.make_block_pairs(p, x.shape[0], x.device)
    forces, dropped = _check_build(fn, p, x)
    # at rest no two vertices are within the radius (spacing 0.01 > 0.008)
    assert (float(forces.abs().max()) > 0.0) == (frame > 0)
    if partners == 8 and frame > 0:
        assert dropped > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_ranks", [1, 2, 4])
def test_dual_build_bit_equal_on_the_pile(pile, recorder, n_ranks):
    """The dual form on each of 1, 2 and 4 row shards of the pile after 40
    frames, against the gathered cloth: both sides sorted, the search
    rectangular, the i-tiles' pads at -1e6."""
    states, _, cfg = pile
    p = cfg.self_collision
    x = states[40].x.t().contiguous().t()
    n = x.shape[0]
    ni = n // n_ranks
    for r in range(n_ranks):
        xi = x[r * ni:(r + 1) * ni]
        fn = blocks.make_block_pairs_dual(p, ni, n, x.device)
        forces, _ = _check_build(fn, p, xi, x)
        assert float(forces.abs().max()) > 0.0


def _poison_allocator(device):
    """tests/test_torch_cuda.py's: fill the caching allocator's free blocks
    with NaN, so the tensors allocated next start as NaN."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    held = [torch.full((n,), float("nan"), device=device)
            for n in [256 * 1024] * 64 + [16 * 1024 * 1024] * 16]
    del held
    torch.cuda.synchronize(device)


@pytest.mark.cuda
def test_build_repeats_bit_equal_from_nan_scratch(pile, recorder):
    """Built on NaN-filled allocations, 24 calls of the single form and of
    the dual form on 4 shards give the plain build's inputs and forces to
    the bit each time (the minimum's arrival counter, CUB's storage, the
    partial rows and the pair kernel's counters reset or overwritten)."""
    states, _, cfg = pile
    p = cfg.self_collision
    x = states[110].x
    device = x.device
    n = x.shape[0]
    _poison_allocator(device)
    fn = blocks.make_block_pairs(p, n, device)
    want = fn.sweep(blocks.pair_inputs(p, x))
    for k in range(24):
        _assert_bits_equal(fn(x), want, f"single, call {k}")
    _check_build(fn, p, x)
    ni = n // 4
    for r in range(4):
        xi = x[r * ni:(r + 1) * ni]
        _poison_allocator(device)
        dual = blocks.make_block_pairs_dual(p, ni, n, device)
        want = dual.sweep(blocks.pair_inputs(p, xi, x))
        for k in range(24):
            _assert_bits_equal(dual(xi, x), want, f"rank {r}, call {k}")


@pytest.mark.cuda
def test_pile_frame_bit_equal_to_the_plain_build(pile, monkeypatch):
    """A frame of the pile from 40 frames on: its state with the inputs
    built on the card, and with the plain build swept by the same pair
    kernel (kernels/blocks.py before the build moved to the card), to the
    bit; 16 on-card builds a frame and no call of pair_inputs."""
    states, top, cfg = pile
    s40 = states[40]
    make = blocks.make_block_pairs

    def plain_build(p, n, device):
        fn = make(p, n, device)
        return lambda x: fn.sweep(blocks.pair_inputs(p, x))

    api._build_step.cache_clear()
    monkeypatch.setattr(blocks, "make_block_pairs", plain_build)
    want = tsb.step(top, cfg, s40)
    monkeypatch.setattr(blocks, "make_block_pairs", make)
    api._build_step.cache_clear()

    def refuse(*args, **kw):
        raise AssertionError("the card path called pair_inputs")

    monkeypatch.setattr(blocks, "pair_inputs", refuse)
    blocks.reset_launch_count()
    got = tsb.step(top, cfg, s40)
    assert blocks.build_count() == blocks.launch_count() == cfg.n_substeps
    for name in ("x", "v"):
        _assert_bits_equal(getattr(got, name), getattr(want, name), name)
    assert not torch.equal(got.x, s40.x)
