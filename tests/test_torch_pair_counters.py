"""The block_pairs kernel's counting instantiation (csrc/block_pairs.cu,
launched while the recorder of ``softbodyunity_torch/utils/profiling.py``
is on) and the spans of a self-collision frame on the card, on the 64k pile
after 40 frames: the kernel's counts equal the plain counts of the same
inputs, and its forces are the plain instantiation's to the bit.  These
tests skip without a CUDA device; the file imports no jax, so on the card:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_pair_counters.py
"""

import dataclasses

import pytest
import torch

import softbodyunity_torch as tsb
from softbodyunity_torch.kernels import blocks, grid_euler
from softbodyunity_torch.solver import blocksparse
from softbodyunity_torch.utils import profiling

# relative band about r^2 in which the kernel's float32 w > 0 (d2 from
# FMAs, rsqrtf within 2 ulps) and a float64 d < r may disagree
EDGE = 1e-5


@pytest.fixture(scope="module")
def pile():
    """``(top, cfg, state)``: cloth_selfcollide_64k after 40 frames."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the "
                    "card")
    host, cfg = tsb.presets.build("cloth_selfcollide_64k")
    top, state = tsb.init(host, device="cuda")
    for _ in range(40):
        state = tsb.step(top, cfg, state)
    return top, cfg, state


@pytest.fixture
def recorder():
    profiling.disable()
    yield profiling
    profiling.disable()


def _params(cfg, partners):
    sc = cfg.self_collision
    return sc if partners is None else dataclasses.replace(
        sc, block_partners=partners)


def _counted(fn, *args):
    """``fn(*args)`` with the recorder on, and the counters it read."""
    profiling.enable()
    out = fn(*args)
    counters = profiling.read().counters
    profiling.disable()
    return out, counters


def _in_reach(inputs, radius):
    """Pairs of the swept tile pairs (tile i, its first nvalid[i]
    partners) at d < r (1 -+ EDGE) in float64: ``(lo, hi)``."""
    xi_tiles, xj_tiles, nvalid, partners = inputs[:4]
    xi = xi_tiles.double()
    lo = hi = 0
    r2 = radius * radius
    for k in range(partners.shape[1]):
        live = k < nvalid
        if not bool(live.any()):
            break
        xj = xj_tiles.double()[partners[live, k]]
        d = xi[live][:, :, :, None] - xj[:, :, None, :]
        d2 = (d * d).sum(dim=1)
        lo += int((d2 < r2 * (1 - EDGE)).sum())
        hi += int((d2 < r2 * (1 + EDGE)).sum())
    return lo, hi


@pytest.mark.cuda
@pytest.mark.parametrize("partners", [None, 8])
def test_counts_equal_the_plain_counts(pile, recorder, partners):
    """Sub-blocks considered and kept (``kept_sub_blocks``), partner
    vertices kept (``kept_partner_vertices``) and pairs swept, 32 for each,
    pairs within the radius (a dense count), partners swept (the sum of
    nvalid) and tile pairs dropped (the diagnostics): at the preset's
    budget of 96 partners and a starved one of 8."""
    top, cfg, state = pile
    p = _params(cfg, partners)
    x = state.x
    fn = blocks.make_block_pairs(p, x.shape[0], x.device)
    _, c = _counted(fn, x)
    inputs = blocks.pair_inputs(p, x)
    kept = blocks.kept_sub_blocks(*inputs[:4], p.radius)
    s = p.block_size // blocks.SUB_BLOCK
    swept = int(inputs[2].sum())
    assert c["block_pairs.partners_swept"] == swept
    assert c["block_pairs.sub_blocks"] == swept * s * s
    assert c["block_pairs.sub_blocks_kept"] == int(kept.sum())
    kept_v = int(blocks.kept_partner_vertices(*inputs[:4], p.radius).sum())
    assert c["block_pairs.partner_vertices_kept"] == kept_v
    assert c["block_pairs.pairs_swept"] == 32 * kept_v
    assert kept_v < 32 * int(kept.sum())
    lo, hi = _in_reach(inputs, p.radius)
    assert lo <= c["block_pairs.pairs_in_reach"] <= hi
    assert c["block_pairs.pairs_in_reach"] > x.shape[0]   # beyond self
    d = blocksparse.self_collision_block_diagnostics(x, p)
    assert c["block_pairs.tile_pairs_dropped"] == int(d["dropped_pairs"])
    if partners == 8:
        assert c["block_pairs.tile_pairs_dropped"] > 0


@pytest.mark.cuda
def test_dense_sweep_counts_every_pair(pile, recorder):
    """The dense instantiation (``fn.sweep(..., dense=True)``) keeps every
    sub-block and partner vertex, sweeps blk^2 pairs a partner tile, and
    meets the same pairs within the radius as the culled one, with the same
    forces to the bit."""
    top, cfg, state = pile
    p = cfg.self_collision
    x = state.x
    fn = blocks.make_block_pairs(p, x.shape[0], x.device)
    culled, c = _counted(fn, x)
    inputs = blocks.pair_inputs(p, x)
    dense, d = _counted(lambda: fn.sweep(inputs, dense=True))
    assert torch.equal(dense, culled)
    blk = p.block_size
    swept = int(inputs[2].sum())
    assert d["block_pairs.sub_blocks_kept"] == d["block_pairs.sub_blocks"]
    assert d["block_pairs.partner_vertices_kept"] == swept * blk * blk // 32
    assert d["block_pairs.pairs_swept"] == swept * blk * blk
    for name in ("sub_blocks", "pairs_in_reach", "partners_swept",
                 "tile_pairs_dropped"):
        assert d[f"block_pairs.{name}"] == c[f"block_pairs.{name}"], name
    assert c["block_pairs.pairs_swept"] < d["block_pairs.pairs_swept"]


@pytest.mark.cuda
def test_dual_form_counts_its_dropped_pairs(pile, recorder):
    top, cfg, state = pile
    p = _params(cfg, 8)
    x = state.x
    n = x.shape[0]
    ni = n // 4
    dropped = swept = 0
    for r in range(4):
        xi = x[r * ni:(r + 1) * ni]
        fn = blocks.make_block_pairs_dual(p, ni, n, x.device)
        _, c = _counted(fn, xi, x)
        d = blocksparse.self_collision_block_dual_diagnostics(xi, x, p)
        assert c["block_pairs_dual.tile_pairs_dropped"] == int(
            d["dropped_pairs"])
        assert c["block_pairs_dual.partners_swept"] == int(d["sum_nvalid"])
        dropped += c["block_pairs_dual.tile_pairs_dropped"]
        swept += c["block_pairs_dual.partners_swept"]
    assert dropped > 0 and swept > 0


@pytest.mark.cuda
@pytest.mark.parametrize("partners", [None, 8])
def test_forces_bit_equal_with_counting_on_and_off(pile, recorder, partners):
    top, cfg, state = pile
    p = _params(cfg, partners)
    x = state.x
    fn = blocks.make_block_pairs(p, x.shape[0], x.device)
    plain = fn(x)
    counted, _ = _counted(fn, x)
    assert torch.equal(counted, plain)
    assert torch.equal(fn(x), plain)
    ni = x.shape[0] // 4
    dual = blocks.make_block_pairs_dual(p, ni, x.shape[0], x.device)
    plain = dual(x[:ni], x)
    counted, _ = _counted(dual, x[:ni], x)
    assert torch.equal(counted, plain)


@pytest.mark.cuda
def test_spans_of_a_card_frame(pile, recorder):
    """A frame of the pile on the card: the wrapper's phases and the force
    plane's, nested under ``api.step``, a ``selfcollide``, ``blocks.launch``
    and ``grid_euler.call`` a substep, the build of the pair kernel's inputs
    inside the one ``blocks.launch`` call (16 ``block_pairs.tiles`` builds,
    no span of the plain sort or partner search), the normals' kernel call
    ``normals.call`` under ``api.normals`` (no span of the plain normals);
    the step's results and launch counts as with the recorder off."""
    top, cfg, state = pile
    grid_euler.reset_launch_count()
    blocks.reset_launch_count()
    plain = tsb.step(top, cfg, state)
    launches = (grid_euler.launch_count(), blocks.launch_count(),
                blocks.build_count())
    grid_euler.reset_launch_count()
    blocks.reset_launch_count()
    recorder.enable()
    traced = tsb.step(top, cfg, state)
    tsb.normals(top, traced)
    rec = recorder.read()
    assert (grid_euler.launch_count(), blocks.launch_count(),
            blocks.build_count()) == launches
    assert launches == (cfg.n_substeps,) * 3
    assert rec.counters["block_pairs.tiles"] == cfg.n_substeps
    assert torch.equal(traced.x, plain.x) and torch.equal(traced.v, plain.v)
    parents = {
        "api.lookup": "api.step", "grid_euler.planes_in": "api.step",
        "grid_euler.pack": "api.step", "selfcollide": "api.step",
        "grid_euler.call": "api.step", "grid_euler.planes_out": "api.step",
        "blocks.launch": "selfcollide", "normals.call": "api.normals",
        "api.step": None, "api.normals": None}
    assert set(rec.names) == set(parents)
    for i, name in enumerate(rec.names):
        p = rec.parent[i]
        assert (rec.names[p] if p >= 0 else None) == parents[name]
        assert rec.end_ns[i] >= rec.start_ns[i] > 0 and rec.frame[i] == 1
    for name in ("selfcollide", "blocks.launch", "grid_euler.call"):
        assert rec.calls[name] == cfg.n_substeps
    assert rec.counters["block_pairs.partners_swept"] > 0
