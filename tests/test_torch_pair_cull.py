"""The block_pairs kernel's cull (csrc/block_pairs.cu), held on the CPU: a
warp of 32 i-vertices skips a 32-vertex slice of a partner tile when the
squared gap of their boxes exceeds r^2 (1 + 2^-10), and that is exact only
if every pair it skips has w == 0 in the kernel's float32 arithmetic.

The tiles and partners are the JAX package's own (its Morton sort and bbox
partner search, ``softbodyunity_tpu/solver/blocksparse.py``, on the same
numpy-seeded positions), padded as the kernel takes them; the port's
``kernels/blocks.py::pair_inputs`` is held to them to the bit.  On seeded
clouds, tests/test_blocksparse.py's folded sheets, two self-collision
cloths shrunk so that every neighbour is inside the radius, and the dual
form's row shards, every pair of a sub-block pair that
``kept_sub_blocks`` drops has w == 0 (``torch.rsqrt``, eps2, c1, c2 as the
wrapper rounds them) and d2 > r^2 (1 + 2^-11), and every pair with w > 0
lies in a kept sub-block pair.  At the edge, pairs at distances around r:
the pair at d = r is swept, and every skipped one has w == 0 also with
d2 formed in one rounding (the card's FMAs) and rsqrt 2 ulps high (the
card's rsqrtf)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softbodyunity_tpu.core.config import SelfCollisionParams as JSCParams
from softbodyunity_tpu.solver import blocksparse as jblocks

import softbodyunity_torch as tsb
from softbodyunity_torch.core.config import SelfCollisionParams
from softbodyunity_torch.kernels import blocks

torch.set_num_threads(1)


def _params(**kw):
    """tests/test_blocksparse.py's parameters, for both packages."""
    base = dict(enabled=True, method="block", radius=0.05, stiffness=10.0,
                cell_size=0.05, block_partners=16)
    base.update(kw)
    return SelfCollisionParams(**base), JSCParams(**base)


def _folded(n_side, span, gap):
    """tests/test_blocksparse.py's folded sheets: n_side^2 vertices at
    spacing 0.01, folded back over itself every ``span`` in y, the layers
    ``gap`` apart."""
    xs, ys = np.meshgrid(np.arange(n_side), np.arange(n_side), indexing="ij")
    layer = (ys.ravel() * 0.01 // span).astype(int)
    yy = np.where(layer % 2 == 0, ys.ravel() * 0.01 % span,
                  span - ys.ravel() * 0.01 % span)
    return np.stack([xs.ravel() * 0.01, yy, layer * gap],
                    axis=1).astype(np.float32)


def _shrunk_cloth(preset):
    """A self-collision preset's cloth at rest, shrunk to 60 % about the
    origin: every structural neighbour inside the radius (chip_smoke.py's
    check scene), with the preset's parameters (method ``block``)."""
    host, cfg = tsb.presets.build(preset)
    sc = cfg.self_collision
    base = {f: getattr(sc, f) for f in ("radius", "stiffness", "cell_size",
                                        "block_partners", "block_size")}
    return (0.6 * host.positions0).astype(np.float32), _params(**base)


def _scene(name):
    """(positions, (torch params, JAX params)) of a named scene."""
    if name.startswith("cloud"):
        n, blk = (int(v) for v in name.split()[1:])
        x = np.random.default_rng(n + blk).uniform(0, 0.5, (n, 3))
        return x.astype(np.float32), _params(
            block_size=blk, block_partners=min(8, -(-n // blk)))
    if name == "folded 48":
        return _folded(48, 0.16, 0.004), _params(radius=0.006,
                                                 cell_size=0.012)
    if name == "folded 128":
        p16 = tsb.presets.build("cloth_selfcollide_16k")[1].self_collision
        return _folded(128, 0.32, 0.75 * p16.radius), _params(
            radius=p16.radius, stiffness=p16.stiffness,
            cell_size=p16.cell_size, block_partners=p16.block_partners)
    return _shrunk_cloth(name)


SCENES = ["cloud 500 256", "cloud 1000 256", "cloud 2048 256",
          "cloud 1000 128", "cloud 2048 128", "folded 48", "folded 128",
          "cloth_batch_rl", "cloth_selfcollide_16k"]


def _jax_inputs(jp, x, xi=None):
    """The kernel's inputs from the JAX package's sort and partner search:
    ``(xi_tiles, xj_tiles, nvalid, partners)``, the tiles ``[B, 3, blk]``
    float32 with the tail at +1e6 (the dual form's i-tiles at -1e6)."""
    blk = jp.block_size
    xb_g, valid_g, _, b_g = jblocks._sorted_tiles(jnp.asarray(x),
                                                  jp.cell_size, blk)
    k = min(jp.block_partners, b_g)
    if xi is None:
        xb_i, valid_i = xb_g, valid_g
        idx, pvalid, _ = jblocks._tile_partners(xb_i, valid_i, jp.radius, k)
    else:
        xb_i, valid_i, _, _ = jblocks._sorted_tiles(jnp.asarray(xi),
                                                    jp.cell_size, blk)
        idx, pvalid, _ = jblocks._tile_partners(
            xb_i, valid_i, jp.radius, k, xb_j=xb_g, valid_j=valid_g)

    def tiles(xb, valid, pad):
        t = np.where(np.asarray(valid)[..., None], np.asarray(xb), pad)
        return torch.from_numpy(
            np.ascontiguousarray(t.astype(np.float32).transpose(0, 2, 1)))

    return (tiles(xb_i, valid_i, 1e6 if xi is None else -1e6),
            tiles(xb_g, valid_g, 1e6),
            torch.from_numpy(np.asarray(pvalid).sum(axis=1).astype(np.int64)),
            torch.from_numpy(np.asarray(idx).astype(np.int64)))


def _weights(p, xi_tiles, xj_tiles):
    """w of every pair of each i-tile ``[M, 3, blk]`` and its partner tile
    ``[M, 3, blk]``, ``[M, blk, blk]``, and d2: the kernel's float32
    formula, w = max(c1 rsqrt(max(d2, eps2)) - c2, 0), with eps2, c1 and c2
    rounded from double as the wrapper rounds them."""
    f32 = torch.float32
    eps2 = torch.tensor((1e-3 * p.radius) ** 2, dtype=f32)
    c1 = torch.tensor(p.stiffness * p.radius, dtype=f32)
    c2 = torch.tensor(p.stiffness, dtype=f32)
    d = xi_tiles[:, :, :, None] - xj_tiles[:, :, None, :]   # [M, 3, blk, blk]
    d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    w = torch.clamp_min(c1 * torch.rsqrt(torch.clamp_min(d2, eps2)) - c2, 0.0)
    return w, d2


def _check_cull(p, xi_tiles, xj_tiles, nvalid, partners):
    """Every pair of a dropped sub-block pair has w == 0 and d2 > r^2 (1 +
    2^-11); every pair with w > 0 lies in a kept one.  Returns (kept,
    sub-block pairs, pairs with w > 0)."""
    kept = blocks.kept_sub_blocks(xi_tiles, xj_tiles, nvalid, partners,
                                  p.radius)
    blk = xi_tiles.shape[2]
    s = blk // blocks.SUB_BLOCK
    assert kept.shape == (*partners.shape, s, s)
    ii, kk = torch.nonzero(torch.arange(partners.shape[1])[None, :]
                           < nvalid[:, None], as_tuple=True)
    assert not kept[~(torch.arange(partners.shape[1])[None, :]
                      < nvalid[:, None])].any()
    positive = 0
    for c in range(0, ii.numel(), 32):
        i, k = ii[c:c + 32], kk[c:c + 32]
        w, d2 = _weights(p, xi_tiles[i], xj_tiles[partners[i, k]])
        m = i.numel()
        keep = kept[i, k]                                     # [m, S, S]
        # [m, S, 32, S, 32] -> each pair with its sub-block's verdict
        keep_pairs = keep[:, :, None, :, None].expand(
            m, s, 32, s, 32).reshape(m, blk, blk)
        assert bool((w[~keep_pairs] == 0.0).all())
        if bool((~keep_pairs).any()):
            assert float(d2[~keep_pairs].min()) > p.radius ** 2 * (
                1.0 + 2.0 ** -11)
        assert bool(keep_pairs[w > 0.0].all())
        positive += int((w > 0.0).sum())
    return int(kept.sum()), ii.numel() * s * s, positive


@pytest.mark.parametrize("scene", SCENES)
def test_cull_drops_only_pairs_out_of_reach(scene):
    """The single form: the JAX package's tiles and partners (and the
    port's pair_inputs, to the bit); some sub-block pairs dropped, some
    pairs interacting."""
    x, (tp, jp) = _scene(scene)
    inputs = _jax_inputs(jp, x)
    got = blocks.pair_inputs(tp, torch.from_numpy(x))
    for g, want in zip(got[1:4], inputs[1:]):
        assert torch.equal(g, want)
    assert torch.equal(got[0], inputs[0])
    kept, total, positive = _check_cull(tp, *inputs)
    assert positive > 0
    assert 0 < kept < total


@pytest.mark.parametrize("n_ranks", [2, 4])
@pytest.mark.parametrize("scene", ["cloud 2048 256", "folded 128",
                                   "cloth_selfcollide_16k"])
def test_dual_cull_drops_only_pairs_out_of_reach(scene, n_ranks):
    """The dual form on row shards: each rank's i-tiles (pads at -1e6)
    against the whole set's tiles (pads at +1e6)."""
    x, (tp, jp) = _scene(scene)
    ni = x.shape[0] // n_ranks
    kept_all = total_all = 0
    for r in range(n_ranks):
        xi = x[r * ni:(r + 1) * ni]
        inputs = _jax_inputs(jp, x, xi)
        got = blocks.pair_inputs(tp, torch.from_numpy(xi),
                                 torch.from_numpy(x))
        for g, want in zip(got[:4], inputs):
            assert torch.equal(g, want)
        kept, total, _ = _check_cull(tp, *inputs)
        kept_all, total_all = kept_all + kept, total_all + total
    assert 0 < kept_all < total_all


def _pair_tiles(a, b):
    """A tile of 32 copies of each point of ``a`` [M, 3] and one of each
    point of ``b``: ``(xi_tiles, xj_tiles, nvalid, partners)`` of M tile
    pairs, M i-tiles of 32 vertices, tile m against partner m."""
    m = a.shape[0]
    xi = torch.from_numpy(a)[:, :, None].expand(m, 3, 32).contiguous()
    xj = torch.from_numpy(b)[:, :, None].expand(m, 3, 32).contiguous()
    return (xi, xj, torch.ones(m, dtype=torch.int64),
            torch.arange(m, dtype=torch.int64)[:, None])


@pytest.mark.parametrize("radius,stiffness", [
    (0.05, 10.0), (0.008, 60.0), (0.006, 10.0), (0.0123, 0.5), (1.0, 1e4),
    (3.0, 1e-3)])
def test_margin_holds_at_the_radius(radius, stiffness):
    """Two points at distances d from r (1 - 2^-9) to r (1 + 2^-9), along
    an axis and a diagonal: the pair at float32 d = r is swept, every pair
    with w > 0 is swept, and every skipped pair has w == 0 under the
    kernel's formula in float32, with d2 formed in one rounding from exact
    squares (the card's FMAs) and with rsqrt 2 ulps high (the card's
    rsqrtf), and d2 > r^2 (1 + 2^-11)."""
    p, _ = _params(radius=radius, stiffness=stiffness)
    r = np.float32(radius)
    t = np.linspace(-2.0 ** -9, 2.0 ** -9, 4097)
    d = (np.float64(r) * (1.0 + t)).astype(np.float32)
    d = np.unique(np.concatenate([d, [r]]))
    zeros = np.zeros_like(d)
    base = np.float32(0.25)
    axis = np.stack([base + d, zeros + base, zeros + base], axis=1)
    diag = np.stack([base + d * np.float32(0.6), base + d * np.float32(0.8),
                     zeros + base], axis=1)
    for b in (axis, diag):
        a = np.full_like(b, base)
        xi, xj, nvalid, partners = _pair_tiles(a, b.astype(np.float32))
        kept = blocks.kept_sub_blocks(xi, xj, nvalid, partners,
                                      p.radius)[:, 0, 0, 0]
        w, d2 = _weights(p, xi[:, :, :1], xj[:, :, :1])
        w, d2 = w[:, 0, 0], d2[:, 0, 0]
        assert bool(kept[torch.from_numpy(d == r)].all())
        assert bool(kept[w > 0.0].all())
        skipped = ~kept
        assert bool(skipped.any()) and bool(kept.any())
        assert bool((w[skipped] == 0.0).all())
        # the card's arithmetic: one rounding for d2, rsqrtf 2 ulps high,
        # c1 rs - c2 contracted into one FMA
        diff = (a.astype(np.float64) - b.astype(np.float32)).astype(
            np.float32).astype(np.float64)
        d2_fma = torch.from_numpy(
            (diff * diff).sum(axis=1).astype(np.float32).astype(np.float64))
        rs_hi = torch.rsqrt(d2_fma) * (1.0 + 2.0 ** -21)
        c1 = float(np.float32(p.stiffness * p.radius))
        c2 = float(np.float32(p.stiffness))
        assert bool((c1 * rs_hi[skipped] - c2 <= 0.0).all())
        for dd in (d2[skipped].double(), d2_fma[skipped]):
            assert float(dd.min()) > p.radius ** 2 * (1.0 + 2.0 ** -11)


def test_non_finite_coordinates_are_never_skipped():
    """A slice with a NaN or infinite coordinate has an infinite box: its
    sub-block pairs are swept, as the dense sweep would have met them."""
    a = np.array([[0.0, 0.0, 0.0]] * 3, dtype=np.float32)
    b = np.array([[5.0, np.nan, 0.0], [np.inf, 5.0, 5.0],
                  [5.0, 5.0, 5.0]], dtype=np.float32)
    p, _ = _params(radius=0.05)
    kept = blocks.kept_sub_blocks(*_pair_tiles(a, b), p.radius)[:, 0, 0, 0]
    assert kept.tolist() == [True, True, False]


# --- the point test: each partner vertex of a kept slice against the warp's
# box (csrc/block_pairs.cu, "The cull") --------------------------------------

def _check_point_cull(p, xi_tiles, xj_tiles, nvalid, partners):
    """Every pair of a partner vertex that ``kept_partner_vertices`` drops
    for a warp has w == 0 and d2 > r^2 (1 + 2^-11); every pair with w > 0
    is swept; the kept vertices lie in kept slices.  Returns (kept
    vertices, vertices of the kept slices, pairs with w > 0)."""
    kept = blocks.kept_sub_blocks(xi_tiles, xj_tiles, nvalid, partners,
                                  p.radius)
    kv = blocks.kept_partner_vertices(xi_tiles, xj_tiles, nvalid, partners,
                                      p.radius)
    blk = xi_tiles.shape[2]
    s = blk // blocks.SUB_BLOCK
    assert kv.shape == (*partners.shape, s, blk)
    in_slices = kept.repeat_interleave(blocks.SUB_BLOCK, dim=-1)
    assert not bool((kv & ~in_slices).any())
    ii, kk = torch.nonzero(torch.arange(partners.shape[1])[None, :]
                           < nvalid[:, None], as_tuple=True)
    positive = 0
    for c in range(0, ii.numel(), 32):
        i, k = ii[c:c + 32], kk[c:c + 32]
        w, d2 = _weights(p, xi_tiles[i], xj_tiles[partners[i, k]])
        m = i.numel()
        # [m, S, blk] -> each pair (warp a's lane, partner vertex j)
        keep = kv[i, k][:, :, None, :].expand(m, s, 32, blk).reshape(
            m, blk, blk)
        assert bool((w[~keep] == 0.0).all())
        if bool((~keep).any()):
            assert float(d2[~keep].min()) > p.radius ** 2 * (
                1.0 + 2.0 ** -11)
        assert bool(keep[w > 0.0].all())
        positive += int((w > 0.0).sum())
    return int(kv.sum()), int(in_slices.sum()), positive


@pytest.mark.parametrize("scene", SCENES)
def test_point_cull_drops_only_pairs_out_of_reach(scene):
    """The single form, on every scene of the slice cull's test: the point
    test keeps fewer partner vertices than the kept slices hold, and drops
    only pairs with w == 0."""
    x, (tp, _) = _scene(scene)
    inputs = blocks.pair_inputs(tp, torch.from_numpy(x))
    kept, in_slices, positive = _check_point_cull(tp, *inputs[:4])
    assert positive > 0
    assert 0 < kept < in_slices


@pytest.mark.parametrize("n_ranks", [2, 4])
@pytest.mark.parametrize("scene", ["cloud 2048 256", "folded 128",
                                   "cloth_selfcollide_16k"])
def test_dual_point_cull_drops_only_pairs_out_of_reach(scene, n_ranks):
    """The dual form on row shards, the i-tiles' pads at -1e6."""
    x, (tp, _) = _scene(scene)
    ni = x.shape[0] // n_ranks
    kept_all = in_slices_all = 0
    for r in range(n_ranks):
        xi = torch.from_numpy(x[r * ni:(r + 1) * ni])
        inputs = blocks.pair_inputs(tp, xi, torch.from_numpy(x))
        kept, in_slices, _ = _check_point_cull(tp, *inputs[:4])
        kept_all, in_slices_all = kept_all + kept, in_slices_all + in_slices
    assert 0 < kept_all < in_slices_all


@pytest.mark.parametrize("radius,stiffness", [
    (0.05, 10.0), (0.008, 60.0), (0.006, 10.0), (0.0123, 0.5), (1.0, 1e4),
    (3.0, 1e-3)])
@pytest.mark.parametrize("warp", ["point", "box"])
def test_point_margin_holds_at_the_radius(radius, stiffness, warp):
    """A partner vertex at distances d from r (1 - 2^-9) to r (1 + 2^-9)
    past the warp's nearest vertex, along an axis and a diagonal, with the
    warp's 32 vertices on one point or spread into a box behind it: the
    vertex at float32 d = r is kept, every pair with w > 0 is swept, and
    every skipped pair has w == 0 under the kernel's formula in float32,
    with d2 formed in one rounding (the card's FMAs) and rsqrt 2 ulps high
    (the card's rsqrtf), and d2 > r^2 (1 + 2^-11)."""
    p, _ = _params(radius=radius, stiffness=stiffness)
    r = np.float32(radius)
    t = np.linspace(-2.0 ** -9, 2.0 ** -9, 2049)
    d = (np.float64(r) * (1.0 + t)).astype(np.float32)
    d = np.unique(np.concatenate([d, [r]]))
    m = d.shape[0]
    base = np.float32(0.25)
    # the warp: lane 0 at base, the others up to 4 r behind it on -x, -y
    back = (np.arange(32, dtype=np.float32) / np.float32(31) * np.float32(
        4.0) * r) if warp == "box" else np.zeros(32, dtype=np.float32)
    a = np.stack([base - back, base - back, np.full(32, base)], axis=1)
    c1 = float(np.float32(p.stiffness * p.radius))
    c2 = float(np.float32(p.stiffness))
    for ux, uy in ((1.0, 0.0), (0.6, 0.8)):
        b = np.stack([base + d * np.float32(ux), base + d * np.float32(uy),
                      np.full(m, base)], axis=1).astype(np.float32)
        xi = torch.from_numpy(a.T.copy())[None].expand(m, 3, 32).contiguous()
        # partner vertex 0 at b, the rest of its slice on b too
        xj = torch.from_numpy(b)[:, :, None].expand(m, 3, 32).contiguous()
        nvalid = torch.ones(m, dtype=torch.int64)
        partners = torch.arange(m, dtype=torch.int64)[:, None]
        kv = blocks.kept_partner_vertices(xi, xj, nvalid, partners,
                                          p.radius)[:, 0, 0, 0]
        w, d2 = _weights(p, xi, xj)
        w, d2 = w[:, :, 0], d2[:, :, 0]                   # [m, 32 lanes]
        assert bool(kv[torch.from_numpy(d == r)].all())
        assert bool(kv[(w > 0.0).any(dim=1)].all())
        skipped = ~kv
        assert bool(skipped.any()) and bool(kv.any())
        assert bool((w[skipped] == 0.0).all())
        diff = (a.astype(np.float32)[None].astype(np.float64)
                - b.astype(np.float64)[:, None])          # [m, 32, 3]
        diff = diff.astype(np.float32).astype(np.float64)
        d2_fma = torch.from_numpy(
            (diff * diff).sum(axis=2).astype(np.float32).astype(np.float64))
        rs_hi = torch.rsqrt(d2_fma) * (1.0 + 2.0 ** -21)
        assert bool((c1 * rs_hi[skipped] - c2 <= 0.0).all())
        for dd in (d2[skipped].double(), d2_fma[skipped]):
            assert float(dd.min()) > p.radius ** 2 * (1.0 + 2.0 ** -11)


FAR_VALUES = [float("inf"), float("-inf"), float("nan"), 1.5 * 2.0 ** 126,
              -1.5 * 2.0 ** 126]


def _far_slice(value, axis, in_warp):
    """A warp of 32 vertices at the origin and a partner slice whose vertex
    0 is in reach (0.5 r along x), vertex 1 at 5 but for ``value`` on
    ``axis``, and the rest at 5 on every axis; with ``in_warp`` the far
    value sits in the warp's lane 7 instead, vertex 1 at 5."""
    xi = torch.zeros(1, 3, 32)
    xj = torch.full((1, 3, 32), 5.0)
    xj[0, :, 0] = torch.tensor([0.025, 0.0, 0.0])
    (xi[0, axis, 7] if in_warp else xj[0, axis, 1]).fill_(value)
    return (xi, xj, torch.ones(1, dtype=torch.int64),
            torch.zeros((1, 1), dtype=torch.int64))


@pytest.mark.parametrize("value", FAR_VALUES)
@pytest.mark.parametrize("axis", [0, 2])
def test_far_partner_vertices_are_never_skipped(value, axis):
    """A partner vertex with a coordinate not finite or past 2^126 in a
    kept slice is swept, as the dense sweep meets it (a NaN or an infinity
    makes its pairs NaN, and two such finite coordinates of opposite sign
    an infinite difference); the other far vertices of the slice are
    dropped."""
    p, _ = _params(radius=0.05)
    kv = blocks.kept_partner_vertices(*_far_slice(value, axis, False),
                                      p.radius)[0, 0, 0]
    assert kv.tolist() == [True, True] + [False] * 30


@pytest.mark.parametrize("value", FAR_VALUES)
def test_a_warp_with_a_far_vertex_keeps_its_kept_slices_whole(value):
    p, _ = _params(radius=0.05)
    inputs = _far_slice(value, 1, True)
    assert bool(blocks.kept_sub_blocks(*inputs, p.radius).all())
    kv = blocks.kept_partner_vertices(*inputs, p.radius)[0, 0, 0]
    assert bool(kv.all())
