"""Self-collision in softbodyunity_torch, held to the JAX package on the CPU:
the Morton sort, the tiles, the partner search and the diagnostics bit for
bit; the plain block forces (the CUDA pair kernel's plain version) against
``blocksparse`` and the Pallas kernel in interpret mode; the dense rule; and
the whole slice — ``step`` on ``cloth_batch_rl`` under each solver with
methods ``block`` and ``dense`` — against JAX ``api.step``, the NumPy oracle
in float64 and the golden trajectory.  Inputs are made with numpy from
fixed seeds and handed to both packages."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softbodyunity_tpu import api as japi
from softbodyunity_tpu.core.config import SelfCollisionParams as JSCParams
from softbodyunity_tpu.core.config import Solver as JSolver
from softbodyunity_tpu.kernels.pallas_blocks import (
    self_collision_forces_block_pallas)
from softbodyunity_tpu.models import presets as jpresets
from softbodyunity_tpu.oracle import reference as oracle
from softbodyunity_tpu.solver import blocksparse as jblocks
from softbodyunity_tpu.solver import forces as jforces

import softbodyunity_torch as tsb
from softbodyunity_torch import convert
from softbodyunity_torch.core.config import SelfCollisionParams
from softbodyunity_torch.kernels import blocks, dispatch, grid_euler
from softbodyunity_torch.solver import blocksparse, forces

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "cloth_batch_rl.npz")


def _params(**kw):
    """tests/test_blocksparse.py's parameters, for both packages."""
    base = dict(enabled=True, method="block", radius=0.05, stiffness=10.0,
                cell_size=0.05, block_partners=16)
    base.update(kw)
    return SelfCollisionParams(**base), JSCParams(**base)


def _cloud(n, side=0.5, seed=None):
    """A seeded random cloud, dense enough for plenty of contacts."""
    rng = np.random.default_rng(n if seed is None else seed)
    return rng.uniform(0, side, (n, 3)).astype(np.float32)


def _folded_sheet():
    """tests/test_blocksparse.py's 48x48 sheet folded into three layers
    0.004 apart, and its parameters."""
    n_side = 48
    xs, ys = np.meshgrid(np.arange(n_side), np.arange(n_side), indexing="ij")
    u = xs.ravel() * 0.01
    layer = (ys.ravel() * 0.01 // 0.16).astype(int)
    yy = np.where(layer % 2 == 0, ys.ravel() * 0.01 % 0.16,
                  0.16 - ys.ravel() * 0.01 % 0.16)
    x = np.stack([u, yy, layer * 0.004], axis=1).astype(np.float32)
    return x, _params(radius=0.006, cell_size=0.012, block_partners=16)


# 500 / 1000: non-multiples of the tile size exercise the padding; 2048:
# many tiles; block 128 covers the tunable tile size
CLOUDS = [(100, 256), (500, 256), (1000, 256), (2048, 256), (100, 128),
          (500, 128), (1000, 128), (2048, 128)]


@pytest.mark.parametrize("n,blk", CLOUDS)
def test_sort_tiles_and_partners_bit_equal_to_jax(n, blk):
    x = _cloud(n)
    tp, jp = _params(block_size=blk, block_partners=min(8, -(-n // blk)))
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    origin = torch.amin(xt, dim=0) - 0.5 * tp.cell_size
    np.testing.assert_array_equal(
        blocksparse.morton_ids(xt, origin, tp.cell_size).numpy(),
        np.asarray(jblocks.morton_ids(
            xj, jnp.min(xj, axis=0) - 0.5 * jp.cell_size, jp.cell_size)))
    tb, tv, to, b = blocksparse._sorted_tiles(xt, tp.cell_size, blk)
    jb, jv, jo, jb_n = jblocks._sorted_tiles(xj, jp.cell_size, blk)
    assert b == jb_n
    for got, want in ((tb, jb), (tv, jv), (to, jo)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    k = min(tp.block_partners, b)
    idx, pvalid, interact = blocksparse._tile_partners(tb, tv, tp.radius, k)
    got = (idx, pvalid, blocksparse.dropped_pairs(interact, pvalid))
    want = jblocks._tile_partners(jb, jv, jp.radius, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got_d = blocksparse.self_collision_block_diagnostics(xt, tp)
    want_d = jblocks.self_collision_block_diagnostics(xj, jp)
    assert {k: int(v) for k, v in got_d.items()} == {
        k: int(v) for k, v in want_d.items()}


@pytest.mark.parametrize("case", ["starved", "folded"])
def test_diagnostics_bit_equal_to_jax(case):
    """The starved budget of tests/test_blocksparse.py (everything piled in
    one spot, one partner per tile: pairs are dropped, and counted) and the
    folded sheet (none dropped)."""
    if case == "starved":
        x = _cloud(4 * blocksparse.BLOCK, side=0.02, seed=0)
        tp, jp = _params(block_partners=1)
    else:
        x, (tp, jp) = _folded_sheet()
    got = blocksparse.self_collision_block_diagnostics(torch.from_numpy(x), tp)
    want = jblocks.self_collision_block_diagnostics(jnp.asarray(x), jp)
    assert int(got["dropped_pairs"]) == int(want["dropped_pairs"])
    assert int(got["candidate_pairs"]) == int(want["candidate_pairs"])
    assert (int(got["dropped_pairs"]) > 0) == (case == "starved")


# tests/test_blocksparse.py:158's kernel-vs-twin tolerance: the Pallas
# kernel takes rsqrt and another summation order
@pytest.mark.parametrize("n,blk", CLOUDS)
def test_plain_block_forces_match_jax_and_pallas(n, blk):
    x = _cloud(n)
    tp, jp = _params(block_size=blk, block_partners=min(8, -(-n // blk)))
    got = blocksparse.self_collision_forces_block(torch.from_numpy(x),
                                                  tp).numpy()
    for want in (jblocks.self_collision_forces_block(jnp.asarray(x), jp),
                 self_collision_forces_block_pallas(jnp.asarray(x), jp,
                                                    interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), atol=5e-4,
                                   rtol=1e-3)
    assert np.abs(got).max() > 0.0


@pytest.mark.parametrize("chunk_rows", [None, 64])
def test_dense_rule_matches_jax(chunk_rows, monkeypatch):
    """The same rule, operations and order as the JAX package; evaluating
    the rows in chunks (a budget of 64 rows here) changes nothing."""
    x = _cloud(300, side=0.3, seed=3)
    if chunk_rows is not None:
        monkeypatch.setattr(forces, "DENSE_CHUNK_BYTES",
                            chunk_rows * 3 * x.shape[0] * x.itemsize)
    got = forces.self_collision_forces_dense(torch.from_numpy(x), 0.05,
                                             10.0).numpy()
    want = np.asarray(jforces.self_collision_forces_dense(jnp.asarray(x),
                                                          0.05, 10.0))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    assert np.abs(want).max() > 0.0


@pytest.mark.parametrize("case", ["folded", "cloud"])
def test_block_equals_dense(case):
    """With no pair dropped the block-sparse pair set is the dense rule's
    (tests/test_blocksparse.py's 5e-4 / 1e-4)."""
    if case == "folded":
        x, (tp, _) = _folded_sheet()
    else:
        x = _cloud(1000)
        tp, _ = _params(block_partners=4)
    xt = torch.from_numpy(x)
    assert int(blocksparse.self_collision_block_diagnostics(
        xt, tp)["dropped_pairs"]) == 0
    f_blk = blocksparse.self_collision_forces_block(xt, tp).numpy()
    f_dns = forces.self_collision_forces_dense(xt, tp.radius,
                                               tp.stiffness).numpy()
    assert np.abs(f_dns).max() > 0.0          # the layers interact
    np.testing.assert_allclose(f_blk, f_dns, atol=5e-4, rtol=1e-4)


def _batch_rl(method, solver=None, jax_side=False):
    """cloth_batch_rl with its self-collision method replaced (the shipping
    dense_mxu is not ported), as tests/test_golden.py does."""
    host, cfg = (jpresets if jax_side else tsb.presets).build("cloth_batch_rl")
    cfg = cfg.replace(self_collision=dataclasses.replace(
        cfg.self_collision, method=method))
    if solver is not None:
        cfg = cfg.replace(solver=solver)
    return host, cfg


# tests/test_stencil.py's x 5e-5 / v 5e-3: the port sums the grid springs
# by stencil, the JAX general path by bands (measured 2.0e-6 / 2.3e-4 on
# Verlet, 1.2e-7 / 6.6e-5 on XPBD, 6e-8 / 1.6e-6 on Euler)
@pytest.mark.parametrize("method", ["block", "dense"])
@pytest.mark.parametrize("solver", list(JSolver))
def test_slice_matches_jax_step(method, solver):
    jhost, jcfg = _batch_rl(method, solver, jax_side=True)
    host = convert.host_from_arrays(
        {f.name: getattr(jhost, f.name) for f in dataclasses.fields(jhost)})
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    jtop, js = japi.init(jhost)
    top, ts = tsb.init(host, device="cpu")
    grid_euler.reset_launch_count()
    blocks.reset_launch_count()
    for _ in range(10):
        js = japi.step(jtop, jcfg, js)
        ts = tsb.step(top, cfg, ts)
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), atol=5e-5)
        np.testing.assert_allclose(ts.v.numpy(), np.asarray(js.v), atol=5e-3)
    moved = float(np.abs(ts.x.numpy() - host.positions0).max())
    assert moved > 1e-2
    # the CPU path runs the plain versions and launches nothing
    assert grid_euler.launch_count() == 0 and blocks.launch_count() == 0


def _oracle_drift(method, n_frames):
    jhost, jcfg = _batch_rl(method, jax_side=True)
    host = convert.host_from_arrays(
        {f.name: getattr(jhost, f.name) for f in dataclasses.fields(jhost)})
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    top, s = tsb.init(host, device="cpu", dtype=torch.float64)
    x = jhost.positions0.copy()
    v = np.zeros_like(x)
    xp = x.copy()
    worst = 0.0
    for _ in range(n_frames):
        x, v, xp = oracle.step(jhost, jcfg, x, v, xp)
        s = tsb.step(top, cfg, s)
        worst = max(worst, float(np.max(np.abs(s.x.numpy() - x))))
    return worst


# tests/test_oracle_parity.py's f64 tier: 1e-6 for the dense rule (the
# oracle's own; the JAX package measures 1.42e-8); block sums the same pairs
# in another order and clamps d at 1e-3 r, which the JAX package's block
# path also shows against the oracle (5.30e-6), hence 1e-5
@pytest.mark.parametrize("method,bound", [("dense", 1e-6), ("block", 1e-5)])
def test_f64_parity_with_oracle(method, bound):
    worst = _oracle_drift(method, 50)
    assert worst < bound, f"{method}: f64 drift {worst:.3e}"


# tests/test_golden.py's 5e-2 for self-collision contact chaos; the first
# recorded frame (10) is also held to 1e-5, before the chaos (the port
# measures 1.8e-7 there and the JAX package's f32 path 2.0e-7 against f64),
# so a wrong force cannot hide behind the loose bound
@pytest.mark.parametrize("method", ["block", "dense"])
def test_golden_replay(method):
    data = np.load(GOLDEN)
    golden = data["positions"]
    every = int(data["record_every"])
    host, cfg = _batch_rl(method)
    top, s = tsb.init(host, device="cpu")
    for r in range(golden.shape[0]):
        for _ in range(every):
            s = tsb.step(top, cfg, s)
        drift = float(np.max(np.abs(s.x.numpy() - golden[r])))
        bound = 1e-5 if r == 0 else 5e-2
        assert drift < bound, f"{method}: drift {drift:.3e} at record {r}"


@pytest.mark.parametrize("method", ["block", "dense"])
def test_grid_path_takes_self_collision_scenes(method):
    """A grid scene with self-collision takes the plain grid path on the
    CPU (the JAX dispatcher sends it to its general path), and the force
    plane changes the result: the sheet shrunk to half its size puts
    neighbours at 0.02, inside the 0.03 radius."""
    host, cfg = _batch_rl(method)
    top, s0 = tsb.init(host, device="cpu")
    s0 = s0.replace(x=0.5 * s0.x)
    fn = dispatch.maybe_fast_step(top, cfg)
    assert fn.__qualname__ == "make_stencil_step.<locals>.fn"
    with_sc = tsb.step(top, cfg, s0)
    off = cfg.replace(self_collision=dataclasses.replace(
        cfg.self_collision, enabled=False))
    without = tsb.step(top, off, s0)
    assert not torch.equal(with_sc.x, without.x)


def test_block_kernel_wrapper_refuses_the_cpu():
    """The pair kernel runs on a CUDA device or raises: no CPU fallback."""
    tp, _ = _params()
    x = torch.from_numpy(_cloud(100))
    with pytest.raises(ValueError, match="CUDA"):
        blocks.self_collision_forces_block_cuda(x, tp)
    with pytest.raises(ValueError, match="CUDA"):
        blocks.make_block_pairs(tp, 100, "cpu")
    with pytest.raises(ValueError, match="block_size"):
        blocks.make_block_pairs(
            dataclasses.replace(tp, block_size=100), 100, "cuda")
