"""The row-sharded grid cloth of softbodyunity_torch (``parallel/halo.py``
over ``parallel/ring.py``), held to the JAX package's halo paths on the CPU.

Every scene is built by the JAX package and carried across with
``softbodyunity_torch.convert``; the JAX halo runs on ``jax.devices()[:P]``
(the forced host devices of ``tests/conftest.py``), the port on a
``LocalRing(P)`` of P threads.  The self-collision scene of
``tests/test_halo.py:662-714`` is held at its tolerances for the three
solvers and P = 1, 2, 4, and over its first 4 substeps at 1e-5, so a force
bug cannot hide in the contact chaos; the dual pair form alone against the
JAX plain version and its Pallas kernel (interpret mode); the collider and
feature scenes of ``tests/test_halo.py`` at theirs; ``DistRing`` over gloo
processes against ``LocalRing`` to the bit; and the refusals."""

import contextlib
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from softbodyunity_tpu import api as japi
from softbodyunity_tpu.core import config as jc
from softbodyunity_tpu.core.topology import cloth_grid as jcloth_grid
from softbodyunity_tpu.kernels.pallas_blocks import (
    self_collision_forces_block_dual_pallas)
from softbodyunity_tpu.parallel import halo as jhalo
from softbodyunity_tpu.solver import blocksparse as jblocks

import softbodyunity_torch as tsb
from softbodyunity_torch import api as tapi
from softbodyunity_torch import convert
from softbodyunity_torch.kernels import blocks
from softbodyunity_torch.kernels import stencil as st
from softbodyunity_torch.parallel import halo
from softbodyunity_torch.parallel.ring import HALO, LocalRing
from softbodyunity_torch.solver import blocksparse

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOLVERS = {"euler": jc.Solver.SEMI_IMPLICIT_EULER,
           "verlet": jc.Solver.VERLET, "xpbd": jc.Solver.XPBD}
JMAKE = {"euler": jhalo.make_halo_step, "verlet": jhalo.make_halo_verlet_step,
         "xpbd": jhalo.make_halo_xpbd_step}
TMAKE = {"euler": halo.make_halo_step, "verlet": halo.make_halo_verlet_step,
         "xpbd": halo.make_halo_xpbd_step}


def _port(jhost, jcfg):
    host = convert.host_from_arrays(
        {f.name: getattr(jhost, f.name) for f in dataclasses.fields(jhost)})
    return host, convert.config_from_dict(dataclasses.asdict(jcfg))


@contextlib.contextmanager
def _jax_x64(on):
    """JAX in float64 inside the block (as tests/test_halo.py:226-258 runs
    its float64 leg), float32 again after it."""
    if on:
        jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        if on:
            jax.config.update("jax_enable_x64", False)


def _jax_halo(jhost, jcfg, solver, n_dev, n_sub, colliders=False,
              features=False, f64=False):
    """The JAX halo path's outputs as NumPy planes: ``(x3, v3[, alive][,
    scale])`` of the whole cloth."""
    with _jax_x64(f64):
        return _jax_halo_run(jhost, jcfg, solver, n_dev, n_sub, colliders,
                             features, jnp.float64 if f64 else jnp.float32)


def _jax_halo_run(jhost, jcfg, solver, n_dev, n_sub, colliders, features,
                  dtype):
    jtop, js = japi.init(jhost, dtype=dtype)
    mesh = Mesh(np.array(jax.devices()[:n_dev]), (jhalo.ROWS_AXIS,))
    fn = jax.jit(JMAKE[solver](jtop, jcfg, mesh), static_argnums=(5,))
    x3, v3, im3, ph = jhalo.shard_grid_state(jtop, js, mesh)
    kw = {}
    if colliders:
        if jcfg.collision.enable_spheres:
            kw.update(sphere_centers=jtop.sphere_centers,
                      sphere_radii=jtop.sphere_radii)
        if jcfg.collision.enable_capsules or jcfg.collision.enable_boxes:
            kw["capsules"], kw["boxes"] = jhalo.pack_capsule_box_geometry(
                jtop)
    if features:
        js = japi.ensure_plastic_state(jtop, jcfg,
                                       japi.ensure_tear_state(jtop, jcfg, js))
        shard, _ = jhalo.tear_plane_shard_maps(jtop, jcfg, mesh)
        kw.update(alive3=shard(js.edge_alive), scale3=shard(js.rest_scale))
    out = fn(x3, x3 if solver == "verlet" else v3, im3, ph, jcfg.dt, n_sub,
             **kw)
    return [np.asarray(o) for o in out]


def _port_halo(jhost, jcfg, solver, n_ranks, n_sub, colliders=False,
               features=False, f64=False):
    """The port's halo path on a ``LocalRing(n_ranks)`` over the CPU, the
    same outputs gathered."""
    host, cfg = _port(jhost, jcfg)
    top, s = tsb.init(host, device="cpu",
                      dtype=torch.float64 if f64 else torch.float32)
    if features:
        s = tapi.ensure_plastic_state(top, cfg,
                                      tapi.ensure_tear_state(top, cfg, s))
    ring = LocalRing(n_ranks)
    fn = TMAKE[solver](top, cfg, ring)

    def rank_main():
        x3, v3, im3, ph = halo.shard_grid_state(top, s, ring)
        kw = {}
        if colliders:
            if cfg.collision.enable_spheres:
                kw.update(sphere_centers=top.sphere_centers,
                          sphere_radii=top.sphere_radii)
            if cfg.collision.enable_capsules or cfg.collision.enable_boxes:
                kw["capsules"], kw["boxes"] = halo.pack_capsule_box_geometry(
                    top)
        if features:
            shard, _ = halo.tear_plane_shard_maps(top, cfg, ring)
            kw.update(alive3=shard(s.edge_alive), scale3=shard(s.rest_scale))
        out = fn(x3, x3 if solver == "verlet" else v3, im3, ph, cfg.dt,
                 n_sub, **kw)
        return [ring.gather_rows(o).numpy() for o in out]

    outs = ring.run(rank_main)
    for o in outs[1:]:                   # every rank gathered the same cloth
        for a, b in zip(o, outs[0]):
            np.testing.assert_array_equal(a, b)
    return outs[0]


def _port_single(jhost, jcfg, n_sub):
    """The port's single-device path (``step`` on the CPU) from rest:
    ``(x3, v3)`` planes, what tests/test_halo.py holds the JAX halo to."""
    host, cfg = _port(jhost, jcfg)
    top, s = tsb.init(host, device="cpu")
    s = tsb.step(top, cfg, s, n_substeps=n_sub)
    ny, nx = top.grid_shape
    return [st.to_planes(s.x, ny, nx).numpy(),
            st.to_planes(s.v, ny, nx).numpy()]


def _contact_scene(jhost, jcfg, solver, n_ranks, n_sub, atol_x, atol_v=None,
                   colliders=False):
    """A scene with contact, where float32 runs part at knife edges: a
    vertex just projected onto a surface ends the next substep within ulps
    of it, and one ulp decides the contact (the port's stencil and the JAX
    stencil already part there, tests/test_torch_xpbd_verlet.py:100-104).
    So the port's halo is held to the JAX halo over the first 4 substeps
    in float32 (at 1e-5) and over the whole run in float64, where the two
    packages' rounding (~1e-13) is far below every contact margin, at the
    JAX test's tolerance; and in float32 to the port's own single-device
    path at the JAX test's tolerance (the relation tests/test_halo.py
    checks).  Returns the float32 run."""
    got = _port_halo(jhost, jcfg, solver, n_ranks, 4, colliders=colliders)
    _assert_close(got, _jax_halo(jhost, jcfg, solver, n_ranks, 4,
                                 colliders=colliders), 1e-5)
    _assert_close(
        _port_halo(jhost, jcfg, solver, n_ranks, n_sub, colliders=colliders,
                   f64=True),
        _jax_halo(jhost, jcfg, solver, n_ranks, n_sub, colliders=colliders,
                  f64=True), atol_x, atol_v)
    got = _port_halo(jhost, jcfg, solver, n_ranks, n_sub, colliders=colliders)
    _assert_close(got, _port_single(jhost, jcfg, n_sub), atol_x, atol_v)
    return got


# --- the self-collision scene -------------------------------------------------

def _sc_scene(solver):
    """tests/test_halo.py:662-714: a 16x32 curtain whose self-collision
    radius (0.08) exceeds its spacing (0.05), so the repulsion acts from the
    first substep; the plane far below."""
    cfg = jc.SimConfig(
        solver=SOLVERS[solver],
        springs=jc.SpringParams(k_structural=300.0, k_shear=150.0,
                                k_bend=60.0, damping=0.5),
        collision=jc.CollisionParams(enable_plane=True, friction=0.2),
        global_damping=0.4,
        self_collision=jc.SelfCollisionParams(
            enabled=True, method="block", radius=0.08, stiffness=20.0,
            cell_size=0.16, block_partners=16))
    host = jcloth_grid(16, 32, spacing=0.05, mass=0.05, shear=True, bend=True,
                       pinned=("top",), springs=cfg.springs, xpbd=cfg.xpbd,
                       plane_height=-5.0, orientation="xy")
    return host, cfg


@pytest.fixture(scope="module")
def sc_reference():
    """The JAX halo on the self-collision scene, computed once per
    (solver, P, substeps)."""
    cache = {}

    def get(solver, n_dev, n_sub):
        key = (solver, n_dev, n_sub)
        if key not in cache:
            cache[key] = _jax_halo(*_sc_scene(solver), solver, n_dev, n_sub)
        return cache[key]

    return get


# tests/test_halo.py:712's tolerances after 96 substeps (the Euler clamp of
# the feedback amplifies rounding); the first 4 substeps at 1e-5
@pytest.mark.parametrize("n_ranks", [1, 2, 4])
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_self_collision_matches_jax_halo(solver, n_ranks, sc_reference):
    jhost, jcfg = _sc_scene(solver)
    for n_sub, atol in ((4, 1e-5),
                        (96, 3e-4 if solver == "euler" else 1.5e-4)):
        got = _port_halo(jhost, jcfg, solver, n_ranks, n_sub)
        want = sc_reference(solver, n_ranks, n_sub)
        assert np.isfinite(got[0]).all()
        np.testing.assert_allclose(got[0], want[0], atol=atol)
    # the curtain moved, and the repulsion acts in this scene
    assert np.abs(got[0] - np.asarray(jhost.positions0).T.reshape(
        got[0].shape)).max() > 1e-2


def test_self_collision_changes_the_halo_result():
    """The force is not inert: without it the 4-substep state differs."""
    jhost, jcfg = _sc_scene("euler")
    off = jcfg.replace(self_collision=dataclasses.replace(
        jcfg.self_collision, enabled=False))
    with_sc = _port_halo(jhost, jcfg, "euler", 2, 4)[0]
    without = _port_halo(jhost, off, "euler", 2, 4)[0]
    assert np.abs(with_sc - without).max() > 1e-6


# --- the dual pair form alone ------------------------------------------------

def _folded_sheet():
    """tests/test_blocksparse.py's 48x48 sheet folded into three layers
    0.004 apart (rows of 48 vertices), and its parameters."""
    n_side = 48
    xs, ys = np.meshgrid(np.arange(n_side), np.arange(n_side), indexing="ij")
    u = xs.ravel() * 0.01
    layer = (ys.ravel() * 0.01 // 0.16).astype(int)
    yy = np.where(layer % 2 == 0, ys.ravel() * 0.01 % 0.16,
                  0.16 - ys.ravel() * 0.01 % 0.16)
    x = np.stack([u, yy, layer * 0.004], axis=1).astype(np.float32)
    return x, dict(enabled=True, method="block", radius=0.006,
                   cell_size=0.012, stiffness=10.0, block_partners=16)


def _cloud():
    rng = np.random.default_rng(7)
    return (rng.uniform(0, 0.5, (2048, 3)).astype(np.float32),
            dict(enabled=True, method="block", radius=0.05, stiffness=10.0,
                 cell_size=0.05, block_partners=8))


# tests/test_blocksparse.py's 5e-4 / 1e-3 between a kernel and its twin; the
# plain versions take the same operations in the same order: 1e-6
@pytest.mark.parametrize("n_ranks,rank", [(2, 0), (2, 1), (4, 0), (4, 3)])
@pytest.mark.parametrize("case", ["folded", "cloud"])
def test_dual_plain_matches_jax(case, n_ranks, rank):
    x, kw = _folded_sheet() if case == "folded" else _cloud()
    tp, jp = tsb.SelfCollisionParams(**kw), jc.SelfCollisionParams(**kw)
    ni = x.shape[0] // n_ranks
    xi = x[rank * ni:(rank + 1) * ni]
    got = blocksparse.self_collision_forces_block_dual(
        torch.from_numpy(xi), torch.from_numpy(x), tp).numpy()
    want = jblocks.self_collision_forces_block_dual(jnp.asarray(xi),
                                                    jnp.asarray(x), jp)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=1e-6)
    pallas = self_collision_forces_block_dual_pallas(
        jnp.asarray(xi), jnp.asarray(x), jp, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=5e-4, rtol=1e-3)
    assert np.abs(got).max() > 0.0
    # the dual diagnostics count the JAX partner search's pairs
    d = blocksparse.self_collision_block_dual_diagnostics(
        torch.from_numpy(xi), torch.from_numpy(x), tp)
    xb_i, valid_i, _, _ = jblocks._sorted_tiles(jnp.asarray(xi), jp.cell_size,
                                                jp.block_size)
    xb_g, valid_g, _, b_g = jblocks._sorted_tiles(jnp.asarray(x),
                                                  jp.cell_size, jp.block_size)
    _, pvalid, overflow = jblocks._tile_partners(
        xb_i, valid_i, jp.radius, min(jp.block_partners, b_g), xb_j=xb_g,
        valid_j=valid_g)
    assert int(d["dropped_pairs"]) == int(overflow)
    assert int(d["sum_nvalid"]) == int(np.asarray(pvalid).sum())


def test_dual_diagnostics_of_one_rank_are_the_single_ones():
    x, kw = _folded_sheet()
    p = tsb.SelfCollisionParams(**kw)
    xt = torch.from_numpy(x)
    dual = blocksparse.self_collision_block_dual_diagnostics(xt, xt, p)
    single = blocksparse.self_collision_block_diagnostics(xt, p)
    for key in ("candidate_pairs", "dropped_pairs"):
        assert int(dual[key]) == int(single[key])


def test_dual_kernel_wrapper_refuses_the_cpu():
    """The dual form runs on a CUDA device or raises: no CPU fallback."""
    x, kw = _cloud()
    p = tsb.SelfCollisionParams(**kw)
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="CUDA"):
        blocks.self_collision_forces_block_dual_cuda(xt[:512], xt, p)
    with pytest.raises(ValueError, match="CUDA"):
        blocks.make_block_pairs_dual(p, 512, 2048, "cpu")


# --- the collider and feature scenes of tests/test_halo.py -------------------

def _curtain(solver=None, n=(16, 32), pinned=("tl", "tr"), **cfg_kw):
    kw = dict(springs=jc.SpringParams(k_structural=500.0, k_shear=250.0,
                                      k_bend=100.0, damping=0.6),
              collision=jc.CollisionParams(enable_plane=True, friction=0.2),
              global_damping=0.3)
    kw.update(cfg_kw)
    if solver is not None:
        kw["solver"] = SOLVERS[solver]
    cfg = jc.SimConfig(**kw)
    return cfg, dict(spacing=0.05, shear=True, bend=True, pinned=pinned,
                     springs=cfg.springs, xpbd=cfg.xpbd, orientation="xy")


def _assert_close(got, want, atol_x, atol_v=None):
    assert np.isfinite(got[0]).all()
    np.testing.assert_allclose(got[0], want[0], atol=atol_x)
    if atol_v is not None:
        np.testing.assert_allclose(got[1], want[1], atol=atol_v)


@pytest.mark.parametrize("n_ranks", [2, 4, 8])
def test_euler_plane_matches_jax_halo(n_ranks):
    """tests/test_halo.py:19-44: the pinned curtain onto the plane."""
    cfg, kw = _curtain()
    host = jcloth_grid(16, 32, plane_height=-0.5, **kw)
    _assert_close(_port_halo(host, cfg, "euler", n_ranks, 64),
                  _jax_halo(host, cfg, "euler", n_ranks, 64), 1e-5, 1e-3)


def test_decomposition_is_exact():
    """With no self-collision the ring changes nothing: 1, 2 and 4 ranks
    step the curtain to the same bits (the halo rows are exact)."""
    cfg, kw = _curtain()
    host = jcloth_grid(16, 32, plane_height=-0.5, **kw)
    one = _port_halo(host, cfg, "euler", 1, 32)
    for n_ranks in (2, 4):
        got = _port_halo(host, cfg, "euler", n_ranks, 32)
        np.testing.assert_array_equal(got[0], one[0])
        np.testing.assert_array_equal(got[1], one[1])


def test_sphere_matches_jax_halo():
    """tests/test_halo.py:115-142 (Euler, 4 ranks, 160 substeps)."""
    cfg, kw = _curtain(collision=jc.CollisionParams(
        enable_plane=True, enable_spheres=True, friction=0.2))
    host = jcloth_grid(16, 32, plane_height=-3.0,
                       sphere_centers=np.array([[0.4, -0.8, 0.0]]),
                       sphere_radii=np.array([0.3]), **kw)
    got = _contact_scene(host, cfg, "euler", 4, 160, 5e-5, colliders=True)
    d = np.linalg.norm(got[0].reshape(3, -1).T - [0.4, -0.8, 0.0], axis=1)
    assert d.min() <= 0.301                     # the cloth touches it


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_verlet_matches_jax_halo(n_ranks):
    """tests/test_halo.py:145-169."""
    cfg, kw = _curtain("verlet", pinned=("top",))
    host = jcloth_grid(16, 32, plane_height=-0.5, **kw)
    _contact_scene(host, cfg, "verlet", n_ranks, 64, 2e-5, 2e-3)


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_xpbd_matches_jax_halo(n_ranks):
    """tests/test_halo.py:65-112's contact-free curtain, and its drape onto
    a reachable plane held to the same bound (the JAX test checks only
    bounded speed there)."""
    cfg, kw = _curtain("xpbd", pinned=("top",), xpbd=jc.XPBDParams(
        compliance_distance=1e-6, compliance_bend=5e-4, n_iterations=6,
        relaxation=1.0))
    host = jcloth_grid(16, 32, plane_height=-2.0, **kw)
    _assert_close(_port_halo(host, cfg, "xpbd", n_ranks, 64),
                  _jax_halo(host, cfg, "xpbd", n_ranks, 64), 2e-5, 2e-3)
    host2 = jcloth_grid(16, 32, plane_height=-0.5, **kw)
    got = _port_halo(host2, cfg, "xpbd", n_ranks, 400)
    assert np.isfinite(got[0]).all()
    assert got[0][1].min() >= -0.5 - 1e-6
    assert np.abs(got[1]).max() < 10.0


def test_xpbd_sphere_matches_jax_halo():
    """tests/test_halo.py:207-258's float32 leg: 50 substeps onto a
    sphere."""
    cfg, kw = _curtain("xpbd", pinned=("top",), xpbd=jc.XPBDParams(
        compliance_distance=1e-6, compliance_bend=5e-4, n_iterations=4,
        relaxation=1.0), collision=jc.CollisionParams(
        enable_plane=True, enable_spheres=True))
    host = jcloth_grid(16, 32, plane_height=-5.0,
                       sphere_centers=np.array([[0.375, -1.0, 0.0]]),
                       sphere_radii=np.array([0.3]), **kw)
    _assert_close(_port_halo(host, cfg, "xpbd", 4, 50, colliders=True),
                  _jax_halo(host, cfg, "xpbd", 4, 50, colliders=True), 2e-5)


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_capsule_box_matches_jax_halo(solver):
    """tests/test_halo.py:390-441: a capsule and a box under the curtain."""
    cfg, kw = _curtain(
        solver, springs=jc.SpringParams(k_structural=500.0, k_shear=250.0,
                                        k_bend=100.0, damping=0.5),
        xpbd=jc.XPBDParams(compliance_distance=1e-5, compliance_bend=5e-4,
                           n_iterations=4),
        collision=jc.CollisionParams(enable_plane=True, enable_capsules=True,
                                     enable_boxes=True))
    host = jcloth_grid(12, 16, plane_height=-3.0, **kw)
    host.capsule_p0 = np.array([[0.0, -0.45, -0.2]])
    host.capsule_p1 = np.array([[0.55, -0.45, 0.2]])
    host.capsule_radii = np.array([0.12])
    host.box_centers = np.array([[0.3, -0.75, 0.0]])
    host.box_half_extents = np.array([[0.2, 0.08, 0.2]])
    host.box_rotations = np.eye(3)[None]
    got = _port_halo(host, cfg, solver, 4, 64, colliders=True)
    _assert_close(got, _jax_halo(host, cfg, solver, 4, 64, colliders=True),
                  2e-5)


def test_strain_tear_plastic_matches_jax_halo():
    """tests/test_halo.py:612-658: strain limiting with tearing and
    plasticity; the liveness planes equal, the rest scales at 2e-5."""
    cfg, kw = _curtain(
        collision=jc.CollisionParams(enable_plane=True),
        global_damping=jc.SimConfig().global_damping,
        strain_limit=jc.StrainLimitParams(enabled=True, max_stretch=0.06,
                                          max_compress=-1.0, iterations=2),
        tear=jc.TearParams(enabled=True, strain_limit=0.25),
        plasticity=jc.PlasticityParams(enabled=True, yield_strain=0.03,
                                       creep=0.2))
    host = jcloth_grid(12, 16, plane_height=-5.0, **kw)
    got = _port_halo(host, cfg, "euler", 4, 48, features=True)
    want = _jax_halo(host, cfg, "euler", 4, 48, features=True)
    _assert_close(got, want, 3e-5)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[3], want[3], atol=2e-5)
    assert got[3].max() > 1.0                   # plastic flow acts


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_wind_features_matches_jax_halo(solver):
    """Wind with lift (the normals judged by global row on each block) and
    tearing with plasticity, under each solver: the 12x16 curtain of
    tests/test_halo.py's feature scene in a (3, 0, 1) wind, sharded over 4
    ranks, at that scene's tolerances (the JAX package has no halo test of
    wind)."""
    cfg, kw = _curtain(
        solver, xpbd=jc.XPBDParams(compliance_distance=1e-6,
                                   compliance_bend=5e-4, n_iterations=4),
        wind=jc.WindParams(velocity=(3.0, 0.0, 1.0), drag=0.3, lift=0.8),
        tear=jc.TearParams(enabled=True, strain_limit=0.25),
        plasticity=jc.PlasticityParams(enabled=True, yield_strain=0.03,
                                       creep=0.2))
    host = jcloth_grid(12, 16, plane_height=-5.0, **kw)
    got = _port_halo(host, cfg, solver, 4, 48, features=True)
    want = _jax_halo(host, cfg, solver, 4, 48, features=True)
    _assert_close(got, want, 3e-5)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[3], want[3], atol=2e-5)
    # the wind blows the curtain downwind (+x)
    x0 = np.asarray(host.positions0).T.reshape(got[0].shape)
    assert (got[0][0] - x0[0]).mean() > 0.0


# --- the ring itself ----------------------------------------------------------

@pytest.mark.parametrize("n_ranks", [1, 2, 3, 4])
def test_local_ring_collectives(n_ranks):
    """exchange_halo: the neighbours' HALO rows, zeros past the ends;
    gather_rows: every rank's block in rank order."""
    h, nx = 3, 5
    whole = torch.arange(2 * n_ranks * h * nx,
                         dtype=torch.float32).reshape(2, n_ranks * h, nx)
    ring = LocalRing(n_ranks)

    def rank_main():
        r = ring.rank
        own = whole[:, r * h:(r + 1) * h]
        ext = ring.exchange_halo(own)
        lo, hi = r * h - HALO, (r + 1) * h + HALO
        want = torch.zeros((2, h + 2 * HALO, nx))
        src = slice(max(lo, 0), min(hi, n_ranks * h))
        want[:, src.start - lo:src.stop - lo] = whole[:, src]
        assert torch.equal(ext, want)
        assert torch.equal(ring.gather_rows(own), whole)
        return r

    assert ring.run(rank_main) == list(range(n_ranks))


def test_local_ring_reraises_a_rank_error():
    """A rank that fails stops the others at the next collective; the error
    comes back to the caller."""
    ring = LocalRing(3)

    def rank_main():
        if ring.rank == 1:
            raise KeyError("rank 1 failed")
        return ring.gather_rows(torch.zeros((1, 2, 2)))

    with pytest.raises(KeyError, match="rank 1 failed"):
        ring.run(rank_main)


def test_local_ring_stress():
    """More ranks than cores, the interpreter switching threads every
    microsecond: every rank's gather sees every other rank's latest block
    (a lost or stale slot would break the sums), and the launch counter of
    the pair kernels loses no update when ranks count at once."""
    n_ranks, rounds = 2 * os.cpu_count() + 1, 50
    ring = LocalRing(n_ranks)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        blocks.reset_launch_count()

        def rank_main():
            r = ring.rank
            for k in range(rounds):
                got = ring.gather_rows(torch.full((1, 2, 1), float(r + k)))
                want = torch.arange(n_ranks, dtype=torch.float32) + k
                assert torch.equal(got[0, ::2, 0], want)
                blocks._count("block_pairs_dual")
            return r

        assert ring.run(rank_main) == list(range(n_ranks))
        assert blocks.launch_count("block_pairs_dual") == n_ranks * rounds
    finally:
        sys.setswitchinterval(switch)
        blocks.reset_launch_count()


# --- DistRing on gloo processes ----------------------------------------------

_CHILD = """
import sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, {tests!r})
import test_torch_halo as t
rank, world = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", init_method="file://" + sys.argv[3],
                        rank=rank, world_size=world)
try:
    from softbodyunity_torch.parallel.ring import DistRing
    out = t.gloo_scene_run(DistRing())
    np.savez(sys.argv[4], *out)
finally:
    dist.destroy_process_group()
"""


def gloo_scene_run(ring):
    """The self-collision scene under XPBD with its features, 8 substeps on
    ``ring`` (a rank of it); the rank's outputs as NumPy arrays."""
    torch.set_num_threads(1)
    jhost, jcfg = _sc_scene("xpbd")
    jcfg = jcfg.replace(tear=jc.TearParams(enabled=True, strain_limit=0.25),
                        strain_limit=jc.StrainLimitParams(
                            enabled=True, max_stretch=0.1, iterations=2))
    host, cfg = _port(jhost, jcfg)
    top, s = tsb.init(host, device="cpu")
    s = tapi.ensure_tear_state(top, cfg, s)
    fn = halo.make_halo_xpbd_step(top, cfg, ring)
    x3, v3, im3, ph = halo.shard_grid_state(top, s, ring)
    shard, _ = halo.tear_plane_shard_maps(top, cfg, ring)
    out = fn(x3, v3, im3, ph, cfg.dt, 8, alive3=shard(s.edge_alive))
    return [o.numpy() for o in out]


@pytest.mark.parametrize("world", [2, 4])
def test_dist_ring_on_gloo_equals_local_ring(world, tmp_path):
    """``world`` gloo processes (``DistRing``: batch_isend_irecv halos, an
    all_gather of the rows) step the same bits as ``LocalRing(world)``."""
    ring = LocalRing(world)
    want = ring.run(lambda: gloo_scene_run(ring))
    code = _CHILD.format(tests=os.path.join(REPO, "tests"))
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world),
         str(tmp_path / "store"), str(tmp_path / f"rank{r}.npz")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    try:
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, errs[r]
        got = np.load(tmp_path / f"rank{r}.npz")
        assert len(got.files) == len(want[r]) == 3
        for i, w in enumerate(want[r]):
            np.testing.assert_array_equal(got[f"arr_{i}"], w)


# --- refusals -----------------------------------------------------------------

def _refused(jhost, jcfg, match):
    host, cfg = _port(jhost, jcfg)
    top, _ = tsb.init(host, device="cpu")
    for make in TMAKE.values():
        with pytest.raises(NotImplementedError, match=match):
            make(top, cfg, LocalRing(2))


def test_refuses_sdf_colliders():
    cfg, kw = _curtain(collision=jc.CollisionParams(enable_plane=True,
                                                    enable_sdf=True))
    _refused(jcloth_grid(8, 8, **kw), cfg, "SDF colliders.*Queue 1 item 6")


def test_refuses_tethers():
    cfg, kw = _curtain(motion=jc.MotionConstraintParams(enabled=True))
    _refused(jcloth_grid(8, 8, **kw), cfg,
             "motion constraints.*Queue 1 item 6")


def test_refuses_tet_lattices():
    from softbodyunity_tpu.core.topology import tet_cube

    cfg = jc.SimConfig(volume_stiffness=0.5)
    host = tet_cube(4, spacing=0.05, springs=cfg.springs, xpbd=cfg.xpbd,
                    plane_height=-1.0)
    _refused(host, cfg, "slab halos.*Queue 1 item 11")


@pytest.mark.parametrize("method", ["dense", "hash"])
def test_refuses_self_collision_methods_but_block(method):
    jhost, jcfg = _sc_scene("euler")
    jcfg = jcfg.replace(self_collision=dataclasses.replace(
        jcfg.self_collision, method=method))
    _refused(jhost, jcfg, "block method only")


def test_refuses_rows_that_do_not_divide():
    cfg, kw = _curtain()
    host, tcfg = _port(jcloth_grid(8, 10, **kw), cfg)
    top, _ = tsb.init(host, device="cpu")
    for n_ranks in (3, 10):      # 10 rows: not divisible, or blocks under 2
        with pytest.raises(ValueError, match="divide"):
            halo.make_halo_step(top, tcfg, LocalRing(n_ranks))
