"""The hand-written CUDA kernels, grid (grid_euler, grid_verlet, grid_xpbd,
with and without their tear and plastic planes, wind, and the strain-limit
sweeps), tet lattice (lattice_euler, lattice_verlet, lattice_xpbd, with and
without the wind's drag) and the
block-sparse self-collision pairs (block_pairs, and its dual form for the
row-sharded halo paths), against their plain
PyTorch versions, on the card; the halo paths on one card (LocalRing) and,
with two cards, on NCCL.  These tests skip without
a CUDA device: the kernels have no CPU mode.  The file imports no jax, so it runs where JAX is absent; there run it
without the repository's conftest (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import softbodyunity_torch as tsb
from softbodyunity_torch.core.config import CollisionParams, Solver, XPBDParams
from softbodyunity_torch.core.config import (PlasticityParams,
                                             SelfCollisionParams,
                                             StrainLimitParams, TearParams,
                                             WindParams)
from softbodyunity_torch.kernels import (blocks, dispatch, grid_euler,
                                        grid_strain, grid_verlet, grid_xpbd,
                                        lattice_euler, lattice_verlet,
                                        lattice_xpbd, stencil)
from softbodyunity_torch.solver import blocksparse
from softbodyunity_torch.solver.step import make_plain_step

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the "
                    "card")
    return torch.device("cuda")


def _scene16(shear=True, bend=True, sphere=False):
    cfg = tsb.SimConfig(
        springs=tsb.SpringParams(k_structural=500.0, k_shear=250.0,
                                 k_bend=100.0, damping=0.6),
        collision=CollisionParams(enable_plane=True, enable_spheres=sphere,
                                  friction=0.2),
        global_damping=0.3,
    )
    host = tsb.cloth_grid(
        16, 8, spacing=0.05, shear=shear, bend=bend, pinned=("tl", "tr"),
        springs=cfg.springs, xpbd=cfg.xpbd, plane_height=-0.25,
        orientation="xy",
        sphere_centers=np.array([[0.35, -0.4, 0.0]]) if sphere else None,
        sphere_radii=np.array([0.15]) if sphere else None,
    )
    return host, cfg


# the kernel differs from its plain version by rounding (nvcc's FMA
# contraction), as the Pallas kernel differs from its twin (rsqrt), so
# these are tests/test_pallas.py's kernel-vs-twin tolerances
@pytest.mark.cuda
@pytest.mark.parametrize("shear,bend,sphere,n_sub,atol_x,atol_v", [
    (False, False, False, 64, 5e-4, 5e-2),
    (True, True, False, 64, 5e-6, 5e-4),
    (True, True, True, 96, 2e-5, 5e-2),
])
def test_kernel_matches_plain_on_card(cuda, shear, bend, sphere, n_sub,
                                      atol_x, atol_v):
    host, cfg = _scene16(shear, bend, sphere)
    top, s0 = tsb.init(host, device=cuda)
    want = stencil.make_stencil_step(top, cfg)(s0, cfg.dt, n_sub)
    grid_euler.reset_launch_count()
    got = grid_euler.make_cuda_step(top, cfg)(s0, cfg.dt, n_sub)
    torch.cuda.synchronize()
    assert grid_euler.launch_count() == n_sub
    torch.testing.assert_close(got.x, want.x, atol=atol_x, rtol=0)
    torch.testing.assert_close(got.v, want.v, atol=atol_v, rtol=0)
    pinned = torch.from_numpy(host.inv_mass == 0.0).to(cuda)
    assert torch.equal(got.x[pinned], s0.x[pinned])


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    host, cfg = _scene16()
    top, s0 = tsb.init(host, device=cuda)
    step = grid_euler.make_cuda_step(top, cfg)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        step(s0.replace(x=s0.x.clone().requires_grad_()), cfg.dt, 1)
    with pytest.raises(ValueError, match="contiguous"):
        step(s0.replace(x=s0.x.t().contiguous().t()), cfg.dt, 1)
    top64, _ = tsb.init(host, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        grid_euler.make_cuda_step(top64, cfg)


def _scene16_solver(solver, sphere_center=None, verlet_sphere=False):
    """tests/test_pallas.py's 16x8 Verlet and XPBD scenes."""
    cfg = tsb.SimConfig(
        solver=solver,
        springs=tsb.SpringParams(k_structural=500.0, k_shear=250.0,
                                 k_bend=100.0,
                                 damping=0.1 if verlet_sphere else 0.6),
        xpbd=XPBDParams(compliance_distance=1e-6, compliance_bend=5e-4,
                        n_iterations=6, relaxation=1.0),
        collision=CollisionParams(enable_plane=True,
                                  enable_spheres=sphere_center is not None,
                                  friction=0.2),
        global_damping=0.3,
    )
    host = tsb.cloth_grid(
        16, 8, spacing=0.05, shear=True, bend=True, pinned=("tl", "tr"),
        springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=-2.5 if verlet_sphere else -0.25, orientation="xy",
        sphere_centers=(np.array([sphere_center]) if sphere_center
                        else None),
        sphere_radii=np.array([0.15]) if sphere_center else None,
    )
    return host, cfg


_WRAPPERS = {Solver.SEMI_IMPLICIT_EULER: grid_euler,
             Solver.VERLET: grid_verlet, Solver.XPBD: grid_xpbd}


# tests/test_pallas.py's kernel-vs-twin tolerances on x; v = position
# change / dt carries x rounding ~1e3-fold, and the Verlet drape flips the
# discrete plane-friction mask on a few vertices
@pytest.mark.cuda
@pytest.mark.parametrize("solver,center,verlet_sphere,n_sub,atol_x,atol_v", [
    (Solver.XPBD, None, False, 64, 1e-5, 1e-3),
    (Solver.XPBD, (0.375, -0.3, 0.0), False, 96, 2e-5, 5e-2),
    (Solver.VERLET, None, False, 64, 1e-3, 5e-2),
    (Solver.VERLET, (0.375, -0.45, 0.0), True, 240, 2e-5, 5e-2),
])
def test_solver_kernel_matches_plain_on_card(cuda, solver, center,
                                             verlet_sphere, n_sub, atol_x,
                                             atol_v):
    host, cfg = _scene16_solver(solver, center, verlet_sphere)
    wrapper = _WRAPPERS[solver]
    top, s0 = tsb.init(host, device=cuda)
    want = stencil.make_stencil_step(top, cfg)(s0, cfg.dt, n_sub)
    for w in _WRAPPERS.values():
        w.reset_launch_count()
    got = wrapper.make_cuda_step(top, cfg)(s0, cfg.dt, n_sub)
    torch.cuda.synchronize()
    per_sub = (grid_xpbd.launches_per_substep(cfg) if solver == Solver.XPBD
               else 1)
    assert wrapper.launch_count() == n_sub * per_sub
    assert sum(w.launch_count() for w in _WRAPPERS.values()) == n_sub * per_sub
    torch.testing.assert_close(got.x, want.x, atol=atol_x, rtol=0)
    torch.testing.assert_close(got.v, want.v, atol=atol_v, rtol=0)
    torch.testing.assert_close(got.x_prev, want.x_prev, atol=atol_x, rtol=0)
    pinned = torch.from_numpy(host.inv_mass == 0.0).to(cuda)
    assert torch.equal(got.x[pinned], s0.x[pinned])


@pytest.mark.cuda
def test_xpbd_kernel_without_sweeps_matches_plain(cuda):
    """n_iterations = 0: the predict launch and one launch that runs only
    the epilogue (friction, pins, x and v out)."""
    host, cfg = _scene16_solver(Solver.XPBD)
    cfg = cfg.replace(xpbd=dataclasses.replace(cfg.xpbd, n_iterations=0))
    top, s0 = tsb.init(host, device=cuda)
    want = stencil.make_stencil_step(top, cfg)(s0, cfg.dt, 32)
    grid_xpbd.reset_launch_count()
    got = grid_xpbd.make_cuda_step(top, cfg)(s0, cfg.dt, 32)
    torch.cuda.synchronize()
    assert grid_xpbd.launch_count() == 32 * 2
    torch.testing.assert_close(got.x, want.x, atol=1e-5, rtol=0)
    torch.testing.assert_close(got.v, want.v, atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", [Solver.VERLET, Solver.XPBD])
def test_solver_kernel_refuses_what_it_does_not_take(cuda, solver):
    host, cfg = _scene16_solver(solver)
    top, s0 = tsb.init(host, device=cuda)
    step = _WRAPPERS[solver].make_cuda_step(top, cfg)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        step(s0.replace(x=s0.x.clone().requires_grad_()), cfg.dt, 1)
    with pytest.raises(ValueError, match="contiguous"):
        step(s0.replace(x=s0.x.t().contiguous().t()), cfg.dt, 1)
    with pytest.raises(TypeError, match="float32"):
        step(s0.replace(x=s0.x.double()), cfg.dt, 1)
    top64, _ = tsb.init(host, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        _WRAPPERS[solver].make_cuda_step(top64, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", list(_WRAPPERS))
def test_dispatch_takes_each_solver_kernel_on_card(cuda, solver):
    """On a CUDA topology the public step goes through the solver's kernel
    (and no other); on CPU tensors through the plain version."""
    host, cfg = _scene16_solver(solver)
    top, s0 = tsb.init(host, device=cuda)
    fn = dispatch.maybe_fast_step(top, cfg)
    # the wrapper's frame loop (kernels/frame.py), named as its module
    assert fn.name == _WRAPPERS[solver].__name__.rsplit(".", 1)[1]
    for w in _WRAPPERS.values():
        w.reset_launch_count()
    tsb.step(top, cfg, s0)
    torch.cuda.synchronize()
    assert _WRAPPERS[solver].launch_count() > 0
    assert sum(w.launch_count() for w in _WRAPPERS.values()
               if w is not _WRAPPERS[solver]) == 0
    top_cpu, _ = tsb.init(host, device="cpu")
    assert (dispatch.maybe_fast_step(top_cpu, cfg).__qualname__
            == "make_stencil_step.<locals>.fn")


def _lattice_scene(solver, n=6, volume_stiffness=0.5, sphere=False, pins=0):
    """tests/test_pallas_lattice.py's tet-cube scenes: on the plane, or
    (sphere) dropped onto a sphere with the plane out of reach."""
    cfg = tsb.SimConfig(
        solver=solver,
        springs=tsb.SpringParams(k_structural=1200.0, damping=1.5),
        xpbd=XPBDParams(compliance_distance=1e-6, compliance_volume=1e-7,
                        n_iterations=4, relaxation=1.0),
        collision=CollisionParams(enable_plane=True, enable_spheres=sphere,
                                  friction=0.4),
        global_damping=0.5,
        volume_stiffness=volume_stiffness,
    )
    host = tsb.tet_cube(n, spacing=0.08, springs=cfg.springs, xpbd=cfg.xpbd,
                        plane_height=-5.0 if sphere else 0.0,
                        origin=(0.0, 0.25 if sphere else 0.01, 0.0))
    if sphere:
        host.sphere_centers = np.array([[0.2, -0.02, 0.2]])
        host.sphere_radii = np.array([0.3])
    host.inv_mass[:pins] = 0.0
    return host, cfg


_LATTICE = {Solver.SEMI_IMPLICIT_EULER: lattice_euler,
            Solver.VERLET: lattice_verlet, Solver.XPBD: lattice_xpbd}


# float32 kernel against float32 plain version on the same card: they
# differ by FMA contraction only, so x is held to 1e-5 after tens of
# substeps with plane or sphere contact (half the 2e-5 that
# tests/test_pallas_lattice.py allows its rsqrt kernel); v = position
# change / dt carries that rounding ~1e3-fold, hence 2e-3 (the JAX twin
# tests' bound on v)
@pytest.mark.cuda
@pytest.mark.parametrize("solver,kw,n_sub", [
    (Solver.SEMI_IMPLICIT_EULER, dict(n=6), 48),
    (Solver.SEMI_IMPLICIT_EULER, dict(n=7), 48),
    (Solver.SEMI_IMPLICIT_EULER, dict(volume_stiffness=0.0), 48),
    (Solver.SEMI_IMPLICIT_EULER, dict(pins=8), 64),
    (Solver.SEMI_IMPLICIT_EULER, dict(sphere=True), 96),
    (Solver.VERLET, dict(n=6), 48),
    (Solver.VERLET, dict(sphere=True, pins=4), 96),
    (Solver.XPBD, dict(n=6), 64),
    (Solver.XPBD, dict(n=7, pins=8), 64),
    (Solver.XPBD, dict(sphere=True), 64),
    # the Euler and Verlet tet and gather passes on a cube and on a box
    # whose three strides differ, each branch: with capsules and boxes the
    # collider tests' bounds, x 5e-5 and v 5e-2
    *[pytest.param(solver, dict(shape=shape, branch=branch), 48,
                   id=f"{solver.value}-{label}-{branch}")
      for solver in (Solver.SEMI_IMPLICIT_EULER, Solver.VERLET)
      for shape, label in (((7, 7, 7), "7^3"), ((5, 6, 9), "5x6x9"))
      for branch in ("plain", "no volume", "drag", "colliders")],
])
def test_lattice_kernel_matches_plain_on_card(cuda, solver, kw, n_sub):
    if "shape" in kw:
        host, cfg = _lattice_box_scene(kw["shape"], 4, kw["branch"], solver)
    else:
        host, cfg = _lattice_scene(solver, **kw)
    atol_x, atol_v = ((5e-5, 5e-2) if kw.get("branch") == "colliders"
                      else (1e-5, 2e-3))
    top, s0 = tsb.init(host, device=cuda)
    want = make_plain_step(top, cfg)(s0, cfg.dt, n_sub)
    for w in (*_WRAPPERS.values(), *_LATTICE.values()):
        w.reset_launch_count()
    got = _LATTICE[solver].make_cuda_step(top, cfg)(s0, cfg.dt, n_sub)
    torch.cuda.synchronize()
    module = _LATTICE[solver]
    volume = cfg.volume_stiffness != 0.0
    assert module.launches_per_substep(top, cfg) == (
        1 + 2 * 4 if solver == Solver.XPBD else 1 + 2 * int(volume))
    # Verlet: one velocity-estimate launch a call besides the substeps
    launches = module.launches_per_call(top, cfg, n_sub)
    assert launches == (n_sub * module.launches_per_substep(top, cfg)
                        + int(solver == Solver.VERLET))
    assert module.launch_count() == launches
    assert sum(w.launch_count() for w in (*_WRAPPERS.values(),
                                          *_LATTICE.values())) == launches
    torch.testing.assert_close(got.x, want.x, atol=atol_x, rtol=0)
    torch.testing.assert_close(got.v, want.v, atol=atol_v, rtol=0)
    torch.testing.assert_close(got.x_prev, want.x_prev, atol=atol_x, rtol=0)
    pinned = torch.from_numpy(host.inv_mass == 0.0).to(cuda)
    assert torch.equal(got.x[pinned], s0.x[pinned])
    if "shape" in kw:
        assert bool(pinned.any())
        assert float((want.x - s0.x).abs().max()) > 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("solver", list(_LATTICE))
def test_lattice_kernel_refuses_what_it_does_not_take(cuda, solver):
    host, cfg = _lattice_scene(solver)
    top, s0 = tsb.init(host, device=cuda)
    step = _LATTICE[solver].make_cuda_step(top, cfg)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        step(s0.replace(x=s0.x.clone().requires_grad_()), cfg.dt, 1)
    with pytest.raises(ValueError, match="contiguous"):
        step(s0.replace(x=s0.x.t().contiguous().t()), cfg.dt, 1)
    with pytest.raises(TypeError, match="float32"):
        step(s0.replace(x=s0.x.double()), cfg.dt, 1)
    top64, _ = tsb.init(host, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        _LATTICE[solver].make_cuda_step(top64, cfg)
    for other in _LATTICE:
        if other != solver:
            with pytest.raises(ValueError, match=solver.value):
                _LATTICE[other].make_cuda_step(top, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", list(_LATTICE))
def test_dispatch_takes_each_lattice_kernel_on_card(cuda, solver):
    """On a CUDA topology the public step of a tet lattice goes through the
    solver's lattice kernel and no other; on CPU tensors through the plain
    version."""
    host, cfg = _lattice_scene(solver)
    top, s0 = tsb.init(host, device=cuda)
    fn = dispatch.maybe_fast_step(top, cfg)
    # the wrapper's frame loop (kernels/frame.py), named as its module
    assert fn.name == _LATTICE[solver].__name__.rsplit(".", 1)[1]
    for w in (*_WRAPPERS.values(), *_LATTICE.values()):
        w.reset_launch_count()
    tsb.step(top, cfg, s0)
    torch.cuda.synchronize()
    assert _LATTICE[solver].launch_count() > 0
    assert sum(w.launch_count() for w in (*_WRAPPERS.values(),
                                          *_LATTICE.values())
               if w is not _LATTICE[solver]) == 0
    top_cpu, _ = tsb.init(host, device="cpu")
    assert (dispatch.maybe_fast_step(top_cpu, cfg).__qualname__
            == "make_plain_step.<locals>.fn")


# --- block_pairs: block-sparse self-collision ---------------------------------

# tests/test_blocksparse.py:158's kernel-vs-twin tolerance (rsqrt and another
# summation order); 500 and 1000 are not multiples of the tile size, so the
# last tile carries far-coordinate pads
@pytest.mark.cuda
@pytest.mark.parametrize("n,blk,partners", [
    (500, 256, 2), (1000, 256, 4), (2048, 256, 8), (1000, 128, 8),
    (2048, 128, 16), (4 * 256, 256, 1),
])
def test_block_pairs_matches_plain_on_card(cuda, n, blk, partners):
    rng = np.random.default_rng(n + blk)
    side = 0.02 if partners == 1 else 0.5      # a pile with a starved budget
    x = torch.tensor(rng.uniform(0, side, (n, 3)), dtype=torch.float32,
                     device=cuda)
    p = SelfCollisionParams(enabled=True, method="block", radius=0.05,
                            stiffness=10.0, cell_size=0.05,
                            block_partners=partners, block_size=blk)
    want = blocksparse.self_collision_forces_block(x, p)
    blocks.reset_launch_count()
    fn = blocks.make_block_pairs(p, n, cuda)
    got = fn(x)
    again = fn(x)              # the arrival counters reset themselves
    torch.cuda.synchronize()
    assert blocks.launch_count() == 2
    assert torch.equal(got, again)             # deterministic
    torch.testing.assert_close(got.t(), want, atol=5e-4, rtol=1e-3)
    assert float(want.abs().max()) > 0.0


# the dual form (TPU kernel #11): one rank's rows against the whole cloth, at
# the single form's tolerance; with one rank it is the single form, to the bit
@pytest.mark.cuda
@pytest.mark.parametrize("n_ranks", [1, 2, 4, 8])
def test_block_pairs_dual_matches_plain_on_card(cuda, n_ranks):
    rng = np.random.default_rng(n_ranks)
    n = 2048
    x = torch.tensor(rng.uniform(0, 0.5, (n, 3)), dtype=torch.float32,
                     device=cuda)
    p = SelfCollisionParams(enabled=True, method="block", radius=0.05,
                            stiffness=10.0, cell_size=0.05, block_partners=8)
    ni = n // n_ranks
    blocks.reset_launch_count()
    for r in range(n_ranks):
        xi = x[r * ni:(r + 1) * ni]
        fn = blocks.make_block_pairs_dual(p, ni, n, cuda)
        got = fn(xi, x)
        again = fn(xi, x)
        want = blocksparse.self_collision_forces_block_dual(xi, x, p)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        torch.testing.assert_close(got.t(), want, atol=5e-4, rtol=1e-3)
        assert float(want.abs().max()) > 0.0
    assert blocks.launch_count("block_pairs_dual") == 2 * n_ranks
    assert blocks.launch_count() == 0
    if n_ranks == 1:
        # 256 divides n, so no tile holds a pad: the same tiles, partners
        # and sums as the single form
        assert torch.equal(got, blocks.make_block_pairs(p, n, cuda)(x))


def _halo_scene(solver):
    """cloth_batch_rl (16x16, method block) with its positions scaled by
    0.6 (chip_smoke.py's shrink): every neighbour inside the self-collision
    radius."""
    host, cfg = _batch_rl(solver)
    top, s0 = tsb.init(host, device="cuda")
    return top, cfg, s0.replace(x=0.6 * s0.x, x_prev=0.6 * s0.x_prev)


def _halo_steps(top, cfg, s0, ring, n_sub):
    """The halo path of ``cfg.solver`` on ``ring`` from ``s0``: each rank's
    ``[3, h, nx]`` position planes."""
    from softbodyunity_torch.parallel import halo

    make = {Solver.SEMI_IMPLICIT_EULER: halo.make_halo_step,
            Solver.VERLET: halo.make_halo_verlet_step,
            Solver.XPBD: halo.make_halo_xpbd_step}[cfg.solver]
    fn = make(top, cfg, ring)
    x3, v3, im3, ph = halo.shard_grid_state(top, s0, ring)
    xp3 = halo.shard_grid_state(top, s0.replace(x=s0.x_prev), ring)[0]
    second = xp3 if cfg.solver == Solver.VERLET else v3
    return fn(x3, second, im3, ph, cfg.dt, n_sub)[0]


# the halo path (plain stencil on each rank, the dual pair kernel) against
# the single-device kernel path: rounding only over 4 substeps (x 1e-5)
@pytest.mark.cuda
@pytest.mark.parametrize("solver", list(_WRAPPERS))
def test_halo_local_ring_matches_kernel_path_on_card(cuda, solver):
    from softbodyunity_torch.parallel.ring import LocalRing

    top, cfg, s0 = _halo_scene(solver)
    n_sub, n_ranks = 4, 4
    want = _WRAPPERS[solver].make_cuda_step(top, cfg)(s0, cfg.dt, n_sub)
    ring = LocalRing(n_ranks)
    blocks.reset_launch_count()
    parts = ring.run(lambda: _halo_steps(top, cfg, s0, ring, n_sub))
    torch.cuda.synchronize()
    assert blocks.launch_count("block_pairs_dual") == n_sub * n_ranks
    got = torch.cat(parts, dim=1)
    ny, nx = top.grid_shape
    torch.testing.assert_close(got, stencil.to_planes(want.x, ny, nx),
                               atol=1e-5, rtol=0)


_NCCL_CHILD = """
import sys
import torch
import torch.distributed as dist
sys.path.insert(0, {tests!r})
import test_torch_cuda as t
rank, world = int(sys.argv[1]), int(sys.argv[2])
torch.cuda.set_device(rank)
dist.init_process_group("nccl", init_method="file://" + sys.argv[3],
                        rank=rank, world_size=world)
try:
    from softbodyunity_torch.parallel.ring import DistRing
    top, cfg, s0 = t._halo_scene(t.Solver.SEMI_IMPLICIT_EULER)
    torch.save(t._halo_steps(top, cfg, s0, DistRing(), 4).cpu(), sys.argv[4])
finally:
    dist.destroy_process_group()
"""


# two processes, one card each, on NCCL: needs two cards, so a one-card
# machine skips it (PERF.md says so)
@pytest.mark.cuda
def test_halo_nccl_two_ranks_on_card(cuda, tmp_path):
    import os
    import subprocess
    import sys

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: NCCL takes one rank per card")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = _NCCL_CHILD.format(tests=os.path.join(repo, "tests"))
    env = dict(os.environ, PYTHONPATH=repo)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), "2", str(tmp_path / "store"),
         str(tmp_path / f"rank{r}.pt")], cwd=repo, env=env,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, errs[r]
    got = torch.cat([torch.load(tmp_path / f"rank{r}.pt") for r in range(2)],
                    dim=1)
    top, cfg, s0 = _halo_scene(Solver.SEMI_IMPLICIT_EULER)
    want = grid_euler.make_cuda_step(top, cfg)(s0, cfg.dt, 4)
    ny, nx = top.grid_shape
    torch.testing.assert_close(got, stencil.to_planes(want.x, ny, nx).cpu(),
                               atol=1e-5, rtol=0)


def _batch_rl(solver, method="block"):
    host, cfg = tsb.presets.build("cloth_batch_rl")
    return host, cfg.replace(solver=solver, self_collision=dataclasses.replace(
        cfg.self_collision, method=method))


# kernel path against the plain path, f32 on the card: FMA contraction and
# rsqrt only, PERF.md's small-scene bounds (x 1e-5, v 2e-3)
@pytest.mark.cuda
@pytest.mark.parametrize("solver", list(_WRAPPERS))
@pytest.mark.parametrize("method", ["block", "dense"])
def test_self_collision_rollout_launches_on_card(cuda, solver, method):
    host, cfg = _batch_rl(solver, method)
    top, s0 = tsb.init(host, device=cuda)
    frames = 3
    for w in (*_WRAPPERS.values(), *_LATTICE.values(), blocks):
        w.reset_launch_count()
    s = s0
    for _ in range(frames):
        s = tsb.step(top, cfg, s)
    torch.cuda.synchronize()
    subs = frames * cfg.n_substeps
    per_sub = (grid_xpbd.launches_per_substep(cfg) if solver == Solver.XPBD
               else 1)
    assert _WRAPPERS[solver].launch_count() == subs * per_sub
    assert blocks.launch_count() == (subs if method == "block" else 0)
    assert sum(w.launch_count() for w in (*_WRAPPERS.values(),
                                          *_LATTICE.values())) == subs * per_sub
    plain = stencil.make_stencil_step(top, cfg)
    want = s0
    for _ in range(frames):
        want = plain(want, cfg.dt, cfg.n_substeps)
    torch.testing.assert_close(s.x, want.x, atol=1e-5, rtol=0)
    torch.testing.assert_close(s.v, want.v, atol=2e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", list(_WRAPPERS))
def test_self_collision_frame_never_waits_for_the_device(cuda, solver):
    """The sort, the partner search and the pair launch of every substep
    stay on the device: torch's sync debug mode raises on a host wait."""
    host, cfg = _batch_rl(solver)
    top, s0 = tsb.init(host, device=cuda)
    fn = _WRAPPERS[solver].make_cuda_step(top, cfg)
    fn(s0, cfg.dt, 1)                          # build and load first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s = fn(s0, cfg.dt, cfg.n_substeps)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(s.x).all())


@pytest.mark.cuda
@pytest.mark.parametrize("solver", list(_WRAPPERS))
def test_null_force_plane_is_the_kernel_without_it(cuda, solver,
                                                   monkeypatch):
    """A zero force plane gives, bit for bit, what the launch without one
    (the null pointer, the kernel as it was before the plane) gives: the
    plane enters at one place and nowhere else."""
    host, cfg = _scene16_solver(solver)
    top, s0 = tsb.init(host, device=cuda)
    wrapper = _WRAPPERS[solver]
    without = wrapper.make_cuda_step(top, cfg)(s0, cfg.dt, 32)
    monkeypatch.setattr(wrapper, "self_collision_planes_cuda",
                        lambda c, ny, nx, device: torch.zeros_like)
    on = cfg.replace(self_collision=SelfCollisionParams(enabled=True,
                                                        method="block"))
    with_zero = wrapper.make_cuda_step(top, on)(s0, cfg.dt, 32)
    torch.cuda.synchronize()
    assert torch.equal(without.x, with_zero.x)
    assert torch.equal(without.v, with_zero.v)


# --- tearing and plasticity: the feature instantiations ------------------------

def _feature_scene(solver, feature, ny=24):
    """tests/test_torch_features.py's hanging cloth (8 wide, pinned along the
    top row): "tear" rips at 3 % strain, "plastic" creeps past 2 %, "both"
    does both, creeping slower."""
    cfg = tsb.SimConfig(
        solver=solver,
        springs=tsb.SpringParams(k_structural=300.0, k_shear=150.0,
                                 k_bend=60.0, damping=0.3),
        xpbd=XPBDParams(compliance_distance=3e-4, compliance_bend=1e-3,
                        n_iterations=4),
        tear=tsb.TearParams(enabled=feature in ("tear", "both"),
                            strain_limit=0.03),
        plasticity=tsb.PlasticityParams(
            enabled=feature in ("plastic", "both"), yield_strain=0.02,
            creep=0.05 if feature == "both" else 0.25),
        collision=CollisionParams(enable_plane=True),
        global_damping=0.1,
    )
    host = tsb.cloth_grid(8, ny, spacing=0.05, shear=True, bend=True,
                          pinned=("top",), springs=cfg.springs,
                          xpbd=cfg.xpbd, plane_height=-5.0, orientation="xy")
    return host, cfg


# float32 kernel against float32 plain version over 64 substeps, the cloth
# tearing and flowing: x to the JAX twin tests' 5e-5 (tests/test_tearing.py),
# v 5e-2 (v carries x's rounding over dt), scales 1e-5; the masks equal
@pytest.mark.cuda
@pytest.mark.parametrize("feature", ["tear", "plastic", "both"])
@pytest.mark.parametrize("solver", list(_WRAPPERS))
def test_feature_kernel_matches_plain_on_card(cuda, solver, feature):
    host, cfg = _feature_scene(solver, feature)
    top, s0 = tsb.init(host, device=cuda)
    want = stencil.make_stencil_step(top, cfg)(s0, cfg.dt, 64)
    for w in _WRAPPERS.values():
        w.reset_launch_count()
    got = _WRAPPERS[solver].make_cuda_step(top, cfg)(s0, cfg.dt, 64)
    torch.cuda.synchronize()
    assert (_WRAPPERS[solver].launch_count()
            == _WRAPPERS[solver].launches_per_frame(cfg, 64))
    torch.testing.assert_close(got.x, want.x, atol=5e-5, rtol=0)
    torch.testing.assert_close(got.v, want.v, atol=5e-2, rtol=0)
    if cfg.tear.enabled:
        assert torch.equal(got.edge_alive, want.edge_alive)
        assert float(want.edge_alive.min()) == 0.0
    if cfg.plasticity.enabled:
        torch.testing.assert_close(got.rest_scale, want.rest_scale,
                                   atol=1e-5, rtol=0)
        assert float(want.rest_scale.max()) > 1.001
    pinned = torch.from_numpy(host.inv_mass == 0.0).to(cuda)
    assert torch.equal(got.x[pinned], s0.x[pinned])


@pytest.mark.cuda
@pytest.mark.parametrize("feature", ["tear", "plastic", "both"])
@pytest.mark.parametrize("solver", list(_WRAPPERS))
def test_feature_update_launch_is_bit_equal_to_plain(cuda, solver, feature):
    """One frame-end launch from identical inputs (a stretched cloth, strains
    around the limits, random liveness and scales) gives the plain update's
    masks and scales to the bit, at every edge."""
    host, cfg = _feature_scene(solver, feature)
    top, s0 = tsb.init(host, device=cuda)
    fn = _WRAPPERS[solver].make_cuda_step(top, cfg)
    feat = fn.features
    rng = np.random.default_rng(7)
    x = s0.x + torch.tensor(0.003 * rng.standard_normal(tuple(s0.x.shape)),
                            dtype=torch.float32, device=cuda)
    e = host.edges.shape[0]
    state = s0.replace(
        x=x, edge_alive=torch.tensor((rng.uniform(size=e) < 0.8),
                                     dtype=torch.float32, device=cuda),
        rest_scale=torch.tensor(rng.uniform(0.9, 1.2, e),
                                dtype=torch.float32, device=cuda))
    alive, scale = feat.planes.to_planes(state)
    x3 = stencil.to_planes(x, *top.grid_shape).contiguous()
    table = torch.tensor(feat.planes.offsets, dtype=torch.float32,
                         device=cuda)
    got = feat.planes.to_edges(*feat.update(x3, alive, scale, table), state)
    want = feat.planes.to_edges(*stencil.update_features(
        x3, feat.planes.offsets, alive, scale, cfg), state)
    torch.cuda.synchronize()
    if cfg.tear.enabled:
        assert torch.equal(got[0], want[0])
        assert 0.1 < float((want[0] == 0).float().mean()) < 0.9
    if cfg.plasticity.enabled:
        assert torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("solver", list(_WRAPPERS))
def test_feature_rollout_launch_counts(cuda, solver):
    """n_substeps + 1 launches a frame (XPBD: n_substeps x (1 +
    n_iterations) + 1), no other kernel, and the masks of a rollout equal
    those of frame-by-frame steps."""
    host, cfg = _feature_scene(solver, "both")
    top, s0 = tsb.init(host, device=cuda)
    for w in (*_WRAPPERS.values(), *_LATTICE.values(), blocks):
        w.reset_launch_count()
    frames = 3
    s_roll, _ = tsb.rollout(top, cfg, s0, frames)
    torch.cuda.synchronize()
    per_frame = (cfg.n_substeps * (1 + cfg.xpbd.n_iterations) + 1
                 if solver == Solver.XPBD else cfg.n_substeps + 1)
    assert _WRAPPERS[solver].launch_count() == frames * per_frame
    assert sum(w.launch_count() for w in (*_WRAPPERS.values(),
                                          *_LATTICE.values(), blocks)) \
        == frames * per_frame
    s = s0
    for _ in range(frames):
        s = tsb.step(top, cfg, s)
    assert torch.equal(s.x, s_roll.x)
    assert torch.equal(s.edge_alive, s_roll.edge_alive)
    assert torch.equal(s.rest_scale, s_roll.rest_scale)


# --- wind and the strain limit ------------------------------------------------

def _wind_scene(solver, nx=10, ny=10, plane_height=-1.0):
    """tests/test_wind.py's cloth in a cross-wind with drag and lift (10x10,
    and 16x24 contact-free: past an 8-row tile)."""
    cfg = tsb.SimConfig(
        solver=solver,
        wind=WindParams(velocity=(2.0, 0.5, 1.0), drag=0.3, lift=0.8),
        xpbd=XPBDParams(n_iterations=3),
        collision=CollisionParams(enable_plane=True),
        global_damping=0.2,
    )
    host = tsb.cloth_grid(nx, ny, spacing=0.05, shear=True, bend=True,
                          pinned=("tl", "tr"), springs=cfg.springs,
                          xpbd=cfg.xpbd, plane_height=plane_height,
                          orientation="xy")
    return host, cfg


# x: tests/test_wind.py's 5e-5 over 64 substeps (its kernel against its
# stencil); v carries x's rounding over dt
@pytest.mark.cuda
@pytest.mark.parametrize("size", ["10x10", "16x24"])
@pytest.mark.parametrize("solver", list(_WRAPPERS))
def test_wind_kernel_matches_plain_on_card(cuda, solver, size):
    host, cfg = (_wind_scene(solver) if size == "10x10"
                 else _wind_scene(solver, 16, 24, plane_height=-3.0))
    top, s0 = tsb.init(host, device=cuda)
    want = stencil.make_stencil_step(top, cfg)(s0, cfg.dt, 64)
    for w in _WRAPPERS.values():
        w.reset_launch_count()
    got = _WRAPPERS[solver].make_cuda_step(top, cfg)(s0, cfg.dt, 64)
    torch.cuda.synchronize()
    per_sub = (grid_xpbd.launches_per_substep(cfg) if solver == Solver.XPBD
               else 1)
    assert _WRAPPERS[solver].launch_count() == 64 * per_sub
    torch.testing.assert_close(got.x, want.x, atol=5e-5, rtol=0)
    torch.testing.assert_close(got.v, want.v, atol=5e-2, rtol=0)
    pinned = torch.from_numpy(host.inv_mass == 0.0).to(cuda)
    assert torch.equal(got.x[pinned], s0.x[pinned])
    assert float(got.x[:, 0].mean()) > float(s0.x[:, 0].mean())


def _strain_scene(solver, feature="none"):
    """tests/test_strainlimit.py's soft 16x16 banner on a plane with an 8 %
    stretch bound; "tear" tears at 20 %, "both" also creeps."""
    cfg = tsb.SimConfig(
        solver=solver,
        strain_limit=StrainLimitParams(enabled=True, max_stretch=0.08),
        springs=tsb.SpringParams(k_structural=30.0, k_shear=15.0,
                                 k_bend=6.0, damping=0.5),
        xpbd=XPBDParams(compliance_distance=5e-3, compliance_bend=5e-2),
        tear=TearParams(enabled=feature != "none", strain_limit=0.2),
        plasticity=PlasticityParams(enabled=feature == "both",
                                    yield_strain=0.02, creep=0.1),
        global_damping=0.4,
    )
    host = tsb.cloth_grid(16, 16, spacing=0.08, mass=0.04, pinned=("top",),
                          shear=True, bend=True, springs=cfg.springs,
                          xpbd=cfg.xpbd, plane_height=-0.9,
                          orientation="xy")
    return host, cfg


# tests/test_strainlimit.py's kernel-vs-twin bounds on x over 64 substeps:
# 3e-5, 2e-4 with tearing (the clamp at the boundary repeats); the masks
# equal; the rest scales 1e-3: x's 2e-4 is 2.5e-3 of strain on these 0.08
# edges, and the creep (0.1) integrates it into the scales (1.75e-4 was
# measured under Verlet and XPBD); one strain launch a substep, which runs
# every sweep
@pytest.mark.cuda
@pytest.mark.parametrize("feature", ["none", "tear", "both"])
@pytest.mark.parametrize("solver", list(_WRAPPERS))
def test_strain_kernel_matches_plain_on_card(cuda, solver, feature):
    host, cfg = _strain_scene(solver, feature)
    top, s0 = tsb.init(host, device=cuda)
    s0 = tsb.api.ensure_plastic_state(top, cfg,
                                      tsb.api.ensure_tear_state(top, cfg, s0))
    want = stencil.make_stencil_step(top, cfg)(s0, cfg.dt, 64)
    for w in (*_WRAPPERS.values(), grid_strain):
        w.reset_launch_count()
    got = _WRAPPERS[solver].make_cuda_step(top, cfg)(s0, cfg.dt, 64)
    torch.cuda.synchronize()
    assert (_WRAPPERS[solver].launch_count()
            == _WRAPPERS[solver].launches_per_frame(cfg, 64))
    assert grid_strain.launch_count() == 64   # one launch, every sweep
    atol = 2e-4 if cfg.tear.enabled else 3e-5
    torch.testing.assert_close(got.x, want.x, atol=atol, rtol=0)
    if cfg.tear.enabled:
        assert torch.equal(got.edge_alive, want.edge_alive)
    if cfg.plasticity.enabled:
        torch.testing.assert_close(got.rest_scale, want.rest_scale,
                                   atol=1e-3, rtol=0)
    pinned = torch.from_numpy(host.inv_mass == 0.0).to(cuda)
    assert torch.equal(got.x[pinned], s0.x[pinned])


@pytest.mark.cuda
@pytest.mark.parametrize("feature", ["none", "tear", "both"])
def test_strain_sweeps_alone_match_plain_on_card(cuda, feature):
    """The sweeps alone from identical positions (the banner stretched 15 %
    with noise, random liveness and scales): x 1e-6 against
    x + stencil.strain_limit_planes, FMA contraction only."""
    host, cfg = _strain_scene(Solver.SEMI_IMPLICIT_EULER, feature)
    top, s0 = tsb.init(host, device=cuda)
    rng = np.random.default_rng(5)
    ny, nx = top.grid_shape
    x = 1.15 * s0.x + torch.tensor(0.01 * rng.standard_normal((ny * nx, 3)),
                                   dtype=torch.float32, device=cuda)
    x3 = stencil.to_planes(x, ny, nx).contiguous()
    offsets = [(di, dj, k, r) for di, dj, k, r in stencil._offsets(
        cfg, top.grid_spacing, True, True)]
    masks = [stencil._valid_mask(ny, nx, di, dj, cuda, torch.float32)
             for di, dj, _, _ in offsets]
    alive = scale = None
    if cfg.tear.enabled:
        alive = torch.stack(masks) * torch.tensor(
            rng.uniform(size=(6, ny, nx)) < 0.8, dtype=torch.float32,
            device=cuda)
    if cfg.plasticity.enabled:
        scale = torch.tensor(rng.uniform(0.9, 1.2, (6, ny, nx)),
                             dtype=torch.float32, device=cuda)
    want = x3 + stencil.strain_limit_planes(
        x3, offsets, masks if alive is None else list(alive),
        top.inv_mass.reshape(1, ny, nx), cfg.strain_limit, scales=scale)
    grid_strain.reset_launch_count()
    got = grid_euler.make_strain_correction(top, cfg)(x3, alive, scale)
    torch.cuda.synchronize()
    assert grid_strain.launch_count() == 1   # one launch, every sweep
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    assert float((want - x3).abs().max()) > 1e-3   # the sweeps moved it
    pinned = (top.inv_mass == 0.0).reshape(ny, nx)
    assert torch.equal(got[:, pinned], x3[:, pinned])


@pytest.mark.cuda
@pytest.mark.parametrize("solver", list(_WRAPPERS))
def test_strain_without_sweeps_runs_the_epilogue(cuda, solver):
    """iterations = 0: one sweep launch a substep that moves nothing and
    runs the rest of the substep (contact, friction)."""
    host, cfg = _strain_scene(solver)
    cfg = cfg.replace(strain_limit=StrainLimitParams(enabled=True,
                                                     iterations=0))
    top, s0 = tsb.init(host, device=cuda)
    want = stencil.make_stencil_step(top, cfg)(s0, cfg.dt, 32)
    grid_strain.reset_launch_count()
    got = _WRAPPERS[solver].make_cuda_step(top, cfg)(s0, cfg.dt, 32)
    torch.cuda.synchronize()
    assert grid_strain.launch_count() == 32
    torch.testing.assert_close(got.x, want.x, atol=3e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", list(_LATTICE))
def test_lattice_drag_kernel_matches_plain_on_card(cuda, solver):
    """tests/test_wind.py:123-150's drag-only wind on the 6^3 cube: x 1e-5
    (FMA contraction only), v 2e-3, the lattice kernels' bounds."""
    host, cfg = _lattice_scene(solver)
    cfg = cfg.replace(wind=WindParams(velocity=(3.0, 0.0, 1.0), drag=0.5))
    top, s0 = tsb.init(host, device=cuda)
    want = make_plain_step(top, cfg)(s0, cfg.dt, 48)
    _LATTICE[solver].reset_launch_count()
    got = _LATTICE[solver].make_cuda_step(top, cfg)(s0, cfg.dt, 48)
    torch.cuda.synchronize()
    assert (_LATTICE[solver].launch_count()
            == _LATTICE[solver].launches_per_call(top, cfg, 48))
    torch.testing.assert_close(got.x, want.x, atol=1e-5, rtol=0)
    torch.testing.assert_close(got.v, want.v, atol=2e-3, rtol=0)
    assert float(got.x[:, 0].mean()) > float(s0.x[:, 0].mean()) + 1e-3


# --- capsule and box contact ---------------------------------------------------

def _rot_z(deg):
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _collider_scene(solver, kind="grid", moving=True):
    """tests/test_torch_colliders.py's scenes in contact from the start: the
    12x12 cloth in the band of a capsule and a box turned 30 degrees, or
    the 5^3 cube straddling a capsule and a box turned 20 degrees; each
    collider with a kinematic velocity unless ``moving`` is off."""
    cfg = tsb.SimConfig(
        solver=solver,
        collision=CollisionParams(enable_plane=True, enable_capsules=True,
                                  enable_boxes=True, restitution=0.1,
                                  friction=0.3),
        volume_stiffness=0.5, global_damping=0.3)
    if kind == "grid":
        host = tsb.cloth_grid(
            12, 12, spacing=0.05, shear=True, bend=True, pinned=("tl",),
            springs=cfg.springs, xpbd=cfg.xpbd, plane_height=-2.0,
            origin=(-0.28, 0.05, -0.28), orientation="xz")
        geometry = dict(
            capsule_p0=[[-0.3, 0.0, 0.0]], capsule_p1=[[0.05, 0.0, 0.0]],
            capsule_radii=[0.12], box_centers=[[0.18, -0.05, 0.1]],
            box_half_extents=[[0.15, 0.1, 0.12]],
            box_rotations=[_rot_z(30.0)])
    else:
        host = tsb.tet_cube(5, spacing=0.05, springs=cfg.springs,
                            xpbd=cfg.xpbd, plane_height=-0.5,
                            origin=(-0.1, -0.02, -0.1))
        host.inv_mass[:3] = 0.0
        geometry = dict(
            capsule_p0=[[-0.15, 0.0, 0.1]], capsule_p1=[[0.25, 0.0, 0.1]],
            capsule_radii=[0.06], box_centers=[[0.05, -0.06, -0.05]],
            box_half_extents=[[0.12, 0.05, 0.1]],
            box_rotations=[_rot_z(20.0)])
    if moving:
        geometry.update(capsule_velocities=[[0.3, 0.0, 0.1]],
                        box_velocities=[[0.0, 0.1, -0.2]])
    return tsb.add_colliders(host, **geometry), cfg


def _kernel_module(solver, kind):
    return (_WRAPPERS if kind == "grid" else _LATTICE)[solver]


def _plain_step(top, cfg, kind):
    return (stencil.make_stencil_step(top, cfg) if kind == "grid"
            else make_plain_step(top, cfg))


def _assert_pins_frozen(host, got, s0, cuda):
    pinned = torch.from_numpy(host.inv_mass == 0.0).to(cuda)
    assert bool(pinned.any())
    assert torch.equal(got.x[pinned], s0.x[pinned])


# 48 substeps in contact from the start, float32 kernel against float32 plain
# version: x 5e-5, the JAX kernel-vs-twin bound of tests/test_colliders.py
# (rounding, here nvcc's FMA contraction, amplified by capsule and box
# contact), v 5e-2 (v carries x's rounding over dt)
@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["grid", "lattice"])
@pytest.mark.parametrize("solver", list(_WRAPPERS))
def test_collider_kernel_matches_plain_on_card(cuda, solver, kind):
    host, cfg = _collider_scene(solver, kind)
    top, s0 = tsb.init(host, device=cuda)
    want = _plain_step(top, cfg, kind)(s0, cfg.dt, 48)
    module = _kernel_module(solver, kind)
    module.reset_launch_count()
    got = module.make_cuda_step(top, cfg)(s0, cfg.dt, 48)
    torch.cuda.synchronize()
    launches = (module.launches_per_call(top, cfg, 48) if kind == "lattice"
                else 48 * module.launches_per_substep(cfg))
    assert module.launch_count() == launches
    torch.testing.assert_close(got.x, want.x, atol=5e-5, rtol=0)
    torch.testing.assert_close(got.v, want.v, atol=5e-2, rtol=0)
    assert float((want.x - s0.x).abs().max()) > 1e-2
    _assert_pins_frozen(host, got, s0, cuda)


# the strain limit's epilogues run the capsule and box contact: Euler and
# Verlet in the last sweep, XPBD as the projection after the sweeps; x 5e-5
# as above
@pytest.mark.cuda
@pytest.mark.parametrize("solver", list(_WRAPPERS))
def test_collider_strain_kernel_matches_plain_on_card(cuda, solver):
    host, cfg = _collider_scene(solver)
    cfg = cfg.replace(strain_limit=StrainLimitParams(
        enabled=True, max_stretch=0.05, iterations=4))
    top, s0 = tsb.init(host, device=cuda)
    want = stencil.make_stencil_step(top, cfg)(s0, cfg.dt, 32)
    grid_strain.reset_launch_count()
    got = _WRAPPERS[solver].make_cuda_step(top, cfg)(s0, cfg.dt, 32)
    torch.cuda.synchronize()
    assert grid_strain.launch_count() == 32   # one launch, every sweep
    torch.testing.assert_close(got.x, want.x, atol=5e-5, rtol=0)
    _assert_pins_frozen(host, got, s0, cuda)


# the feature instantiation with capsules and boxes: x 5e-5 as above, the
# masks equal, the rest scales 1e-4 (x's rounding over the 0.05 rest length,
# integrated by the 0.2 creep)
@pytest.mark.cuda
@pytest.mark.parametrize("solver", list(_WRAPPERS))
def test_collider_feature_kernel_matches_plain_on_card(cuda, solver):
    host, cfg = _collider_scene(solver)
    cfg = cfg.replace(tear=TearParams(enabled=True, strain_limit=0.3),
                      plasticity=PlasticityParams(enabled=True,
                                                  yield_strain=0.02,
                                                  creep=0.2))
    top, s0 = tsb.init(host, device=cuda)
    s0 = tsb.api.ensure_plastic_state(top, cfg,
                                      tsb.api.ensure_tear_state(top, cfg, s0))
    want = stencil.make_stencil_step(top, cfg)(s0, cfg.dt, 32)
    got = _WRAPPERS[solver].make_cuda_step(top, cfg)(s0, cfg.dt, 32)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.x, want.x, atol=5e-5, rtol=0)
    assert torch.equal(got.edge_alive, want.edge_alive)
    torch.testing.assert_close(got.rest_scale, want.rest_scale, atol=1e-4,
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["grid", "lattice"])
@pytest.mark.parametrize("solver", list(_WRAPPERS))
def test_colliders_off_are_the_kernel_without_them(cuda, solver, kind):
    """Capsule and box rows that the config turns off launch with counts 0
    and give, bit for bit, what the scene without them gives: the branch is
    a loop over no rows, and the plane and sphere path is untouched."""
    host, cfg = _collider_scene(solver, kind)
    bare = dataclasses.replace(
        host, capsule_p0=None, capsule_p1=None, capsule_radii=None,
        capsule_velocities=None, box_centers=None, box_half_extents=None,
        box_rotations=None, box_velocities=None)
    off = cfg.replace(collision=dataclasses.replace(
        cfg.collision, enable_capsules=False, enable_boxes=False))
    module = _kernel_module(solver, kind)
    out = []
    for h in (host, bare):
        top, s0 = tsb.init(h, device=cuda)
        out.append(module.make_cuda_step(top, off)(s0, cfg.dt, 32))
    torch.cuda.synchronize()
    assert torch.equal(out[0].x, out[1].x)
    assert torch.equal(out[0].v, out[1].v)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["grid", "lattice"])
@pytest.mark.parametrize("solver", list(_WRAPPERS))
def test_move_colliders_rollout_launch_counts(cuda, solver, kind):
    """Moving the capsule every frame through api.move_colliders: no
    launch beyond frames x substeps x launches per substep, no other
    kernel, one step function built, and each frame equal to the bit to a
    step function built fresh on the moved topology."""
    host, cfg = _collider_scene(solver, kind)
    top, s = tsb.init(host, device=cuda)
    ref = s
    module = _kernel_module(solver, kind)
    for w in (*_WRAPPERS.values(), *_LATTICE.values(), blocks):
        w.reset_launch_count()
    misses = tsb.api._build_step.cache_info().misses
    frames = 6
    for i in range(frames):
        moved = tsb.move_colliders(
            top, capsule_p0=top.capsule_p0 + 0.01 * i,
            capsule_velocities=[[0.6, 0.6, 0.6]])
        s = tsb.step(moved, cfg, s)
        fresh = module.make_cuda_step(moved, cfg)
        ref = fresh(ref, cfg.dt, cfg.n_substeps)
    torch.cuda.synchronize()
    per_call = (module.launches_per_call(top, cfg, cfg.n_substeps)
                if kind == "lattice"
                else cfg.n_substeps * module.launches_per_substep(cfg))
    # the fresh step functions launched as many again
    assert module.launch_count() == 2 * frames * per_call
    assert sum(w.launch_count() for w in (*_WRAPPERS.values(),
                                          *_LATTICE.values(), blocks)) \
        == 2 * frames * per_call
    assert tsb.api._build_step.cache_info().misses == misses + 1
    assert torch.equal(s.x, ref.x) and torch.equal(s.v, ref.v)


# --- the XPBD kernels on shapes that do not divide their tiles ----------------

# each grid branch's scene, as the tests above build it (their config, pins,
# plane, colliders) at another shape, and the tolerances those tests hold
# it to: (x, v)
_XPBD_GRID_TOL = {"plain": (1e-5, 1e-3), "features": (5e-5, 5e-2),
                  "wind": (5e-5, 5e-2), "force": (1e-5, 2e-3),
                  "colliders": (5e-5, 5e-2)}


def _xpbd_grid_scene(nx, ny, full, n_iter, branch, shear=None, bend=None):
    """A grid XPBD scene of nx x ny vertices, with all six offsets or the
    structural two (or those ``shear`` and ``bend`` say), ``n_iter`` Jacobi
    sweeps, and one branch: "plain"
    (_scene16_solver's), "features" (_feature_scene's tear and plastic
    planes), "wind" (_wind_scene's), "force" (the self-collision force
    plane, its radius past the rest spacing so that every structural pair
    pushes apart; _halo_scene's 60 % shrink buckles these cloths under
    XPBD, where the earlier one-pass kernel parts from the plain version
    as well) or "colliders" (_collider_scene's capsule and box).
    The hanging cloths stay clear of their plane (130 rows reach 6.5 m
    down)."""
    if branch == "features":
        host, cfg = _feature_scene(Solver.XPBD, "both")
        kw = dict(pinned=("top",), plane_height=-10.0, orientation="xy")
    elif branch == "wind":
        host, cfg = _wind_scene(Solver.XPBD)
        kw = dict(pinned=("tl", "tr"), plane_height=-10.0, orientation="xy")
    elif branch == "colliders":
        host, cfg = _collider_scene(Solver.XPBD)
        kw = dict(pinned=("tl",), plane_height=-2.0,
                  origin=(-0.28, 0.05, -0.28), orientation="xz")
    else:
        host, cfg = _scene16_solver(Solver.XPBD)
        kw = dict(pinned=("tl", "tr"), plane_height=-10.0, orientation="xy")
        if branch == "force":
            cfg = cfg.replace(self_collision=SelfCollisionParams(
                enabled=True, method="block", radius=0.06, cell_size=0.06))
    cfg = cfg.replace(xpbd=dataclasses.replace(cfg.xpbd, n_iterations=n_iter))
    grid = tsb.cloth_grid(nx, ny, spacing=0.05,
                          shear=full if shear is None else shear,
                          bend=full if bend is None else bend,
                          springs=cfg.springs, xpbd=cfg.xpbd, **kw)
    if branch == "colliders":
        grid = dataclasses.replace(grid, **{
            f: getattr(host, f) for f in (
                "capsule_p0", "capsule_p1", "capsule_radii",
                "capsule_velocities", "box_centers", "box_half_extents",
                "box_rotations", "box_velocities")})
    return grid, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("branch", list(_XPBD_GRID_TOL))
@pytest.mark.parametrize("n_iter", [0, 1, 8])
@pytest.mark.parametrize("full", [True, False], ids=["six", "structural"])
@pytest.mark.parametrize("nx,ny", [(37, 53), (19, 130)])
def test_xpbd_grid_tiles_match_plain_on_card(cuda, nx, ny, full, n_iter,
                                             branch):
    """The tiled sweep on grids that no tile shape divides (the ragged last
    tile in both directions; 19 columns are narrower than a tile), with
    every offset (a halo of 2) and the structural two (a halo of 1),
    against the plain version over 32 substeps."""
    host, cfg = _xpbd_grid_scene(nx, ny, full, n_iter, branch)
    top, s0 = tsb.init(host, device=cuda)
    if branch == "features":
        s0 = tsb.api.ensure_plastic_state(
            top, cfg, tsb.api.ensure_tear_state(top, cfg, s0))
    want = stencil.make_stencil_step(top, cfg)(s0, cfg.dt, 32)
    for w in (*_WRAPPERS.values(), *_LATTICE.values()):
        w.reset_launch_count()
    got = grid_xpbd.make_cuda_step(top, cfg)(s0, cfg.dt, 32)
    torch.cuda.synchronize()
    assert grid_xpbd.launch_count() == grid_xpbd.launches_per_frame(cfg, 32)
    assert sum(w.launch_count() for w in (*_WRAPPERS.values(),
                                          *_LATTICE.values())) \
        == grid_xpbd.launches_per_frame(cfg, 32)
    atol_x, atol_v = _XPBD_GRID_TOL[branch]
    torch.testing.assert_close(got.x, want.x, atol=atol_x, rtol=0)
    torch.testing.assert_close(got.v, want.v, atol=atol_v, rtol=0)
    if branch == "features":
        assert torch.equal(got.edge_alive, want.edge_alive)
        torch.testing.assert_close(got.rest_scale, want.rest_scale,
                                   atol=1e-5, rtol=0)
    assert float((want.x - s0.x).abs().max()) > 1e-3
    pinned = torch.from_numpy(host.inv_mass == 0.0).to(cuda)
    assert torch.equal(got.x[pinned], s0.x[pinned])


@pytest.mark.cuda
@pytest.mark.parametrize("branch", ["plain", "features", "colliders"])
@pytest.mark.parametrize("shear,bend", [(True, False), (False, True)],
                         ids=["shear", "bend"])
def test_xpbd_grid_patterns_match_plain_on_card(cuda, shear, bend, branch):
    """The two offset patterns the test above does not take (structural
    with shear, structural with bend: a frame of one and of two), each a
    sweep of its own, against the plain version over 32 substeps."""
    host, cfg = _xpbd_grid_scene(37, 53, None, 8, branch, shear, bend)
    top, s0 = tsb.init(host, device=cuda)
    want = stencil.make_stencil_step(top, cfg)(s0, cfg.dt, 32)
    grid_xpbd.reset_launch_count()
    got = grid_xpbd.make_cuda_step(top, cfg)(s0, cfg.dt, 32)
    torch.cuda.synchronize()
    assert grid_xpbd.launch_count() == grid_xpbd.launches_per_frame(cfg, 32)
    atol_x, atol_v = _XPBD_GRID_TOL[branch]
    torch.testing.assert_close(got.x, want.x, atol=atol_x, rtol=0)
    torch.testing.assert_close(got.v, want.v, atol=atol_v, rtol=0)
    if branch == "features":
        assert torch.equal(got.edge_alive, want.edge_alive)
    pinned = torch.from_numpy(host.inv_mass == 0.0).to(cuda)
    assert torch.equal(got.x[pinned], s0.x[pinned])


# --- grid Euler: the tiled substep and the one-launch strain sweeps ----------

# the four offset patterns of the tiled kernels: structural, with shear, with
# bend, with both
_PATTERNS = [(False, False), (True, False), (False, True), (True, True)]
_PATTERN_IDS = ["structural", "shear", "bend", "six"]


def _euler_grid_scene(nx, ny, shear, bend, branch,
                      solver=Solver.SEMI_IMPLICIT_EULER):
    """A grid Euler (or ``solver``) scene of nx x ny vertices with the
    springs of one offset pattern and one branch: "plain" (_scene16's
    springs, pinned at the top corners), "features" (_feature_scene's tear
    and plastic planes, pinned along the top row), "wind" (_wind_scene's),
    "force" (the self-collision force plane, its radius past the rest
    spacing so that every structural pair pushes apart) or "colliders"
    (_collider_scene's capsule and box under a cloth lying in xz).  The
    hanging cloths stay clear of their plane."""
    kw = dict(pinned=("tl", "tr"), plane_height=-(0.05 * ny + 1.0),
              orientation="xy")
    host = None
    if branch == "features":
        _, cfg = _feature_scene(solver, "both")
        kw["pinned"] = ("top",)
    elif branch == "wind":
        _, cfg = _wind_scene(solver)
    elif branch == "colliders":
        host, cfg = _collider_scene(solver)
        kw = dict(pinned=("tl",), plane_height=-2.0,
                  origin=(-0.28, 0.05, -0.28), orientation="xz")
    else:
        _, cfg = _scene16()
        cfg = cfg.replace(solver=solver)
        if branch == "force":
            cfg = cfg.replace(self_collision=SelfCollisionParams(
                enabled=True, method="block", radius=0.06, cell_size=0.06))
    grid = tsb.cloth_grid(nx, ny, spacing=0.05, shear=shear, bend=bend,
                          springs=cfg.springs, xpbd=cfg.xpbd, **kw)
    if host is not None:
        grid = dataclasses.replace(grid, **{
            f: getattr(host, f) for f in (
                "capsule_p0", "capsule_p1", "capsule_radii",
                "capsule_velocities", "box_centers", "box_half_extents",
                "box_rotations", "box_velocities")})
    return grid, cfg


# float32 kernel against float32 plain version over 32 substeps: x 5e-5
# (the JAX kernel-vs-twin bounds of tests/test_tearing.py, test_wind.py and
# test_colliders.py), 5e-4 with the structural springs alone (a floppy
# cloth: test_kernel_matches_plain_on_card's bound); v 5e-2 (x's rounding
# over dt)
@pytest.mark.cuda
@pytest.mark.parametrize("branch", ["plain", "features", "wind", "force",
                                    "colliders"])
@pytest.mark.parametrize("shear,bend", _PATTERNS, ids=_PATTERN_IDS)
@pytest.mark.parametrize("nx,ny", [(37, 53), (5, 300)])
def test_grid_euler_tiles_match_plain_on_card(cuda, nx, ny, shear, bend,
                                              branch):
    """The tiled substep, compiled for each offset pattern, on grids that no
    tile divides (the ragged last tile in both directions; 5 columns are
    narrower than a tile), with each branch, against the plain version;
    the frame one C call (one a substep with the force plane)."""
    host, cfg = _euler_grid_scene(nx, ny, shear, bend, branch)
    top, s0 = tsb.init(host, device=cuda)
    if branch == "features":
        s0 = tsb.api.ensure_plastic_state(
            top, cfg, tsb.api.ensure_tear_state(top, cfg, s0))
    want = stencil.make_stencil_step(top, cfg)(s0, cfg.dt, 32)
    for w in (*_WRAPPERS.values(), *_LATTICE.values()):
        w.reset_launch_count()
    got = grid_euler.make_cuda_step(top, cfg)(s0, cfg.dt, 32)
    torch.cuda.synchronize()
    assert grid_euler.launch_count() == grid_euler.launches_per_frame(cfg, 32)
    assert sum(w.launch_count() for w in (*_WRAPPERS.values(),
                                          *_LATTICE.values())) \
        == grid_euler.launches_per_frame(cfg, 32)
    atol_x = 5e-5 if shear or bend else 5e-4
    torch.testing.assert_close(got.x, want.x, atol=atol_x, rtol=0)
    torch.testing.assert_close(got.v, want.v, atol=5e-2, rtol=0)
    if branch == "features":
        assert torch.equal(got.edge_alive, want.edge_alive)
        torch.testing.assert_close(got.rest_scale, want.rest_scale,
                                   atol=1e-5, rtol=0)
    assert float((want.x - s0.x).abs().max()) > 1e-4
    pinned = torch.from_numpy(host.inv_mass == 0.0).to(cuda)
    assert torch.equal(got.x[pinned], s0.x[pinned])


# the Verlet tile against the plain version over 32 substeps, at
# test_solver_kernel_matches_plain_on_card's Verlet bounds (x and x_prev
# 1e-3, v = (x - x_prev) / dt 5e-2)
@pytest.mark.cuda
@pytest.mark.parametrize("branch", ["plain", "features", "wind", "force",
                                    "colliders"])
@pytest.mark.parametrize("shear,bend", _PATTERNS, ids=_PATTERN_IDS)
@pytest.mark.parametrize("nx,ny", [(37, 53), (5, 300)])
def test_grid_verlet_tiles_match_plain_on_card(cuda, nx, ny, shear, bend,
                                               branch):
    """The tiled Verlet substep, compiled for each offset pattern, on grids
    that no tile divides, with each branch, against the plain version; the
    frame one C call (one a substep with the force plane), its launches
    those of launches_per_frame."""
    host, cfg = _euler_grid_scene(nx, ny, shear, bend, branch, Solver.VERLET)
    top, s0 = tsb.init(host, device=cuda)
    if branch == "features":
        s0 = tsb.api.ensure_plastic_state(
            top, cfg, tsb.api.ensure_tear_state(top, cfg, s0))
    want = stencil.make_stencil_step(top, cfg)(s0, cfg.dt, 32)
    for w in (*_WRAPPERS.values(), *_LATTICE.values()):
        w.reset_launch_count()
    got = grid_verlet.make_cuda_step(top, cfg)(s0, cfg.dt, 32)
    torch.cuda.synchronize()
    per_frame = grid_verlet.launches_per_frame(cfg, 32)
    assert grid_verlet.launch_count() == per_frame
    assert sum(w.launch_count() for w in (*_WRAPPERS.values(),
                                          *_LATTICE.values())) == per_frame
    torch.testing.assert_close(got.x, want.x, atol=1e-3, rtol=0)
    torch.testing.assert_close(got.x_prev, want.x_prev, atol=1e-3, rtol=0)
    torch.testing.assert_close(got.v, want.v, atol=5e-2, rtol=0)
    if branch == "features":
        assert torch.equal(got.edge_alive, want.edge_alive)
        torch.testing.assert_close(got.rest_scale, want.rest_scale,
                                   atol=1e-5, rtol=0)
    assert float((want.x - s0.x).abs().max()) > 1e-4
    pinned = torch.from_numpy(host.inv_mass == 0.0).to(cuda)
    assert torch.equal(got.x[pinned], s0.x[pinned])


@pytest.mark.cuda
@pytest.mark.parametrize("n_sub", [0, 1, 2, 7])
@pytest.mark.parametrize("feature", ["tear", "both"])
def test_grid_verlet_frame_parity_on_card(cuda, feature, n_sub):
    """One C call runs a frame of any length and rotates the three
    position buffers itself: frames of 0, 1, 2 and 7 substeps (each
    remainder of the period 3, and of the strain limit's period 2), three
    in a row, return the state and planes of the plain version's frames,
    at the Verlet bounds above; with the strain limit too."""
    for strain in (False, True):
        host, cfg = _feature_scene(Solver.VERLET, feature)
        if strain:
            cfg = cfg.replace(strain_limit=StrainLimitParams(
                enabled=True, max_stretch=0.02, iterations=3))
        top, s0 = tsb.init(host, device=cuda)
        s0 = tsb.api.ensure_plastic_state(
            top, cfg, tsb.api.ensure_tear_state(top, cfg, s0))
        fn = grid_verlet.make_cuda_step(top, cfg)
        plain = stencil.make_stencil_step(top, cfg)
        got, want = s0, s0
        for _ in range(3):
            got, want = fn(got, cfg.dt, n_sub), plain(want, cfg.dt, n_sub)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.x, want.x, atol=1e-3, rtol=0)
        torch.testing.assert_close(got.x_prev, want.x_prev, atol=1e-3,
                                   rtol=0)
        assert torch.equal(got.edge_alive, want.edge_alive)
        if n_sub == 0:
            assert torch.equal(got.x, s0.x)
            assert torch.equal(got.x_prev, s0.x_prev)


@pytest.mark.cuda
@pytest.mark.parametrize("branch", ["plain", "wind", "force", "colliders"])
@pytest.mark.parametrize("shear,bend", [(True, True), (False, False)],
                         ids=["six", "structural"])
def test_grid_euler_wide_grids_match_plain_on_card(cuda, shear, bend,
                                                   branch):
    """A grid of 2,112 tiles, more than the card holds CTAs of the
    substep kernel at once: its plain substeps (also with capsules and
    boxes) take grid_euler_wide_kernel (the offsets' terms in two halves,
    eight CTAs an SM), with wind or the force plane the substep kernel;
    against the plain version over 16 substeps, as the tiles above."""
    host, cfg = _euler_grid_scene(1024, 520, shear, bend, branch)
    top, s0 = tsb.init(host, device=cuda)
    want = stencil.make_stencil_step(top, cfg)(s0, cfg.dt, 16)
    grid_euler.reset_launch_count()
    got = grid_euler.make_cuda_step(top, cfg)(s0, cfg.dt, 16)
    torch.cuda.synchronize()
    assert grid_euler.launch_count() == 16
    atol_x = 5e-5 if shear or bend else 5e-4
    torch.testing.assert_close(got.x, want.x, atol=atol_x, rtol=0)
    torch.testing.assert_close(got.v, want.v, atol=5e-2, rtol=0)
    assert float((want.x - s0.x).abs().max()) > 1e-4
    pinned = torch.from_numpy(host.inv_mass == 0.0).to(cuda)
    assert torch.equal(got.x[pinned], s0.x[pinned])


@pytest.mark.cuda
@pytest.mark.parametrize("n_sub", [0, 1, 7])
@pytest.mark.parametrize("feature", ["tear", "both"])
def test_grid_euler_frame_parity_on_card(cuda, feature, n_sub):
    """One C call runs a frame of any length: even, odd and empty frames
    return the buffers and planes the last launch wrote, as the plain
    version's frame; with the strain limit too (x then stays in one
    buffer)."""
    for strain in (False, True):
        host, cfg = _feature_scene(Solver.SEMI_IMPLICIT_EULER, feature)
        if strain:
            cfg = cfg.replace(strain_limit=StrainLimitParams(
                enabled=True, max_stretch=0.02, iterations=3))
        top, s0 = tsb.init(host, device=cuda)
        s0 = tsb.api.ensure_plastic_state(
            top, cfg, tsb.api.ensure_tear_state(top, cfg, s0))
        fn = grid_euler.make_cuda_step(top, cfg)
        plain = stencil.make_stencil_step(top, cfg)
        got, want = s0, s0
        for _ in range(3):
            got, want = fn(got, cfg.dt, n_sub), plain(want, cfg.dt, n_sub)
        torch.cuda.synchronize()
        # the feature and strain kernel-vs-plain bounds above
        torch.testing.assert_close(got.x, want.x,
                                   atol=2e-4 if strain else 5e-5, rtol=0)
        torch.testing.assert_close(got.v, want.v, atol=5e-2, rtol=0)
        assert torch.equal(got.edge_alive, want.edge_alive)
        if n_sub == 0:
            assert torch.equal(got.x, s0.x) and torch.equal(got.v, s0.v)


def _stretched_sweeps(nx, ny, shear, bend, iterations, features, cuda,
                      seed=5):
    """The sweeps alone from identical positions: a cloth of nx x ny
    vertices (at most 0.9 m across, so that float32 positions keep ulps
    below 1e-7), stretched 15 % with noise, with random liveness and rest
    scales under ``features``.  Returns (top, cfg, x3, alive, scale,
    want), want the plain x3 + strain_limit_planes."""
    spacing = 0.9 / max(nx, ny)
    cfg = tsb.SimConfig(strain_limit=StrainLimitParams(
        enabled=True, max_stretch=0.08, iterations=iterations),
        tear=TearParams(enabled=features), plasticity=PlasticityParams(
            enabled=features))
    host = tsb.cloth_grid(nx, ny, spacing=spacing, pinned=("top",),
                          shear=shear, bend=bend, springs=cfg.springs,
                          xpbd=cfg.xpbd, orientation="xy")
    top, s0 = tsb.init(host, device=cuda)
    rng = np.random.default_rng(seed)
    x = 1.15 * s0.x + torch.tensor(
        0.1 * spacing * rng.standard_normal((ny * nx, 3)),
        dtype=torch.float32, device=cuda)
    x3 = stencil.to_planes(x, ny, nx).contiguous()
    offsets = stencil._offsets(cfg, top.grid_spacing, shear, bend)
    masks = [stencil._valid_mask(ny, nx, di, dj, cuda, torch.float32)
             for di, dj, _, _ in offsets]
    alive = scale = None
    if features:
        alive = torch.stack(masks) * torch.tensor(
            rng.uniform(size=(len(offsets), ny, nx)) < 0.8,
            dtype=torch.float32, device=cuda)
        scale = torch.tensor(rng.uniform(0.9, 1.2, (len(offsets), ny, nx)),
                             dtype=torch.float32, device=cuda)
    want = x3 + stencil.strain_limit_planes(
        x3, offsets, masks if alive is None else list(alive),
        top.inv_mass.reshape(1, ny, nx), cfg.strain_limit, scales=scale)
    return top, cfg, x3, alive, scale, want


@pytest.mark.cuda
@pytest.mark.parametrize("iterations,features", [(1, False), (5, True)])
@pytest.mark.parametrize("shear,bend", _PATTERNS, ids=_PATTERN_IDS)
@pytest.mark.parametrize("nx,ny", [(37, 53), (1024, 520)])
def test_strain_sweeps_tiles_match_plain_on_card(cuda, nx, ny, shear, bend,
                                                 iterations, features):
    """One launch of the sweeps, compiled for each offset pattern, on a
    grid no tile divides and on one of 2,112 tiles, more than the card
    holds resident, so that each CTA loops over several tiles and the
    grid barrier separates sweeps: x 1e-6 against the plain sweeps, FMA
    contraction only."""
    top, cfg, x3, alive, scale, want = _stretched_sweeps(
        nx, ny, shear, bend, iterations, features, cuda)
    grid_strain.reset_launch_count()
    got = grid_euler.make_strain_correction(top, cfg)(x3, alive, scale)
    torch.cuda.synchronize()
    assert grid_strain.launch_count() == 1
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    assert float((want - x3).abs().max()) > 1e-5   # the sweeps moved it
    pinned = (top.inv_mass == 0.0).reshape(ny, nx)
    assert torch.equal(got[:, pinned], x3[:, pinned])


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny", [(37, 53), (1024, 520)])
def test_strain_sweeps_repeat_bit_equal_on_card(cuda, nx, ny):
    """Each edge's correction comes from one thread and each vertex sums
    its terms in a fixed order, across the grid barrier too: 24 launches
    from one state give one result to the bit."""
    top, cfg, x3, alive, scale, _ = _stretched_sweeps(
        nx, ny, True, True, 5, True, cuda)
    fn = grid_euler.make_strain_correction(top, cfg)
    want = fn(x3, alive, scale)
    for k in range(23):
        assert torch.equal(fn(x3, alive, scale), want), k


@pytest.mark.cuda
@pytest.mark.parametrize("branch", ["plain", "features", "wind", "force",
                                    "colliders"])
@pytest.mark.parametrize("nx,ny", [(37, 53), (1024, 520)])
def test_grid_euler_tiles_repeat_bit_equal_on_card(cuda, nx, ny, branch):
    """24 frames of 32 substeps from one state, on a grid no tile divides
    and on one wide enough for the wide kernel, give one result to the
    bit: no shared-memory race in the tile."""
    host, cfg = _euler_grid_scene(nx, ny, True, True, branch)
    top, s0 = tsb.init(host, device=cuda)
    if branch == "features":
        s0 = tsb.api.ensure_plastic_state(
            top, cfg, tsb.api.ensure_tear_state(top, cfg, s0))
    fn = grid_euler.make_cuda_step(top, cfg)
    want = fn(s0, cfg.dt, 32)
    for k in range(23):
        got = fn(s0, cfg.dt, 32)
        assert torch.equal(got.x, want.x), k
        assert torch.equal(got.v, want.v), k
    assert float((want.x - s0.x).abs().max()) > 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("branch", ["plain", "features", "wind", "force",
                                    "colliders"])
@pytest.mark.parametrize("nx,ny", [(37, 53), (1024, 520)])
def test_grid_verlet_tiles_repeat_bit_equal_on_card(cuda, nx, ny, branch):
    """24 frames of 32 substeps of the Verlet tile from one state, on a
    grid no tile divides and on one of more tiles than the card holds at
    once, give one result to the bit: no shared-memory race in the tile
    or its staged velocity estimate, and the frame's buffer rotation reads
    no stale buffer."""
    host, cfg = _euler_grid_scene(nx, ny, True, True, branch, Solver.VERLET)
    top, s0 = tsb.init(host, device=cuda)
    if branch == "features":
        s0 = tsb.api.ensure_plastic_state(
            top, cfg, tsb.api.ensure_tear_state(top, cfg, s0))
    fn = grid_verlet.make_cuda_step(top, cfg)
    want = fn(s0, cfg.dt, 32)
    for k in range(23):
        got = fn(s0, cfg.dt, 32)
        assert torch.equal(got.x, want.x), k
        assert torch.equal(got.x_prev, want.x_prev), k
    assert float((want.x - s0.x).abs().max()) > 1e-4


def _pair_scenes(cuda):
    """(name, x, params) of the culled block_pairs' card tests: a seeded
    cloud, tests/test_blocksparse.py's 128 x 128 folded sheet at the 16k
    preset's parameters, and cloth_selfcollide_64k after 24 substeps (the
    pile)."""
    rng = np.random.default_rng(7)
    cloud = torch.tensor(rng.uniform(0, 0.5, (2048, 3)), dtype=torch.float32,
                         device=cuda)
    p = SelfCollisionParams(enabled=True, method="block", radius=0.05,
                            stiffness=10.0, cell_size=0.05, block_partners=8)
    p16 = tsb.presets.build("cloth_selfcollide_16k")[1].self_collision
    xs, ys = np.meshgrid(np.arange(128), np.arange(128), indexing="ij")
    layer = (ys.ravel() * 0.01 // 0.32).astype(int)
    yy = np.where(layer % 2 == 0, ys.ravel() * 0.01 % 0.32,
                  0.32 - ys.ravel() * 0.01 % 0.32)
    sheet = torch.tensor(np.stack(
        [xs.ravel() * 0.01, yy, layer * 0.75 * p16.radius], axis=1),
        dtype=torch.float32, device=cuda)
    host, cfg = tsb.presets.build("cloth_selfcollide_64k")
    top, s0 = tsb.init(host, device=cuda)
    pile = tsb.step(top, cfg, s0, n_substeps=24).x
    return [("cloud", cloud, p), ("folded 128", sheet, p16),
            ("64k pile", pile, cfg.self_collision)]


@pytest.mark.cuda
def test_block_pairs_repeats_bit_equal_on_card(cuda):
    """The culled pair kernel, single form and dual form on 4 row shards:
    24 launches from one state give one result to the bit (the slice boxes
    in shared memory, the partial rows and the arrival counters), and a
    build on fresh NaN-filled allocations (the partial rows) gives it
    again; each scene has pairs in reach."""
    for name, x, p in _pair_scenes(cuda):
        n = x.shape[0]
        fn = blocks.make_block_pairs(p, n, cuda)
        want = fn(x)
        for k in range(23):
            assert torch.equal(fn(x), want), (name, k)
        _poison_allocator(cuda)
        assert torch.equal(blocks.make_block_pairs(p, n, cuda)(x), want), name
        assert float(want.abs().max()) > 0.0, name
        ni = n // 4
        for r in range(4):
            xi = x[r * ni:(r + 1) * ni]
            dual = blocks.make_block_pairs_dual(p, ni, n, cuda)
            want_r = dual(xi, x)
            for k in range(23):
                assert torch.equal(dual(xi, x), want_r), (name, r, k)
            _poison_allocator(cuda)
            assert torch.equal(
                blocks.make_block_pairs_dual(p, ni, n, cuda)(xi, x), want_r)


@pytest.mark.cuda
def test_normals_are_bit_equal_run_to_run_on_card(cuda):
    """The vertex normals sum each vertex's faces in a fixed order, so two
    calls on the card give the same bits (index_add_'s atomics did not),
    and agree with the CPU's sum to float32 rounding."""
    host, cfg = tsb.presets.build("cloth_bench_64k")
    top, s0 = tsb.init(host, device=cuda)
    rng = np.random.default_rng(3)
    s = s0.replace(x=s0.x + torch.tensor(
        0.01 * rng.standard_normal(tuple(s0.x.shape)), dtype=torch.float32,
        device=cuda))
    a = tsb.normals(top, s)
    b = tsb.normals(top, s)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    cpu = tsb.normals(*tsb.init(host, device="cpu")[:1], s.replace(
        x=s.x.cpu()))
    torch.testing.assert_close(a.cpu(), cpu, atol=1e-5, rtol=0)


def _tet_box(shape, spacing, springs, xpbd, plane_height, origin):
    """tet_cube's lattice on nx x ny x nz vertices: the same 5-tet cells,
    parity-alternated, their edges as springs."""
    from softbodyunity_torch.core import topology as T

    nx, ny, nz = shape
    cube = tsb.tet_cube(2, spacing=spacing, springs=springs, xpbd=xpbd,
                        plane_height=plane_height, origin=origin)

    def vid(i, j, k):
        return (i * ny + j) * nz + k

    pos = np.array([(i, j, k) for i in range(nx) for j in range(ny)
                    for k in range(nz)], dtype=np.float64) * spacing
    pos += np.asarray(origin, dtype=np.float64)
    tets = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            for k in range(nz - 1):
                pat = T._FIVE if (i + j + k) % 2 == 0 else T._FIVE_ALT
                tets += [tuple(vid(i + a, j + b, k + c) for a, b, c in t)
                         for t in pat]

    def vol(t):
        p = pos[np.asarray(t)]
        return float(np.dot(np.cross(p[1] - p[0], p[2] - p[0]), p[3] - p[0])
                     / 6.0)

    tets = [t if vol(t) > 0 else (t[0], t[1], t[3], t[2]) for t in tets]
    pairs = sorted({tuple(sorted((t[a], t[b]))) for t in tets
                    for a in range(4) for b in range(a + 1, 4)})
    edges, rest, cls, k, alpha = T._edge_arrays(
        [(a, b, T.EDGE_STRUCTURAL) for a, b in pairs], pos, springs, xpbd)
    incident, sign = T._build_incidence(len(pos), edges)
    return dataclasses.replace(
        cube, positions0=pos, edges=edges, rest_length=rest, edge_class=cls,
        edge_stiffness=k, edge_compliance=alpha,
        inv_mass=np.ones(len(pos)), incident=incident, incident_sign=sign,
        tets=np.array(tets, dtype=np.int32),
        rest_volume=np.array([vol(t) for t in tets]),
        triangles=np.zeros((0, 3), np.int32), lattice_shape=shape)


def _lattice_box_scene(shape, n_iter, branch, solver=Solver.XPBD):
    """_lattice_scene's cube (on the plane, a pinned corner) under
    ``solver`` at ``shape``, with ``n_iter`` XPBD sweeps, and one branch:
    "plain", "no volume" (Euler and Verlet: volume_stiffness 0), "drag"
    (test_lattice_drag_kernel_matches_plain_on_card's wind) or "colliders"
    (_collider_scene's lattice capsule and box)."""
    host, cfg = _lattice_scene(solver, pins=8)
    if branch == "colliders":
        chost, ccfg = _collider_scene(solver, "lattice")
        cfg = ccfg
        kw = dict(spacing=0.05, plane_height=-0.5, origin=(-0.1, -0.02, -0.1))
    else:
        kw = dict(spacing=0.08, plane_height=0.0, origin=(0.0, 0.01, 0.0))
    if branch == "drag":
        cfg = cfg.replace(wind=WindParams(velocity=(3.0, 0.0, 1.0), drag=0.5))
    if branch == "no volume":
        cfg = cfg.replace(volume_stiffness=0.0)
    cfg = cfg.replace(xpbd=dataclasses.replace(cfg.xpbd, n_iterations=n_iter))
    box = _tet_box(shape, springs=cfg.springs, xpbd=cfg.xpbd, **kw)
    box.inv_mass[:8] = 0.0
    if branch == "colliders":
        box = dataclasses.replace(box, **{
            f: getattr(chost, f) for f in (
                "capsule_p0", "capsule_p1", "capsule_radii",
                "capsule_velocities", "box_centers", "box_half_extents",
                "box_rotations", "box_velocities")})
    return box, cfg


# the lattice tests' bounds: x 1e-5 (FMA contraction only), v 2e-3; with
# capsules and boxes the collider tests' 5e-5 and 5e-2
@pytest.mark.cuda
@pytest.mark.parametrize("branch", ["plain", "drag", "colliders"])
@pytest.mark.parametrize("n_iter", [0, 1, 8])
@pytest.mark.parametrize("shape", [(7, 7, 7), (5, 6, 9)],
                         ids=["7^3", "5x6x9"])
def test_xpbd_lattice_passes_match_plain_on_card(cuda, shape, n_iter,
                                                 branch):
    """The constraint and gather passes, each constraint evaluated once,
    against the plain version over 48 substeps, on a cube and on a box
    whose three strides differ."""
    host, cfg = _lattice_box_scene(shape, n_iter, branch)
    top, s0 = tsb.init(host, device=cuda)
    want = make_plain_step(top, cfg)(s0, cfg.dt, 48)
    atol_x, atol_v = (5e-5, 5e-2) if branch == "colliders" else (1e-5, 2e-3)
    for w in (*_WRAPPERS.values(), *_LATTICE.values()):
        w.reset_launch_count()
    got = lattice_xpbd.make_cuda_step(top, cfg)(s0, cfg.dt, 48)
    torch.cuda.synchronize()
    per_sub = lattice_xpbd.launches_per_substep(top, cfg)
    assert per_sub == (2 if n_iter == 0 else 1 + 2 * n_iter)
    assert lattice_xpbd.launch_count() == 48 * per_sub
    assert sum(w.launch_count() for w in (*_WRAPPERS.values(),
                                          *_LATTICE.values())) \
        == 48 * per_sub
    torch.testing.assert_close(got.x, want.x, atol=atol_x, rtol=0)
    torch.testing.assert_close(got.v, want.v, atol=atol_v, rtol=0)
    pinned = torch.from_numpy(host.inv_mass == 0.0).to(cuda)
    assert torch.equal(got.x[pinned], s0.x[pinned])
    assert float((want.x - s0.x).abs().max()) > 1e-3


@pytest.mark.cuda
def test_div6_is_the_ieee_quotient_on_card(cuda):
    """csrc/lattice_common.cuh::div6, the tets' divides by 6 in every
    lattice kernel (a product with the reciprocal and an FMA correction),
    equals x / 6.0f to the bit on all 2^32 floats, a NaN matching a NaN:
    so the kernels keep the IEEE divide's results."""
    import ctypes

    from softbodyunity_torch.kernels.build import load_library

    check = load_library("lattice_euler").lattice_euler_div6_mismatches
    check.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    check.restype = ctypes.c_int
    mismatches = torch.zeros(1, dtype=torch.int64, device=cuda)
    assert check(mismatches.data_ptr(),
                 torch.cuda.current_stream(cuda).cuda_stream) == 0
    torch.cuda.synchronize()
    assert int(mismatches.item()) == 0


# --- what compute-sanitizer would check, where it cannot run -----------------
#
# compute-sanitizer can refuse a card ("Error: Device not supported", in a
# virtualised machine even for a one-line program), so these stand in for
# its initcheck (a read of memory no launch wrote) and racecheck
# (shared-memory hazards): each run is repeated on device memory that the
# caching allocator hands back full of NaN, and each XPBD kernel many times
# over from one state, all held bit-equal.

def _poison_allocator(device):
    """Fill the caching allocator's free blocks with NaN: blocks of the
    small pool (up to 1 MB) and of the large pool, then release them to
    the cache, so the tensors allocated next start as NaN."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    held = [torch.full((n,), float("nan"), device=device)
            for n in [256 * 1024] * 64 + [16 * 1024 * 1024] * 16]
    del held
    torch.cuda.synchronize(device)


def _poison_runs():
    """(name, build) pairs: each build() returns a function of no argument
    that makes a step function and runs it from rest."""
    def lattice(solver, module, n=7, shape=None, branch="colliders"):
        def build():
            if shape is None:
                host, cfg = _lattice_scene(solver, n=n)
            else:
                host, cfg = _lattice_box_scene(shape, 8, branch, solver)
            top, s0 = tsb.init(host, device="cuda")
            return lambda: module.make_cuda_step(top, cfg)(s0, cfg.dt, 48)
        return build

    def grid(branch, full=True):
        def build():
            host, cfg = _xpbd_grid_scene(37, 53, full, 8, branch)
            top, s0 = tsb.init(host, device="cuda")
            return lambda: grid_xpbd.make_cuda_step(top, cfg)(s0, cfg.dt, 32)
        return build

    def euler(branch, full=True, size=(37, 53),
              solver=Solver.SEMI_IMPLICIT_EULER):
        def build():
            host, cfg = _euler_grid_scene(*size, full, full, branch, solver)
            top, s0 = tsb.init(host, device="cuda")
            if branch == "features":
                s0 = tsb.api.ensure_plastic_state(
                    top, cfg, tsb.api.ensure_tear_state(top, cfg, s0))
            return lambda: _WRAPPERS[solver].make_cuda_step(top, cfg)(
                s0, cfg.dt, 32)
        return build

    def strain(solver):
        def build():
            host, cfg = _strain_scene(solver, "both")
            top, s0 = tsb.init(host, device="cuda")
            s0 = tsb.api.ensure_plastic_state(
                top, cfg, tsb.api.ensure_tear_state(top, cfg, s0))
            return lambda: _WRAPPERS[solver].make_cuda_step(top, cfg)(
                s0, cfg.dt, 32)
        return build

    return [
        ("lattice_euler 7^3", lattice(Solver.SEMI_IMPLICIT_EULER,
                                      lattice_euler)),
        ("lattice_euler 5x6x9", lattice(Solver.SEMI_IMPLICIT_EULER,
                                        lattice_euler, shape=(5, 6, 9),
                                        branch="plain")),
        ("lattice_verlet 7^3", lattice(Solver.VERLET, lattice_verlet)),
        ("lattice_xpbd 7^3", lattice(Solver.XPBD, lattice_xpbd)),
        ("lattice_xpbd 5x6x9 colliders", lattice(Solver.XPBD, lattice_xpbd,
                                                 shape=(5, 6, 9))),
        ("grid_xpbd features", grid("features")),
        ("grid_xpbd force", grid("force")),
        ("grid_xpbd colliders structural", grid("colliders", full=False)),
        ("grid_euler features", euler("features")),
        ("grid_euler force", euler("force")),
        ("grid_euler wind", euler("wind")),
        ("grid_euler colliders structural", euler("colliders", full=False)),
        ("grid_euler wide", euler("plain", size=(1024, 520))),
        ("grid_euler strain", strain(Solver.SEMI_IMPLICIT_EULER)),
        ("grid_verlet strain", strain(Solver.VERLET)),
        ("grid_verlet features", euler("features", solver=Solver.VERLET)),
        ("grid_verlet force", euler("force", solver=Solver.VERLET)),
        ("grid_verlet wind", euler("wind", solver=Solver.VERLET)),
        ("grid_verlet colliders structural",
         euler("colliders", full=False, solver=Solver.VERLET)),
        ("grid_xpbd strain", strain(Solver.XPBD)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("name", [n for n, _ in _poison_runs()])
def test_kernels_read_no_unwritten_memory_on_card(cuda, name):
    """A run on NaN-filled fresh allocations (every buffer and scratch
    plane the wrappers allocate) equals, bit for bit, a run on whatever the
    allocator held before, and again a second plain run: no launch reads
    an entry no launch wrote (the 7^3 lattice_euler compare once failed
    by 0.35 on the card, PERF.md)."""
    run = dict(_poison_runs())[name]()
    first = run()
    _poison_allocator(cuda)
    poisoned = run()
    again = run()
    torch.cuda.synchronize()
    for got in (poisoned, again):
        assert torch.equal(got.x, first.x)
        assert torch.equal(got.v, first.v)
    assert bool(torch.isfinite(first.x).all())


@pytest.mark.cuda
@pytest.mark.parametrize("branch", list(_XPBD_GRID_TOL))
@pytest.mark.parametrize("nx,ny", [(37, 53), (19, 130)])
def test_xpbd_grid_sweep_repeats_bit_equal_on_card(cuda, nx, ny, branch):
    """Each edge is evaluated from the same staged values and each vertex
    sums its terms in a fixed order, so 24 runs of 32 substeps from one
    state, on grids no tile divides, give one result to the bit; a
    shared-memory race (a read before the tile's barrier, a term written
    twice) would show as runs that differ."""
    host, cfg = _xpbd_grid_scene(nx, ny, True, 8, branch)
    top, s0 = tsb.init(host, device=cuda)
    if branch == "features":
        s0 = tsb.api.ensure_plastic_state(
            top, cfg, tsb.api.ensure_tear_state(top, cfg, s0))
    fn = grid_xpbd.make_cuda_step(top, cfg)
    want = fn(s0, cfg.dt, 32)
    for k in range(23):
        got = fn(s0, cfg.dt, 32)
        assert torch.equal(got.x, want.x), k
        assert torch.equal(got.v, want.v), k
    assert float((want.x - s0.x).abs().max()) > 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("branch", ["plain", "drag", "colliders"])
@pytest.mark.parametrize("shape", [(7, 7, 7), (5, 6, 9)],
                         ids=["7^3", "5x6x9"])
@pytest.mark.parametrize("solver", list(_LATTICE),
                         ids=[s.value for s in _LATTICE])
def test_xpbd_lattice_passes_repeat_bit_equal_on_card(cuda, solver, shape,
                                                      branch):
    """Under each lattice solver: the XPBD constraint pass and the Euler and
    Verlet tet pass write each lambda and scratch entry from one thread and
    the gathers sum in a fixed order, so 24 runs of 48 substeps from one
    state give one result to the bit."""
    host, cfg = _lattice_box_scene(shape, 8, branch, solver)
    top, s0 = tsb.init(host, device=cuda)
    fn = _LATTICE[solver].make_cuda_step(top, cfg)
    want = fn(s0, cfg.dt, 48)
    for k in range(23):
        got = fn(s0, cfg.dt, 48)
        assert torch.equal(got.x, want.x), k
        assert torch.equal(got.v, want.v), k
    assert float((want.x - s0.x).abs().max()) > 1e-3
