"""The plain PyTorch grid-cloth Verlet and XPBD paths — the plain versions of
the grid_verlet and grid_xpbd CUDA kernels — held to the JAX package on the
CPU: to its XLA stencil twin and its fused Pallas kernels (interpret mode)
in float32, to the NumPy oracle in float64, and to the cloth_xpbd golden.
Inputs are made with numpy from a fixed seed and handed to both packages
(the port's through ``softbodyunity_torch.convert``)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softbodyunity_tpu import api as japi
from softbodyunity_tpu.core.config import (CollisionParams, SimConfig, Solver,
                                           SpringParams, XPBDParams)
from softbodyunity_tpu.core.state import State as JState
from softbodyunity_tpu.core.topology import cloth_grid as j_cloth_grid
from softbodyunity_tpu.kernels import stencil as jstencil
from softbodyunity_tpu.kernels.pallas_substep import make_pallas_verlet_step
from softbodyunity_tpu.kernels.pallas_xpbd import make_pallas_xpbd_step
from softbodyunity_tpu.models import presets as jpresets
from softbodyunity_tpu.oracle import reference as oracle
from softbodyunity_tpu.solver import collide as jcollide

import softbodyunity_torch as tsb
from softbodyunity_torch import convert
from softbodyunity_torch.kernels import stencil
from softbodyunity_torch.solver import collide

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
XPBD = XPBDParams(compliance_distance=1e-6, compliance_bend=5e-4,
                  n_iterations=6, relaxation=1.0)


def _scene(solver, sphere_center=None, verlet_sphere=False):
    """The 16x8 scenes of tests/test_pallas.py (JAX host and config)."""
    cfg = SimConfig(
        solver=solver,
        springs=SpringParams(k_structural=500.0, k_shear=250.0, k_bend=100.0,
                             damping=0.1 if verlet_sphere else 0.6),
        xpbd=XPBD,
        collision=CollisionParams(enable_plane=True,
                                  enable_spheres=sphere_center is not None,
                                  friction=0.2),
        global_damping=0.3,
    )
    host = j_cloth_grid(
        16, 8, spacing=0.05, shear=True, bend=True, pinned=("tl", "tr"),
        springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=-2.5 if verlet_sphere else -0.25, orientation="xy",
    )
    if sphere_center is not None:
        host.sphere_centers = np.array([sphere_center])
        host.sphere_radii = np.array([0.15])
    return host, cfg


def _port(host, cfg):
    return (convert.host_from_arrays(
                {f.name: getattr(host, f.name)
                 for f in dataclasses.fields(host)}),
            convert.config_from_dict(dataclasses.asdict(cfg)))


def _run_all(host, cfg, n_substeps, seed):
    """(port plain f32, JAX stencil, JAX Pallas interpret) states after
    ``n_substeps`` from the rest shape with a seeded velocity field, zero on
    the pins (for Verlet, carried as ``x_prev = x - dt * v``)."""
    rng = np.random.default_rng(seed)
    x0 = host.positions0
    v0 = 0.2 * rng.standard_normal(x0.shape)
    v0[host.inv_mass == 0.0] = 0.0
    xp0 = x0 - cfg.dt * v0
    jtop, _ = japi.init(host)
    js = JState(x=jnp.asarray(x0, jnp.float32), v=jnp.asarray(v0, jnp.float32),
                x_prev=jnp.asarray(xp0, jnp.float32))
    j_st = jax.jit(lambda t, s: jstencil.make_stencil_step(t, cfg)(
        s, cfg.dt, n_substeps))(jtop, js)
    make_pallas = (make_pallas_xpbd_step if cfg.solver == Solver.XPBD
                   else make_pallas_verlet_step)
    j_pal = make_pallas(jtop, cfg, interpret=True)(js, cfg.dt, n_substeps)
    thost, tcfg = _port(host, cfg)
    ttop, _ = tsb.init(thost, device="cpu")
    got = stencil.make_stencil_step(ttop, tcfg)(
        convert.state_from_arrays(x0, v0, xp0, "cpu"), tcfg.dt, n_substeps)
    return got, j_st, j_pal


def _assert_pins_frozen(host, got):
    pinned = host.inv_mass == 0.0
    np.testing.assert_array_equal(
        got.x.numpy()[pinned], host.positions0[pinned].astype(np.float32))


# tests/test_pallas.py's kernel-vs-twin tolerances.  XPBD: 1e-5 x / 1e-3 v
# (v = delta/dt amplifies x rounding 960x).  Verlet draped on the plane with
# friction 0.2: 1e-3 x / 5e-2 v, because the plane-friction contact mask is
# discrete and 1-ulp pre-clamp noise flips it on a few vertices.
@pytest.mark.parametrize("solver,atol_x,atol_v", [
    (Solver.XPBD, 1e-5, 1e-3),
    (Solver.VERLET, 1e-3, 5e-2),
])
def test_plain_matches_jax_stencil_and_pallas(solver, atol_x, atol_v):
    host, cfg = _scene(solver)
    got, j_st, j_pal = _run_all(host, cfg, 64, seed=3)
    for want in (j_st, j_pal):
        np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                                   atol=atol_x)
        np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v),
                                   atol=atol_v)
        np.testing.assert_allclose(got.x_prev.numpy(),
                                   np.asarray(want.x_prev), atol=atol_x)
    _assert_pins_frozen(host, got)


# tests/test_pallas.py's sphere scenes and their 2e-5 bound on x: XPBD 96
# substeps with the sphere at (0.375, -0.3, 0); Verlet 240 substeps with the
# plane out of reach, axial damping 0.1 and the sphere at (0.375, -0.45, 0)
@pytest.mark.parametrize("solver,center,n_sub,verlet_sphere", [
    (Solver.XPBD, (0.375, -0.3, 0.0), 96, False),
    (Solver.VERLET, (0.375, -0.45, 0.0), 240, True),
])
def test_plain_sphere_matches_jax_stencil_and_pallas(solver, center, n_sub,
                                                     verlet_sphere):
    host, cfg = _scene(solver, sphere_center=center,
                       verlet_sphere=verlet_sphere)
    got, j_st, j_pal = _run_all(host, cfg, n_sub, seed=4)
    for want in (j_st, j_pal):
        np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                                   atol=2e-5)
    _assert_pins_frozen(host, got)
    d = np.linalg.norm(got.x.numpy() - np.array(center), axis=1)
    assert d.min() < 0.151        # real contact with the sphere
    assert d.min() > 0.15 - 1e-5  # and nothing left inside it


def test_xpbd_offsets_and_count_match_jax():
    cfg = SimConfig(xpbd=XPBD)
    ny, nx = 7, 9
    for shear, bend in ((False, False), (True, False), (True, True)):
        offs = stencil._xpbd_offsets(cfg, 0.05, shear, bend)
        assert offs == jstencil._xpbd_offsets(cfg, 0.05, shear, bend)
        assert ([o[:2] for o in offs]
                == [o[:2] for o in stencil._offsets(cfg, 0.05, shear, bend)])
    masks = [stencil._valid_mask(ny, nx, di, dj, "cpu", torch.float64)
             for di, dj, _, _ in offs]
    cnt = stencil.jacobi_count(offs, masks).numpy()
    # every vertex of the full grid counts the edges incident to it
    host = tsb.cloth_grid(nx, ny, shear=True, bend=True)
    deg = np.bincount(host.edges.ravel(), minlength=ny * nx)
    np.testing.assert_array_equal(cnt.ravel(), deg)


def test_sphere_contact_shell_matches_jax():
    assert collide.SPHERE_CONTACT_SHELL == jcollide.SPHERE_CONTACT_SHELL


def _oracle_drift(host, cfg, n_frames, n_substeps=None):
    """Worst |x| gap over ``n_frames`` between the port's plain path in f64
    and the NumPy oracle, from the rest state."""
    thost, tcfg = _port(host, cfg)
    top, s = tsb.init(thost, device="cpu", dtype=torch.float64)
    x = host.positions0.copy()
    v = np.zeros_like(x)
    xp = x.copy()
    worst = 0.0
    for _ in range(n_frames):
        x, v, xp = oracle.step(host, cfg, x, v, xp, n_substeps=n_substeps)
        s = tsb.step(top, tcfg, s, n_substeps=n_substeps)
        worst = max(worst, float(np.max(np.abs(s.x.numpy() - x))))
    return worst


def test_f64_exact_parity_with_oracle_xpbd():
    """cloth_xpbd over 50 frames (tests/test_oracle_parity.py's f64 tier)."""
    worst = _oracle_drift(*jpresets.build("cloth_xpbd"), n_frames=50)
    assert worst < 1e-6, f"cloth_xpbd: f64 drift {worst:.3e}"


def test_f64_exact_parity_with_oracle_verlet():
    """The 9x7 Verlet scene of tests/test_stencil.py, 120 substeps."""
    cfg = SimConfig(
        solver=Solver.VERLET,
        springs=SpringParams(k_structural=500.0, k_shear=250.0, k_bend=100.0,
                             damping=0.6),
        xpbd=XPBD,
        collision=CollisionParams(enable_plane=True),
        global_damping=0.3,
    )
    host = j_cloth_grid(
        9, 7, spacing=0.05, shear=True, bend=True, pinned=("tl", "tr"),
        springs=cfg.springs, xpbd=cfg.xpbd, plane_height=-0.25,
        orientation="xy",
    )
    worst = _oracle_drift(host, cfg, n_frames=1, n_substeps=120)
    assert worst < 1e-6, f"verlet 9x7: f64 drift {worst:.3e}"


def test_golden_replay_cloth_xpbd():
    """tests/test_golden.py's 2e-3 through the public step on the CPU."""
    data = np.load(os.path.join(GOLDEN_DIR, "cloth_xpbd.npz"))
    golden = data["positions"]
    every = int(data["record_every"])
    host, cfg = tsb.presets.build("cloth_xpbd")
    top, state = tsb.init(host, device="cpu")
    for r in range(golden.shape[0]):
        for _ in range(every):
            state = tsb.step(top, cfg, state)
        drift = float(np.max(np.abs(state.x.numpy() - golden[r])))
        assert drift < 2e-3, f"drift {drift:.3e} at frame {(r + 1) * every}"


def jax_stencil_f32_drift(name, frames, every):
    """The JAX package's own f32-vs-f64 drift on preset ``name``: its XLA
    stencil path in float32 against the same path in float64, the worst
    |x| gap printed every ``every`` frames.  Not a test (minutes at 64k);
    ``chip_smoke.py`` takes its Verlet fidelity bound from this number:

        python tests/test_torch_xpbd_verlet.py cloth_bench_64k_verlet 1000 50
    """
    jax.config.update("jax_enable_x64", True)
    host, cfg = jpresets.build(name)
    run = jax.jit(lambda t, s: jstencil.make_stencil_step(t, cfg)(
        s, cfg.dt, cfg.n_substeps))
    t32, s32 = japi.init(host, dtype=jnp.float32)
    t64, s64 = japi.init(host, dtype=jnp.float64)
    worst = 0.0
    for i in range(frames):
        s32, s64 = run(t32, s32), run(t64, s64)
        if (i + 1) % every == 0:
            d = float(np.max(np.abs(np.asarray(s32.x, np.float64)
                                    - np.asarray(s64.x))))
            worst = max(worst, d)
            print(f"{name} frame {i + 1}: drift {d:.6e}", flush=True)
    print(f"{name} worst drift over {frames} frames: {worst:.6e}")


if __name__ == "__main__":
    import sys

    jax.config.update("jax_platforms", "cpu")
    jax_stencil_f32_drift(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
