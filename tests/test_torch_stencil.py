"""The plain PyTorch grid-cloth Euler path — the CUDA kernel's plain version —
held to the JAX package on the CPU: to its XLA stencil twin and its fused
Pallas kernel (interpret mode) in float32, and to the NumPy oracle in
float64.  Inputs are made with numpy from a fixed seed and handed to both
packages (the port's through ``softbodyunity_torch.convert``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softbodyunity_tpu import api as japi
from softbodyunity_tpu.core.config import (CollisionParams, SimConfig,
                                           SpringParams)
from softbodyunity_tpu.core.state import State as JState
from softbodyunity_tpu.core.topology import cloth_grid as j_cloth_grid
from softbodyunity_tpu.kernels import stencil as jstencil
from softbodyunity_tpu.kernels.pallas_substep import make_pallas_step
from softbodyunity_tpu.models import presets as jpresets
from softbodyunity_tpu.oracle import reference as oracle

import softbodyunity_torch as tsb
from softbodyunity_torch import convert
from softbodyunity_torch.kernels import stencil

torch.set_num_threads(1)


def _scene(shear=True, bend=True, sphere=False):
    """The 16x8 scene of tests/test_pallas.py (JAX host and config)."""
    cfg = SimConfig(
        springs=SpringParams(k_structural=500.0, k_shear=250.0,
                             k_bend=100.0, damping=0.6),
        collision=CollisionParams(enable_plane=True, enable_spheres=sphere,
                                  friction=0.2),
        global_damping=0.3,
    )
    host = j_cloth_grid(
        16, 8, spacing=0.05, shear=shear, bend=bend, pinned=("tl", "tr"),
        springs=cfg.springs, xpbd=cfg.xpbd, plane_height=-0.25,
        orientation="xy",
    )
    if sphere:
        host.sphere_centers = np.array([[0.35, -0.4, 0.0]])
        host.sphere_radii = np.array([0.15])
    return host, cfg


def _port(host, cfg):
    """The same scene carried into the port."""
    return (convert.host_from_arrays(
                {f.name: getattr(host, f.name)
                 for f in dataclasses.fields(host)}),
            convert.config_from_dict(dataclasses.asdict(cfg)))


def _initial(host, seed):
    """Rest positions and a seeded random velocity field, zero on pins."""
    rng = np.random.default_rng(seed)
    v = 0.2 * rng.standard_normal(host.positions0.shape)
    v[host.inv_mass == 0.0] = 0.0
    return host.positions0, v


def _run_both(host, cfg, n_substeps, seed):
    """(port plain f32 state, JAX stencil state, JAX Pallas state) after
    ``n_substeps`` from the seeded initial state."""
    x0, v0 = _initial(host, seed)
    jtop, _ = japi.init(host)
    js = JState(x=jnp.asarray(x0, jnp.float32), v=jnp.asarray(v0, jnp.float32),
                x_prev=jnp.asarray(x0, jnp.float32))
    j_st = jax.jit(lambda t, s: jstencil.make_stencil_step(t, cfg)(
        s, cfg.dt, n_substeps))(jtop, js)
    j_pal = make_pallas_step(jtop, cfg, interpret=True)(js, cfg.dt, n_substeps)
    thost, tcfg = _port(host, cfg)
    ttop, _ = tsb.init(thost, device="cpu")
    got = stencil.make_stencil_step(ttop, tcfg)(
        convert.state_from_arrays(x0, v0, x0, "cpu"), tcfg.dt, n_substeps)
    return got, j_st, j_pal


# tests/test_pallas.py's kernel-vs-twin tolerances: the Pallas kernel takes
# rsqrt where the twins take sqrt and a divide, and the floppier
# structural-only cloth amplifies that rounding faster through plane contact
@pytest.mark.parametrize(
    "shear,bend,atol_x,atol_v",
    [(False, False, 5e-4, 5e-2), (True, True, 5e-6, 5e-4)],
)
def test_plain_path_matches_jax_stencil_and_pallas(shear, bend, atol_x,
                                                   atol_v):
    host, cfg = _scene(shear=shear, bend=bend)
    got, j_st, j_pal = _run_both(host, cfg, 64, seed=0)
    for want in (j_st, j_pal):
        np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                                   atol=atol_x)
        np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v),
                                   atol=atol_v)
    np.testing.assert_allclose(got.x_prev.numpy(), np.asarray(j_st.x_prev),
                               atol=atol_x)


def test_plain_path_sphere_matches_jax_stencil_and_pallas():
    """tests/test_pallas.py's sphere scene and 2e-5 bound on x."""
    host, cfg = _scene(sphere=True)
    got, j_st, j_pal = _run_both(host, cfg, 96, seed=1)
    for want in (j_st, j_pal):
        np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                                   atol=2e-5)
    # the cloth really is in contact with the sphere
    d = np.linalg.norm(got.x.numpy() - np.array([0.35, -0.4, 0.0]), axis=1)
    assert d.min() < 0.151


@pytest.mark.parametrize("shear,bend", [(False, False), (True, False),
                                        (True, True)])
def test_spring_forces_match_jax(shear, bend):
    """One force evaluation on seeded random positions and velocities.  The
    port sums the same terms in the same order, so f32 results agree to a
    few ulps of the ~10 N forces."""
    host, cfg = _scene(shear=shear, bend=bend)
    ny, nx = host.grid_shape
    rng = np.random.default_rng(2)
    x = host.positions0 + 0.01 * rng.standard_normal(host.positions0.shape)
    v = rng.standard_normal(host.positions0.shape)
    x3 = x.T.reshape(3, ny, nx).astype(np.float32)
    v3 = v.T.reshape(3, ny, nx).astype(np.float32)
    offs = stencil._offsets(cfg, host.grid_spacing, shear, bend)
    assert offs == jstencil._offsets(cfg, host.grid_spacing, shear, bend)
    masks = [stencil._valid_mask(ny, nx, di, dj, "cpu", torch.float32)
             for di, dj, _, _ in offs]
    for (di, dj, _, _), m in zip(offs, masks):
        np.testing.assert_array_equal(m.numpy(),
                                      jstencil._valid_mask(ny, nx, di, dj))
    got = stencil.stencil_spring_forces(torch.from_numpy(x3),
                                        torch.from_numpy(v3), offs, masks,
                                        cfg.springs.damping).numpy()
    want = np.asarray(jstencil.stencil_spring_forces(
        jnp.asarray(x3), jnp.asarray(v3), offs, cfg.springs.damping))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _oracle_drift(jhost, jcfg, n_frames):
    """Worst |x| gap over ``n_frames`` between the port's plain path in f64
    and the NumPy oracle, from the same host scene."""
    thost, tcfg = _port(jhost, jcfg)
    top, s = tsb.init(thost, device="cpu", dtype=torch.float64)
    x = jhost.positions0.copy()
    v = np.zeros_like(x)
    xp = x.copy()
    worst = 0.0
    for _ in range(n_frames):
        x, v, xp = oracle.step(jhost, jcfg, x, v, xp)
        s = tsb.step(top, tcfg, s)
        worst = max(worst, float(np.max(np.abs(s.x.numpy() - x))))
    return worst, s


@pytest.mark.parametrize("name", ["cloth_32_euler", "cloth_hanging_sphere"])
def test_f64_exact_parity_with_oracle(name):
    """tests/test_oracle_parity.py's f64 tier: f64 summation-order noise
    only, amplified by contact on the sphere scene; a semantic difference
    shows at 1e-3 and up."""
    worst, _ = _oracle_drift(*jpresets.build(name), n_frames=50)
    assert worst < 1e-6, f"{name}: f64 drift {worst:.3e}"


def test_f64_parity_with_moving_colliders():
    """Kinematic collider velocities are honoured: a conveyor plane and a
    moving sphere under a falling sheet, f64 against the oracle, and the
    velocities change the result."""
    cfg = SimConfig(
        springs=SpringParams(k_structural=400.0, k_shear=200.0,
                             k_bend=50.0, damping=0.5),
        collision=CollisionParams(enable_plane=True, enable_spheres=True,
                                  friction=0.4, restitution=0.3),
        global_damping=0.2,
    )
    host = j_cloth_grid(
        12, 10, spacing=0.05, springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=-0.1, sphere_centers=np.array([[0.3, -0.12, 0.22]]),
        sphere_radii=np.array([0.1]), orientation="xz",
    )
    still, s_still = _oracle_drift(host, cfg, n_frames=30)
    host.plane_velocity = np.array([0.5, 0.0, -0.2])
    host.sphere_velocities = np.array([[0.3, 0.2, -0.1]])
    moving, s_moving = _oracle_drift(host, cfg, n_frames=30)
    assert still < 1e-6 and moving < 1e-6, (still, moving)
    assert float((s_moving.x - s_still.x).abs().max()) > 1e-3
