"""The plain PyTorch tet-lattice path (softbodyunity_torch/solver/step.py,
solver/banded.py, solver/collide.py), the plain version of the lattice_euler,
lattice_verlet and lattice_xpbd CUDA kernels, held to the JAX package on the
CPU: its copies of the builders bit-equal, in float32 to the fused Pallas
lattice kernels (interpret mode) and to ``step_scan`` on the banded path, in
float64 to the NumPy oracle, and to the ``softbody_cube`` golden.  Inputs
are made with numpy from a fixed seed and handed to both packages (the
port's through ``softbodyunity_torch.convert``)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softbodyunity_tpu import api as japi
from softbodyunity_tpu.core.config import (CollisionParams, SimConfig, Solver,
                                           SpringParams, WindParams,
                                           XPBDParams)
from softbodyunity_tpu.core.state import State as JState
from softbodyunity_tpu.core.topology import tet_cube as j_tet_cube
from softbodyunity_tpu.kernels.pallas_lattice import (
    make_lattice_step, make_lattice_verlet_step, make_lattice_xpbd_step)
from softbodyunity_tpu.models import presets as jpresets
from softbodyunity_tpu.oracle import reference as oracle
from softbodyunity_tpu.solver import banded as jbanded
from softbodyunity_tpu.solver import collide as jcollide
from softbodyunity_tpu.solver.step import step_scan

import softbodyunity_torch as tsb
from softbodyunity_torch import convert
from softbodyunity_torch.core import topology as ttopo
from softbodyunity_torch.kernels import dispatch, lattice
from softbodyunity_torch.solver import banded, collide, step

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
XPBD = XPBDParams(compliance_distance=1e-6, compliance_volume=1e-7,
                  n_iterations=4, relaxation=1.0)
_PALLAS = {Solver.SEMI_IMPLICIT_EULER: make_lattice_step,
           Solver.VERLET: make_lattice_verlet_step,
           Solver.XPBD: make_lattice_xpbd_step}


def _scene(n=6, volume_stiffness=0.5, plane_height=0.0, origin_y=0.01,
           solver=Solver.SEMI_IMPLICIT_EULER, sphere=False):
    """tests/test_pallas_lattice.py's scenes (JAX host and config)."""
    cfg = SimConfig(
        solver=solver,
        springs=SpringParams(k_structural=1200.0, damping=1.5),
        xpbd=XPBD,
        collision=CollisionParams(enable_plane=True, enable_spheres=sphere,
                                  friction=0.4),
        global_damping=0.5,
        volume_stiffness=volume_stiffness,
    )
    host = j_tet_cube(
        n, spacing=0.08, springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=plane_height, origin=(0.0, origin_y, 0.0),
    )
    if sphere:
        host.sphere_centers = np.array([[0.2, -0.02, 0.2]])
        host.sphere_radii = np.array([0.3])
    return host, cfg


def _port(host, cfg):
    return (convert.host_from_arrays(
                {f.name: getattr(host, f.name)
                 for f in dataclasses.fields(host)}),
            convert.config_from_dict(dataclasses.asdict(cfg)))


def _run_all(host, cfg, n_substeps, seed):
    """(port plain f32, JAX Pallas interpret, JAX step_scan) states after
    ``n_substeps`` from the rest shape with a seeded velocity field, zero
    on the pins (for Verlet, carried as ``x_prev = x - dt * v``)."""
    rng = np.random.default_rng(seed)
    x0 = host.positions0
    v0 = 0.1 * rng.standard_normal(x0.shape)
    v0[host.inv_mass == 0.0] = 0.0
    xp0 = x0 - cfg.dt * v0
    jtop, _ = japi.init(host)
    js = JState(x=jnp.asarray(x0, jnp.float32), v=jnp.asarray(v0, jnp.float32),
                x_prev=jnp.asarray(xp0, jnp.float32))
    j_pal = _PALLAS[cfg.solver](jtop, cfg, interpret=True)(js, cfg.dt,
                                                           n_substeps)
    j_ref = jax.jit(lambda t, s: step_scan(t, cfg, s, cfg.dt, n_substeps))(
        jtop, js)
    thost, tcfg = _port(host, cfg)
    ttop, _ = tsb.init(thost, device="cpu")
    got = step.make_plain_step(ttop, tcfg)(
        convert.state_from_arrays(x0, v0, xp0, "cpu"), tcfg.dt, n_substeps)
    return got, j_pal, j_ref


# --- (a) the copies ----------------------------------------------------------

@pytest.mark.parametrize("n", [6, 7])
def test_tet_cube_and_band_builders_match_jax(n):
    kw = dict(spacing=0.08, plane_height=-0.5, origin=(0.1, 0.4, -0.2),
              mass=0.3)
    host, jhost = ttopo.tet_cube(n, **kw), j_tet_cube(n, **kw)
    for f in dataclasses.fields(jhost):
        a, b = getattr(host, f.name), getattr(jhost, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    args = (host.positions0.shape[0], host.edges, host.rest_length,
            host.edge_stiffness, host.edge_compliance)
    for got, want in (
            (banded.build_offset_groups(*args), jbanded.build_offset_groups(*args)),
            (banded.build_tet_groups(args[0], host.tets, host.rest_volume),
             jbanded.build_tet_groups(args[0], host.tets, host.rest_volume))):
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if isinstance(b, tuple):
                assert a == b, f.name
            else:
                b = np.asarray(b)
                assert a.dtype == b.dtype and a.shape == b.shape, f.name
                np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_band_builders_keep_residuals_like_jax():
    """A mesh with a few irregular springs and tets: the same residual
    arrays and groups in both packages (min_count keeps rare deltas out)."""
    host = ttopo.tet_cube(5, spacing=0.1)
    rng = np.random.default_rng(7)
    n = host.positions0.shape[0]
    # deltas 50..55, one edge each: no band of the lattice
    extra = np.stack([np.arange(6), 2 * np.arange(6) + 50], axis=1)
    edges = np.concatenate([host.edges, extra.astype(np.int32)])
    rest = np.concatenate([host.rest_length, rng.uniform(0.1, 0.3, 6)])
    k = np.concatenate([host.edge_stiffness, np.full(6, 7.0)])
    c = np.concatenate([host.edge_compliance, np.zeros(6)])
    tets = np.concatenate([host.tets, np.array([[0, 7, 33, 101]], np.int32)])
    rv = np.concatenate([host.rest_volume, [1e-3]])
    got = banded.build_offset_groups(n, edges, rest, k, c)
    want = jbanded.build_offset_groups(n, edges, rest, k, c)
    assert got.n_residual == want.n_residual == 6
    np.testing.assert_array_equal(got.residual_edges,
                                  np.asarray(want.residual_edges))
    assert got.deltas == want.deltas and got.uniform == want.uniform
    tg = banded.build_tet_groups(n, tets, rv)
    assert tg.n_residual == jbanded.build_tet_groups(n, tets, rv).n_residual == 1


def test_sphere_contact_shell_matches_jax():
    assert collide.SPHERE_CONTACT_SHELL == jcollide.SPHERE_CONTACT_SHELL


# --- (b) float32 against the Pallas kernels and the banded step_scan ---------

# tests/test_pallas_lattice.py's tolerances: x 2e-5, v 2e-3 (v carries x's
# rounding over dt)
@pytest.mark.parametrize("n", [6, 7])
def test_euler_matches_pallas_and_banded(n):
    host, cfg = _scene(n=n)
    got, j_pal, j_ref = _run_all(host, cfg, 48, seed=n)
    for want in (j_pal, j_ref):
        np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=2e-5)
        np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=2e-3)
    assert got.x.numpy()[:, 1].min() <= 1e-6     # the cube reached the plane


def test_euler_without_volume_matches_pallas_and_banded():
    host, cfg = _scene(volume_stiffness=0.0)
    got, j_pal, j_ref = _run_all(host, cfg, 48, seed=1)
    for want in (j_pal, j_ref):
        np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=2e-5)


@pytest.mark.parametrize("solver", list(_PALLAS))
def test_pinned_corner_is_bit_frozen(solver):
    host, cfg = _scene(solver=solver)
    host.inv_mass[:8] = 0.0
    got, j_pal, j_ref = _run_all(host, cfg, 64, seed=2)
    np.testing.assert_array_equal(got.x.numpy()[:8],
                                  host.positions0[:8].astype(np.float32))
    for want in (j_pal, j_ref):
        np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=2e-5)


# sphere scenes: 5e-5 (Euler, Verlet with pins), 2e-5 (XPBD)
@pytest.mark.parametrize("solver,n_sub,atol,origin_y", [
    (Solver.SEMI_IMPLICIT_EULER, 96, 5e-5, 0.25),
    (Solver.VERLET, 96, 5e-5, 0.25),
    (Solver.XPBD, 64, 2e-5, 0.3),
])
def test_sphere_matches_pallas_and_banded(solver, n_sub, atol, origin_y):
    host, cfg = _scene(plane_height=-5.0, origin_y=origin_y, solver=solver,
                       sphere=True)
    if solver == Solver.VERLET:
        host.inv_mass[:4] = 0.0
    got, j_pal, j_ref = _run_all(host, cfg, n_sub, seed=3)
    for want in (j_pal, j_ref):
        np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=atol)
    d = np.linalg.norm(got.x.numpy() - np.array([0.2, -0.02, 0.2]), axis=1)
    assert d.min() < 0.31                        # rests on the sphere
    assert d.min() > 0.3 - 1e-5                  # and nothing inside it


@pytest.mark.parametrize("solver", [Solver.VERLET, Solver.XPBD])
def test_verlet_and_xpbd_match_pallas_and_banded(solver):
    host, cfg = _scene(solver=solver)
    got, j_pal, j_ref = _run_all(host, cfg, 48 if solver == Solver.VERLET
                                 else 64, seed=4)
    for want in (j_pal, j_ref):
        np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=2e-5)
        np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=2e-3)
    if solver == Solver.VERLET:
        np.testing.assert_allclose(got.x_prev.numpy(),
                                   np.asarray(j_ref.x_prev), atol=2e-5)
    assert got.x.numpy()[:, 1].min() <= 1e-6


# --- (c) float64 against the NumPy oracle -----------------------------------

@pytest.mark.parametrize("name", ["softbody_cube", "softbody_cube_xpbd_sub"])
def test_f64_exact_parity_with_oracle(name):
    """50 frames (tests/test_oracle_parity.py's f64 tier), through the
    public step on the CPU."""
    jhost, jcfg = jpresets.build(name)
    host, cfg = tsb.presets.build(name)
    top, s = tsb.init(host, device="cpu", dtype=torch.float64)
    x = jhost.positions0.copy()
    v = np.zeros_like(x)
    xp = x.copy()
    worst = 0.0
    for _ in range(50):
        x, v, xp = oracle.step(jhost, jcfg, x, v, xp)
        s = tsb.step(top, cfg, s)
        worst = max(worst, float(np.max(np.abs(s.x.numpy() - x))))
    assert worst < 1e-6, f"{name}: f64 drift {worst:.3e}"


# --- (d) the golden ------------------------------------------------------------

def test_golden_replay_softbody_cube():
    """tests/test_golden.py's 1e-4 through the public step on the CPU."""
    data = np.load(os.path.join(GOLDEN_DIR, "softbody_cube.npz"))
    golden = data["positions"]
    every = int(data["record_every"])
    host, cfg = tsb.presets.build("softbody_cube")
    top, state = tsb.init(host, device="cpu")
    for r in range(golden.shape[0]):
        for _ in range(every):
            state = tsb.step(top, cfg, state)
        drift = float(np.max(np.abs(state.x.numpy() - golden[r])))
        assert drift < 1e-4, f"drift {drift:.3e} at frame {(r + 1) * every}"


# --- (e) dispatch ----------------------------------------------------------------

@pytest.mark.parametrize("solver", list(_PALLAS))
def test_dispatch_routes_lattices_to_the_plain_step(solver):
    host, cfg = _scene(solver=solver)
    thost, tcfg = _port(host, cfg)
    top, _ = tsb.init(thost, device="cpu")
    fn = dispatch.maybe_fast_step(top, tcfg)
    assert fn.__qualname__ == "make_plain_step.<locals>.fn"
    gates = {Solver.SEMI_IMPLICIT_EULER: lattice.lattice_applicable,
             Solver.VERLET: lattice.lattice_verlet_applicable,
             Solver.XPBD: lattice.lattice_xpbd_applicable}
    assert [g(top, tcfg) for g in gates.values()] == [
        s == solver for s in gates]


@pytest.mark.parametrize("what", ["wind", "capsules", "residual_edge",
                                  "residual_tet"])
def test_lattice_outside_the_port_raises(what):
    host, cfg = _scene()
    if what == "wind":
        # the drag runs on lattices since its branch was ported; lift, which
        # needs surface normals, still refuses (the TPU kernels gate it off)
        cfg = cfg.replace(wind=WindParams(velocity=(1.0, 0.0, 0.0), drag=0.2,
                                          lift=0.5))
    elif what == "capsules":
        # capsule contact runs on lattices since its branch was ported; an
        # SDF collider beside it still refuses
        cfg = cfg.replace(collision=dataclasses.replace(
            cfg.collision, enable_capsules=True, enable_sdf=True))
    elif what == "residual_edge":
        host.edges = np.concatenate([host.edges, [[0, 100]]]).astype(np.int32)
        host.rest_length = np.append(host.rest_length, 0.4)
        host.edge_stiffness = np.append(host.edge_stiffness, 1200.0)
        host.edge_compliance = np.append(host.edge_compliance, 0.0)
    else:
        host.tets = np.concatenate([host.tets, [[0, 7, 43, 100]]]).astype(
            np.int32)
        host.rest_volume = np.append(host.rest_volume, 1e-4)
    thost, tcfg = _port(host, cfg)
    top, state = tsb.init(thost, device="cpu")
    match = "Queue 1 item 3" if what.startswith("residual") else "ROADMAP"
    with pytest.raises(NotImplementedError, match=match):
        tsb.step(top, tcfg, state)
    with pytest.raises(NotImplementedError, match=match):
        step.make_plain_step(top, tcfg)


def test_convert_carries_the_lattice_fields():
    jhost, _ = jpresets.build("softbody_cube")
    host, _ = _port(jhost, SimConfig())
    assert host.lattice_shape == (6, 6, 6)
    np.testing.assert_array_equal(host.tets, jhost.tets)
    np.testing.assert_array_equal(host.rest_volume, jhost.rest_volume)
    top, _ = tsb.init(host, device="cpu")
    assert top.n_tets == jhost.tets.shape[0]
    assert len(top.tet_groups.deltas) == 10 and top.tet_groups.n_residual == 0
    assert len(top.offset_groups.deltas) == 9


def jax_banded_f32_drift(name, frames, every):
    """The JAX package's own f32-vs-f64 drift on preset ``name``: its banded
    ``step_scan`` path in float32 against the same path in float64, the
    worst |x| gap printed every ``every`` frames.  Not a test (minutes at
    64k); ``chip_smoke.py`` takes the 64k cubes' fidelity bounds from it:

        PYTHONPATH=. python tests/test_torch_lattice.py softbody_cube_64k 200 10
    """
    jax.config.update("jax_enable_x64", True)
    host, cfg = jpresets.build(name)
    run = jax.jit(lambda t, s: step_scan(t, cfg, s, cfg.dt, cfg.n_substeps))
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
    jax_banded_f32_drift(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
