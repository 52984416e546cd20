"""Wind (drag and lift) and strain limiting in softbodyunity_torch, held to
the JAX package on the CPU: the port's plain grid steps against the JAX
stencil (wind) and the JAX fused and row-tiled Pallas kernels in interpret
mode (wind; the strain limit with and without tear and plastic planes), the
float64 steps against the NumPy oracle, the ``cloth_strain_limited`` golden,
the lattice steps' wind drag against the JAX lattice kernels (interpret),
wind with self-collision against the JAX general path, and the refusals of
what the JAX package runs only on its general path.  Inputs are made with
numpy from a fixed seed or the scene's rest shape and handed to both
packages.  The kernels themselves are tested on the card by
tests/test_torch_cuda.py."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softbodyunity_tpu import api as japi
from softbodyunity_tpu.core.config import (CollisionParams, PlasticityParams,
                                           SelfCollisionParams, SimConfig,
                                           Solver, SpringParams,
                                           StrainLimitParams, TearParams,
                                           WindParams, XPBDParams)
from softbodyunity_tpu.core.state import State as JState
from softbodyunity_tpu.core.topology import cloth_grid as j_cloth_grid
from softbodyunity_tpu.core.topology import tet_cube as j_tet_cube
from softbodyunity_tpu.kernels import stencil as jstencil
from softbodyunity_tpu.kernels.pallas_lattice import (
    make_lattice_step, make_lattice_verlet_step, make_lattice_xpbd_step)
from softbodyunity_tpu.kernels.pallas_substep import (make_pallas_step,
                                                      make_pallas_verlet_step)
from softbodyunity_tpu.kernels.pallas_tiled import (make_tiled_step,
                                                    make_tiled_verlet_step,
                                                    make_tiled_xpbd_step)
from softbodyunity_tpu.kernels.pallas_xpbd import make_pallas_xpbd_step
from softbodyunity_tpu.oracle import reference as oracle

import softbodyunity_torch as tsb
from softbodyunity_torch import convert
from softbodyunity_torch.kernels import dispatch, grid_features, stencil
from softbodyunity_torch.solver import step as tstep

torch.set_num_threads(1)

SOLVERS = [Solver.SEMI_IMPLICIT_EULER, Solver.VERLET, Solver.XPBD]
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
_FUSED = {Solver.SEMI_IMPLICIT_EULER: make_pallas_step,
          Solver.VERLET: make_pallas_verlet_step,
          Solver.XPBD: make_pallas_xpbd_step}
_TILED = {Solver.SEMI_IMPLICIT_EULER: make_tiled_step,
          Solver.VERLET: make_tiled_verlet_step,
          Solver.XPBD: make_tiled_xpbd_step}
_LATTICE = {Solver.SEMI_IMPLICIT_EULER: make_lattice_step,
            Solver.VERLET: make_lattice_verlet_step,
            Solver.XPBD: make_lattice_xpbd_step}


@pytest.fixture(autouse=True)
def _restore_x64():
    prev = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", prev)


def _port(host, cfg):
    return (convert.host_from_arrays(
                {f.name: getattr(host, f.name)
                 for f in dataclasses.fields(host)}),
            convert.config_from_dict(dataclasses.asdict(cfg)))


def _port_run(host, cfg, dtype=torch.float32):
    thost, tcfg = _port(host, cfg)
    top, s0 = tsb.init(thost, device="cpu", dtype=dtype)
    return top, tcfg, s0


def _wind_scene(solver, nx=10, ny=10, plane_height=-1.0, iterations=None):
    """tests/test_wind.py's cloth in a cross-wind with drag and lift (its
    10x10 scene; 16x24 with the plane out of reach for the row tiles)."""
    cfg = SimConfig(
        solver=solver,
        wind=WindParams(velocity=(2.0, 0.5, 1.0), drag=0.3, lift=0.8),
        collision=CollisionParams(enable_plane=True),
        global_damping=0.2,
    )
    if iterations is not None:
        cfg = cfg.replace(xpbd=XPBDParams(n_iterations=iterations))
    host = j_cloth_grid(
        nx, ny, spacing=0.05, shear=True, bend=True, pinned=("tl", "tr"),
        springs=cfg.springs, xpbd=cfg.xpbd, plane_height=plane_height,
        orientation="xy",
    )
    return host, cfg


def _strain_scene(solver, tear=False, plastic=False):
    """tests/test_strainlimit.py's 16x16 banner with soft springs, an 8 %
    stretch bound, and optionally tearing (at 20 %) and plastic creep."""
    cfg = SimConfig(
        solver=solver,
        strain_limit=StrainLimitParams(enabled=True, max_stretch=0.08),
        springs=SpringParams(k_structural=30.0, k_shear=15.0, k_bend=6.0,
                             damping=0.5),
        xpbd=XPBDParams(compliance_distance=5e-3, compliance_bend=5e-2),
        tear=TearParams(enabled=tear, strain_limit=0.2),
        plasticity=PlasticityParams(enabled=plastic, yield_strain=0.02,
                                    creep=0.1),
        global_damping=0.4,
    )
    host = j_cloth_grid(16, 16, spacing=0.08, mass=0.04, pinned=("top",),
                        shear=True, bend=True, springs=cfg.springs,
                        xpbd=cfg.xpbd, plane_height=-0.9, orientation="xy")
    return host, cfg


def _strain_f64_scene(solver, tear=False, plastic=False):
    """tests/test_strainlimit.py's f64 parity scene: an 8x8 soft banner
    falling into the clamp with no plane (contact would turn the last bit
    into a friction decision), optionally tearing and creeping; XPBD runs
    4 iterations, to keep the NumPy oracle's time down."""
    cfg = SimConfig(
        solver=solver,
        strain_limit=StrainLimitParams(enabled=True, max_stretch=0.1),
        springs=SpringParams(k_structural=20.0, k_shear=10.0, k_bend=4.0,
                             damping=0.5),
        xpbd=XPBDParams(compliance_distance=5e-3, compliance_bend=5e-2,
                        n_iterations=4),
        tear=TearParams(enabled=tear, strain_limit=0.2),
        plasticity=PlasticityParams(enabled=plastic, yield_strain=0.02,
                                    creep=0.1),
        collision=CollisionParams(enable_plane=False),
        global_damping=0.5,
    )
    host = j_cloth_grid(8, 8, spacing=0.1, mass=0.05, pinned=("top",),
                        shear=True, bend=True, springs=cfg.springs,
                        xpbd=cfg.xpbd, plane_height=-100.0, orientation="xy")
    return host, cfg


def _max_strain(host, x):
    a, b = host.edges[:, 0], host.edges[:, 1]
    length = np.linalg.norm(x[b] - x[a], axis=1)
    return float(np.max(length / host.rest_length - 1.0))


def _pins_frozen(host, x):
    pinned = host.inv_mass == 0.0
    np.testing.assert_array_equal(x[pinned],
                                  host.positions0[pinned].astype(np.float32))


# --- the plain wind force -----------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_wind_force_and_normals_match_jax(seed):
    """The plain normals and wind force on a perturbed 16x8 grid, f32:
    the same operations as the JAX stencil's, in the same order."""
    rng = np.random.default_rng(seed)
    host = j_cloth_grid(8, 16, spacing=0.05, shear=True, bend=True,
                        orientation="xy")
    x = host.positions0 + 0.01 * rng.standard_normal(host.positions0.shape)
    v = rng.standard_normal(x.shape)
    x3 = x.T.reshape(3, 16, 8).astype(np.float32)
    v3 = v.T.reshape(3, 16, 8).astype(np.float32)
    wind = WindParams(velocity=(2.0, 0.5, 1.0), drag=0.3, lift=0.8)
    cfg = SimConfig(wind=wind)
    want_n = np.asarray(jstencil.grid_vertex_normals(jnp.asarray(x3)))
    want_f = np.asarray(jstencil.wind_forces_grid(jnp.asarray(x3),
                                                  jnp.asarray(v3), cfg))
    got_n = stencil.grid_vertex_normals(torch.from_numpy(x3)).numpy()
    got_f = stencil.wind_forces_grid(torch.from_numpy(x3),
                                     torch.from_numpy(v3), wind).numpy()
    np.testing.assert_allclose(got_n, want_n, atol=1e-6)
    np.testing.assert_allclose(got_f, want_f, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got_n, axis=0), 1.0, atol=1e-6)


# --- wind against the JAX stencil and kernels -----------------------------------

# x: tests/test_wind.py's 5e-5 over 64 substeps (its fused kernel against
# its stencil); the port computes the stencil's operations, so it holds the
# stencil closer, and the kernels (rsqrt) at the same 5e-5
@pytest.mark.parametrize("solver", SOLVERS)
def test_wind_plain_step_matches_jax_stencil_and_fused(solver):
    host, cfg = _wind_scene(solver)
    jtop, js = japi.init(host)
    j_st = jax.jit(lambda t, s: jstencil.make_stencil_step(t, cfg)(
        s, cfg.dt, 64))(jtop, js)
    j_fused = _FUSED[solver](jtop, cfg, interpret=True)(js, cfg.dt, 64)
    top, tcfg, s0 = _port_run(host, cfg)
    got = stencil.make_stencil_step(top, tcfg)(s0, tcfg.dt, 64)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(j_st.x), atol=1e-5)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(j_fused.x),
                               atol=5e-5)
    _pins_frozen(host, got.x.numpy())
    # the wind did work: the cloth moved downwind (+x) from rest
    assert got.x[:, 0].mean() > float(host.positions0[:, 0].mean()) + 1e-4


@pytest.mark.parametrize("solver", SOLVERS)
def test_wind_plain_step_matches_jax_tiled(solver):
    """tests/test_wind.py:154-190: the row-tiled kernels with tile=8 on a
    contact-free 16x24 cloth, 48 substeps, x 5e-5."""
    host, cfg = _wind_scene(solver, nx=16, ny=24, plane_height=-3.0,
                            iterations=3)
    jtop, js = japi.init(host)
    want = _TILED[solver](jtop, cfg, tile=8, interpret=True)(js, cfg.dt, 48)
    top, tcfg, s0 = _port_run(host, cfg)
    got = stencil.make_stencil_step(top, tcfg)(s0, tcfg.dt, 48)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=5e-5)


# --- the strain limit against the JAX kernels --------------------------------------

# tests/test_strainlimit.py:243-275's cases and tolerances: x 3e-5 (2e-4
# with tearing: the clamp at the boundary repeats), the masks equal
@pytest.mark.parametrize("solver,tear,plastic", [
    (Solver.SEMI_IMPLICIT_EULER, False, False),
    (Solver.VERLET, False, False),
    (Solver.XPBD, False, False),
    (Solver.SEMI_IMPLICIT_EULER, True, True),
    (Solver.VERLET, True, False),
    (Solver.XPBD, True, False),
])
def test_strain_plain_step_matches_jax_kernel(solver, tear, plastic):
    host, cfg = _strain_scene(solver, tear, plastic)
    jtop, js = japi.init(host)
    js = japi.ensure_plastic_state(jtop, cfg,
                                   japi.ensure_tear_state(jtop, cfg, js))
    want = _FUSED[solver](jtop, cfg, interpret=True)(js, cfg.dt, 64)
    top, tcfg, s0 = _port_run(host, cfg)
    got = tsb.step(top, tcfg, s0, n_substeps=64)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                               atol=2e-4 if tear else 3e-5)
    if tear:
        np.testing.assert_array_equal(got.edge_alive.numpy(),
                                      np.asarray(want.edge_alive))
    if plastic:
        np.testing.assert_allclose(got.rest_scale.numpy(),
                                   np.asarray(want.rest_scale), atol=1e-4)
    # the limiter worked: the soft springs alone stretch past 8 %
    assert _max_strain(host, got.x.numpy()) > 0.05
    _pins_frozen(host, got.x.numpy())


def test_strain_sweeps_hold_the_bound():
    """Without the limit the soft banner stretches far past 10 %; with it
    the sweeps pull the worst edge back toward the bound
    (tests/test_strainlimit.py's physical check)."""
    host, cfg = _strain_scene(Solver.SEMI_IMPLICIT_EULER)
    cfg = cfg.replace(strain_limit=StrainLimitParams(enabled=True,
                                                     max_stretch=0.1))
    top, tcfg, s0 = _port_run(host, cfg)
    on = tsb.step(top, tcfg, s0, n_substeps=160)
    off = tsb.step(top, tcfg.replace(strain_limit=StrainLimitParams()), s0,
                   n_substeps=160)
    assert _max_strain(host, off.x.numpy()) > 0.3
    assert _max_strain(host, on.x.numpy()) < 0.2


# --- float64 against the oracle ------------------------------------------------------

def _oracle_run(host, cfg, frames, feature_fields=False):
    x = host.positions0.copy()
    v = np.zeros_like(x)
    xp = x.copy()
    e = host.edges.shape[0]
    alive = np.ones(e) if cfg.tear.enabled else None
    scale = np.ones(e) if cfg.plasticity.enabled else None
    for _ in range(frames):
        out = oracle.step(host, cfg, x, v, xp, alive=alive, rest_scale=scale)
        x, v, xp = out[:3]
        if alive is not None:
            alive = out[3]
        if scale is not None:
            scale = out[-1]
    return x, alive, scale


@pytest.mark.parametrize("what", ["wind", "strain", "strain+tear+plastic"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_f64_plain_step_matches_oracle(solver, what):
    """40 frames in float64 against ``oracle.step``, as
    tests/test_wind.py:61-72 holds the JAX paths: < 1e-6, masks equal."""
    if what == "wind":
        host, cfg = _wind_scene(solver, iterations=4)
    else:
        host, cfg = _strain_f64_scene(solver, tear="tear" in what,
                                      plastic="plastic" in what)
    top, tcfg, s = _port_run(host, cfg, dtype=torch.float64)
    for _ in range(40):
        s = tsb.step(top, tcfg, s)
    x, alive, scale = _oracle_run(host, cfg, 40)
    assert float(np.max(np.abs(s.x.numpy() - x))) < 1e-6
    if alive is not None:
        np.testing.assert_array_equal(s.edge_alive.numpy(), alive)
    if scale is not None:
        np.testing.assert_allclose(s.rest_scale.numpy(), scale, atol=1e-9)
    if what != "wind":   # the scene stretches into the clamp
        assert _max_strain(host, x) > 0.05


def test_golden_replay_cloth_strain_limited():
    """tests/test_golden.py's 5e-3 through the public step on the CPU."""
    data = np.load(os.path.join(GOLDEN_DIR, "cloth_strain_limited.npz"))
    golden = data["positions"]
    every = int(data["record_every"])
    host, cfg = tsb.presets.build("cloth_strain_limited")
    top, state = tsb.init(host, device="cpu")
    for r in range(golden.shape[0]):
        for _ in range(every):
            state = tsb.step(top, cfg, state)
        drift = float(np.max(np.abs(state.x.numpy() - golden[r])))
        assert drift < 5e-3, f"drift {drift:.3e} at frame {(r + 1) * every}"


# --- the launch-start form with the strain limit ------------------------------------

@pytest.mark.parametrize("solver", SOLVERS)
def test_launch_start_form_matches_with_strain_limit(solver):
    """The kernels' launch-start feature form against the end-of-substep
    form, bit for bit over two frames, with the strain limit's sweeps
    reading the planes that the substep's first launch updated."""
    host, cfg = _strain_scene(solver, tear=True, plastic=True)
    top, tcfg, s0 = _port_run(host, cfg)
    end_form = stencil.make_stencil_step(top, tcfg)
    start_form = grid_features.make_launch_start_step(top, tcfg)
    a = b = s0
    for _ in range(2):
        a = end_form(a, tcfg.dt, 32)
        b = start_form(b, tcfg.dt, 32)
    for name in ("x", "v", "x_prev", "edge_alive", "rest_scale"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert float(a.rest_scale.max()) > 1.0


# --- lattices: the wind's drag ------------------------------------------------------------

@pytest.mark.parametrize("solver", SOLVERS)
def test_lattice_drag_matches_jax_kernel(solver):
    """tests/test_wind.py:123-150's drag-only cube (6^3, where every spring
    lies in a band: 5^3 leaves some out) against the JAX
    lattice kernel of each solver in interpret mode, 48 substeps, x 2e-5;
    the wind pushes the cube downwind."""
    cfg = SimConfig(
        solver=solver,
        wind=WindParams(velocity=(3.0, 0.0, 0.0), drag=0.5, lift=0.0),
        xpbd=XPBDParams(compliance_distance=1e-6, compliance_volume=1e-7,
                        n_iterations=4),
        collision=CollisionParams(enable_plane=True),
        volume_stiffness=0.5,
        global_damping=0.3,
    )
    host = j_tet_cube(6, spacing=0.05, springs=cfg.springs, xpbd=cfg.xpbd,
                      plane_height=0.0, origin=(0.0, 0.05, 0.0))
    jtop, js = japi.init(host)
    want = _LATTICE[solver](jtop, cfg, interpret=True)(js, cfg.dt, 48)
    top, tcfg, s0 = _port_run(host, cfg)
    fn = dispatch.maybe_fast_step(top, tcfg)
    assert fn.__qualname__ == "make_plain_step.<locals>.fn"
    got = fn(s0, tcfg.dt, 48)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=2e-5)
    assert float(got.x[:, 0].mean()) > float(host.positions0[:, 0].mean()) + 1e-3


@pytest.mark.parametrize("solver", SOLVERS)
def test_lattice_drag_f64_matches_oracle(solver):
    cfg = SimConfig(
        solver=solver,
        wind=WindParams(velocity=(3.0, 0.0, 1.0), drag=0.5),
        xpbd=XPBDParams(compliance_distance=1e-6, compliance_volume=1e-7,
                        n_iterations=4),
        collision=CollisionParams(enable_plane=True),
        volume_stiffness=0.5,
        global_damping=0.3,
    )
    host = j_tet_cube(6, spacing=0.05, springs=cfg.springs, xpbd=cfg.xpbd,
                      plane_height=0.0, origin=(0.0, 0.05, 0.0))
    top, tcfg, s = _port_run(host, cfg, dtype=torch.float64)
    for _ in range(10):
        s = tsb.step(top, tcfg, s)
    x, _, _ = _oracle_run(host, cfg, 10)
    assert float(np.max(np.abs(s.x.numpy() - x))) < 1e-6


def test_lattice_drag_plain_state_from_seeded_velocity_matches_jax():
    """The Verlet drag reads v_est = (x - x_prev) / dt: a seeded velocity
    field, carried as x_prev, against the JAX banded jnp path, f32."""
    from softbodyunity_tpu.solver.step import step_scan

    cfg = SimConfig(
        solver=Solver.VERLET,
        wind=WindParams(velocity=(1.0, 0.5, -2.0), drag=0.4),
        collision=CollisionParams(enable_plane=True),
        volume_stiffness=0.5,
        global_damping=0.3,
    )
    host = j_tet_cube(6, spacing=0.05, springs=cfg.springs, xpbd=cfg.xpbd,
                      plane_height=0.0, origin=(0.0, 0.05, 0.0))
    rng = np.random.default_rng(3)
    x0 = host.positions0
    v0 = 0.2 * rng.standard_normal(x0.shape)
    xp0 = x0 - cfg.dt * v0
    jtop, _ = japi.init(host)
    js = JState(x=jnp.asarray(x0, jnp.float32), v=jnp.asarray(v0, jnp.float32),
                x_prev=jnp.asarray(xp0, jnp.float32))
    want = jax.jit(lambda t, s: step_scan(t, cfg, s, cfg.dt, 32))(jtop, js)
    thost, tcfg = _port(host, cfg)
    top, _ = tsb.init(thost, device="cpu")
    got = tstep.make_plain_step(top, tcfg)(
        convert.state_from_arrays(x0, v0, xp0, "cpu"), tcfg.dt, 32)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=2e-5)


# --- wind with self-collision -------------------------------------------------------

@pytest.mark.parametrize("solver", SOLVERS)
def test_wind_with_self_collision_matches_jax_general_path(solver):
    """Grid cloth with wind and self-collision (method ``dense``) takes the
    grid path, where the force plane and the wind force add; the JAX
    package runs it on its general path (springs + repulsion + wind,
    solver/step.py::total_forces).  A 12x12 cloth folded toward itself by
    a cross-wind, 3 frames, x 5e-5 (two summation orders of the same
    forces; its normals are the C11 segment sums there, shifts here)."""
    cfg = SimConfig(
        solver=solver,
        wind=WindParams(velocity=(0.0, 0.0, 3.0), drag=0.3, lift=0.8),
        self_collision=SelfCollisionParams(enabled=True, method="dense",
                                           radius=0.06, stiffness=20.0),
        collision=CollisionParams(enable_plane=True),
        global_damping=0.2,
    )
    host = j_cloth_grid(12, 12, spacing=0.05, shear=True, bend=True,
                        pinned=("tl", "tr"), springs=cfg.springs,
                        xpbd=cfg.xpbd, plane_height=-1.0, orientation="xy")
    jtop, js = japi.init(host)
    top, tcfg, s = _port_run(host, cfg)
    assert dispatch.maybe_fast_step(top, tcfg).__qualname__ == (
        "make_stencil_step.<locals>.fn")
    for _ in range(3):
        js = japi.step(jtop, cfg.replace(backend="jnp"), js)
        s = tsb.step(top, tcfg, s)
    np.testing.assert_allclose(s.x.numpy(), np.asarray(js.x), atol=5e-5)


# --- what the JAX package runs only on its general path -------------------------------

@pytest.mark.parametrize("what", ["lattice_lift", "lattice_strain",
                                  "strain_self_collision"])
def test_general_path_branches_raise(what):
    if what == "strain_self_collision":
        host, cfg = _strain_scene(Solver.SEMI_IMPLICIT_EULER)
        cfg = cfg.replace(self_collision=SelfCollisionParams(
            enabled=True, method="dense"))
    else:
        cfg = SimConfig(
            wind=WindParams(velocity=(1.0, 0.0, 0.0), drag=0.2,
                            lift=0.5 if what == "lattice_lift" else 0.0),
            strain_limit=StrainLimitParams(enabled=what == "lattice_strain"),
            collision=CollisionParams(enable_plane=True),
            volume_stiffness=0.5)
        host = j_tet_cube(6, spacing=0.05, springs=cfg.springs,
                          xpbd=cfg.xpbd, plane_height=0.0)
    for solver in SOLVERS:
        top, tcfg, s0 = _port_run(host, cfg.replace(solver=solver))
        with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
            tsb.step(top, tcfg, s0)
        with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
            dispatch.maybe_fast_step(top, tcfg)


@pytest.mark.parametrize("what", ["capsules", "boxes"])
def test_capsule_box_with_wind_still_raises(what):
    """Capsule and box contact run with wind since their branch was ported
    (tests/test_torch_colliders.py); an SDF collider beside them, which no
    grid kernel runs yet, still refuses with wind on, naming Queue 1 item
    6."""
    host, cfg = _wind_scene(Solver.SEMI_IMPLICIT_EULER)
    top, tcfg, s0 = _port_run(host, cfg)
    tcfg = tcfg.replace(collision=dataclasses.replace(
        tcfg.collision, enable_sdf=True, **{f"enable_{what}": True}))
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        tsb.step(top, tcfg, s0)


def test_presets_run_a_frame_on_the_cpu():
    """The two 64k presets, cut to a 32x32 corner of the same cloth, step
    a frame through the plain path: finite, pins frozen, the wind blowing
    the curtain downwind and the strain limit holding the soft banner."""
    for name in ("cloth_wind_64k", "cloth_strain_64k"):
        _, cfg = tsb.presets.build(name)
        host = tsb.cloth_grid(32, 32, spacing=0.01, shear=True, bend=True,
                              pinned=("top",), springs=cfg.springs,
                              xpbd=cfg.xpbd, plane_height=-50.0,
                              orientation="xy")
        top, s0 = tsb.init(host, device="cpu")
        s = s0
        for _ in range(3):
            s = tsb.step(top, cfg, s)
        pinned = torch.from_numpy(host.inv_mass == 0.0)
        assert bool(torch.isfinite(s.x).all())
        assert torch.equal(s.x[pinned], s0.x[pinned])
        if name == "cloth_wind_64k":
            assert float(s.x[:, 0].mean()) > float(s0.x[:, 0].mean())
