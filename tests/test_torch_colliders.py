"""Capsule and oriented-box contact in softbodyunity_torch, on the CPU.

The port's collider primitives against the JAX package's
(``softbodyunity_tpu/solver/collide.py``) on random and edge-case points;
the three grid solvers' plain versions against the JAX fused and row-tiled
Pallas kernels (interpret mode), the three lattice solvers' against the JAX
lattice kernels (interpret mode), all in float32; float64 against the NumPy
oracle; capsules and boxes with tearing and plasticity, the strain limit,
wind and self-collision; and ``api.move_colliders``, which moves colliders
between frames without building a new step function.  The CUDA kernels are
held to these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Run as a script it measures the JAX package's own float32-vs-float64 drift
on chip_smoke.py's two 64k collider scenes (see :func:`jax_f32_drift`), or
how deep its stencil leaves vertices in the capsule and the box of the
cloth scene (see :func:`crease_depth`).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softbodyunity_tpu import api as japi
from softbodyunity_tpu.core.config import (CollisionParams, PlasticityParams,
                                           SelfCollisionParams, SimConfig,
                                           Solver, StrainLimitParams,
                                           TearParams, WindParams)
from softbodyunity_tpu.core.topology import add_colliders, cloth_grid, tet_cube
from softbodyunity_tpu.kernels import stencil as jstencil
from softbodyunity_tpu.kernels.pallas_lattice import (make_lattice_step,
                                                      make_lattice_verlet_step,
                                                      make_lattice_xpbd_step)
from softbodyunity_tpu.kernels.pallas_substep import (make_pallas_step,
                                                      make_pallas_verlet_step)
from softbodyunity_tpu.kernels.pallas_tiled import (make_tiled_step,
                                                    make_tiled_verlet_step,
                                                    make_tiled_xpbd_step)
from softbodyunity_tpu.kernels.pallas_xpbd import make_pallas_xpbd_step
from softbodyunity_tpu.oracle import reference as oracle
from softbodyunity_tpu.solver import collide as jcollide
from softbodyunity_tpu.solver.step import step_scan

import softbodyunity_torch as tsb
from softbodyunity_torch import api, convert
from softbodyunity_torch.kernels import dispatch
from softbodyunity_torch.solver import collide as tcollide

torch.set_num_threads(1)

SOLVERS = [Solver.SEMI_IMPLICIT_EULER, Solver.VERLET, Solver.XPBD]
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


def _rot_z(deg):
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _rot_x(deg):
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def _scene(solver, *, origin_y=0.25, nx=12, ny=12):
    """tests/test_colliders.py::_scene: cloth falling onto a capsule and a
    box turned 30 degrees about z, the plane far below; ``origin_y=0.05``
    starts it inside the colliders' band."""
    cfg = SimConfig(
        solver=solver,
        collision=CollisionParams(
            enable_plane=True, enable_capsules=True, enable_boxes=True,
            restitution=0.1, friction=0.3),
        global_damping=0.3)
    host = cloth_grid(
        nx, ny, spacing=0.05, shear=True, bend=True, pinned=(),
        springs=cfg.springs, xpbd=cfg.xpbd, plane_height=-2.0,
        origin=(-0.28, origin_y, -0.28), orientation="xz")
    host = add_colliders(
        host, capsule_p0=[[-0.3, 0.0, 0.0]], capsule_p1=[[0.05, 0.0, 0.0]],
        capsule_radii=[0.12], box_centers=[[0.18, -0.05, 0.1]],
        box_half_extents=[[0.15, 0.1, 0.12]], box_rotations=[_rot_z(30.0)])
    return host, cfg


def _cube_scene(solver):
    """tests/test_colliders.py::_cube_scene: a 5^3 tet cube straddling a
    capsule and a box turned 20 degrees about z."""
    cfg = SimConfig(
        solver=solver,
        collision=CollisionParams(enable_plane=True, enable_capsules=True,
                                  enable_boxes=True, friction=0.3),
        volume_stiffness=0.5, global_damping=0.4)
    host = tet_cube(5, spacing=0.05, springs=cfg.springs, xpbd=cfg.xpbd,
                    plane_height=-0.5, origin=(-0.1, -0.02, -0.1))
    host = add_colliders(
        host, capsule_p0=[[-0.15, 0.0, 0.1]], capsule_p1=[[0.25, 0.0, 0.1]],
        capsule_radii=[0.06], box_centers=[[0.05, -0.06, -0.05]],
        box_half_extents=[[0.12, 0.05, 0.1]], box_rotations=[_rot_z(20.0)])
    return host, cfg


def _moving_scene():
    """tests/test_moving_colliders.py::_scene: every collider family moves
    (a conveyor plane, a sphere, a capsule and a box, each at its own
    velocity)."""
    cfg = SimConfig(
        solver=Solver.SEMI_IMPLICIT_EULER,
        collision=CollisionParams(
            enable_plane=True, enable_spheres=True, enable_capsules=True,
            enable_boxes=True, restitution=0.2, friction=0.4),
        global_damping=0.3)
    host = cloth_grid(
        12, 12, spacing=0.05, shear=True, bend=True, pinned=(),
        springs=cfg.springs, xpbd=cfg.xpbd, plane_height=0.0,
        origin=(-0.28, 0.12, -0.28), orientation="xz",
        sphere_centers=np.array([[-0.15, 0.0, -0.1]]),
        sphere_radii=np.array([0.13]))
    host = add_colliders(
        host, capsule_p0=[[0.0, 0.0, 0.05]], capsule_p1=[[0.3, 0.0, 0.05]],
        capsule_radii=[0.11], box_centers=[[0.05, 0.0, -0.25]],
        box_half_extents=[[0.1, 0.13, 0.1]], box_rotations=[np.eye(3)],
        plane_velocity=[0.3, 0.0, -0.1], sphere_velocities=[[0.25, 0.0, 0.0]],
        capsule_velocities=[[-0.2, 0.0, 0.1]],
        box_velocities=[[0.0, 0.0, 0.2]])
    return host, cfg


def _port(host, cfg):
    return (convert.host_from_arrays(
                {f.name: getattr(host, f.name)
                 for f in dataclasses.fields(host)}),
            convert.config_from_dict(dataclasses.asdict(cfg)))


def _port_run(host, cfg, dtype=torch.float32):
    thost, tcfg = _port(host, cfg)
    top, s0 = tsb.init(thost, device="cpu", dtype=dtype)
    return top, tcfg, s0


# --- the primitives, against the JAX package's ---------------------------------

# The primitives run the same float32 operations in both packages, but
# torch's float32 sqrt on the CPU is not always correctly rounded (1 ulp off
# numpy's and XLA's at some inputs), and a radius minus a distance or a
# position plus a push-out cancels that into a few ulps of a small result.
# So each element must be within one float32 ulp at the inputs' scale (the
# largest coordinate, or the result itself where that is larger), and
# almost all of them equal to the bit.
BIT_EQUAL_SHARE = 0.99


def _ulp_close(got, want, scale):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    gap = np.abs(got.astype(np.float64) - want.astype(np.float64))
    ulp = np.spacing(np.maximum(np.maximum(np.abs(got), np.abs(want)),
                                np.float32(scale)))
    bad = ~(gap <= ulp)
    assert not bad.any(), (
        f"{int(bad.sum())} elements past 1 ulp at scale {scale}; worst gap "
        f"{float(gap.max()):.3e} at {np.argmax(gap)}")
    share = float(np.mean(got.view(np.int32) == want.view(np.int32)))
    assert share >= BIT_EQUAL_SHARE, f"only {share:.4f} equal to the bit"


def _compare(got, want, scale):
    """Component lists (or tuples of them, or masks): masks equal, values
    as :func:`_ulp_close`."""
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _compare(g, w, scale)
    elif np.asarray(want).dtype == bool:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    else:
        _ulp_close(got.numpy() if torch.is_tensor(got) else got, want, scale)


def _points(rng, n, center, spread):
    return (np.asarray(center, np.float32)
            + rng.uniform(-spread, spread, (n, 3)).astype(np.float32))


def _both(points):
    """(torch components, jnp components) of float32 [N, 3] points."""
    pts = np.asarray(points, np.float32)
    return ([torch.from_numpy(pts[:, c].copy()) for c in range(3)],
            [jnp.asarray(pts[:, c]) for c in range(3)])


def _scalars(values):
    """(torch 0-d tensors, jnp 0-d arrays) of float32 scalars."""
    v = np.asarray(values, np.float32)
    return ([torch.tensor(a) for a in v], [jnp.asarray(a) for a in v])


CAPSULE = dict(p0=[-0.3, 0.1, 0.05], p1=[0.2, -0.1, 0.15], r=0.12,
               w=[0.3, -0.2, 0.1])


def _capsule_points(rng):
    p0, p1 = np.asarray(CAPSULE["p0"]), np.asarray(CAPSULE["p1"])
    ax = (p1 - p0) / np.linalg.norm(p1 - p0)
    return np.concatenate([
        _points(rng, 3000, (p0 + p1) / 2, 0.4),
        [p0, p1, p0 - 0.05 * ax, p1 + 0.05 * ax,   # the ends, and past them
         p0 + [0.0, 0.12, 0.0], (p0 + p1) / 2]]).astype(np.float32)


@pytest.mark.parametrize("what", ["project", "resolve", "friction"])
def test_capsule_primitives_match_jax(what):
    """Closest point, push-out, velocity response and friction of a capsule
    on random points, the segment's ends and points on its axis (dist 0),
    with a kinematic velocity w != 0: equal to 1 ulp."""
    rng = np.random.default_rng(7)
    pts = _capsule_points(rng)
    vel = rng.standard_normal(pts.shape).astype(np.float32)
    start = (pts - 0.01 * vel).astype(np.float32)
    mov = rng.uniform(size=len(pts)) < 0.9
    (tx, jx), (tv, jv), (ts, js) = _both(pts), _both(vel), _both(start)
    tp0, jp0 = _scalars(CAPSULE["p0"])
    tp1, jp1 = _scalars(CAPSULE["p1"])
    (tr,), (jr,) = _scalars([CAPSULE["r"]])
    tw, jw = _scalars(CAPSULE["w"])
    tm, jm = torch.from_numpy(mov), jnp.asarray(mov)
    if what == "project":
        got = tcollide.capsule_project_components(tx, tm, tp0, tp1, tr)
        want = jcollide.capsule_project_components(jx, jm, jp0, jp1, jr)
        assert np.abs(np.asarray(want[0]) - pts[:, 0]).max() > 1e-3
    elif what == "resolve":
        got = tcollide.capsule_resolve_components(tx, tv, tm, tp0, tp1, tr,
                                                  0.3, 0.4, tw)
        want = jcollide.capsule_resolve_components(jx, jv, jm, jp0, jp1, jr,
                                                   0.3, 0.4, w=jw)
    else:
        got = tcollide.capsule_friction_components(tx, ts, tm, tp0, tp1, tr,
                                                   tw, 0.4, 1.0 / 960)
        want = jcollide.capsule_friction_components(jx, js, jm, jp0, jp1, jr,
                                                    jw, 0.4, 1.0 / 960)
    _compare(got, want, np.abs(pts).max())


def _box_cases(rng):
    """(center, half, rotation, points): a box turned about two axes with
    random points; and an axis-aligned box about the origin with points on
    its axes at q = +0.0 and -0.0 and at exact ties of the penetrations
    (two and three axes)."""
    rot = _rot_z(30.0) @ _rot_x(25.0)
    c = [0.18, -0.05, 0.1]
    turned = (c, [0.15, 0.1, 0.12], rot, _points(rng, 3000, c, 0.3))
    edge = np.array([
        [-0.0, -0.05, -0.03], [0.0, -0.05, -0.03], [-0.0, 0.05, 0.03],
        [0.03, 0.03, 0.0], [-0.03, 0.03, -0.0], [0.04, -0.04, 0.14],
        [0.0, 0.0, 0.0], [-0.0, -0.0, -0.0], [0.05, 0.05, 0.15],
        [0.1, 0.0, 0.0], [0.11, 0.02, 0.0], [0.0, -0.1, 0.2]], np.float32)
    aligned = ([0.0, 0.0, 0.0], [0.1, 0.1, 0.2], np.eye(3),
               np.concatenate([edge, _points(rng, 500, (0, 0, 0), 0.12)]))
    return [turned, aligned]


@pytest.mark.parametrize("what", ["face", "project", "resolve", "friction"])
def test_box_primitives_match_jax(what):
    """Local coordinates, exit face (ties broken x < y < z, q = -0.0 on the
    +1 side), push-out, velocity response and friction of oriented boxes
    with a kinematic velocity w != 0: equal to 1 ulp; masks equal."""
    rng = np.random.default_rng(11)
    for center, half, rot, pts in _box_cases(rng):
        pts = np.asarray(pts, np.float32)
        vel = rng.standard_normal(pts.shape).astype(np.float32)
        start = (pts - 0.01 * vel).astype(np.float32)
        mov = rng.uniform(size=len(pts)) < 0.9
        (tx, jx), (tv, jv), (ts, js) = _both(pts), _both(vel), _both(start)
        tc, jc = _scalars(center)
        th, jh = _scalars(half)
        r32 = np.asarray(rot, np.float32)
        trot = [[torch.tensor(r32[c, i]) for i in range(3)]
                for c in range(3)]
        jrot = [[jnp.asarray(r32[c, i]) for i in range(3)] for c in range(3)]
        tw, jw = _scalars([0.0, 0.5, -0.2])
        tm, jm = torch.from_numpy(mov), jnp.asarray(mov)
        if what == "face":
            got = tcollide.box_face_push_components(tx, tc, th, trot)
            want = jcollide.box_face_push_components(jx, jc, jh, jrot)
            assert np.asarray(want[0]).any() and not np.asarray(want[0]).all()
        elif what == "project":
            got = tcollide.box_project_components(tx, tm, tc, th, trot)
            want = jcollide.box_project_components(jx, jm, jc, jh, jrot)
        elif what == "resolve":
            got = tcollide.box_resolve_components(tx, tv, tm, tc, th, trot,
                                                  0.3, 0.4, tw)
            want = jcollide.box_resolve_components(jx, jv, jm, jc, jh, jrot,
                                                   0.3, 0.4, w=jw)
        else:
            # half the points on a face, within its contact shell
            q = (pts - np.asarray(center, np.float32)) @ r32
            k = np.argmin(np.asarray(half) - np.abs(q), axis=1)
            on = q.copy()
            on[np.arange(len(q)), k] = (np.sign(q[np.arange(len(q)), k])
                                        * np.asarray(half)[k])
            face = (np.asarray(center) + on @ r32.T).astype(np.float32)
            pts2 = np.where((np.arange(len(pts)) % 2 == 0)[:, None], face,
                            pts).astype(np.float32)
            (tx, jx) = _both(pts2)
            got = tcollide.box_friction_components(tx, ts, tm, tc, th, trot,
                                                   tw, 0.4, 1.0 / 960)
            want = jcollide.box_friction_components(jx, js, jm, jc, jh, jrot,
                                                    jw, 0.4, 1.0 / 960)
            moved = np.abs(np.asarray(want[0]) - pts2[:, 0]).max()
            assert moved > 0.0, "no vertex took box friction"
        _compare(got, want, np.abs(pts).max())


# --- the plain solvers against the JAX kernels (float32, interpret mode) ------

def _contact_happened(x):
    # the capsule pushed some vertex up, above the band it started in
    assert np.asarray(x)[:, 1].max() > 0.06


@pytest.mark.parametrize("solver", SOLVERS)
def test_grid_matches_jax_fused_kernel(solver):
    """The three grid solvers against the JAX fused kernels (TPU kernels
    #1-3) in interpret mode, 48 substeps from inside the colliders' band,
    at tests/test_colliders.py's 5e-5 (rsqrt-vs-sqrt spring rounding
    amplified by contact)."""
    host, cfg = _scene(solver, origin_y=0.05)
    jtop, js = japi.init(host)
    want = _FUSED[solver](jtop, cfg, interpret=True)(js, cfg.dt, 48)
    top, tcfg, s0 = _port_run(host, cfg)
    got = tsb.step(top, tcfg, s0, n_substeps=48)
    _contact_happened(want.x)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=5e-5)


@pytest.mark.parametrize("solver", SOLVERS)
def test_grid_matches_jax_row_tiled_kernel(solver):
    """The same against the JAX row-tiled kernels (TPU kernels #4-6) on a
    16-row cloth, 32 substeps: tile 8 (XPBD 16, its halo's minimum), as
    tests/test_colliders.py runs them, at its 5e-5."""
    host, cfg = _scene(solver, origin_y=0.05, ny=16)
    jtop, js = japi.init(host)
    tile = 16 if solver == Solver.XPBD else 8
    want = _TILED[solver](jtop, cfg, tile=tile, interpret=True)(js, cfg.dt,
                                                                32)
    top, tcfg, s0 = _port_run(host, cfg)
    got = tsb.step(top, tcfg, s0, n_substeps=32)
    _contact_happened(want.x)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=5e-5)


@pytest.mark.parametrize("solver", SOLVERS)
def test_lattice_matches_jax_lattice_kernel(solver):
    """The three banded lattice solvers against the JAX lattice kernels
    (TPU kernels #7-9) in interpret mode on a cube straddling a capsule and
    a box, 48 substeps, at tests/test_colliders.py's 5e-5."""
    host, cfg = _cube_scene(solver)
    jtop, js = japi.init(host)
    want = _LATTICE[solver](jtop, cfg, interpret=True)(js, cfg.dt, 48)
    top, tcfg, s0 = _port_run(host, cfg)
    assert dispatch.maybe_fast_step(top, tcfg).__qualname__ == (
        "make_plain_step.<locals>.fn")
    got = tsb.step(top, tcfg, s0, n_substeps=48)
    assert np.abs(np.asarray(want.x)[:, 1] - host.positions0[:, 1]).max() \
        > 1e-3
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=5e-5)


def test_moving_colliders_match_jax_fused_kernel():
    """tests/test_moving_colliders.py's scene, every collider family with
    its own kinematic velocity, against the JAX fused Euler kernel in
    interpret mode, 48 substeps, at that test's 5e-5."""
    host, cfg = _moving_scene()
    jtop, js = japi.init(host)
    want = make_pallas_step(jtop, cfg, interpret=True)(js, cfg.dt, 48)
    top, tcfg, s0 = _port_run(host, cfg)
    got = tsb.step(top, tcfg, s0, n_substeps=48)
    assert np.abs(np.asarray(want.v)).max() > 0.05
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=5e-5)


# --- float64 against the oracle -----------------------------------------------

def _oracle_pair(host, cfg, steps):
    top, tcfg, s = _port_run(host, cfg, dtype=torch.float64)
    x = host.positions0.copy()
    v = np.zeros_like(x)
    xp = x.copy()
    for _ in range(steps):
        x, v, xp = oracle.step(host, cfg, x, v, xp)
        s = tsb.step(top, tcfg, s)
    return s.x.numpy(), x


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("scene", ["grid", "lattice"])
def test_f64_matches_oracle(solver, scene):
    """Float64 against ``oracle.step`` at tests/test_colliders.py:88-100's
    bounds: 1e-6, and 3e-5 for XPBD, whose Jacobi iterations amplify the
    summation-order noise under contact chaos (8e-6 measured there at 40
    steps).  The cloth over that test's 40 steps; the cube over 10, the
    oracle's per-tet loop being slow (XPBD 60 s for 40 steps)."""
    host, cfg = (_scene if scene == "grid" else _cube_scene)(solver)
    got, want = _oracle_pair(host, cfg, 40 if scene == "grid" else 10)
    bound = 3e-5 if solver == Solver.XPBD else 1e-6
    drift = float(np.max(np.abs(got - want)))
    assert drift < bound, f"{solver} {scene}: f64 drift {drift:.3e}"


# --- capsules and boxes with the other branches -------------------------------

def _jax_stencil(host, cfg, n_sub):
    jtop, js = japi.init(host)
    js = japi.ensure_plastic_state(jtop, cfg,
                                   japi.ensure_tear_state(jtop, cfg, js))
    return jax.jit(lambda t, s: jstencil.make_stencil_step(t, cfg)(
        s, cfg.dt, n_sub))(jtop, js)


@pytest.mark.parametrize("solver", SOLVERS)
def test_with_tear_and_plastic_matches_jax_stencil(solver):
    """Tearing and plasticity beside the capsule and the box, 32 substeps,
    against the JAX stencil (which updates the planes at the end of every
    substep, as the plain version does): the masks equal, the scales and x
    at 5e-5 (the spring rounding amplified by contact, as above)."""
    host, cfg = _scene(solver, origin_y=0.05)
    cfg = cfg.replace(tear=TearParams(enabled=True, strain_limit=0.3),
                      plasticity=PlasticityParams(enabled=True,
                                                  yield_strain=0.02,
                                                  creep=0.2))
    want = _jax_stencil(host, cfg, 32)
    top, tcfg, s0 = _port_run(host, cfg)
    got = tsb.step(top, tcfg, s0, n_substeps=32)
    alive = np.asarray(want.edge_alive)
    assert (alive == 0).any() and np.asarray(want.rest_scale).max() > 1.0
    np.testing.assert_array_equal(got.edge_alive.numpy(), alive)
    np.testing.assert_allclose(got.rest_scale.numpy(),
                               np.asarray(want.rest_scale), atol=5e-5)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=5e-5)


@pytest.mark.parametrize("solver", SOLVERS)
def test_with_strain_limit_matches_jax_fused_kernel(solver):
    """The strain limit beside the capsule and the box against the JAX
    fused kernels in interpret mode (the JAX stencil has no sweeps), 32
    substeps: the contact after the sweeps (Euler, Verlet) and XPBD's
    projection after them.  3e-5, tests/test_strainlimit.py's kernel
    bound (the TPU kernel's rsqrt against sqrt and divide here)."""
    host, cfg = _scene(solver, origin_y=0.05)
    cfg = cfg.replace(strain_limit=StrainLimitParams(
        enabled=True, max_stretch=0.05, iterations=4))
    jtop, js = japi.init(host)
    want = _FUSED[solver](jtop, cfg, interpret=True)(js, cfg.dt, 32)
    top, tcfg, s0 = _port_run(host, cfg)
    got = tsb.step(top, tcfg, s0, n_substeps=32)
    _contact_happened(want.x)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=3e-5)


@pytest.mark.parametrize("solver", SOLVERS)
def test_with_wind_matches_jax_stencil(solver):
    """Wind with drag and lift beside the capsule and the box, 32 substeps,
    against the JAX stencil at 5e-5 (contact-amplified rounding)."""
    host, cfg = _scene(solver, origin_y=0.05)
    cfg = cfg.replace(wind=WindParams(velocity=(2.0, 0.5, 1.0), drag=0.3,
                                      lift=0.8))
    want = _jax_stencil(host, cfg, 32)
    top, tcfg, s0 = _port_run(host, cfg)
    got = tsb.step(top, tcfg, s0, n_substeps=32)
    _contact_happened(want.x)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=5e-5)


@pytest.mark.parametrize("solver", SOLVERS)
def test_with_self_collision_matches_jax_general_path(solver):
    """Block-sparse self-collision beside the capsule and the box, 3
    frames, against the JAX package's general jnp path (its fused kernels
    take no outside force), as tests/test_torch_wind_strain.py holds wind
    with self-collision: 5e-5, the rounding of a different force sum (edge
    list there, stencil here) amplified by contact."""
    host, cfg = _scene(solver, origin_y=0.05)
    cfg = cfg.replace(self_collision=SelfCollisionParams(
        enabled=True, method="block", radius=0.03, stiffness=40.0,
        block_size=16, block_partners=8), n_substeps=8)
    jtop, js = japi.init(host)
    top, tcfg, s = _port_run(host, cfg)
    assert dispatch.maybe_fast_step(top, tcfg).__qualname__ == (
        "make_stencil_step.<locals>.fn")
    for _ in range(3):
        js = japi.step(jtop, cfg.replace(backend="jnp"), js)
        s = tsb.step(top, tcfg, s)
    _contact_happened(js.x)
    np.testing.assert_allclose(s.x.numpy(), np.asarray(js.x), atol=5e-5)


# --- move_colliders -------------------------------------------------------------

def _move_case(kind, solver):
    """A scene in contact from the start, 2 substeps a frame."""
    if kind == "grid":
        host, cfg = _scene(solver, origin_y=0.05)
    else:
        host, cfg = _cube_scene(solver)
    return _port_run(host, cfg.replace(n_substeps=2))


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("kind", ["grid", "lattice"])
def test_move_colliders_reuses_the_step_function(kind, solver):
    """Moving the capsule (and turning the box) every frame for 20 frames
    gives the same x, to the bit, as a step function built fresh on each
    moved topology, and builds no step function after the first: the
    cache misses stay put.  A new collider count builds one."""
    top, cfg, s = _move_case(kind, solver)
    ref = s
    p0 = top.capsule_p0.clone()
    misses = api._build_step.cache_info().misses
    for i in range(20):
        moved = api.move_colliders(
            top, capsule_p0=p0 + torch.tensor([0.0, 0.004 * i, 0.0]),
            capsule_velocities=[[0.0, 0.24, 0.0]],
            box_rotations=[_rot_z(20.0 + i)])
        assert all(getattr(moved, f) is getattr(top, f) for f in (
            "inv_mass", "edges", "offset_groups", "tet_groups",
            "sphere_centers"))
        s = tsb.step(moved, cfg, s)
        ref = dispatch.maybe_fast_step(moved, cfg)(ref, cfg.dt,
                                                   cfg.n_substeps)
        assert torch.equal(s.x, ref.x) and torch.equal(s.v, ref.v)
    assert api._build_step.cache_info().misses == misses + 1
    assert bool(torch.isfinite(s.x).all())
    # a second capsule is a new count: a new step function
    two = api.move_colliders(top, capsule_p0=top.capsule_p0.repeat(2, 1),
                             capsule_p1=top.capsule_p1.repeat(2, 1),
                             capsule_radii=top.capsule_radii.repeat(2),
                             capsule_velocities=torch.zeros(2, 3))
    assert two.n_capsules == 2
    tsb.step(two, cfg, s)
    assert api._build_step.cache_info().misses == misses + 2


def test_step_function_refuses_another_scene():
    """A built step function takes the call's collider rows, and nothing
    else of another topology."""
    top, cfg, s = _move_case("grid", Solver.SEMI_IMPLICIT_EULER)
    other, _, _ = _move_case("grid", Solver.SEMI_IMPLICIT_EULER)
    fn = dispatch.maybe_fast_step(top, cfg)
    fn(s, cfg.dt, 1, top=api.move_colliders(top, box_centers=[[0, 0, 0]]))
    with pytest.raises(ValueError, match="another scene"):
        fn(s, cfg.dt, 1, top=other)


def test_move_colliders_moves_the_contact():
    """A capsule raised to the cloth's height pushes it elsewhere: the
    moved rows are what the next frame reads."""
    top, cfg, s0 = _move_case("grid", Solver.SEMI_IMPLICIT_EULER)
    still = tsb.step(top, cfg, s0)
    raised = api.move_colliders(top, capsule_p0=[[-0.3, 0.05, 0.0]],
                                capsule_p1=[[0.05, 0.05, 0.0]])
    moved = tsb.step(raised, cfg, s0)
    assert float((moved.x - still.x).abs().max()) > 1e-2


# --- the JAX package's own float32 drift on the 64k scenes ------------------

def jax_f32_drift(scene, solver_name, frames, every):
    """The JAX package's own f32-vs-f64 drift on one of chip_smoke.py's 64k
    collider scenes: its XLA stencil (cloth) or banded ``step_scan`` (cube)
    in float32 against the same path in float64, the worst |x| gap printed
    every ``every`` frames.  Not a test (minutes at 64k); chip_smoke.py
    takes the scenes' fidelity bounds from it:

        PYTHONPATH=. python tests/test_torch_colliders.py cloth euler 200 10
        PYTHONPATH=. python tests/test_torch_colliders.py cube xpbd 60 10
    """
    import softbodyunity_tpu as jsb

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    jax.config.update("jax_enable_x64", True)
    solver = {"euler": Solver.SEMI_IMPLICIT_EULER, "verlet": Solver.VERLET,
              "xpbd": Solver.XPBD}[solver_name]
    if scene == "cloth":
        host, cfg = chip_smoke.cloth_colliders_64k(jsb, solver)
        run = jax.jit(lambda t, s: jstencil.make_stencil_step(t, cfg)(
            s, cfg.dt, cfg.n_substeps))
    else:
        preset = {"euler": "softbody_cube_64k",
                  "verlet": "softbody_cube_64k_verlet",
                  "xpbd": "softbody_cube_64k_xpbd"}[solver_name]
        host, cfg = chip_smoke.add_cube_colliders(
            jsb, *jsb.presets.build(preset))
        run = jax.jit(lambda t, s: step_scan(t, cfg, s, cfg.dt,
                                             cfg.n_substeps))
    t32, s32 = japi.init(host, dtype=jnp.float32)
    t64, s64 = japi.init(host, dtype=jnp.float64)
    worst = 0.0
    for i in range(frames):
        s32, s64 = run(t32, s32), run(t64, s64)
        if (i + 1) % every == 0:
            d = float(np.max(np.abs(np.asarray(s32.x, np.float64)
                                    - np.asarray(s64.x))))
            worst = max(worst, d)
            print(f"{scene} {solver_name} frame {i + 1}: drift {d:.6e}",
                  flush=True)
    print(f"{scene} {solver_name} worst drift over {frames} frames: "
          f"{worst:.6e}")


def crease_depth(capsule_end_x, frames, every):
    """How deep the JAX package's own float32 stencil leaves vertices inside
    the capsule and the box of chip_smoke.py's cloth scene (Euler), with the
    capsule's end p1 at ``capsule_end_x``: 0.23 is
    tests/test_colliders.py::_scene scaled by 4.6, where the capsule
    overlaps the box's corner; chip_smoke.py uses -0.6.  The capsule is
    raised by 0.05 m at frame 151, as chip_smoke.py's main path raises it.
    Prints the deepest vertex in each and the vertices within 1e-3 of both
    every ``every`` frames:

        PYTHONPATH=. python tests/test_torch_colliders.py crease 0.23 300 25
    """
    import softbodyunity_tpu as jsb

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    host, cfg = chip_smoke.cloth_colliders_64k(jsb, Solver.SEMI_IMPLICIT_EULER)
    host.capsule_p1 = np.array([[capsule_end_x, 0.0, 0.0]])
    run = jax.jit(lambda t, s: jstencil.make_stencil_step(t, cfg)(
        s, cfg.dt, cfg.n_substeps))
    top, s = japi.init(host)
    lift = np.array([0.0, 0.05, 0.0])
    w = np.asarray(top.capsule_velocities)
    for i in range(frames):
        if i == frames // 2:
            top = japi.move_colliders(
                top, capsule_p0=np.asarray(top.capsule_p0) + lift,
                capsule_p1=np.asarray(top.capsule_p1) + lift,
                capsule_velocities=w + lift / (cfg.dt * cfg.n_substeps))
        elif i == frames // 2 + 1:
            top = japi.move_colliders(top, capsule_velocities=w)
        s = run(top, s)
        if (i + 1) % every == 0:
            x = np.asarray(s.x, np.float64)
            p0 = np.asarray(top.capsule_p0[0], np.float64)
            ax = np.asarray(top.capsule_p1[0], np.float64) - p0
            t = np.clip((x - p0) @ ax / (ax @ ax), 0.0, 1.0)
            cap = (float(top.capsule_radii[0])
                   - np.linalg.norm(x - p0 - t[:, None] * ax, axis=1))
            q = ((x - np.asarray(top.box_centers[0], np.float64))
                 @ np.asarray(top.box_rotations[0], np.float64))
            box = (np.asarray(top.box_half_extents[0], np.float64)
                   - np.abs(q)).min(axis=1)
            both = int(((cap > -1e-3) & (box > -1e-3)).sum())
            print(f"capsule end {capsule_end_x} frame {i + 1}: deepest in "
                  f"the capsule {cap.max():.3e}, in the box {box.max():.3e}, "
                  f"{both} vertices within 1e-3 of both", flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1] == "crease":
        crease_depth(float(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
    else:
        jax_f32_drift(sys.argv[1], sys.argv[2], int(sys.argv[3]),
                      int(sys.argv[4]))
