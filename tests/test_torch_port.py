"""softbodyunity_torch's copies of the framework-free layers, held equal to
the JAX package: config, grid builder, presets, the state hand-off in
``convert``, ``suggest_dt``, vertex normals, and the no-jax import rule.
(``tests/test_torch_lattice.py`` holds the tet-cube builder and the band
builders equal.)"""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softbodyunity_tpu import api as japi
from softbodyunity_tpu.core import topology as jtopo
from softbodyunity_tpu.models import presets as jpresets
from softbodyunity_tpu.solver.normals import vertex_normals as j_vertex_normals

import softbodyunity_torch as tsb
from softbodyunity_torch import convert
from softbodyunity_torch.core import topology as ttopo
from softbodyunity_torch.solver.normals import vertex_normals

torch.set_num_threads(1)

SLICE_PRESETS = ["cloth_32_euler", "cloth_hanging_sphere", "cloth_bench_64k",
                 "cloth_xpbd", "cloth_bench_64k_xpbd",
                 "cloth_bench_64k_verlet", "softbody_cube",
                 "softbody_cube_xpbd_sub", "cloth_batch_rl",
                 "cloth_selfcollide_16k", "cloth_selfcollide_64k",
                 "cloth_tearing_64k", "cloth_plastic_64k",
                 "cloth_strain_limited", "cloth_strain_64k", "cloth_wind_64k"]
# tet_cube(40) is seconds of Python loops in each package: these presets are
# held equal by their configs and their builder's arguments
LATTICE_64K = ["softbody_cube_64k", "softbody_cube_64k_verlet",
               "softbody_cube_64k_xpbd"]
# the grids past 128k vertices, held equal the same way (the 1m curtain's
# arrays are ~1 GB in each package)
GRID_LARGE = ["cloth_bench_262k", "cloth_bench_1m", "cloth_tearing_262k",
              "cloth_plastic_262k"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _plain(obj):
    """asdict() output with enums as their values, so configs of the two
    packages (whose Solver enums are distinct classes) compare."""
    d = dataclasses.asdict(obj)
    d["solver"] = d["solver"].value
    return d


def _assert_hosts_equal(got, want):
    names = [f.name for f in dataclasses.fields(want)]
    assert [f.name for f in dataclasses.fields(got)] == names
    for name in names:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray), name
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)   # exact
        else:
            assert a == b, name


def test_preset_names_are_jax_presets():
    ported = SLICE_PRESETS + LATTICE_64K + GRID_LARGE
    assert set(tsb.presets.names()) == set(ported)
    assert set(ported) <= set(jpresets.names())


@pytest.mark.parametrize("name", SLICE_PRESETS)
def test_preset_config_and_arrays_match_jax(name):
    host, cfg = tsb.presets.build(name)
    jhost, jcfg = jpresets.build(name)
    assert _plain(cfg) == _plain(jcfg)
    _assert_hosts_equal(host, jhost)


@pytest.mark.parametrize("name", LATTICE_64K)
def test_64k_lattice_preset_matches_jax(name, monkeypatch):
    calls = []

    def record(*args, **kw):
        calls.append((args, {k: dataclasses.asdict(v)
                             if dataclasses.is_dataclass(v) else v
                             for k, v in kw.items()}))
        return None

    monkeypatch.setattr(jpresets, "tet_cube", record)
    monkeypatch.setattr(tsb.presets, "tet_cube", record)
    _, cfg = tsb.presets.build(name)
    _, jcfg = jpresets.build(name)
    assert _plain(cfg) == _plain(jcfg)
    assert len(calls) == 2 and calls[0] == calls[1]
    assert calls[0][0] == (40,)


@pytest.mark.parametrize("name,side", [
    ("cloth_bench_262k", 512), ("cloth_bench_1m", 1024),
    ("cloth_tearing_262k", 512), ("cloth_plastic_262k", 512)])
def test_large_grid_preset_matches_jax(name, side, monkeypatch):
    calls = []

    def record(*args, **kw):
        calls.append((args, {k: dataclasses.asdict(v)
                             if dataclasses.is_dataclass(v) else v
                             for k, v in kw.items()}))
        return None

    monkeypatch.setattr(jpresets, "cloth_grid", record)
    monkeypatch.setattr(tsb.presets, "cloth_grid", record)
    _, cfg = tsb.presets.build(name)
    _, jcfg = jpresets.build(name)
    assert _plain(cfg) == _plain(jcfg)
    assert len(calls) == 2 and calls[0] == calls[1]
    assert calls[0][0] == (side, side)


@pytest.mark.parametrize("kw", [
    dict(pinned=("corners", "bl", 5), shear=False, bend=True),
    dict(pinned=("left", "right", "top", "bottom"), orientation="xz",
         mass=0.3, origin=(0.5, -1.0, 2.0)),
    dict(pinned=("br",), shear=True, bend=False, spacing=0.07,
         sphere_centers=[[0.1, -0.2, 0.0], [0.4, 0.0, 0.1]],
         sphere_radii=[0.1, 0.2], plane_height=-2.5),
])
def test_cloth_grid_matches_jax(kw):
    _assert_hosts_equal(ttopo.cloth_grid(7, 5, **kw),
                        jtopo.cloth_grid(7, 5, **kw))


def test_self_collision_params_match_jax():
    """The copied SelfCollisionParams: the same fields, defaults and
    types."""
    from softbodyunity_tpu.core.config import SelfCollisionParams as J

    assert ([(f.name, f.type, f.default) for f in dataclasses.fields(
        tsb.SelfCollisionParams)]
        == [(f.name, f.type, f.default) for f in dataclasses.fields(J)])
    jp = J(enabled=True, method="block", radius=0.01, block_partners=32)
    assert dataclasses.asdict(convert.config_from_dict(dataclasses.asdict(
        jpresets.build("cloth_32_euler")[1].replace(
            self_collision=jp))).self_collision) == dataclasses.asdict(jp)


_COLLIDERS = [
    dict(capsule_p0=[[-0.3, 0.0, 0.0]], capsule_p1=[[0.05, 0.0, 0.0]],
         capsule_radii=[0.12], box_centers=[[0.18, -0.05, 0.1]],
         box_half_extents=[[0.15, 0.1, 0.12]]),
    dict(capsule_p0=[[0, 0, 0], [1, 0, 0]], capsule_p1=[[0, 1, 0], [1, 1, 0]],
         capsule_radii=[0.1, 0.2], capsule_velocities=[[0.3, 0, 0], [0, 0, 1]],
         box_centers=[0.2, 0.1, 0.0], box_half_extents=[0.1, 0.2, 0.3],
         box_rotations=[[[0, -1, 0], [1, 0, 0], [0, 0, 1]]],
         box_velocities=[[0.0, 0.5, 0.0]], plane_velocity=[0.5, 0.0, 0.1],
         sphere_velocities=[[0.1, 0.0, 0.0]]),
    dict(sdf_grids=np.zeros((4, 4, 4)), sdf_origins=[0.0, 0.0, 0.0],
         sdf_spacings=[0.1], sdf_velocities=[[0.0, 0.0, 1.0]]),
]


@pytest.mark.parametrize("kw", _COLLIDERS)
def test_add_colliders_matches_jax(kw):
    """The copied add_colliders fills the same fields with the same arrays
    (box_rotations defaults to identity)."""
    grid = dict(sphere_centers=[[0.0, -0.5, 0.0]], sphere_radii=[0.2])
    _assert_hosts_equal(
        ttopo.add_colliders(ttopo.cloth_grid(5, 4, **grid), **kw),
        jtopo.add_colliders(jtopo.cloth_grid(5, 4, **grid), **kw))


@pytest.mark.parametrize("kw,match", [
    # tests/test_colliders.py:345's cases
    (dict(capsule_p0=[[0, 0, 0]], capsule_p1=[[1, 0, 0]],
          capsule_radii=[0.1, 0.2]), "disagree"),
    (dict(box_centers=[[0, 0, 0]], box_half_extents=[[0.1] * 3, [0.2] * 3]),
     "disagree"),
    (dict(box_centers=[[0, 0, 0]], box_half_extents=[[0.1] * 3],
          box_rotations=np.broadcast_to(np.eye(3), (2, 3, 3))),
     "box_rotations"),
    # a partial capsule or box, and velocities of the wrong count
    (dict(capsule_p0=[[0, 0, 0]], capsule_radii=[0.1]), "capsules need"),
    (dict(box_half_extents=[[0.1] * 3]), "boxes need box_centers"),
    (dict(box_centers=[[0, 0, 0]]), "box_half_extents"),
    (dict(capsule_p0=[[0, 0, 0]], capsule_p1=[[1, 0, 0]], capsule_radii=[0.1],
          capsule_velocities=[[0, 0, 0], [0, 0, 0]]), "capsule_velocities"),
    (dict(sdf_grids=np.zeros((4, 4, 4))), "sdf colliders need"),
])
def test_add_colliders_rejects_as_jax(kw, match):
    for module in (ttopo, jtopo):
        with pytest.raises(ValueError, match=match):
            module.add_colliders(module.cloth_grid(4, 4, spacing=0.1), **kw)


def test_cloth_grid_rejects_unknown_pin():
    with pytest.raises(ValueError):
        ttopo.cloth_grid(4, 4, pinned=("middle",))


@pytest.mark.parametrize("name", SLICE_PRESETS[:2])
def test_convert_host_and_config_from_jax(name):
    jhost, jcfg = jpresets.build(name)
    host = convert.host_from_arrays(
        {f.name: getattr(jhost, f.name) for f in dataclasses.fields(jhost)})
    _assert_hosts_equal(host, jhost)
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    assert cfg == tsb.presets.build(name)[1]
    # the same dict after a JSON round trip (lists, enum values)
    via_json = json.loads(json.dumps(_plain(jcfg)))
    assert convert.config_from_dict(via_json) == cfg
    with pytest.raises(TypeError):
        convert.config_from_dict({"no_such_field": 1})


def test_convert_state_from_arrays():
    rng = np.random.default_rng(0)
    x, v, xp = (rng.standard_normal((12, 3)) for _ in range(3))
    s = convert.state_from_arrays(x, v, xp, device="cpu",
                                  dtype=torch.float64)
    for got, want in ((s.x, x), (s.v, v), (s.x_prev, xp)):
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
    # a copy: later host edits do not reach the device state
    x[0, 0] = 99.0
    assert s.x[0, 0].item() != 99.0


@pytest.mark.parametrize("name", SLICE_PRESETS)
def test_suggest_dt_matches_jax(name):
    host, cfg = tsb.presets.build(name)
    jhost, jcfg = jpresets.build(name)
    assert tsb.suggest_dt(host, cfg) == japi.suggest_dt(jhost, jcfg)


@pytest.mark.parametrize("dtype,atol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
def test_vertex_normals_match_jax(dtype, atol):
    """Seeded random cloth shape; f32 tolerance covers the different
    summation order of index_add_ vs segment_sum (a few ulps of the sums,
    magnified by the normalisation of near-flat sums)."""
    host = ttopo.cloth_grid(9, 6, spacing=0.1, orientation="xy")
    rng = np.random.default_rng(1)
    x = host.positions0 + 0.03 * rng.standard_normal(host.positions0.shape)
    tri = torch.tensor(host.triangles, dtype=torch.int64)
    got = vertex_normals(tri, torch.tensor(x, dtype=dtype)).numpy()
    if dtype == torch.float64:
        from softbodyunity_tpu.oracle.reference import vertex_normals as ref
        want = ref(host.triangles, x)
    else:
        want = np.asarray(j_vertex_normals(jnp.asarray(host.triangles),
                                           jnp.asarray(x, jnp.float32)))
    np.testing.assert_allclose(got, want, atol=atol)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=atol)


def test_package_imports_no_jax():
    code = ("import sys, softbodyunity_torch\n"
            "import softbodyunity_torch.kernels.grid_euler\n"
            "import softbodyunity_torch.kernels.grid_verlet\n"
            "import softbodyunity_torch.kernels.grid_xpbd\n"
            "import softbodyunity_torch.kernels.lattice_euler\n"
            "import softbodyunity_torch.kernels.lattice_verlet\n"
            "import softbodyunity_torch.kernels.lattice_xpbd\n"
            "import softbodyunity_torch.kernels.blocks\n"
            "import softbodyunity_torch.kernels.grid_features\n"
            "import softbodyunity_torch.kernels.grid_strain\n"
            "import softbodyunity_torch.solver.blocksparse\n"
            "import softbodyunity_torch.solver.forces\n"
            "import softbodyunity_torch.solver.step\n"
            "import softbodyunity_torch.solver.collide\n"
            "import softbodyunity_torch.kernels.dispatch\n"
            "import softbodyunity_torch.convert\n"
            "import softbodyunity_torch.parallel.ring\n"
            "import softbodyunity_torch.parallel.halo\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(("
            "'jax.', 'jaxlib', 'softbodyunity_tpu'))]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
