"""softbodyunity_torch's copies of the framework-free layers, held equal to
the JAX package: config, grid builder, presets, the state hand-off in
``convert``, ``suggest_dt``, vertex normals, and the no-jax import rule."""

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

SLICE_PRESETS = ["cloth_32_euler", "cloth_hanging_sphere", "cloth_bench_64k"]
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
    assert set(tsb.presets.names()) == set(SLICE_PRESETS)
    assert set(SLICE_PRESETS) <= set(jpresets.names())


@pytest.mark.parametrize("name", SLICE_PRESETS)
def test_preset_config_and_arrays_match_jax(name):
    host, cfg = tsb.presets.build(name)
    jhost, jcfg = jpresets.build(name)
    assert _plain(cfg) == _plain(jcfg)
    _assert_hosts_equal(host, jhost)


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
            "import softbodyunity_torch.kernels.dispatch\n"
            "import softbodyunity_torch.convert\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(("
            "'jax.', 'jaxlib', 'softbodyunity_tpu'))]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
