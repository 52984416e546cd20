"""The vertex normals' kernel path (``kernels/normals.py``,
``csrc/normals.cu``): on the CPU, its incident-face table against the plain
version's, the plain version for every scene on the CPU, a routed call
with the C call stood in for (its arguments and entry per dtype, the
launch counter, the ``normals.call`` span, the refusal of positions that
require grad) and the cache of the scenes' normals; on the card, the
kernel against the plain version on the curtain, the pile, the 64k cube's
surface and a small mesh of odd cases, in float64 too, and run to run
into NaN-filled memory.  The card tests skip without a CUDA device; the file
imports no jax, so on the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_normals.py
"""

import json
import re
import types

import numpy as np
import pytest
import torch

import softbodyunity_torch as tsb
from softbodyunity_torch import api
from softbodyunity_torch.core.topology import SceneKey
from softbodyunity_torch.kernels import normals as nk
from softbodyunity_torch.solver.normals import incident_faces, vertex_normals
from softbodyunity_torch.utils import profiling

torch.set_num_threads(1)


def _odd_mesh():
    """``(triangles, x)`` float64: a fan of 10 faces round a pole (valence
    10 > 6) on a jittered disc; a zero-area face (two corners at one
    point); and two faces on the same three vertices wound both ways, on
    integer coordinates, so their normals cancel exactly and those three
    vertices' normals are zero vectors."""
    n_ring = 10
    ring = np.arange(1, n_ring + 1)
    fan = np.stack([np.zeros(n_ring, np.int64), ring, np.roll(ring, -1)], 1)
    angle = 2.0 * np.pi * np.arange(n_ring) / n_ring
    rng = np.random.default_rng(9)
    disc = np.concatenate([[[0.0, 0.0, 0.3]], np.stack(
        [np.cos(angle), np.sin(angle), np.zeros(n_ring)], 1)])
    disc = disc + 0.02 * rng.standard_normal(disc.shape)
    flat = np.array([[11, 12, 13]])                       # zero area
    flat_x = np.array([[2.0, 0.0, 0.0], [2.0, 0.0, 0.0], [3.0, 1.0, 0.0]])
    pair = np.array([[14, 15, 16], [14, 16, 15]])         # cancelling
    pair_x = np.array([[0.0, 3.0, 1.0], [2.0, 3.0, 0.0], [1.0, 5.0, 2.0]])
    tri = np.concatenate([fan, flat, pair])
    return tri, np.concatenate([disc, flat_x, pair_x])


def _meshes():
    """name -> ``(triangles int64, n_vertices)`` of the meshes the scenes
    render: a cloth grid, a small tet cube's surface, the odd mesh and a
    random mesh of high valence."""
    grid = tsb.cloth_grid(9, 7, spacing=0.1, orientation="xy")
    cube = tsb.tet_cube(4, spacing=0.1)
    odd, x = _odd_mesh()
    rng = np.random.default_rng(4)
    return {
        "grid": (torch.tensor(grid.triangles), grid.positions0.shape[0]),
        "cube_surface": (torch.tensor(cube.triangles),
                         cube.positions0.shape[0]),
        "odd": (torch.tensor(odd), x.shape[0]),
        "random": (torch.tensor(rng.integers(0, 60, (300, 3))), 64),
    }


@pytest.mark.parametrize("mesh", ["grid", "cube_surface", "odd", "random"])
def test_face_table_is_incident_faces_column_by_column(mesh):
    """The kernel's int32 ``[D, N]`` table is the plain ``[N, D]`` table
    transposed, every slot and pad (``F``) alike; pads end each row, where
    the kernel stops."""
    tri, n = _meshes()[mesh]
    plain = incident_faces(tri, n)
    table = nk.face_table(tri, n)
    assert table.dtype == torch.int32 and table.is_contiguous()
    assert tuple(table.shape) == (plain.shape[1], n)
    for v in range(n):
        assert torch.equal(table[:, v].long(), plain[v]), v
    pad = table == tri.shape[0]
    assert bool((pad[1:] >= pad[:-1]).all())   # no face after a pad


def test_scene_struct_mirrors_the_source():
    """``_Scene`` lists ``csrc/normals.cu``'s ``NormalsScene`` fields in
    order, pointers as pointers and ints as ints."""
    from pathlib import Path

    src = (Path(nk.__file__).resolve().parent / "csrc" /
           "normals.cu").read_text()
    body = re.search(r"struct NormalsScene \{(.*?)\};", src, re.S).group(1)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        words = re.findall(r"[A-Za-z_]\w*", decl)
        if "*" in decl:                    # const int* name
            fields.append((words[-1], "p"))
        else:                              # int a, b, c
            fields += [(name, "i") for name in words[1:]]
    import ctypes

    got = [(name, "p" if t is ctypes.c_void_p else "i")
           for name, t in nk._Scene._fields_]
    assert got == fields


@pytest.fixture
def fresh_cache(monkeypatch):
    """``api.normals``' cache of the scenes' normals empty before and after
    the test."""
    api._normals_of.cache_clear()
    monkeypatch.setattr(api, "_last_normals", (None, None))
    yield
    api._normals_of.cache_clear()
    api._last_normals = (None, None)


@pytest.fixture
def recorder():
    """The recorder off before and after the test."""
    profiling.disable()
    yield profiling
    profiling.disable()


def _cloth(dtype=torch.float32):
    host = tsb.cloth_grid(12, 9, spacing=0.1, orientation="xy")
    top, s = tsb.init(host, device="cpu", dtype=dtype)
    rng = np.random.default_rng(6)
    x = s.x + torch.tensor(0.03 * rng.standard_normal(tuple(s.x.shape)),
                           dtype=dtype)
    return top, s.replace(x=x)


@pytest.mark.parametrize("case", ["cpu", "float64", "requires_grad"])
def test_plain_path_takes_cpu_float64_and_autograd(case, monkeypatch,
                                                   fresh_cache):
    """On the CPU ``api.normals`` gives the plain version's bits and
    launches nothing, for float32, for float64 and for an ``x`` that
    requires grad (whose normals keep the graph): the device alone
    decides."""
    def refuse(top):
        raise AssertionError("the kernel path was taken")

    monkeypatch.setattr(nk, "NormalsScene", refuse)
    top, s = _cloth(torch.float64 if case == "float64" else torch.float32)
    x = s.x.clone().requires_grad_(case == "requires_grad")
    before = nk.launch_count()
    got = tsb.normals(top, s.replace(x=x))
    assert nk.launch_count() == before
    assert torch.equal(got, vertex_normals(top.triangles, x))
    if case == "requires_grad":
        got.sum().backward()
        assert x.grad is not None and bool(torch.isfinite(x.grad).all())


@pytest.fixture
def kernel_on_cpu(monkeypatch, fresh_cache):
    """``api.normals`` on a CPU float32 tensor routed to the kernel's
    wrapper, whose host side runs as on the card: the device type set to
    the CPU's and each dtype's C entry stood in for by one that records its
    arguments and launches nothing.  Yields the list of the calls."""
    calls = []

    def entry(dtype):
        def call(ref, x, out, stream):
            scene = ref._obj
            calls.append(dict(x=x, out=out, stream=stream, n=scene.n,
                              n_face=scene.n_face, depth=scene.depth,
                              tris=scene.tris, table=scene.table,
                              device=scene.device, dtype=dtype))
            return 0
        return call

    monkeypatch.setattr(nk, "DEVICE_TYPE", "cpu")
    monkeypatch.setattr(nk, "_launchers", lambda: (
        {d: entry(d) for d in (torch.float32, torch.float64)}, None))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    yield calls


def test_card_call_is_one_c_call_into_a_new_output(kernel_on_cpu, recorder):
    """A routed call is one C call with the scene's tables, ``x`` and a new
    output on the current stream, counted once; a second call gets another
    output, so two frames' normals never alias; the recorder off, no
    span."""
    top, s = _cloth()
    recorder.enable()
    recorder.disable()
    before = nk.launch_count()
    a = tsb.normals(top, s)
    b = tsb.normals(top, s)
    assert nk.launch_count() == before + 2
    assert [c["out"] for c in kernel_on_cpu] == [a.data_ptr(), b.data_ptr()]
    assert a.data_ptr() != b.data_ptr()
    assert tuple(a.shape) == (top.n_vertices, 3) and a.dtype == torch.float32
    scene = api._normals_of(SceneKey(top))
    assert isinstance(scene, nk.NormalsScene)
    for c in kernel_on_cpu:
        assert c["x"] == s.x.data_ptr() and c["stream"] == 0
        assert c["device"] == 0 and c["dtype"] == torch.float32
        assert (c["n"], c["n_face"], c["depth"]) == (
            top.n_vertices, top.triangles.shape[0], scene.table.shape[0])
        assert (c["tris"], c["table"]) == (scene.tris.data_ptr(),
                                           scene.table.data_ptr())
    assert torch.equal(scene.tris.long(), top.triangles)
    assert torch.equal(scene.table,
                       nk.face_table(top.triangles, top.n_vertices))
    assert recorder.read().names == []


def test_card_call_span_under_api_normals(kernel_on_cpu, recorder):
    """While the recorder is on, a routed call is ``normals.call`` inside
    ``api.normals``, once a call, and none of the plain path's spans."""
    top, s = _cloth()
    tsb.normals(top, s)                      # the scene packed
    recorder.enable()
    tsb.normals(top, s)
    tsb.normals(top, s)
    rec = recorder.read()
    assert sorted(set(rec.names)) == ["api.normals", "normals.call"]
    assert rec.calls == {"api.normals": 2, "normals.call": 2}
    for i, name in enumerate(rec.names):
        p = rec.parent[i]
        assert (rec.names[p] if p >= 0 else None) == (
            "api.normals" if name == "normals.call" else None)
        assert rec.end_ns[i] >= rec.start_ns[i] > 0


def test_card_call_takes_float64_through_its_own_entry(kernel_on_cpu):
    """Float64 positions on the card go to the kernel too, through the C
    entry of their dtype, into a float64 output."""
    top, s = _cloth(torch.float64)
    got = tsb.normals(top, s)
    assert [c["dtype"] for c in kernel_on_cpu] == [torch.float64]
    assert kernel_on_cpu[0]["x"] == s.x.data_ptr()
    assert kernel_on_cpu[0]["out"] == got.data_ptr()
    assert got.dtype == torch.float64


def test_card_call_refuses_positions_that_require_grad(kernel_on_cpu):
    """On the card positions that require grad raise: the kernel has no
    backward, and nothing degrades to the plain version."""
    top, s = _cloth()
    x = s.x.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        tsb.normals(top, s.replace(x=x))
    assert kernel_on_cpu == []


def test_normals_keep_a_scene_for_moved_colliders(kernel_on_cpu):
    """The topology last asked for finds its scene by identity, without a
    ``SceneKey``; a topology from ``move_colliders`` gets the same scene
    through its ``SceneKey``; another scene (a second ``init``) gets a new
    one, and the first scene stays cached."""
    host = tsb.cloth_grid(6, 5, spacing=0.1, orientation="xy",
                          plane_height=-1.0)
    top, s = tsb.init(host, device="cpu")
    tsb.normals(top, s)
    first = api._last_normals[1]
    assert isinstance(first, nk.NormalsScene)
    lookups = api._normals_of.cache_info()
    tsb.normals(top, s)
    assert api._normals_of.cache_info() == lookups   # the slot alone
    moved = tsb.move_colliders(top, plane_height=-0.5)
    tsb.normals(moved, s)
    assert moved is not top and api._last_normals == (moved, first)
    other, _ = tsb.init(host, device="cpu")
    tsb.normals(other, s)
    assert api._last_normals[1] is not first
    tsb.normals(top, s)
    assert api._last_normals[1] is first
    assert api._normals_of.cache_info().misses == 2


def test_scene_checks_its_inputs(monkeypatch):
    """A scene refuses a topology off the kernel's device, a triangle that
    names a vertex out of range, and positions of another shape, of a dtype
    other than float32 and float64, or that require grad."""
    top, s = _cloth()
    with pytest.raises(ValueError, match="cuda"):
        nk.NormalsScene(top)
    monkeypatch.setattr(nk, "DEVICE_TYPE", "cpu")
    scene = nk.NormalsScene(top)
    with pytest.raises(ValueError, match="take"):
        scene(s.x[:-1])
    with pytest.raises(TypeError, match="float32 and float64"):
        scene(s.x.half())
    with pytest.raises(NotImplementedError, match="requires grad"):
        scene(s.x.clone().requires_grad_(True))
    bad = top.triangles.clone()
    bad[3, 1] = top.n_vertices
    import dataclasses

    with pytest.raises(ValueError, match="outside"):
        nk.NormalsScene(dataclasses.replace(top, triangles=bad))


# -- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the "
                    "card")
    return torch.device("cuda")


def _card_scene(name, device):
    """``(top, x)`` on the card: the 64k curtain perturbed, the 64k pile
    after 30 frames, the 64k cube's surface crumpled, the odd mesh."""
    rng = np.random.default_rng(17)
    if name == "odd":
        tri, x = _odd_mesh()
        host = tsb.cloth_grid(2, 2, spacing=0.1)
        top, _ = tsb.init(host, device=device)
        import dataclasses

        top = dataclasses.replace(
            top, triangles=torch.tensor(tri, device=device),
            n_vertices=x.shape[0])
        return top, torch.tensor(x, dtype=torch.float32, device=device)
    preset = {"curtain": "cloth_bench_64k", "pile": "cloth_selfcollide_64k",
              "cube": "softbody_cube_64k"}[name]
    host, cfg = tsb.presets.build(preset)
    top, s = tsb.init(host, device=device)
    if name == "pile":
        for _ in range(30):
            s = tsb.step(top, cfg, s)
        return top, s.x
    scale = 0.01 if name == "curtain" else 0.005
    return top, s.x + torch.tensor(
        scale * rng.standard_normal(tuple(s.x.shape)), dtype=torch.float32,
        device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["curtain", "pile", "cube", "odd"])
def test_kernel_matches_plain_on_card(cuda, name, fresh_cache):
    """``sb.normals`` on the card (one launch) against the plain version
    on the card from the same x: within 1e-5 a component, the card-vs-CPU
    tolerance (the plain cross product may contract into FMAs, and a
    vertex whose faces nearly cancel magnifies a few ulps).  Prints the
    largest difference and its 99.9th percentile.  On the odd mesh the
    cancelling vertices' normals are zero vectors in both, as is the
    zero-area face's corners."""
    top, x = _card_scene(name, cuda)
    s = tsb.State(x=x, v=torch.zeros_like(x), x_prev=x)
    before = nk.launch_count()
    got = tsb.normals(top, s)
    torch.cuda.synchronize()
    assert nk.launch_count() == before + 1
    want = vertex_normals(top.triangles, x,
                          incident_faces(top.triangles, top.n_vertices))
    d = (got - want).abs()
    flat = d.flatten().double()
    print(json.dumps({"normals_vs_plain": name, "max": float(flat.max()),
                      "p999": float(torch.quantile(flat[:2 ** 24], 0.999)),
                      "vertices": top.n_vertices}))
    assert float(d.max()) <= 1e-5, float(d.max())
    assert bool(torch.isfinite(got).all())
    if name == "odd":
        zero = torch.zeros(3, device=cuda)
        for v in range(11, 17):
            assert torch.equal(got[v], zero) and torch.equal(want[v], zero)


@pytest.mark.cuda
def test_kernel_repeats_bit_equal_into_nan_filled_memory_on_card(
        cuda, fresh_cache):
    """24 calls of the kernel on the crumpled curtain, each into an output
    drawn from NaN-filled memory: every call the first's bits, one launch
    each."""
    top, x = _card_scene("curtain", cuda)
    s = tsb.State(x=x, v=torch.zeros_like(x), x_prev=x)
    want = tsb.normals(top, s)
    before = nk.launch_count()
    from test_torch_cuda import _poison_allocator

    for k in range(24):
        _poison_allocator(cuda)
        assert torch.equal(tsb.normals(top, s), want), k
    assert nk.launch_count() == before + 24


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["curtain", "odd"])
def test_kernel_matches_plain_in_float64_on_card(cuda, name, fresh_cache):
    """Float64 positions on the card take the kernel (one launch, a
    float64 output) and agree with the plain version's float64 run on the
    card within 1e-12 a component: rounding of float64, magnified where
    faces nearly cancel.  Prints the largest difference."""
    top, x = _card_scene(name, cuda)
    x = x.double()
    s = tsb.State(x=x, v=torch.zeros_like(x), x_prev=x)
    before = nk.launch_count()
    got = tsb.normals(top, s)
    torch.cuda.synchronize()
    assert nk.launch_count() == before + 1 and got.dtype == torch.float64
    want = vertex_normals(top.triangles, x)
    d = float((got - want).abs().max())
    print(json.dumps({"normals_vs_plain_f64": name, "max": d}))
    assert d <= 1e-12, d


@pytest.mark.cuda
def test_card_refuses_positions_that_require_grad(cuda, fresh_cache):
    """On the card positions that require grad raise and launch nothing:
    the kernel has no backward (ROADMAP Queue 1 item 9)."""
    host = tsb.cloth_grid(40, 30, spacing=0.05, orientation="xy")
    top, s = tsb.init(host, device=cuda)
    x = s.x.clone().requires_grad_(True)
    before = nk.launch_count()
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        tsb.normals(top, s.replace(x=x))
    assert nk.launch_count() == before

