"""The tet cube's lattice Euler path: the host-phase spans of its card
wrapper (``kernels/lattice_euler.py``) under the recorder, on the CPU with
the C call stood in for, and on the card the 64k cube stepped through
``sb.step`` against the benchmark's plain float64 reference
(``benchmark/reference/tet_cube.py``).  The card test skips without a CUDA
device; the file imports no jax, so on the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cube.py
"""

import contextlib
import json
import os
import types

import pytest
import torch

import softbodyunity_torch as tsb
from softbodyunity_torch import api
from softbodyunity_torch.kernels import build, dispatch, lattice, lattice_euler
from softbodyunity_torch.kernels.grid_scene import ColliderRows
from softbodyunity_torch.utils import profiling

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# span -> its parent, in a frame of the lattice Euler wrapper
PARENTS = {
    "api.step": None,
    "api.lookup": "api.step",
    "lattice_euler.planes_in": "api.step",
    "lattice_euler.pack": "api.step",
    "lattice_euler.call": "api.step",
    "lattice_euler.planes_out": "api.step",
}


@pytest.fixture
def recorder():
    """The recorder off before and after the test."""
    profiling.disable()
    yield profiling
    profiling.disable()


@pytest.fixture
def wrapper_on_cpu(monkeypatch):
    """``sb.step`` on a CPU tet cube routed to ``lattice_euler``'s card
    wrapper, whose host phases run as on the card: the scene's tables are
    zeros of the card's shapes and each C call counts three launches and
    changes nothing, so the state comes back as it went in.  Yields the
    list of the C calls made."""
    calls = []

    def substep(args, planes, launched):
        launched._obj.value = 3
        calls.append(args)
        return 0

    def pack(top, cfg, solver, kernel):
        n = top.n_vertices
        return lattice.LatticeScene(
            device=top.device, n=n, inv_mass=top.inv_mass,
            bits=lattice.ownership_bits(top, True),
            edges=torch.zeros((len(top.offset_groups.deltas), 3)),
            tets=torch.zeros((len(top.tet_groups.deltas), 4)),
            cnt=torch.ones(n), colliders=ColliderRows(top, cfg))

    monkeypatch.setattr(build, "load_library", lambda name: types.SimpleNamespace(
        lattice_euler_substep=substep,
        lattice_euler_error_string=lambda err: b"stood in"))
    lib = build.Library("lattice_euler")
    lib.declare("lattice_euler_substep", [])
    monkeypatch.setattr(lattice_euler, "_library", lambda: lib)
    monkeypatch.setattr(lattice_euler, "pack_lattice_scene", pack)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(dispatch, "_lattice_step",
                        lambda top, cfg: lattice_euler.make_cuda_step(top,
                                                                      cfg))
    api._build_step.cache_clear()
    yield calls
    api._build_step.cache_clear()


def _cube(n_substeps=4):
    cfg = tsb.SimConfig(
        springs=tsb.SpringParams(k_structural=500.0, damping=0.5),
        collision=tsb.CollisionParams(enable_plane=True, friction=0.4),
        global_damping=0.5, volume_stiffness=0.5, n_substeps=n_substeps)
    host = tsb.tet_cube(5, spacing=0.02, mass=0.01, springs=cfg.springs,
                        xpbd=cfg.xpbd, plane_height=0.0,
                        origin=(0.0, 1.0, 0.0))
    top, state = tsb.init(host, device="cpu")
    return top, cfg, state


def test_tet_box_is_the_cube_with_a_size_on_each_side():
    """``tet_cube(n)`` is ``tet_box(n, n, n)``; a box that is no cube has
    its own lattice shape, positive rest volumes and its two k-faces, and
    steps on the plain CPU path through the lattice gate."""
    import dataclasses

    import numpy as np

    kw = dict(spacing=0.02, mass=0.01, origin=(0.0, 1.0, 0.0))
    cube, box = tsb.tet_cube(4, **kw), tsb.tet_box(4, 4, 4, **kw)
    for field in dataclasses.fields(cube):
        a, b = getattr(cube, field.name), getattr(box, field.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), field.name
        else:
            assert a == b, field.name
    host = tsb.tet_box(5, 6, 7, **kw)
    assert host.lattice_shape == (5, 6, 7)
    assert host.positions0.shape == (210, 3) and host.tets.shape == (600, 4)
    assert host.triangles.shape == (2 * 4 * 5 * 2, 3)
    assert bool((host.rest_volume > 0).all())
    assert host.rest_volume.sum() == pytest.approx(4 * 5 * 6 * 0.02 ** 3)
    top, state = tsb.init(host, device="cpu", dtype=torch.float64)
    cfg = tsb.SimConfig(volume_stiffness=0.5, n_substeps=4)
    lattice.lattice_gate(top, cfg)
    out = tsb.step(top, cfg, state)
    assert bool(torch.isfinite(out.x).all())
    assert float(out.x[:, 1].mean()) < float(state.x[:, 1].mean())


def test_wrapper_records_no_span_while_off(recorder, wrapper_on_cpu):
    top, cfg, state = _cube()
    recorder.enable()
    recorder.disable()
    out = tsb.step(top, cfg, state)
    assert len(wrapper_on_cpu) == cfg.n_substeps
    assert torch.equal(out.x, state.x)
    rec = recorder.read()
    assert rec.names == [] and rec.calls == {} and rec.self_ns == {}


def test_wrapper_spans_of_a_frame(recorder, wrapper_on_cpu):
    """One frame: the four ``lattice_euler.*`` spans nested under
    ``api.step``, ``.call`` once a substep around each C call, the launch
    counter as with the recorder off."""
    top, cfg, state = _cube()
    tsb.step(top, cfg, state)                 # the step function built
    lattice_euler.reset_launch_count()
    recorder.enable()
    out = tsb.step(top, cfg, state)
    rec = recorder.read()
    assert torch.equal(out.x, state.x) and torch.equal(out.v, state.v)
    assert lattice_euler.launch_count() == 3 * cfg.n_substeps
    assert set(rec.names) == set(PARENTS)
    for i, name in enumerate(rec.names):
        p = rec.parent[i]
        assert (rec.names[p] if p >= 0 else None) == PARENTS[name]
        assert rec.end_ns[i] >= rec.start_ns[i] > 0 and rec.frame[i] == 1
    assert rec.calls["lattice_euler.call"] == cfg.n_substeps
    for name in ("api.step", "lattice_euler.planes_in", "lattice_euler.pack",
                 "lattice_euler.planes_out"):
        assert rec.calls[name] == 1
    # the phases in order: planes in, pack, the calls, planes out
    first = {name: rec.names.index(name) for name in PARENTS}
    assert (first["lattice_euler.planes_in"] < first["lattice_euler.pack"]
            < first["lattice_euler.call"] < first["lattice_euler.planes_out"])


def _reference_module():
    import importlib.util

    path = os.path.join(ROOT, "benchmark", "reference", "tet_cube.py")
    spec = importlib.util.spec_from_file_location("tet_cube_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the "
                    "card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cube64k_frame_on_the_card_against_the_float64_reference(cuda):
    """The benchmark's 64k cube (``benchmark/configs/cube64k.json``, the
    preset ``softbody_cube_64k``) from a seeded spinning start, one frame
    through ``sb.step`` on the card (``csrc/lattice_euler.cu``), against
    the plain reference in float64 from the same float32 state.  Bounds:
    float32 arithmetic with float32 rest tables over 16 substeps puts a
    vertex 3.6-3.7e-7 m, its velocity 1.4e-4 m/s and a normal 1.1-1.3e-7
    from float64 in free fall (three seeds on the H100); 2e-6 m, 1e-3 m/s
    and 1e-5 leave room while the frame moves vertices 1-2 cm."""
    ref_mod = _reference_module()
    with open(os.path.join(ROOT, "benchmark", "configs", "cube64k.json")) as f:
        config = json.load(f)
    from benchmark import scene

    host, cfg = scene.build(tsb, config)
    top, _ = tsb.init(host, device=cuda)
    x = ref_mod.rest_positions(config["scene"]).to(cuda, torch.float32)
    v = ref_mod.start_velocity(config, scene.episode_generator(2**31 + 5, 0),
                               cuda)
    lattice_euler.reset_launch_count()
    out = tsb.step(top, cfg, tsb.State(x=x, v=v, x_prev=x - cfg.dt * v))
    assert lattice_euler.launch_count() == 3 * cfg.n_substeps
    ref = ref_mod.Reference(config, dtype=torch.float64, device=cuda)
    xr, vr = ref.frame(x, v)
    err = (out.x.double() - xr).norm(dim=1).max().item()
    moved = (xr - x.double()).norm(dim=1).max().item()
    assert err < 2e-6 and moved > 1e-3, (err, moved)
    assert (out.v.double() - vr).norm(dim=1).max().item() < 1e-3
    normals = tsb.normals(top, out)
    assert (normals.double() - ref.normals(out.x)).norm(
        dim=1).max().item() < 1e-5
