"""The frame loop of the CUDA step wrappers (``kernels/frame.py``) on the
CPU, its C calls stood in for by Python functions that record them: the
call schedule with and without a force plane, the force plane evaluated on
the planes the wrapper names, the launches counted under the wrapper's
name, a nonzero code raised with the library's own error string, the four
host-phase spans nested in ``api.step``, and a ``[N, 3]`` state through
planes and back to the bit on a grid and on a lattice.  Then each of the
six wrappers (``grid_{euler,verlet,xpbd}``, ``lattice_{euler,verlet,xpbd}``)
through ``sb.step`` with its C entry stood in for: its spans, its calls,
its count, and a frame that leaves the state as it was.  The file imports
no jax."""

import contextlib
import types

import pytest
import torch

import softbodyunity_torch as tsb
from softbodyunity_torch import api
from softbodyunity_torch.core.config import SelfCollisionParams, Solver
from softbodyunity_torch.kernels import (build, dispatch, frame, grid_euler,
                                         grid_scene, grid_verlet, grid_xpbd,
                                         lattice, lattice_euler,
                                         lattice_verlet, lattice_xpbd)
from softbodyunity_torch.utils import profiling

torch.set_num_threads(1)

PHASES = ("planes_in", "pack", "call", "planes_out")


@pytest.fixture
def recorder():
    """The recorder off before and after the test."""
    profiling.disable()
    yield profiling
    profiling.disable()


@pytest.fixture
def no_card(monkeypatch):
    """``torch.cuda``'s device context and current stream stood in for, so
    that the loop's host side runs on the CPU; ``library(name,
    **entries)`` makes a :class:`build.Library` over stand-in C entries,
    its error string ``b"stood in <code>"``."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))

    def library(name, **entries):
        cdll = types.SimpleNamespace(**entries, **{
            f"{name}_error_string": lambda err: f"stood in {err}".encode()})
        monkeypatch.setattr(build, "load_library", lambda _: cdll)
        lib = build.Library(name)
        for symbol in entries:
            lib.declare(symbol, [])
        return lib

    api._build_step.cache_clear()
    yield library
    api._build_step.cache_clear()


def _entry(calls, launches=1, err=0):
    """A stand-in C entry: records its arguments, reports ``launches``
    through its last argument (the launches' out pointer) and returns
    ``err``."""
    def entry(*args):
        calls.append(args)
        args[-1]._obj.value = launches
        return err
    return entry


def _slots(n):
    """A stand-in for ``grid_xpbd_resident_slots``: ``n`` resident CTAs."""
    def entry(out):
        out._obj.value = n
        return 0
    return entry


def _scene(shape):
    """What the loop reads of a packed scene."""
    return types.SimpleNamespace(
        device=torch.device("cpu"), inv_mass=torch.ones(shape),
        colliders=types.SimpleNamespace(built=None, args=lambda top: ()))


def _state(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    x, v, xp = (torch.randn((n, 3), generator=g) for _ in range(3))
    return tsb.State(x=x, v=v, x_prev=xp)


def _loop(lib, shape, calls, force=None, per_substep=False, after=None,
            planes=(("x", None), ("v", None))):
    """A frame loop over ``[len, 3, *shape]`` stacks whose C call is ``calls``'
    stand-in: substep k reads slot k % 2 of each pair, as a ping-pong
    kernel's."""
    entry = lib.fake_call

    def call(ctx, k0, n_run, last, f_ext, count):
        return entry(k0, n_run, last, f_ext, count)

    def planes_at(ctx, k):
        return ctx[0][k % 2], ctx[1][k % 2 if len(ctx[1]) > 1 else 0]

    def state(x, v, dt, s, edge_alive, rest_scale):
        return tsb.State(x=x, v=v, x_prev=x - dt * v)

    return frame.FrameLoop(
        "fake", lib, _scene(shape), planes,
        pack=lambda planes, bufs, dt, colliders, stream: planes, call=call,
        planes_at=planes_at, state=state, after=after,
        per_substep=per_substep, force=force)


@pytest.mark.parametrize("form", ["frame", "force", "per_substep"])
@pytest.mark.parametrize("n", [0, 1, 4])
def test_call_schedule(no_card, form, n):
    """One call ``(0, n)`` for the frame; with a force plane, or where the
    wrapper says so, one call ``(k, 1)`` a substep, the last flagged.  The
    force plane is evaluated before each call on the planes the wrapper
    names for the substep's start, and its pointer handed to the call."""
    calls, seen = [], []
    lib = no_card("fake", fake_call=_entry(calls))

    def force(x3):
        seen.append(x3)
        return torch.zeros_like(x3)

    fn = _loop(lib, (4, 5), calls, force=force if form == "force" else None,
                 per_substep=form == "per_substep")
    fn(_state(20), 0.01, n)
    got = [args[:3] for args in calls]
    if form == "frame":
        assert got == [(0, n, True)]
        assert calls[0][3] is None and seen == []
    else:
        assert got == [(k, 1, k == n - 1) for k in range(n)]
    if form == "force":
        assert len(seen) == n
        for k, x3 in enumerate(seen):
            assert tuple(x3.shape) == (3, 4, 5)
            # slot k % 2 of the x pair: the planes the wrapper names
            assert x3.data_ptr() == seen[k % 2].data_ptr()
            assert calls[k][3] is not None
        if n > 1:
            assert seen[0].data_ptr() != seen[1].data_ptr()


def test_launches_count_under_the_wrappers_name(no_card):
    """Each call's reported launches, and those the ``after`` hook made
    itself, go to the counter of the wrapper's name."""
    calls = []
    lib = no_card("fake", fake_call=_entry(calls, launches=3))
    fn = _loop(lib, (6,), calls, per_substep=True,
                 after=lambda ctx, k0, n_run, last: 2 if last else 0)
    profiling.reset_count("fake")
    fn(_state(6), 0.01, 5)
    assert len(calls) == 5
    assert profiling.count("fake") == 5 * 3 + 2


def test_nonzero_code_raises_with_the_librarys_string(no_card):
    calls = []
    lib = no_card("fake", fake_call=_entry(calls, err=719))
    fn = _loop(lib, (3, 3), calls)
    profiling.reset_count("fake")
    with pytest.raises(RuntimeError,
                       match=r"fake launch failed: cudaError 719 "
                             r"\(stood in 719\)"):
        fn(_state(9), 0.01, 2)
    assert len(calls) == 1 and profiling.count("fake") == 1


@pytest.mark.parametrize("shape", [(7, 5), (35,)], ids=["grid", "lattice"])
def test_state_to_planes_and_back_to_the_bit(no_card, shape):
    """Each field named lands in its plane, ``[3, *shape]`` (a grid's
    ``(ny, nx)``, a lattice's ``(N,)``), alone or as a slot of a stack:
    plane c holds coordinate c in vertex order; an unnamed entry is an
    empty plane of that shape; the last planes come back as the ``[N, 3]``
    state, bit for bit."""
    calls, packed = [], []
    lib = no_card("fake", fake_call=_entry(calls))
    fn = _loop(lib, shape, calls, planes=(("x", "x_prev"), ("v",), "v",
                                            None))
    fn.pack = lambda planes, bufs, dt, colliders, stream: (
        packed.append(planes) or planes)
    s = _state(35, seed=3)
    out = fn(s, 0.5, 2)
    (x, v, v1, empty), = packed
    assert tuple(x.shape) == (2, 3, *shape) and tuple(v.shape) == (1, 3,
                                                                   *shape)
    assert tuple(v1.shape) == tuple(empty.shape) == (3, *shape)
    assert v1.is_contiguous() and empty.is_contiguous()
    for plane, field in ((x[0], s.x), (x[1], s.x_prev), (v[0], s.v),
                         (v1, s.v)):
        assert torch.equal(plane.reshape(3, -1), field.t())
        assert torch.equal(frame.from_planes(plane), field)
        assert frame.from_planes(plane).is_contiguous()
    assert torch.equal(out.x, s.x) and torch.equal(out.v, s.v)


def test_input_checks(no_card):
    """The fields a wrapper reads are checked as a kernel takes them."""
    calls = []
    fn = _loop(no_card("fake", fake_call=_entry(calls)), (3, 3), calls)
    s = _state(9)
    with pytest.raises(ValueError, match="state.v has shape"):
        fn(s.replace(v=s.v[:4]), 0.01, 1)
    with pytest.raises(TypeError, match="state.x is torch.float64"):
        fn(s.replace(x=s.x.double()), 0.01, 1)
    assert calls == []


def test_spans_nest_in_api_step(no_card, recorder, monkeypatch):
    """While the recorder is on: ``<name>.planes_in``, ``.pack``, ``.call``
    (once a C call) and ``.planes_out``, each a child of ``api.step``, in
    that order; none while it is off."""
    calls = []
    lib = no_card("fake", fake_call=_entry(calls))
    host = tsb.cloth_grid(4, 4, spacing=0.1)
    top, s = tsb.init(host, device="cpu")
    cfg = tsb.SimConfig(n_substeps=3)
    fn = _loop(lib, (4, 4), calls, per_substep=True)
    monkeypatch.setattr(dispatch, "maybe_fast_step", lambda top, cfg: fn)
    recorder.enable()
    recorder.disable()
    tsb.step(top, cfg, s)
    assert recorder.read().names == []
    recorder.enable()
    tsb.step(top, cfg, s)
    rec = recorder.read()
    spans = [f"fake.{phase}" for phase in PHASES]
    assert set(rec.names) == {"api.step", "api.lookup", *spans}
    for i, name in enumerate(rec.names):
        p = rec.parent[i]
        assert (rec.names[p] if p >= 0 else None) == (
            None if name == "api.step" else "api.step")
    assert rec.calls["fake.call"] == 3
    assert all(rec.calls[name] == 1 for name in spans if name != "fake.call")
    first = [rec.names.index(name) for name in spans]
    assert first == sorted(first)


# the six wrappers: module, C entry, solver, kind of scene
WRAPPERS = [
    (grid_euler, "grid_euler_substeps", Solver.SEMI_IMPLICIT_EULER, "grid"),
    (grid_verlet, "grid_verlet_substeps", Solver.VERLET, "grid"),
    (grid_xpbd, "grid_xpbd_substep", Solver.XPBD, "grid"),
    (lattice_euler, "lattice_euler_substep", Solver.SEMI_IMPLICIT_EULER,
     "lattice"),
    (lattice_verlet, "lattice_verlet_substep", Solver.VERLET, "lattice"),
    (lattice_xpbd, "lattice_xpbd_substep", Solver.XPBD, "lattice"),
]
ONE_CALL_A_FRAME = (grid_euler, grid_verlet)


def _wrapper_scene(kind, solver, self_collision=False):
    cfg = tsb.SimConfig(
        solver=solver, n_substeps=6,
        self_collision=SelfCollisionParams(
            enabled=self_collision, method="dense", radius=0.02,
            stiffness=10.0))
    if kind == "grid":
        host = tsb.cloth_grid(8, 6, spacing=0.05, springs=cfg.springs,
                              xpbd=cfg.xpbd)
    else:
        host = tsb.tet_cube(5, spacing=0.1, springs=cfg.springs,
                            xpbd=cfg.xpbd)
    top, s = tsb.init(host, device="cpu")
    g = torch.Generator().manual_seed(5)
    s = s.replace(v=0.1 * torch.randn(s.v.shape, generator=g),
                  x_prev=s.x - 0.01 * torch.randn(s.x.shape, generator=g))
    return top, cfg, s


@pytest.fixture
def wrapper_on_cpu(no_card, monkeypatch):
    """``sb.step`` on a CPU scene routed to a wrapper's ``make_cuda_step``,
    its scene packed as on the card (the device check stood in for) and
    its C entry stood in for by one that records its calls, reports one
    launch and writes nothing (grid XPBD's occupancy query by the H100's
    264 resident CTAs, or ``slots``).  Returns ``route(module, entry)`` ->
    the list of the calls."""
    monkeypatch.setattr(grid_scene, "check_card", lambda *a: None)
    monkeypatch.setattr(lattice, "check_card", lambda *a: None)

    def route(module, entry, slots=264):
        calls = []
        entries = {entry: _entry(calls)}
        if module is grid_xpbd:
            entries["grid_xpbd_resident_slots"] = _slots(slots)
        lib = no_card(module.__name__.rsplit(".", 1)[1], **entries)
        monkeypatch.setattr(module, "_library", lambda: lib)
        monkeypatch.setattr(dispatch, "maybe_fast_step",
                            lambda top, cfg: module.make_cuda_step(top, cfg))
        api._build_step.cache_clear()
        return calls

    return route


@pytest.mark.parametrize("module,entry,solver,kind", WRAPPERS,
                         ids=[w[0].__name__.rsplit(".", 1)[1]
                              for w in WRAPPERS])
def test_wrapper_frame_through_the_loop(wrapper_on_cpu, recorder, module,
                                          entry, solver, kind):
    """A frame of six substeps whose C calls write nothing: one call a
    frame (grid Euler, Verlet) or a substep (the others), a launch counted
    each, the four ``<wrapper>.*`` spans under ``api.step``, and the state
    back as it went in (six substeps bring each ping-pong and Verlet's
    three-way rotation back to the first planes): x and the field the
    solver reads bit for bit, the third from them by the solver's rule."""
    calls = wrapper_on_cpu(module, entry)
    top, cfg, s = _wrapper_scene(kind, solver)
    name = module.__name__.rsplit(".", 1)[1]
    tsb.step(top, cfg, s)                      # the step function built
    calls.clear()
    module.reset_launch_count()
    recorder.enable()
    out = tsb.step(top, cfg, s)
    rec = recorder.read()
    n_calls = 1 if module in ONE_CALL_A_FRAME else cfg.n_substeps
    assert len(calls) == n_calls and module.launch_count() == n_calls
    spans = [f"{name}.{phase}" for phase in PHASES]
    assert set(rec.names) == {"api.step", "api.lookup", *spans}
    for i, span in enumerate(rec.names):
        p = rec.parent[i]
        assert (rec.names[p] if p >= 0 else None) == (
            None if span == "api.step" else "api.step")
    assert rec.calls[f"{name}.call"] == n_calls
    assert torch.equal(out.x, s.x)
    if solver == Solver.VERLET:
        assert torch.equal(out.x_prev, s.x_prev)
        assert torch.equal(out.v, (s.x - s.x_prev) / cfg.dt)
    else:
        assert torch.equal(out.v, s.v)
        assert torch.equal(out.x_prev, s.x - cfg.dt * s.v)


@pytest.mark.parametrize("module,entry,solver", [w[:3] for w in WRAPPERS[:3]],
                         ids=["grid_euler", "grid_verlet", "grid_xpbd"])
def test_grid_force_plane_from_the_wrappers_module(wrapper_on_cpu,
                                                   monkeypatch, module,
                                                   entry, solver):
    """With self-collision each grid wrapper calls once a substep, the
    force plane built by its own module's ``self_collision_planes_cuda``
    (the name ``benchmark/control.py``'s faults patch) and evaluated on
    the substep's start positions, and hands its pointer to that call."""
    calls = wrapper_on_cpu(module, entry)
    seen, forces = [], []

    def planes_cuda(cfg, ny, nx, device):
        def force(x3):
            seen.append((x3.data_ptr(), x3.clone()))
            forces.append(torch.zeros_like(x3))
            return forces[-1]
        return force

    monkeypatch.setattr(module, "self_collision_planes_cuda", planes_cuda)
    top, cfg, s = _wrapper_scene("grid", solver, self_collision=True)
    tsb.step(top, cfg, s)
    assert len(calls) == len(seen) == cfg.n_substeps
    ny, nx = top.grid_shape
    assert torch.equal(seen[0][1], s.x.t().reshape(3, ny, nx))
    for k, (args, (ptr, _), f) in enumerate(zip(calls, seen, forces)):
        if module is grid_xpbd:     # (struct, x, x_out, f_ext, ...)
            assert (ptr, args[3]) == (args[1], f.data_ptr())
        else:                       # (frame, first, n, finish, f_ext, ...)
            x = args[0]._obj.x
            slot = (k % 2 if module is grid_euler
                    else grid_verlet.buffers(k, False)[0])
            assert (ptr, args[4]) == (x[slot], f.data_ptr())
            assert args[1:4] == (k, 1, int(k == cfg.n_substeps - 1))


def test_grid_xpbd_hands_its_counters_only_while_recording(wrapper_on_cpu,
                                                           recorder):
    """The XPBD wrapper's struct carries the device counters' pointer (the
    last sweep's counting instantiation, ``csrc/grid_xpbd.cu``) while the
    recorder is on and null while it is off; the calls are the same."""
    calls = wrapper_on_cpu(grid_xpbd, "grid_xpbd_substep")
    top, cfg, s = _wrapper_scene("grid", Solver.XPBD)
    tsb.step(top, cfg, s)
    off = [args[0]._obj.counters for args in calls]
    calls.clear()
    recorder.enable()
    tsb.step(top, cfg, s)
    on = [args[0]._obj.counters for args in calls]
    recorder.disable()
    names = tuple(f"grid_xpbd.{n}" for n in grid_xpbd.COUNTERS)
    bufs = [buf for found, buf in profiling._live_buffers() if found == names]
    assert off == [None] * cfg.n_substeps
    assert len(on) == cfg.n_substeps and on[0] in {
        b.data_ptr() for b in bufs}
    assert len(set(on)) == 1


@pytest.mark.parametrize("slots,resident", [(264, 1), (0, 0)],
                         ids=["resident", "sweeps"])
def test_grid_xpbd_hands_its_plan_and_flags(wrapper_on_cpu, slots,
                                            resident):
    """The XPBD wrapper's struct carries its plan (resident where the
    grid's tiles fit the card's resident CTAs), and the same stage flags
    and host epoch in every call of every frame: one int a tile, zeroed
    once with the step function.  The resident substeps count once a
    frame, all of them or none."""
    calls = wrapper_on_cpu(grid_xpbd, "grid_xpbd_substep", slots)
    top, cfg, s = _wrapper_scene("grid", Solver.XPBD)
    grid_xpbd.reset_launch_count()
    s = tsb.step(top, cfg, tsb.step(top, cfg, s))
    structs = [args[0]._obj for args in calls]
    assert len(structs) == 2 * cfg.n_substeps
    assert {st.resident for st in structs} == {resident}
    assert len({st.flags for st in structs}) == 1
    assert len({st.epoch for st in structs}) == 1
    fn = api._build_step(api.SceneKey(top), cfg)
    assert fn.resident is bool(resident)
    assert fn.flags.data_ptr() == structs[0].flags
    assert fn.flags.dtype == torch.int32 and not bool(fn.flags.any())
    assert fn.flags.numel() == grid_xpbd.tiles(top.grid_shape) == 1
    assert grid_xpbd.resident_substep_count() == (
        2 * cfg.n_substeps * resident)
    assert grid_xpbd.launch_count() == 2 * cfg.n_substeps
