"""The tet cube's configuration, plain reference, roofline and readers: the
file builds the preset, the reference's own lattice is the program's, its
frame is the program's plain CPU step to rounding, and the cell runs on the
CPU at a small size."""

import json
import math
import os

import pytest
import torch

from benchmark import harness, scene, trace
from benchmark.reference import tet_cube
from benchmark.roofline import lattice_euler
from benchmark.tests import small


def config(n=None, **sim):
    """``cube64k.json``, cut to ``n`` vertices a side if given (a tuple:
    ``(nx, ny, nz)``)."""
    with open(os.path.join(small.BENCH, "configs", "cube64k.json")) as f:
        c = json.load(f)
    if n is not None:
        sides = n if isinstance(n, tuple) else (n, n, n)
        c["scene"].update(zip(("nx", "ny", "nz"), sides))
    c["sim"].update(sim)
    return c


def tree(tmp_path, n=6):
    """``small.tree``'s copy of the benchmark, its cube cut to ``n^3``
    (``small.shrink`` cuts a scene's ``nx`` x ``ny`` alone)."""
    bench, base = small.tree(tmp_path, n=16, episode_frames=6)
    path = os.path.join(str(tmp_path), "benchmark", "configs", "cube64k.json")
    with open(path) as f:
        c = json.load(f)
    assert (c["scene"]["nx"], c["scene"]["ny"]) == (16, 16)
    c["scene"].update(nx=n, ny=n, nz=n)
    with open(path, "w") as f:
        json.dump(c, f)
    return bench, base


def sorted_tets(tets):
    return sorted(tuple(sorted(t)) for t in tets.tolist())


def test_config_is_its_preset():
    import numpy as np

    import softbodyunity_torch as sb

    c = config()
    host, cfg = scene.build(sb, c)
    p_host, p_cfg = sb.presets.build(c["preset"])
    assert cfg == p_cfg
    for field in ("positions0", "edges", "rest_length", "edge_stiffness",
                  "inv_mass", "tets", "rest_volume", "triangles"):
        assert np.array_equal(np.asarray(getattr(host, field)),
                              np.asarray(getattr(p_host, field))), field
    assert host.plane_height == p_host.plane_height
    assert host.lattice_shape == p_host.lattice_shape == (40, 40, 40)
    n_vert, n_edge, n_tet = lattice_euler.sizes(c)
    assert (host.positions0.shape[0], host.edges.shape[0],
            host.tets.shape[0]) == (n_vert, n_edge, n_tet) == (
                64000, 369720, 296595)
    assert c["reduced"] == []
    # small.shrink, the benchmark's tests' cut, reads a grid's keys
    cut = small.shrink(c, 8)["scene"]
    assert (cut["nx"], cut["ny"], cut["nz"], cut["plane_height"]) == (
        8, 8, 40, 0.0)


@pytest.mark.parametrize("n", [6, (3, 4, 5)], ids=["cube", "box"])
def test_the_reference_lattice_is_the_programs(n):
    import numpy as np

    import softbodyunity_torch as sb

    c = config(n)
    host, _ = scene.build(sb, c)
    ref = tet_cube.lattice(c["scene"])
    assert torch.equal(ref["x0"], torch.from_numpy(host.positions0))
    assert torch.equal(ref["edges"], torch.from_numpy(
        np.asarray(host.edges)).long())
    assert torch.allclose(ref["rest_length"],
                          torch.from_numpy(host.rest_length), rtol=0,
                          atol=1e-15)
    assert torch.equal(ref["triangles"], torch.from_numpy(
        np.asarray(host.triangles)).long())
    # the tets as oriented sets: the same vertex sets, each of positive
    # volume at rest in both, with the same rest volume
    prog = torch.from_numpy(np.asarray(host.tets)).long()
    assert sorted_tets(ref["tets"]) == sorted_tets(prog)
    assert bool((tet_cube.signed_volumes(ref["x0"], prog) > 0).all())
    assert bool((ref["rest_volume"] > 0).all())
    by_set = {tuple(sorted(t)): v for t, v in zip(
        ref["tets"].tolist(), ref["rest_volume"].tolist())}
    for t, v in zip(prog.tolist(), host.rest_volume.tolist()):
        assert by_set[tuple(sorted(t))] == pytest.approx(v, rel=0, abs=1e-18)


def test_start_velocity():
    c = config(6)
    gen = scene.episode_generator
    v = tet_cube.start_velocity(c, gen(2**31 + 7, 0), "cpu")
    assert v.dtype == torch.float32 and v.shape == (216, 3)
    assert torch.equal(v, tet_cube.start_velocity(c, gen(2**31 + 7, 0), "cpu"))
    assert not torch.equal(v, tet_cube.start_velocity(c, gen(2**31 + 7, 1),
                                                      "cpu"))
    # the smooth field at most 0.5 m/s, the spin at most 2 rad/s at the
    # corners' distance from the centre
    corner = math.sqrt(3) * 2.5 * c["scene"]["spacing"]
    assert float(v.norm(dim=1).max()) <= 0.5 + 2.0 * corner + 1e-6
    # the spin gives the cube angular momentum about its centre
    x = tet_cube.rest_positions(c["scene"])
    ang = torch.linalg.cross(x - x.mean(dim=0), v.double()).sum(dim=0)
    assert float(ang.norm()) > 0


# Agreement with the port's plain CPU step (sb.step on a CPU topology runs
# solver/step.py::make_plain_step), both in float64, one frame at a time
# from the program's state, as the benchmark's check compares.  The port
# holds each spring group's rest length and each tet pattern's rest volume
# in float32: with those rounded alike the reference is the program to
# rounding (1e-12 m); with its own float64 tables it is within 5e-7 m a
# frame (the rounding of a 0.02 m rest length, ~1e-9 m, pulled by k = 500
# over a frame, and more where contact switches on a vertex that one side
# puts a hair below the ground).
CASES = {
    "spinning_drop": dict(origin=[0.0, 0.15, 0.0]),
    "volume_off": dict(origin=[0.0, 0.15, 0.0], volume_stiffness=0.0),
    "below_plane": dict(origin=[0.0, 0.0, 0.0], plane_height=0.05),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_reference_follows_the_plain_step(case):
    import softbodyunity_torch as sb

    opts = dict(CASES[case])
    c = config(6, volume_stiffness=opts.pop("volume_stiffness", 0.5))
    c["scene"].update(opts)
    host, cfg = scene.build(sb, c)
    top, state = sb.init(host, device="cpu", dtype=torch.float64)
    v = tet_cube.start_velocity(c, scene.episode_generator(2**31 + 3, 0),
                                "cpu").double()
    state = state.replace(v=v, x_prev=state.x - cfg.dt * v)
    ref = tet_cube.TetCube(c)
    rounded = tet_cube.TetCube(c)
    rounded.rest_length = rounded.rest_length.float().double()
    rounded.rest_volume = rounded.rest_volume.float().double()
    worst = {"rounded": 0.0, "own": 0.0, "normals": 0.0}
    landed = False
    for _ in range(24):
        xr, vr = rounded.frame(state.x, state.v)
        xo, _ = ref.frame(state.x, state.v)
        state = sb.step(top, cfg, state)
        worst["rounded"] = max(worst["rounded"],
                               float((state.x - xr).abs().max()),
                               float((state.v - vr).abs().max()) * cfg.dt)
        worst["own"] = max(worst["own"], float((state.x - xo).abs().max()))
        worst["normals"] = max(worst["normals"], float(
            (sb.normals(top, state) - ref.normals(state.x)).abs().max()))
        landed |= bool((state.x[:, 1] <= c["scene"]["plane_height"]).any())
    assert landed, "the case never reached the ground"
    assert worst["rounded"] < 1e-12, worst
    assert worst["own"] < 5e-7, worst
    assert worst["normals"] < 1e-12, worst


def test_roofline_counts_by_hand():
    c = config(3)
    # 27 vertices; axis edges 3 x 9 x 2 = 54, face diagonals 3 x 3 x 4 =
    # 36; 5 x 8 = 40 tets
    assert lattice_euler.sizes(c) == (27, 90, 40)
    ref = tet_cube.lattice(c["scene"])
    assert (ref["edges"].shape[0], ref["tets"].shape[0]) == (90, 40)
    # a 2 x 3 x 4 box: axis edges 1*3*4 + 2*2*4 + 2*3*3 = 46, diagonals
    # 1*2*4 + 1*3*3 + 2*2*3 = 29; 5 x 1*2*3 = 30 tets
    box = tet_cube.lattice(config((2, 3, 4))["scene"])
    assert lattice_euler.sizes(config((2, 3, 4))) == (24, 75, 30) == (
        box["x0"].shape[0], box["edges"].shape[0], box["tets"].shape[0])
    nbytes, ops = lattice_euler.counts(c)
    assert nbytes == 27 * (48 + 12) + 12 * 9 + 16 * 10 + 16
    assert ops == 34 * 90 + 119 * 40 + (22 + 15) * 27
    off = config(3, volume_stiffness=0.0)
    assert lattice_euler.counts(off) == (27 * (48 + 8) + 12 * 9 + 16,
                                         34 * 90 + 22 * 27)
    bound, kind = lattice_euler.bound_per_substep(config())
    assert kind == "bytes"
    assert bound * 1e6 == pytest.approx(1.146, abs=1e-3)


def _run(op_s):
    cell = harness.Cell("cube64k.render", 1, config(), {}, [], [])
    run = harness.Run(cell)
    if op_s is not None:
        run.device = trace.DeviceRecord(
            substeps=32, window_s=1e-3, busy_s=5e-4, n_ops=len(op_s),
            op_s=op_s, span_op_s={}, idle_s={}, gaps=[])
    return run


def test_readers_find_nothing_without_their_kernels():
    roof = harness.load_reader("lattice_euler_roofline")
    tet = harness.load_reader("lattice_tet_us")
    for op_s in (None, {}, {"grid_euler_substep_kernel": 1e-4}):
        assert roof(_run(op_s)) is None and tet(_run(op_s)) is None
    run = _run({"void lattice_euler_integrate_kernel(...)": 32 * 14e-6,
                "void lattice_tet_kernel(...)": 32 * 12e-6,
                "void lattice_euler_gather_kernel(...)": 32 * 12e-6,
                "Memcpy DtoH": 1e-3})
    assert tet(run) == pytest.approx(12.0)
    bound, _ = lattice_euler.bound_per_substep(config())
    assert roof(run) == pytest.approx(100.0 * bound / 38e-6)


def test_the_cell_runs_on_the_cpu(tmp_path):
    """``cube64k.render`` through the harness on a 6^3 copy of its file,
    the program's plain path on the CPU, judged by the reference."""
    bench, base = tree(tmp_path)
    result, numbers, limits = harness.run_cell(
        "cube64k.render", 2**31 + 17, 1.0, False, device="cpu",
        bench=bench, base=base)
    assert result["correct"] is True, numbers
    assert set(result["metrics"]) == {"frame_ms_p95", "setup_s"}
    assert set(limits) == set(config()["check"]["limits"]) | {"step_builds"}


def volume_off(sb_step):
    """The program stepped with its tet volume term left out."""
    def step(top, cfg, state, *args, **kw):
        return sb_step(top, cfg.replace(volume_stiffness=0.0), state, *args,
                       **kw)
    return step


def unchanged(sb_step):
    def step(top, cfg, state, *args, **kw):
        sb_step(top, cfg, state, *args, **kw)   # the work, its result lost
        return state
    return step


@pytest.mark.parametrize("fault", [volume_off, unchanged],
                         ids=["volume_off", "state_unchanged"])
def test_a_broken_cube_run_is_not_correct(tmp_path, monkeypatch, fault):
    import softbodyunity_torch as sb

    monkeypatch.setattr(sb, "step", fault(sb.step))
    bench, base = tree(tmp_path)
    result, numbers, limits = harness.run_cell(
        "cube64k.render", 2**31 + 17, 1.0, False, device="cpu",
        bench=bench, base=base)
    assert result["correct"] is False, numbers
    assert numbers["x_rms_first_m"] > limits["x_rms_first_m"], numbers


def test_the_reference_imports_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys; import benchmark.reference.tet_cube; "
            "import benchmark.roofline.lattice_euler; "
            "tops = {m.split('.')[0] for m in sys.modules}; "
            "bad = tops & {'softbodyunity_torch', 'softbodyunity_tpu', "
            "'jax', 'jaxlib', 'flax'}; "
            "print(sorted(bad)); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=small.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
