"""The XPBD curtain's configuration, plain reference, roofline and readers:
the file builds its preset, a constraint projected by hand is the
reference's, the reference follows the program's plain CPU step, and the
cell runs on the CPU at a small size, where a broken program fails it."""

import json
import math
import os

import pytest
import torch

from benchmark import check as checks
from benchmark import control, harness, scene, trace
from benchmark.roofline import grid_xpbd as roofline
from benchmark.tests import small

grid_xpbd = harness.load_module(harness.BENCH, "reference", "grid_xpbd")
CELL = "cloth64k_xpbd.render"


def config(n=None, **scene_keys):
    """``cloth64k_xpbd.json``, cut to ``n`` x ``n`` if given."""
    with open(os.path.join(small.BENCH, "configs",
                           "cloth64k_xpbd.json")) as f:
        c = json.load(f)
    if n is not None:
        c = small.shrink(c, n)
    c["scene"].update(scene_keys)
    return c


def test_config_is_its_preset():
    import numpy as np

    import softbodyunity_torch as sb

    c = config()
    host, cfg = scene.build(sb, c)
    p_host, p_cfg = sb.presets.build(c["preset"])
    assert cfg == p_cfg
    for field in ("positions0", "edges", "rest_length", "edge_stiffness",
                  "edge_compliance", "inv_mass", "triangles"):
        assert np.array_equal(np.asarray(getattr(host, field)),
                              np.asarray(getattr(p_host, field))), field
    assert host.plane_height == p_host.plane_height
    assert host.grid_shape == p_host.grid_shape == (256, 256)
    n, edges, classes = roofline.sizes(c)
    assert (host.positions0.shape[0], host.edges.shape[0], classes) == (
        n, edges, 6) == (65536, 390658, 6)
    assert c["reduced"] == [] and c["sim"]["solver"] == "xpbd"


def _line(scene_keys):
    """A reference over a free 1 x n row (no shear, no pins), its
    constraints found by hand below."""
    c = config(**scene_keys)
    c["scene"].update(ny=1, shear=False, pinned=[])
    return c, grid_xpbd.Reference(c)


def _state(ref, points):
    x = torch.tensor(points, dtype=torch.float64)
    return ref.planes(x), torch.zeros_like(ref.planes(x))


def test_one_distance_constraint_by_hand():
    """Two vertices 12 mm apart, rest 10 mm: one sweep moves each by
    w dlam / count along the line, lambda takes dlam."""
    c, ref = _line({"nx": 2, "bend": False})
    x3, delta = _state(ref, [[0.0, 0.0, 0.0], [0.012, 0.0, 0.0]])
    lams = ref.zero_lambdas()
    contact = torch.zeros(1, 2, dtype=torch.bool)
    delta, _ = ref.sweep(x3, delta, lams, contact)
    w = 1.0 / c["scene"]["mass"]
    at = c["sim"]["xpbd"]["compliance_distance"] / c["sim"]["dt"] ** 2
    dlam = -(0.012 - 0.01) / (2 * w + at)
    # a moves by -w dlam n, b by +w dlam n, n = +x; one constraint each
    assert float(lams[0]) == pytest.approx(dlam, rel=1e-14)
    assert float(delta[0, 0, 0]) == pytest.approx(-w * dlam, rel=1e-14)
    assert float(delta[0, 0, 1]) == pytest.approx(w * dlam, rel=1e-14)
    assert float(delta[1:].abs().max()) == 0.0
    # the pair is pulled together, by less than the whole 2 mm
    gap = 0.012 + float(delta[0, 0, 1] - delta[0, 0, 0])
    assert 0.01 < gap < 0.012


def test_one_bend_constraint_by_hand():
    """Three vertices bent at the middle by 60 degrees, the two structural
    constraints at rest: the bend constraint (0, 2) alone moves the ends,
    with the bend compliance, and the middle vertex not at all."""
    c, ref = _line({"nx": 3, "bend": True})
    h = c["scene"]["spacing"]
    th = math.pi / 3
    pts = [[0.0, 0.0, 0.0], [h, 0.0, 0.0],
           [h + h * math.cos(th), h * math.sin(th), 0.0]]
    x3, delta = _state(ref, pts)
    lams = ref.zero_lambdas()
    contact = torch.zeros(1, 3, dtype=torch.bool)
    delta, _ = ref.sweep(x3, delta, lams, contact)
    w = 1.0 / c["scene"]["mass"]
    at = c["sim"]["xpbd"]["compliance_bend"] / c["sim"]["dt"] ** 2
    a, b = (torch.tensor(p, dtype=torch.float64) for p in (pts[0], pts[2]))
    length = float((b - a).norm())
    n = (b - a) / length
    dlam = -(length - 2 * h) / (2 * w + at)
    bend = [k for k, (_, dj, _, _) in enumerate(ref.constraints) if dj == 2]
    assert float(lams[bend[0]]) == pytest.approx(dlam, rel=1e-12)
    # each end: one structural constraint (at rest to rounding) and the
    # bend one, so count 2; the middle vertex's two structural ones
    assert torch.allclose(delta[:, 0, 0], -w * dlam * n / 2, rtol=0,
                          atol=1e-15)
    assert torch.allclose(delta[:, 0, 2], w * dlam * n / 2, rtol=0,
                          atol=1e-15)
    assert float(delta[:, 0, 1].abs().max()) < 1e-15


def test_pins_hold_and_lambda_accumulates():
    """A pinned vertex keeps its position bit for bit and its velocity 0;
    each sweep's lambda is the last one's plus its own dlam, which the last
    lambda enters: ``dlam = -(C + at lambda) / (w_a + w_b + at)``."""
    c = config(8)
    ref = grid_xpbd.Reference(c)
    x0 = grid_xpbd.rest_positions(c["scene"])
    v0 = grid_xpbd.start_velocity(c, scene.episode_generator(2**31 + 9, 0),
                                  "cpu").double()
    pins = grid_xpbd.pin_mask(c["scene"], "cpu").reshape(-1)
    x, v = ref.frame(x0, v0)
    assert torch.equal(x[pins], x0[pins]) and float(v[pins].abs().max()) == 0
    assert float((x[~pins] - x0[~pins]).abs().max()) > 1e-4
    # two sweeps by hand on the structural class (0, 1)
    x3 = ref.planes(x0)
    delta = ref.dt * ref.planes(v0)
    lams = ref.zero_lambdas()
    contact = torch.zeros_like(ref.free)
    alpha = c["sim"]["xpbd"]["compliance_distance"]
    at = alpha / ref.dt ** 2
    a, b = grid_xpbd.ends(8, 8, 0, 1)
    seen = []
    for _ in range(2):
        xe = x3 + delta
        d = xe[(slice(None), *b)] - xe[(slice(None), *a)]
        C = torch.sqrt((d * d).sum(dim=0)) - c["scene"]["spacing"]
        before = lams[0].clone()
        delta, contact = ref.sweep(x3, delta, lams, contact)
        want = -(C + at * before) / (ref.inv_mass[a] + ref.inv_mass[b] + at)
        assert torch.allclose(lams[0] - before, want, rtol=1e-12,
                              atol=1e-18)
        seen.append(lams[0].clone())
    assert float((seen[1] - seen[0]).abs().max()) > 0
    assert float(seen[0].abs().max()) > 0


# Agreement with the port's plain CPU step (sb.step on a CPU topology runs
# kernels/stencil.py::xpbd_substep_grid), a frame at a time from the
# program's state, as the benchmark's check compares.  In float64 the two
# run the same operations in another order of summation: 1e-12 m.  The
# program in float32 rounds its positions (coordinates up to 0.31 m, an
# ulp of 3e-8) at every sweep of every substep, 128 a frame: within 5e-7 m
# a frame (measured 3.6e-8), velocities within 5e-7 m of change a substep
# (dt v), unit normals within 1e-6 (measured 9.3e-8).
@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 5e-7)],
                         ids=["float64", "float32"])
def test_the_reference_follows_the_plain_step(n, dtype, tol):
    import softbodyunity_torch as sb

    c = config(n)
    host, cfg = scene.build(sb, c)
    top, state = sb.init(host, device="cpu", dtype=dtype)
    v = grid_xpbd.start_velocity(c, scene.episode_generator(2**31 + 5, n),
                                 "cpu").to(dtype)
    state = state.replace(v=v, x_prev=state.x - cfg.dt * v)
    ref = grid_xpbd.Reference(c)
    normals_tol = 1e-12 if dtype == torch.float64 else 1e-6
    for _ in range(2):
        xr, vr = ref.frame(state.x, state.v)
        state = sb.step(top, cfg, state)
        assert float((state.x.double() - xr).abs().max()) < tol
        assert float((state.v.double() - vr).abs().max()) * cfg.dt < tol
        got = sb.normals(top, state).double()
        assert float((got - ref.normals(state.x)).abs().max()) < normals_tol


def test_the_reference_refuses_what_it_does_not_run():
    c = config(4)
    c["sim"]["solver"] = "euler"
    with pytest.raises(ValueError):
        grid_xpbd.Reference(c)
    c = config(4)
    c["sim"]["wind"] = {"enabled": True}
    with pytest.raises(ValueError):
        grid_xpbd.Reference(c)


def test_roofline_counts_by_hand():
    c = config(4)
    # 16 vertices; structural 4 x 3 x 2 = 24, shear 3 x 3 x 2 = 18, bend
    # 4 x 2 x 2 = 16: 58 constraints in 6 classes
    assert roofline.sizes(c) == (16, 58, 6)
    nbytes, ops = roofline.counts(c)
    assert nbytes == 16 * 4 * 14 + 16 * 6 + 16
    assert ops == 8 * (36 * 58 + 12 * 16) + 18 * 16
    # the grid's own constraint count is the reference's
    ref = grid_xpbd.Reference(c)
    assert sum(int(ref.inv_mass[grid_xpbd.ends(4, 4, di, dj)[0]].numel())
               for di, dj, _, _ in ref.constraints) == 58
    bound, kind = roofline.bound_per_substep(config())
    assert kind == "operations"
    assert bound * 1e6 == pytest.approx(1.791, abs=1e-3)


def _run(op_s):
    cell = harness.Cell(CELL, 1, config(), {}, [], [])
    run = harness.Run(cell)
    if op_s is not None:
        run.device = trace.DeviceRecord(
            substeps=32, window_s=1e-3, busy_s=5e-4, n_ops=len(op_s),
            op_s=op_s, span_op_s={}, idle_s={}, gaps=[])
    return run


def test_readers_find_nothing_without_their_kernels():
    roof = harness.load_reader("grid_xpbd_roofline")
    sweep = harness.load_reader("xpbd_sweep_us")
    for op_s in (None, {}, {"grid_euler_substep_kernel": 1e-4}):
        assert roof(_run(op_s)) is None and sweep(_run(op_s)) is None
    run = _run({
        "void (anonymous namespace)::grid_xpbd_predict_kernel<false, "
        "false, false>(...)": 32 * 2e-6,
        "void (anonymous namespace)::grid_xpbd_sweep_kernel<3, false, "
        "false>(...)": 32 * 72e-6,
        "Memcpy DtoH": 1e-3})
    assert sweep(run) == pytest.approx(72.0)
    bound, _ = roofline.bound_per_substep(config())
    assert roof(run) == pytest.approx(100.0 * bound / 74e-6)


def test_the_cell_is_in_the_benchmark():
    b = small.bench()
    cell = harness.find_cell(CELL, b)
    assert cell.chips == 1 and cell.config["name"] == "cloth64k_xpbd"
    assert cell.end_to_end == ["frame_ms_p95", "setup_s"]
    assert {"grid_xpbd_roofline", "xpbd_sweep_us", "step_host_us",
            "render_ms", "device_idle_pct",
            "device_ops_per_substep"} == set(cell.per_layer)


def test_the_cell_runs_on_the_cpu(tmp_path):
    """``cloth64k_xpbd.render`` through the harness on a 16 x 16 copy of
    its file, the program's plain path on the CPU, judged by the
    reference."""
    bench, base = small.tree(tmp_path, n=16, episode_frames=6)
    result, numbers, limits = harness.run_cell(
        CELL, 2**31 + 17, 1.0, False, device="cpu", bench=bench, base=base)
    assert result["correct"] is True, numbers
    assert set(result["metrics"]) == {"frame_ms_p95", "setup_s"}
    assert set(limits) == set(config()["check"]["limits"]) | {"step_builds"}


def _kept(tmp_path, cfg_change=None):
    """The episodes a run of the 16 x 16 cell keeps, stepped by the
    program (its ``SimConfig`` changed by ``cfg_change``)."""
    bench, base = small.tree(tmp_path, n=16, episode_frames=6)
    cell = harness.find_cell(CELL, bench, base)
    prog = harness.Program(cell, "cpu", base)
    if cfg_change:
        prog.cfg = cfg_change(prog.cfg)
    return cell, prog, control.episodes_of(prog, cell, 2**31 + 23)


def _sweeps_half(cfg):
    import dataclasses

    return dataclasses.replace(cfg, xpbd=dataclasses.replace(
        cfg.xpbd, n_iterations=cfg.xpbd.n_iterations // 2))


@pytest.mark.parametrize("fault", ["sweeps_half", "frozen"])
def test_a_broken_xpbd_program_is_not_correct(tmp_path, fault):
    """Half the sweeps (``control_xpbd.py``'s fault) and a step that
    returns its state unchanged fail the cell's limits; the program
    itself passes them."""
    cell, prog, kept = _kept(tmp_path, _sweeps_half if fault ==
                             "sweeps_half" else None)
    limits = cell.config["check"]["limits"]

    def start_state(episode):
        s = prog.start(2**31 + 23, episode)
        return s.x, s.v

    numbers = checks.compare(cell.config, prog.reference, kept,
                             start_state, prog.device)
    if fault == "frozen":
        # the program's own frames pass; a frozen step in its place fails
        assert all(numbers[k] <= v for k, v in limits.items()), numbers
        numbers = checks.compare(
            cell.config, prog.reference, kept, start_state, prog.device,
            program=control.Frozen(prog.reference.Reference(cell.config)))
    failed = [k for k, v in limits.items() if not numbers[k] <= v]
    assert failed, numbers
    assert numbers["x_rms_first_m"] > limits["x_rms_first_m"], numbers


def test_the_reference_imports_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys; from benchmark import harness; "
            "harness.load_module(harness.BENCH, 'reference', 'grid_xpbd'); "
            "import benchmark.roofline.grid_xpbd; "
            "tops = {m.split('.')[0] for m in sys.modules}; "
            "bad = tops & {'softbodyunity_torch', 'softbodyunity_tpu', "
            "'jax', 'jaxlib', 'flax'}; "
            "print(sorted(bad)); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=small.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
