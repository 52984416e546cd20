"""The end-to-end readers take all the frames and all the time of the
window, and the device record is read from the trace as its docstrings
say."""

import numpy as np
import pytest

from benchmark import harness, trace
from benchmark.harness import load_reader


def run_of(frame_s, substeps_per_frame=16):
    cell = harness.Cell("c.render", 1, {"sim": {}}, {},
                        [], [])
    run = harness.Run(cell)
    run.frame_s = list(frame_s)
    run.frames = len(frame_s)
    run.substeps = substeps_per_frame * len(frame_s)
    run.window_s = float(sum(frame_s))
    return run


def test_a_stall_moves_the_rate_and_the_tail():
    rng = np.random.default_rng(0)
    frames = list(1e-3 + 1e-4 * rng.random(400))
    rate, p95 = load_reader("substeps_per_s"), load_reader("frame_ms_p95")
    base = run_of(frames)
    stalled = run_of(frames[:200] + [0.25] + frames[200:])
    assert rate(stalled) < rate(base)
    assert p95(stalled) > p95(base)
    # the rate is all the substeps over all the time, not a median of chunks
    assert rate(stalled) == pytest.approx(16 * 401 / (sum(frames) + 0.25))
    assert p95(base) == pytest.approx(np.percentile(frames, 95) * 1e3)


def test_a_mix_without_frame_times_has_no_tail():
    run = run_of([])
    run.substeps, run.window_s = 1600, 1.0
    assert load_reader("frame_ms_p95")(run) is None
    assert load_reader("substeps_per_s")(run) == 1600.0


def test_host_span_readers():
    run = run_of([1e-3] * 4)
    run.spans = {"step": [2e-4] * 4, "normals": [1e-4] * 4,
                 "readback": [3e-4] * 4}
    assert load_reader("step_host_us")(run) == pytest.approx(200.0)
    assert load_reader("render_ms")(run) == pytest.approx(0.4)
    run.spans = {"step": [2e-4], "normals": [], "readback": []}
    assert load_reader("render_ms")(run) is None


def events():
    """Two frames of a synthetic trace, in ns: a marker opens each span."""
    us = 1000
    return [
        ("spin_kernel", 0, 1 * us),                 # step
        ("grid_euler_substep_kernel", 10 * us, 20 * us),
        ("sort_kernel", 25 * us, 30 * us),
        ("spin_kernel", 31 * us, 32 * us),          # normals
        ("gather_kernel", 40 * us, 45 * us),
        ("spin_kernel", 46 * us, 47 * us),          # readback
        ("Memcpy DtoH", 50 * us, 60 * us),
    ]


def test_trace_reduction():
    rec = trace.reduce(events(), ["step", "normals", "readback"], 16)
    assert rec.n_ops == 4
    assert rec.window_s == pytest.approx(60e-6)
    assert rec.busy_s == pytest.approx(30e-6)
    assert rec.span_op_s["step"] == pytest.approx(
        {"grid_euler_substep_kernel": 10e-6, "sort_kernel": 5e-6})
    # gaps: 10 (to the kernel) + 5 in step, 10 in normals, 5 in readback
    assert rec.idle_s["step"] == pytest.approx(15e-6)
    assert rec.idle_s["normals"] == pytest.approx(10e-6)
    assert rec.idle_s["readback"] == pytest.approx(5e-6)
    cell = harness.Cell("c", 1, {"sim": {"self_collision": {"enabled": True,
                                                    "radius": 1}},
                                 "scene": {"nx": 256, "ny": 256,
                                           "shear": True, "bend": False}},
                        {}, [], [])
    run = harness.Run(cell, device=rec)
    assert load_reader("device_idle_pct")(run) == pytest.approx(50.0)
    assert load_reader("device_ops_per_substep")(run) == pytest.approx(0.25)
    assert load_reader("selfcollide_device_us")(run) == pytest.approx(
        5e-6 / 16 * 1e6)
    from benchmark.roofline.grid_euler import bound_per_substep

    bound, _ = bound_per_substep(cell.config)
    assert load_reader("grid_euler_roofline")(run) == pytest.approx(
        100 * bound * 16 / 10e-6)


def test_a_trace_whose_markers_disagree_is_not_read():
    assert trace.reduce(events(), ["step", "normals"], 16) is None
    assert trace.reduce(events()[1:3], [], 16) is None


def test_short_symbols():
    assert harness.short_symbol(
        "void (anonymous namespace)::grid_euler_substep_kernel<3, false>"
        "(float const*, (anonymous namespace)::Colliders, int)"
    ) == "grid_euler_substep_kernel<3, false>"
    assert harness.short_symbol("Memcpy DtoH (Device -> Pinned)") == (
        "Memcpy DtoH")


def test_markers_lost_by_the_trace_are_matched_by_time():
    names = ["reset", "step", "normals", "readback", "step", "normals"]
    noted = [0, 100, 400, 500, 900, 1200]
    # the device starts each marker 30 ns after the host noted its span;
    # the trace lost the markers of the first "normals" and "readback"
    marks = [("spin_kernel", t + 30, t + 31) for t in noted]
    kept = [marks[i] for i in (0, 1, 4, 5)]
    assert trace.marker_spans(kept, names, noted) == [
        "reset", "step", "step", "normals"]
    assert trace.marker_spans(marks, names, noted) == names
    assert trace.marker_spans(kept, names) is None
