"""The port's recorder (``softbodyunity_torch/utils/profiling.py``) on the
CPU: no span while it is off; with it on, the spans of a block
self-collision frame and its normals, nested as the layers nest, one frame
number a frame, self time the duration less the children's; a full
storage counts what it drops; and every kernel wrapper's launch counter
reads through it as before.  The file imports no jax."""

import threading
import time

import numpy as np
import pytest
import torch

import softbodyunity_torch as tsb
from softbodyunity_torch.core.config import SelfCollisionParams
from softbodyunity_torch.kernels import (blocks, grid_euler, grid_strain,
                                        grid_verlet, grid_xpbd,
                                        lattice_euler, lattice_verlet,
                                        lattice_xpbd)
from softbodyunity_torch.utils import profiling

torch.set_num_threads(1)

# span -> its parent, in a frame of the plain path with block self-collision
PARENTS = {
    "api.step": None,
    "api.lookup": "api.step",
    "selfcollide": "api.step",
    "blocksparse.sort": "selfcollide",
    "blocksparse.partners": "selfcollide",
    "api.normals": None,
    "normals.faces": "api.normals",
    "normals.sum": "api.normals",
}


@pytest.fixture
def recorder():
    """The recorder off before and after the test."""
    profiling.disable()
    yield profiling
    profiling.disable()


def _pile(n_substeps=2):
    """A 32 x 32 curtain with block self-collision (4 tiles of 256), its
    corners pinned, on the CPU."""
    cfg = tsb.SimConfig(
        springs=tsb.SpringParams(k_structural=600.0, k_shear=300.0,
                                 damping=0.5),
        self_collision=SelfCollisionParams(
            enabled=True, method="block", radius=0.03, stiffness=40.0,
            cell_size=0.06, block_partners=4),
        n_substeps=n_substeps,
    )
    host = tsb.cloth_grid(32, 32, spacing=0.02, shear=True, bend=False,
                          pinned=("tl", "tr"), springs=cfg.springs,
                          xpbd=cfg.xpbd, orientation="xy")
    top, state = tsb.init(host, device="cpu")
    return top, cfg, state


def _frames(top, cfg, state, n):
    for _ in range(n):
        state = tsb.step(top, cfg, state)
        tsb.normals(top, state)
    return state


def test_off_records_no_span(recorder):
    top, cfg, state = _pile()
    recorder.enable()
    recorder.disable()
    _frames(top, cfg, state, 2)
    rec = recorder.read()
    assert rec.names == [] and rec.spans_dropped == 0
    assert rec.calls == {} and rec.self_ns == {}


def test_spans_of_a_self_collision_frame(recorder):
    top, cfg, state = _pile()
    state = _frames(top, cfg, state, 1)     # the step function built
    recorder.enable()
    _frames(top, cfg, state, 2)
    rec = recorder.read()
    names = rec.names
    assert set(names) == set(PARENTS)
    n = len(names)
    for i in range(n):
        p = rec.parent[i]
        assert (names[p] if p >= 0 else None) == PARENTS[names[i]]
        assert rec.end_ns[i] >= rec.start_ns[i] > 0
        if p >= 0:
            assert rec.start_ns[p] <= rec.start_ns[i]
            assert rec.end_ns[i] <= rec.end_ns[p]
            assert rec.frame[i] == rec.frame[p]
    # one frame number a frame: each step and the normals after it
    steps = [i for i in range(n) if names[i] == "api.step"]
    assert [rec.frame[i] for i in steps] == [1, 2]
    for i in range(n):
        if names[i] == "api.normals":
            assert rec.frame[i] == rec.frame[max(s for s in steps if s < i)]
    # a selfcollide span a substep, each with its sort and partner search
    assert rec.calls["selfcollide"] == 2 * cfg.n_substeps
    assert rec.calls["blocksparse.sort"] == 2 * cfg.n_substeps
    assert rec.calls["blocksparse.partners"] == 2 * cfg.n_substeps
    assert rec.calls["api.step"] == rec.calls["api.normals"] == 2
    # self time: the duration less the children's, by name
    for name in PARENTS:
        own = sum(rec.end_ns[i] - rec.start_ns[i]
                  - sum(rec.end_ns[j] - rec.start_ns[j] for j in range(n)
                        if rec.parent[j] == i)
                  for i in range(n) if names[i] == name)
        assert rec.self_ns[name] == own >= 0


def test_full_storage_counts_spans_dropped(recorder):
    top, cfg, state = _pile()
    state = _frames(top, cfg, state, 1)
    recorder.enable()
    _frames(top, cfg, state, 1)
    per_frame = len(recorder.read().names)
    recorder.enable(capacity=5)
    _frames(top, cfg, state, 2)
    rec = recorder.read()
    assert len(rec.names) == 5
    assert rec.spans_dropped == 2 * per_frame - 5
    # the kept spans are the first five, whole
    assert rec.names[:2] == ["api.step", "api.lookup"]
    assert all(e >= s > 0 for s, e in zip(rec.start_ns, rec.end_ns))


def test_enable_forgets_the_last_recording(recorder):
    top, cfg, state = _pile()
    state = _frames(top, cfg, state, 1)
    recorder.enable()
    _frames(top, cfg, state, 2)
    recorder.enable()
    _frames(top, cfg, state, 1)
    rec = recorder.read()
    assert rec.calls["api.step"] == 1
    assert set(rec.frame) == {1}


def test_a_span_left_open_is_not_a_parent_of_the_next_frame(recorder):
    recorder.enable()
    sp = recorder.begin("api.step", new_frame=True)
    recorder.begin("grid_euler.call")       # raised: never closed
    del sp
    root = recorder.begin("api.step", new_frame=True)
    child = recorder.begin("api.lookup")
    recorder.end(child)
    recorder.end(root)
    rec = recorder.read()
    assert rec.parent[root] == -1 and rec.parent[child] == root
    assert rec.calls == {"api.step": 1, "api.lookup": 1}
    assert rec.end_ns[1] == 0 and rec.frame[root] == 2


def test_each_thread_nests_its_own_spans(recorder):
    """Ranks of the halo paths run their pair kernels from threads: a span
    is the child of the span open on its own thread."""
    recorder.enable()
    start = threading.Barrier(4)
    opened = {}

    def rank(r):
        start.wait(timeout=10)
        for _ in range(50):
            outer = recorder.begin("selfcollide")
            inner = recorder.begin("blocks.launch")
            opened.setdefault(r, []).append((outer, inner))
            recorder.end(inner)
            recorder.end(outer)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    rec = recorder.read()
    assert rec.calls == {"selfcollide": 200, "blocks.launch": 200}
    for pairs in opened.values():
        for outer, inner in pairs:
            assert rec.parent[outer] == -1 and rec.parent[inner] == outer


def test_device_counters_zeroed_by_enable_and_read_by_name(recorder):
    buf = recorder.device_counters(("t.a", "t.b"), "cpu")
    buf += torch.tensor([3, 4])
    assert recorder.read().counters["t.a"] == 3
    recorder.enable()
    buf += torch.tensor([1, 2])
    second = recorder.device_counters(("t.a",), "cpu")
    second += 5
    counters = recorder.read().counters
    assert (counters["t.a"], counters["t.b"]) == (6, 2)
    del buf, second
    assert "t.a" not in recorder.read().counters


WRAPPERS = {
    "grid_euler": grid_euler, "grid_verlet": grid_verlet,
    "grid_xpbd": grid_xpbd, "grid_strain": grid_strain,
    "lattice_euler": lattice_euler, "lattice_verlet": lattice_verlet,
    "lattice_xpbd": lattice_xpbd,
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_launch_count_reads_the_recorder(name):
    """A wrapper's ``launch_count()`` is the recorder's counter of its
    name, reset by its ``reset_launch_count()``, and counts whether the
    recorder is on or off."""
    mod = WRAPPERS[name]
    mod.reset_launch_count()
    assert mod.launch_count() == 0
    profiling.add(name, 3)
    profiling.add(name)
    assert mod.launch_count() == profiling.count(name) == 4
    for other in WRAPPERS.values():
        if other is not mod:
            other.reset_launch_count()
    assert mod.launch_count() == 4
    mod.reset_launch_count()
    assert mod.launch_count() == 0


def test_block_pairs_counts_both_forms():
    blocks.reset_launch_count()
    blocks._count("block_pairs")
    blocks._count("block_pairs_dual")
    blocks._count("block_pairs_dual")
    assert (blocks.launch_count(), blocks.launch_count("block_pairs_dual"),
            blocks.launch_count("block_pairs")) == (1, 2, 1)
    blocks.reset_launch_count()
    assert blocks.launch_count() == blocks.launch_count(
        "block_pairs_dual") == 0


def test_plain_path_counts_no_launch_with_the_recorder_on(recorder):
    top, cfg, state = _pile()
    for mod in (*WRAPPERS.values(), blocks):
        mod.reset_launch_count()
    recorder.enable()
    x = _frames(top, cfg, state, 2).x
    assert np.isfinite(x.numpy()).all()
    counts = recorder.read().counters
    assert all(counts.get(name, 0) == 0
               for name in (*WRAPPERS, *blocks.FORMS))


class _MadeUpTrace:
    """A profiler session whose device trace is made up from the loop's
    markers: each marker starts 5 us after its note and one 10 us op
    follows 20 us after it."""

    def __init__(self):
        self.names, self.noted_ns, self.substeps, self.on = [], [], 0, False

    def start(self):
        self.on = True

    def stop(self):
        self.on = False

    def mark(self, name):
        if self.on:
            self.names.append(name)
            self.noted_ns.append(time.time_ns())

    def events(self):
        out = []
        for t in self.noted_ns:
            out += [("spin_kernel", t + 5000, t + 6000),
                    ("gather_kernel", t + 20000, t + 30000)]
        return sorted(out, key=lambda e: e[1])


def test_trace_tool_on_a_shrunk_cell(tmp_path, monkeypatch):
    """``tools/trace_cell.py trace`` on a 16 x 16 copy of the self-colliding
    cell, the program on the CPU under a made-up device trace: the
    program's numbers of the frames in and out of the profile, the idle
    split over its spans, and the recorder's cost frame by frame."""
    import json
    import os
    import runpy

    from benchmark import trace
    from benchmark.tests import small

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tool = runpy.run_path(os.path.join(root, "tools", "trace_cell.py"))
    monkeypatch.setattr(trace, "Session", _MadeUpTrace)
    bench, base = small.tree(tmp_path, n=16, episode_frames=2)
    path = os.path.join(base, "traffic", "render.json")
    with open(path) as f:
        mix = json.load(f)
    mix["profile_seconds"] = 0.1        # the first episode, two frames
    with open(path, "w") as f:
        json.dump(mix, f)
    out = tool["trace"]("selfcollide64k.render", 2**31 + 11, 2.5, True,
                        device="cpu", base=base, bench=bench)
    assert out["selfcollide_host_us"] > 0 and out["wrapper_host_us"] > 0
    assert out["normals_idle_us"] > 0 and out["selfcollide_idle_us"] > 0
    assert out["pair_hit_pct"] is None          # no kernel on the CPU
    assert out["marker_lag"]["min_us"] == 5.0
    assert out["spans_dropped"] == 0 and out["spans"] > 0
    split = dict(out["idle_by_program_span"])
    assert "selfcollide" in split or "blocksparse.sort" in split
    assert 0.0 <= out["step_idle_below_api_step"]
    profiling.disable()
    out = tool["trace"]("selfcollide64k.render", 2**31 + 11, 2.5, False,
                        device="cpu", base=base, bench=bench, alternate=True)
    ab = out["alternate"]
    assert ab["frames"] >= 2
    assert ab["step_host_us"]["on"] > 0 and ab["step_host_us"]["off"] > 0
    profiling.disable()


def test_trace_tool_on_the_xpbd_cell(tmp_path, monkeypatch):
    """``tools/trace_cell.py trace`` on a 16 x 16 copy of the XPBD curtain,
    the program on the CPU under a made-up device trace: the cell's readers
    and ``xpbd_unmet_pct`` find no kernel there; ``xpbd_unmet_pct`` is the
    sweep's unmet constraints over those it evaluated."""
    import json
    import os
    import runpy

    from benchmark import trace
    from benchmark.tests import small

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tool = runpy.run_path(os.path.join(root, "tools", "trace_cell.py"))
    monkeypatch.setattr(trace, "Session", _MadeUpTrace)
    bench, base = small.tree(tmp_path, n=16, episode_frames=2)
    path = os.path.join(base, "traffic", "render.json")
    with open(path) as f:
        mix = json.load(f)
    mix["profile_seconds"] = 0.1
    with open(path, "w") as f:
        json.dump(mix, f)
    out = tool["trace"]("cloth64k_xpbd.render", 2**31 + 13, 1.5, True,
                        device="cpu", base=base, bench=bench)
    profiling.disable()
    assert out["frames"] > 0 and out["spans"] > 0
    assert out["xpbd_unmet_pct"] is None        # no kernel on the CPU
    assert out["grid_xpbd_roofline"] is None and out["xpbd_sweep_us"] is None
    assert out["xpbd_resident_pct"] is None
    assert out["xpbd_flag_polls_per_stage"] is None
    pct = tool["xpbd_unmet_pct"]
    assert pct({}) is None
    assert pct({"grid_xpbd.edges_checked": 400,
                "grid_xpbd.edges_unmet": 30}) == pytest.approx(7.5)


def test_trace_tool_xpbd_resident_readings():
    """``xpbd_resident_pct``: the resident substeps over the window's; and
    ``xpbd_flag_polls_per_stage``: the failed flag polls per tile (256 on
    the 64k curtain) and Jacobi stage (8) of the resident substeps."""
    import os
    import runpy

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tool = runpy.run_path(os.path.join(root, "tools", "trace_cell.py"))
    share = tool["xpbd_resident_pct"]
    assert share(0, 0, 160) is None           # no XPBD launch
    assert share(160, 160, 160) == pytest.approx(100.0)
    assert share(9 * 160, 0, 160) == pytest.approx(0.0)
    config = {"scene": {"ny": 256, "nx": 256},
              "sim": {"xpbd": {"n_iterations": 8}}}
    polls = tool["xpbd_flag_polls_per_stage"]
    assert polls({}, 16, config) is None      # the recorder counted nothing
    assert polls({"grid_xpbd.flag_polls": 0}, 0, config) is None
    assert polls({"grid_xpbd.flag_polls": 16 * 8 * 256 * 3}, 16,
                 config) == pytest.approx(3.0)
    assert polls({"grid_xpbd.flag_polls": 5}, 16,
                 {"scene": {"ny": 256, "nx": 256},
                  "sim": {"xpbd": None}}) is None
