"""Trace one cell of the benchmark with the program's recorder on: where the
device idles inside the program's step and normals, what the pair kernel
counts, and what the recorder costs.

    python3 tools/trace_cell.py trace --workload selfcollide64k.render \\
        --seed 7 --seconds 20 [--recorder 0|1]
    python3 tools/trace_cell.py kernel [--frames 40] [--reps 50]
    python3 tools/trace_cell.py sites

``trace`` runs the cell as ``benchmark/run.py --trace 1`` does (the
harness's program, warm frames and frame loop, ``torch.profiler`` over the
first whole episodes of the window) with the program's recorder
(``softbodyunity_torch/utils/profiling.py``) on over the whole window, or
off with ``--recorder 0``, and leaves out the comparison with the
reference.  It prints one JSON line: the cell's per-layer numbers as the
benchmark's readers read them, its ``idle_gaps``, the block_pairs kernel's
device time a profiled substep by instantiation, the markers' lag behind
the host's notes, and with the recorder ``idle_by_program_span``, the
program's per-layer numbers (``benchmark/program_trace.py``), the share of
the loop's ``step`` idle that falls inside spans below ``api.step``, the
counters and what the read-out took.

``kernel`` times a call of ``make_block_pairs`` (the build's kernels and
the pair kernel) on the 64k pile after ``--frames`` frames, ``--reps``
calls with the recorder on (the counting instantiations) and off,
interleaved: each op's device time a call in ``torch.profiler``, by short
symbol, and the host's time a call with the recorder off, whole and in the
C call alone.  ``sites`` times a span site on
the host with the recorder off, as the program writes it (a check and a
pair of calls) and as a context manager that returns a shared no-op
object, and a span with the recorder on.  Run from the root of a checkout;
``trace`` and ``kernel`` need a CUDA device.
"""

import argparse
import ctypes
import json
import os
import sys
import time
import timeit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _device_us(session, substeps, key):
    """Device us a substep of the ops whose name holds ``key``, by short
    symbol."""
    from benchmark import harness

    out = {}
    for name, start, end in session.events():
        if key in name:
            sym = harness.short_symbol(name)
            out[sym] = out.get(sym, 0.0) + (end - start) * 1e-3 / substeps
    return out


class Alternating:
    """The program's API with the recorder switched on for every other
    ``step`` (and the ``normals`` after it): the recorder's cost within one
    process, frame by frame, so both sides meet the same phases of the
    host.  ``on[k]`` is the state of the k-th frame the profiler left out,
    which is the k-th entry of the loop's host spans."""

    def __init__(self, sb, session):
        self._sb, self._session, self._k, self.on = sb, session, 0, []

    def __getattr__(self, name):
        return getattr(self._sb, name)

    def step(self, *args, **kw):
        from softbodyunity_torch.utils import profiling

        # the tool's A/B switch: the storage stays, spans only pause
        profiling.on = self._k % 2 == 0
        self._k += 1
        if not self._session.on:
            self.on.append(profiling.on)
        return self._sb.step(*args, **kw)


def _by_state(values, on, scale):
    """Means of ``values`` times ``scale`` where ``on`` is True and where
    it is False."""
    pick = {s: [v for v, o in zip(values, on) if o == s] for s in (1, 0)}
    return {("on" if s else "off"): (sum(v) / len(v) * scale if v else None)
            for s, v in pick.items()}


def _clock_dump(session, path):
    """The markers' host notes, device starts and the start of the runtime
    call that launched each (by correlation id) into ``path``."""
    from torch.autograd import DeviceType

    from benchmark.trace import MARKER

    marks, launches = [], {}
    for ev in session._prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CPU:
            launches[ev.correlation_id()] = (ev.name(), ev.start_ns())
        elif MARKER in ev.name():
            marks.append((ev.start_ns(), ev.correlation_id()))
    marks.sort()
    with open(path, "w") as f:
        json.dump({"names": session.names, "noted_ns": session.noted_ns,
                   "marker_start_ns": [m[0] for m in marks],
                   "launch": [launches.get(m[1]) for m in marks]}, f)


def trace(workload, seed, seconds, recorder, device="cuda", base=None,
          bench=None, alternate=False, dump=None):
    """The ``trace`` line; ``base`` and ``bench``: another benchmark folder
    and its ``BENCHMARK.json`` object (a test's shrunk copy), ``device``:
    where the program runs; ``alternate``: the recorder on every other
    frame (:class:`Alternating`); ``dump``: a file for the markers' clock
    readings."""
    from benchmark import harness
    from benchmark import program_trace as pt
    from benchmark import trace as tr
    from softbodyunity_torch.utils import profiling

    class Noted(tr.Session):
        """A session that notes when the profiler started and stopped."""

        def start(self):
            self.start_ns = time.time_ns()
            super().start()

        def stop(self):
            super().stop()
            self.stop_ns = time.time_ns()

    base = base or harness.BENCH
    bench = bench or harness.load_json(os.path.join(os.path.dirname(base),
                                                    "BENCHMARK.json"))
    cell = harness.find_cell(workload, bench, base)
    prog = harness.Program(cell, device, base)
    harness.episode_loop(prog, seed, 0.0, harness.Run(cell),
                         warm_frames=cell.traffic["warm_frames"])
    warm = tr.Session()
    warm.start()
    warm.stop()
    session = Noted()
    prog.sync()
    prog.reset_counters()
    if recorder or alternate:
        profiling.enable()
    if alternate:
        prog.sb = Alternating(prog.sb, session)
    run = harness.Run(cell)
    harness.episode_loop(prog, seed, seconds, run, None, session,
                         profile_s=cell.traffic["profile_seconds"])
    profiling.disable()
    if dump:
        _clock_dump(session, dump)
    t = time.perf_counter()
    rec = profiling.read() if recorder else None
    read_s = time.perf_counter() - t
    events = session.events()
    run.device = dev = tr.reduce(events, session.names, session.substeps,
                                 session.noted_ns)
    out = {"cell": workload, "seed": seed, "recorder": recorder,
           "frames": run.frames, "substeps": run.substeps,
           "window_s": run.window_s}
    for metric in cell.per_layer:
        out[metric] = harness.load_reader(metric, base)(run)
    out["busy_s"], out["profile_s"] = dev.busy_s, dev.window_s
    out["idle_gaps"] = sorted(([k, v] for k, v in dev.idle_s.items()),
                              key=lambda kv: -kv[1])
    out["pair_kernel_us"] = _device_us(session, dev.substeps,
                                       "block_pairs_kernel")
    lags = pt.marker_lags(events, session.noted_ns)
    out["marker_lag"] = pt.lag_summary(lags)
    out["markers_before_note"] = sum(lag < 0 for lag in lags)
    out["counters"] = prog.counters()
    if alternate:
        on = prog.sb.on
        spans = run.spans
        out["alternate"] = {
            "frames": len(on),
            "step_host_us": _by_state(spans["step"], on, 1e6),
            "render_ms": _by_state(
                [a + b for a, b in zip(spans["normals"], spans["readback"])],
                on, 1e3)}
        return out
    if rec is not None:
        offsets = pt.clock_offsets(events, session.noted_ns)
        by_span, by_loop = pt.attribute(events, rec, session.names,
                                        session.noted_ns, offsets)
        profiled = (session.start_ns, session.stop_ns)
        frames = sum(1 for i, name in enumerate(rec.names)
                     if name == "api.step"
                     and profiled[0] <= rec.start_ns[i] <= profiled[1])
        out["idle_by_program_span"] = pt.idle_by_program_span(
            rec, by_span, by_loop)
        out.update(pt.program_metrics(rec, by_span, profiled, dev.substeps,
                                      frames))
        below = (pt.under(rec, by_span, "api.step")
                 - pt.by_name(rec, by_span).get("api.step", 0))
        step_idle = dev.idle_s.get("step", 0.0)
        out["step_idle_below_api_step"] = (below * 1e-9 / step_idle
                                           if step_idle else None)
        out["profiled_frames"] = frames
        out["self_us_per_call"] = {
            name: rec.self_ns[name] / rec.calls[name] * 1e-3
            for name in sorted(rec.calls)}
        out["counters"] = rec.counters
        out["spans"] = len(rec.names)
        out["spans_dropped"] = rec.spans_dropped
        out["read_s"] = read_s
    return out


def kernel(frames, reps):
    import torch

    import softbodyunity_torch as sb
    from benchmark import trace as tr
    from softbodyunity_torch.kernels import blocks
    from softbodyunity_torch.utils import profiling

    host, cfg = sb.presets.build("cloth_selfcollide_64k")
    top, state = sb.init(host, device="cuda")
    for _ in range(frames):
        state = sb.step(top, cfg, state)
    p = cfg.self_collision
    x = state.x
    fn = blocks.make_block_pairs(p, x.shape[0], x.device)
    fn(x)
    profiling.enable()             # both instantiations warm; one counted
    fn(x)
    counters = profiling.read().counters
    torch.cuda.synchronize()
    session = tr.Session()
    session.start()
    for k in range(2 * reps):
        if k % 10 == 0:
            profiling.enable() if (k // 10) % 2 else profiling.disable()
        fn(x)
    session.stop()
    profiling.disable()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(x)
    host_us = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    # the C call alone, with the arguments the wrapper passes
    c_call = blocks._library().block_pairs_build_forces
    args = (ctypes.byref(fn.scratch.build), x.data_ptr(), *x.stride(),
            None, 0, 0, torch.empty((3, x.shape[0]), device=x.device)
            .data_ptr(), None, None, torch.cuda.current_stream().cuda_stream)
    t0 = time.perf_counter()
    for _ in range(reps):
        c_call(*args)
    c_us = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return {"frames": frames, "reps": reps,
            "device_us": _device_us(session, reps, ""),
            "host_us_per_call": host_us, "c_call_us": c_us,
            "counters_per_launch": {
                k: v for k, v in counters.items()
                if k.startswith("block_pairs.")}}


def sites(number=1_000_000):
    from softbodyunity_torch.utils import profiling

    class Noop:
        __slots__ = ()

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    noop = Noop()

    def span(name):
        return noop if not profiling.on else None

    def pair():
        sp = profiling.begin("x") if profiling.on else -1
        if sp >= 0:
            profiling.end(sp)

    def context():
        with span("x"):
            pass

    def empty():
        pass

    def ns(f):
        return min(timeit.repeat(f, number=number, repeat=5)) / number * 1e9

    profiling.disable()
    out = {"empty_call_ns": ns(empty), "pair_off_ns": ns(pair),
           "context_off_ns": ns(context)}
    profiling.enable(capacity=5 * number + 8)
    out["pair_on_ns"] = ns(pair)
    profiling.disable()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="what", required=True)
    t = sub.add_parser("trace")
    t.add_argument("--workload", required=True)
    t.add_argument("--seed", type=int, required=True)
    t.add_argument("--seconds", type=float, default=20.0)
    t.add_argument("--recorder", type=int, choices=(0, 1), default=1)
    t.add_argument("--alternate", action="store_true",
                   help="the recorder on every other frame")
    t.add_argument("--dump", help="a file for the markers' clock readings")
    k = sub.add_parser("kernel")
    k.add_argument("--frames", type=int, default=40)
    k.add_argument("--reps", type=int, default=50)
    sub.add_parser("sites")
    args = p.parse_args(argv)
    if args.what == "trace":
        out = trace(args.workload, args.seed, args.seconds,
                    bool(args.recorder), alternate=args.alternate,
                    dump=args.dump)
    elif args.what == "kernel":
        out = kernel(args.frames, args.reps)
    else:
        out = sites()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
