"""One run of one cell: set-up, the measured window, the traced part, the
check, the result line.

Everything a cell is made of is found by name from ``BENCHMARK.json``: its
configuration file (``configs/<config>.json``, which names the program's
scene builder and its plain reference, ``reference/<name>.py``), its
traffic mix (``traffic/<mix>.json``, read by the one frame loop below) and
a reader module for each of its metrics (``metrics/<metric>.py``, a
``read(run)`` that returns a number, or None where it finds nothing to
read).  A later cell, configuration, mix or metric is new files and new
entries, no edit here.

The loop is closed: a frame starts when the one before it has finished.
Every ``episode_frames`` frames the scene is reset to the next episode's
seeded start state, so the mix of states in the window is the same however
fast the program runs; the window starts at the start of an episode.  Per
frame the loop calls the program's ``step``, then ``normals``, then copies
the positions and normals into two pinned host buffers allocated once; a
frame ends when both are on the host.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import traceback
from typing import Dict, List, Optional

from . import check as checks
from . import scene as scenes

BENCH = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "softbodyunity_tpu")


class Refused(Exception):
    """A run that cannot give a result: exit non-zero, print none."""


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[str]
    per_layer: List[str]


def find_cell(name: str, bench: Optional[dict] = None,
              base: str = BENCH) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration, its
    mix and the names of the metrics it reports."""
    bench = bench if bench is not None else load_json(
        os.path.join(os.path.dirname(base), "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(os.path.dirname(base),
                                    configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(base, "traffic",
                                     w["traffic"] + ".json"))

    def names(metrics):
        return [m["name"] for m in metrics
                if name in m.get("workloads", [name])]

    return Cell(name, w["chips"], config, traffic,
                names(bench["end_to_end"]), names(bench["per_layer"]))


def forbidden_modules() -> List[str]:
    """The modules of the JAX side that this process holds, compared by
    their whole top-level name."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    setup_s: float = 0.0
    window_s: float = 0.0
    substeps: int = 0
    frames: int = 0
    failed: int = 0
    frame_s: List[float] = dataclasses.field(default_factory=list)
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    device: object = None           # trace.DeviceRecord of a traced run


class Program:
    """The program under test, set up for one cell on one device, with the
    cell's reference module, whose rest shape is every episode's start."""

    def __init__(self, cell: Cell, device: str, base: str = BENCH):
        import torch

        import softbodyunity_torch as sb

        self.torch, self.sb, self.cell = torch, sb, cell
        self.device = torch.device(device)
        self.reference = load_module(base, "reference",
                                     cell.config["reference"])
        host, self.cfg = scenes.build(sb, cell.config)
        self.top, _ = sb.init(host, device=self.device)
        self.rest = self.reference.rest_positions(cell.config["scene"]).to(
            self.device, torch.float32)
        self.n = self.rest.shape[0]
        self.n_substeps = self.cfg.n_substeps
        pin = self.device.type == "cuda"
        self.host_x = torch.empty((self.n, 3), dtype=torch.float32,
                                  pin_memory=pin)
        self.host_n = torch.empty_like(self.host_x, pin_memory=pin)

    def start(self, seed: int, episode: int):
        """The start state of ``episode``, as the benchmark hands it to the
        program."""
        v = self.reference.start_velocity(
            self.cell.config, scenes.episode_generator(seed, episode),
            self.device)
        return self.sb.State(x=self.rest, v=v,
                             x_prev=self.rest - self.cfg.dt * v)

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def step_builds(self) -> int:
        from softbodyunity_torch import api

        return api._build_step.cache_info().misses

    def _counted(self):
        """The program's kernel wrappers loaded so far that count their
        launches, by module name."""
        prefix = "softbodyunity_torch.kernels."
        return {name[len(prefix):]: mod
                for name, mod in sorted(sys.modules.items())
                if name.startswith(prefix)
                and callable(getattr(mod, "launch_count", None))
                and callable(getattr(mod, "reset_launch_count", None))}

    def counters(self) -> Dict[str, int]:
        """Launches since :meth:`reset_counters`, of each wrapper that
        launched."""
        counts = {f"{name}_launches": mod.launch_count()
                  for name, mod in self._counted().items()}
        return {k: v for k, v in counts.items() if v}

    def reset_counters(self):
        for mod in self._counted().values():
            mod.reset_launch_count()


def episode_loop(prog: Program, seed: int, seconds: float, run: Run,
                 sample: Optional[checks.Sample] = None, session=None,
                 profile_s: float = 0.0, warm_frames: int = 0):
    """The frame loop.  With ``warm_frames`` it runs that many frames of
    the first episode and returns (the warm-up, where a step that raises
    ends the run); else it runs episodes for ``seconds`` and fills ``run``,
    where a step that raises counts as a failed frame and ends its
    episode.  With ``session`` (a traced run) the profiler covers the whole
    episodes that start before ``profile_s`` has passed, and those frames
    stay out of the host spans."""
    from time import perf_counter

    sb, top, cfg = prog.sb, prog.top, prog.cfg
    traffic = prog.cell.traffic
    per_episode = traffic["episode_frames"]
    hx, hn = prog.host_x, prog.host_n
    spans = run.spans
    for name in ("step", "normals", "readback", "reset"):
        spans.setdefault(name, [])
    mark = session.mark if session is not None else (lambda name: None)
    t_start = perf_counter()
    deadline = t_start + seconds
    episode = 0
    done = False
    while not done:
        if session is not None and episode == 0:
            session.start()
        profiled = session is not None and session.on
        mark("reset")
        t = perf_counter()
        state = prog.start(seed, episode)
        if not profiled:
            spans["reset"].append(perf_counter() - t)
        keep = sample.begin(episode) if sample is not None else None
        frames_done = 0
        normals = None
        for k in range(1, per_episode + 1):
            t0 = perf_counter()
            mark("step")
            try:
                new = sb.step(top, cfg, state)
            except Exception:
                if warm_frames:
                    raise
                run.failed += 1
                run.frames += 1
                if run.failed == 1:
                    traceback.print_exc()
                break
            t1 = perf_counter()
            mark("normals")
            normals = sb.normals(top, new)
            t2 = perf_counter()
            mark("readback")
            hx.copy_(new.x, non_blocking=True)
            hn.copy_(normals, non_blocking=True)
            prog.sync()
            t3 = perf_counter()
            run.frame_s.append(t3 - t0)
            if not profiled:
                spans["step"].append(t1 - t0)
                spans["normals"].append(t2 - t1)
                spans["readback"].append(t3 - t2)
            if keep is not None and k in keep[0]:
                keep[1].append(checks.Kept(k, state, hx.clone(), hn.clone()))
            if profiled:
                session.substeps += prog.n_substeps
            state = new
            frames_done += 1
            run.frames += 1
            run.substeps += prog.n_substeps
            if warm_frames and frames_done >= warm_frames:
                done = True
                break
            if not warm_frames and perf_counter() >= deadline:
                done = True
                break
        # a NaN never leaves these scenes (it spreads to the neighbours
        # every substep), so a finite last frame clears the episode
        x_ok = prog.torch.isfinite(state.x).all()
        if frames_done:
            x_ok = x_ok & prog.torch.isfinite(normals).all()
        if not bool(x_ok):
            run.failed += frames_done
        done = done or perf_counter() >= deadline
        if session is not None and session.on and (
                done or perf_counter() - t_start >= profile_s):
            session.stop()
        episode += 1
    prog.sync()
    run.window_s = perf_counter() - t_start


def load_module(base: str, folder: str, name: str):
    """The module ``<folder>/<name>.py`` of the benchmark folder ``base``,
    found by its file, so that a tree with new files needs no package."""
    import importlib.util

    path = os.path.join(base, folder, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{folder}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, base: str = BENCH):
    """The ``read`` function of ``metrics/<name>.py``."""
    return load_module(base, "metrics", name).read


def short_symbol(name: str, keep: int = 160) -> str:
    """A kernel's symbol without its parameter list, its return type and
    ``(anonymous namespace)::``, cut to ``keep`` characters: the name and
    the template arguments that say which operation it is."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i > 0 else name
                break
    return name[:keep].strip()


def units(bench: dict) -> Dict[str, str]:
    return {m["name"]: m["unit"]
            for m in bench["end_to_end"] + bench["per_layer"]}


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", bench: Optional[dict] = None,
             setup_from: Optional[float] = None, age: float = 0.0,
             base: str = BENCH):
    """Run one cell once; returns ``(result, numbers, limits)``, the result
    line's object with the numbers compared beside their limits last.
    ``setup_from`` is the ``perf_counter`` reading that ``age`` seconds of
    the process's life had passed at (the set-up's start)."""
    from time import perf_counter

    import torch

    t = perf_counter()
    if setup_from is None:
        setup_from = t
    # the set-up's phases, on standard error: what a slow set-up spent
    phases = {"process_s": age, "imports_s": t - setup_from}
    bench = bench if bench is not None else load_json(
        os.path.join(os.path.dirname(base), "BENCHMARK.json"))
    cell = find_cell(name, bench, base)
    cuda = torch.device(device).type == "cuda"
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < cell.chips):
        raise Refused(
            f"{name} needs {cell.chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    phases["device_query_s"] = perf_counter() - t
    t = perf_counter()
    prog = Program(cell, device, base)
    prog.sync()
    phases["program_s"] = perf_counter() - t
    t = perf_counter()
    episode_loop(prog, seed, 0.0, Run(cell),
                 warm_frames=cell.traffic["warm_frames"])
    session = None
    if trace:
        from .trace import Session

        warm = Session()      # the profiler's first start, out of the window
        warm.start()
        warm.stop()
        session = Session()
    prog.sync()
    builds = prog.step_builds()
    prog.reset_counters()
    run = Run(cell)
    run.setup_s = age + perf_counter() - setup_from
    phases["warm_s"] = perf_counter() - t
    sample = checks.Sample(seed, cell.config, cell.traffic["episode_frames"])
    episode_loop(prog, seed, seconds, run, sample, session,
                 profile_s=cell.traffic["profile_seconds"])
    peak = torch.cuda.max_memory_allocated(prog.device) if cuda else 0
    counters = prog.counters()
    counters["step_builds_in_window"] = prog.step_builds() - builds
    if session is not None:
        run.device = session.record()
    unit = units(bench)
    metrics = {}
    for metric in (cell.per_layer if trace else cell.end_to_end):
        value = load_reader(metric, base)(run)
        if value is not None:
            metrics[metric] = {"value": value, "unit": unit[metric]}

    def start_state(episode):
        s = prog.start(seed, episode)
        return s.x, s.v

    numbers = checks.compare(cell.config, prog.reference, sample.episodes(),
                             start_state, prog.device)
    numbers["step_builds"] = counters["step_builds_in_window"]
    limits = dict(cell.config["check"]["limits"], step_builds=0)
    correct = (run.failed == 0
               and all(k in numbers and numbers[k] <= v
                       for k, v in limits.items()))
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": (torch.cuda.get_device_name(prog.device) if cuda
                    else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": run.frames,
              "failed": run.failed, "metrics": metrics, "device": dev}
    rec = run.device
    if trace and rec is not None:
        dev["busy_s"] = rec.busy_s
        dev["window_s"] = rec.window_s
        by_symbol: Dict[str, float] = {}
        for name, secs in rec.op_s.items():
            key = short_symbol(name)
            by_symbol[key] = by_symbol.get(key, 0.0) + secs
        top_ops = sorted(by_symbol.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(rec.idle_s.items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [list(kv) for kv in top_ops],
                               "idle_gaps": [list(kv) for kv in idle]}
    # a number that is not finite (a NaN in a frame) fails; JSON carries it
    # as null, standard error as inf
    result["check"] = {k: {"value": (numbers[k] if k in numbers
                                     and math.isfinite(numbers[k]) else None),
                           "limit": v}
                       for k, v in limits.items()}
    info = {"cell": name, "seed": seed, "frames": run.frames,
            "substeps": run.substeps, "window_s": run.window_s,
            "episodes_kept": [e for e, _ in sample.episodes()],
            "setup": phases, **counters}
    if run.frame_s:
        import statistics

        info["frame_ms_median"] = statistics.median(run.frame_s) * 1e3
    if session is not None:
        info["trace_events"] = session.n_events
        info["trace_markers"] = session.n_markers
        info["spans_noted"] = len(session.names)
    if rec is not None:
        info["profiled_substeps"] = rec.substeps
        info["profiled_ops"] = rec.n_ops
        info["longest_gaps"] = rec.gaps
    print(json.dumps(info), file=sys.stderr)
    return result, numbers, limits
