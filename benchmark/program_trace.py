"""The device's idle time split over the program's own spans, on the clock
the device trace and the program share.

``trace.py`` cuts a traced window by the loop's spans (``step``,
``normals``, ``readback``, ``reset``), and an idle gap there counts for the
span of the op that ends it.  Inside those, the program's recorder
(``softbodyunity_torch/utils/profiling.py``, its ``Record``) notes its own
spans on ``time.time_ns()``, the Unix clock onto which ``torch.profiler``
puts the device's timestamps.  So each idle interval of the device is split
here over the innermost program span the host had open at each instant of
it; what no program span covers goes to the loop's span open then, the last
the loop noted before that instant.

The two clocks are not quite one.  The host notes a marker before it
launches it, so on one clock a marker's lag (device start less host note)
would never be negative; on an H100 the trace's device timestamps drift
against ``time.time_ns()`` by some 10 us a second and are set back now and
then, so that some markers start before their notes (``PERF.md`` §3).  So
each idle interval is moved onto the host's clock by the offset of
the last marker before it: the least lag of the markers within
``WINDOW_NS`` of that one, which is the clock's offset plus the shortest
launch latency, since some marker in the window finds the device idle.  An
idle instant then lands on the host's span that launched the op ending it.

Everything here reads numbers only, from ``(symbol, start_ns, end_ns)``
device events sorted by start (as ``trace.Session.events`` gives them) and
the program's span arrays: it imports neither torch nor the program.
"""

from __future__ import annotations

import bisect
import collections
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

from .trace import MARKER

Interval = Tuple[int, int]

WINDOW_NS = 100_000_000     # markers within 0.1 s set a marker's offset


def idle_intervals(events) -> List[Interval]:
    """The device's idle intervals ``[(start_ns, end_ns)]`` from the first
    marker's start to the last op's end: the gaps in the union of the ops'
    intervals, markers left out, as ``trace.reduce`` counts them."""
    marks = [e for e in events if MARKER in e[0]]
    if not marks:
        return []
    t0 = marks[0][1]
    out = []
    cover = t0
    for name, start, stop in events:
        if start < t0 or MARKER in name:
            continue
        if start > cover:
            out.append((cover, start))
        cover = max(cover, stop)
    return out


def marker_lags(events, noted_ns: Sequence[int]) -> List[int]:
    """Each marker's device start less the host's note of it, in ns, where
    the trace kept every marker (else empty)."""
    marks = [e for e in events if MARKER in e[0]]
    if len(marks) != len(noted_ns):
        return []
    return [m[1] - t for m, t in zip(marks, noted_ns)]


def clock_offsets(events, noted_ns: Sequence[int],
                  window_ns: int = WINDOW_NS):
    """``(marker device starts, offsets)``: each marker's offset, the least
    lag of the markers whose device starts lie within ``window_ns`` of its
    own; None where the trace lost markers."""
    lags = marker_lags(events, noted_ns)
    if not lags:
        return None
    starts = [e[1] for e in events if MARKER in e[0]]
    offsets = []
    window = collections.deque()    # indices, their lags increasing
    hi = 0
    for j, t in enumerate(starts):
        while hi < len(starts) and starts[hi] <= t + window_ns:
            while window and lags[window[-1]] >= lags[hi]:
                window.pop()
            window.append(hi)
            hi += 1
        while starts[window[0]] < t - window_ns:
            window.popleft()
        offsets.append(lags[window[0]])
    return starts, offsets


def to_host_clock(intervals: Sequence[Interval], offsets):
    """``intervals`` on the device trace's clock moved onto the host's by
    the offset of the last marker that started before each (the first
    marker's before it); unmoved where ``offsets`` is None."""
    if offsets is None:
        return list(intervals)
    starts, off = offsets
    out = []
    for a, b in intervals:
        d = off[max(bisect.bisect_right(starts, a) - 1, 0)]
        out.append((a - d, b - d))
    return out


def innermost(spans) -> List[Tuple[int, int, int]]:
    """``[(start, end, key)]``, disjoint and in order, of the innermost of
    the nested spans ``[(start, end, key)]`` (those of one thread) open at
    each instant that any covers."""
    segs = []
    stack: List[Tuple[int, int]] = []      # (end, key), innermost last
    t = 0

    def close_until(limit):
        nonlocal t
        while stack and stack[-1][0] <= limit:
            end, key = stack.pop()
            if end > t:
                segs.append((t, end, key))
            t = max(t, end)

    for start, end, key in sorted(spans):
        close_until(start)
        if stack and start > t:
            segs.append((t, start, stack[-1][1]))
        stack.append((end, key))
        t = start
    close_until(float("inf"))
    return segs


def split(intervals: Sequence[Interval], segs):
    """Split ``intervals`` (disjoint, in order) over ``segs`` (disjoint, in
    order, :func:`innermost`'s): ``(ns by key, [the parts no segment
    covers])``."""
    by_key: Dict[object, int] = {}
    rest: List[Interval] = []
    starts = [s[0] for s in segs]
    for a, b in intervals:
        j = max(bisect.bisect_right(starts, a) - 1, 0)
        t = a
        while t < b:
            if j < len(segs) and segs[j][1] <= t:
                j += 1
                continue
            if j >= len(segs) or segs[j][0] >= b:
                rest.append((t, b))
                break
            s, e, key = segs[j]
            if s > t:
                rest.append((t, s))
                t = s
            hi = min(e, b)
            by_key[key] = by_key.get(key, 0) + hi - t
            t = hi
    return by_key, rest


def loop_segments(names: Sequence[str], noted_ns: Sequence[int]):
    """The loop's spans as :func:`innermost` segments: each from its note
    to the next, the last without end."""
    ends = list(noted_ns[1:]) + [float("inf")]
    return [(s, e, name) for name, s, e in zip(names, noted_ns, ends)
            if e > s]


def attribute(events, rec, loop_names, loop_noted_ns, offsets=None):
    """``(idle ns by program span index, idle ns by loop span name)``: the
    device's idle intervals, moved onto the host's clock by ``offsets``
    (:func:`clock_offsets`), split over the innermost closed span of the
    program's record ``rec`` (its ``start_ns``, ``end_ns``), and the rest
    over the loop's spans."""
    idle = to_host_clock(idle_intervals(events), offsets)
    spans = [(s, e, i)
             for i, (s, e) in enumerate(zip(rec.start_ns, rec.end_ns)) if e]
    by_span, rest = split(idle, innermost(spans))
    by_loop, _ = split(rest, loop_segments(loop_names, loop_noted_ns))
    return by_span, by_loop


def by_name(rec, by_span: Dict[int, int]) -> Dict[str, int]:
    """Idle ns by the name of the innermost span (a span's self part)."""
    out: Dict[str, int] = {}
    for i, ns in by_span.items():
        out[rec.names[i]] = out.get(rec.names[i], 0) + ns
    return out


def under(rec, by_span: Dict[int, int], name: str) -> int:
    """Idle ns while the host was inside a span ``name``, its children
    included."""
    total = 0
    for i, ns in by_span.items():
        while i >= 0 and rec.names[i] != name:
            i = rec.parent[i]
        if i >= 0:
            total += ns
    return total


def idle_by_program_span(rec, by_span, by_loop, top: int = 10):
    """The breakdown's ``[[name, s]]``: idle seconds by the innermost
    program span, the loop's spans for what none covers, largest first."""
    merged = dict(by_name(rec, by_span))
    for name, ns in by_loop.items():
        merged[name] = merged.get(name, 0) + ns
    ranked = sorted(merged.items(), key=lambda kv: -kv[1])[:top]
    return [[name, ns * 1e-9] for name, ns in ranked]


# the host phases of a frame around the kernel's C calls
WRAPPER_SPANS = ("api.lookup", "grid_euler.planes_in", "grid_euler.pack",
                 "grid_euler.planes_out")


def frames_outside(rec, profiled: Interval) -> List[int]:
    """The ``api.step`` spans that started outside ``profiled``."""
    lo, hi = profiled
    return [i for i, name in enumerate(rec.names)
            if name == "api.step" and rec.end_ns[i]
            and not lo <= rec.start_ns[i] <= hi]


def host_us(rec, profiled: Interval) -> Dict[str, Optional[float]]:
    """Over the frames outside the profile: ``selfcollide_host_us``, the
    mean ``selfcollide`` span, and ``wrapper_host_us``, a frame's
    ``api.step`` self time plus its lookup and the wrapper's phases (all
    but the C calls and the force plane); None where no such span ran."""
    roots = frames_outside(rec, profiled)
    frames = set(rec.frame[i] for i in roots)
    wrapper = sc = n_sc = 0
    covered: Dict[int, int] = {}
    for i, name in enumerate(rec.names):
        if not rec.end_ns[i] or rec.frame[i] not in frames:
            continue
        d = rec.end_ns[i] - rec.start_ns[i]
        if rec.parent[i] >= 0:
            covered[rec.parent[i]] = covered.get(rec.parent[i], 0) + d
        if name == "selfcollide":
            sc += d
            n_sc += 1
        elif name in WRAPPER_SPANS:
            wrapper += d
    wrapper += sum(rec.end_ns[i] - rec.start_ns[i] - covered.get(i, 0)
                   for i in roots)
    return {"selfcollide_host_us": sc / n_sc * 1e-3 if n_sc else None,
            "wrapper_host_us": wrapper / len(frames) * 1e-3 if frames
            else None}


def program_metrics(rec, by_span, profiled: Interval, substeps: int,
                    frames: int) -> Dict[str, Optional[float]]:
    """The program's per-layer numbers of a traced window:
    :func:`host_us`'s two, ``selfcollide_idle_us`` (device idle while the
    host was inside ``selfcollide``, a profiled substep),
    ``normals_idle_us`` (inside ``api.normals``, a profiled frame) and
    ``pair_hit_pct`` (the pair kernel's pairs within the radius over the
    pairs it swept, from its counters); None where nothing was read."""
    out = host_us(rec, profiled)
    has = set(rec.names)
    out["selfcollide_idle_us"] = (
        under(rec, by_span, "selfcollide") * 1e-3 / substeps
        if "selfcollide" in has and substeps else None)
    out["normals_idle_us"] = (
        under(rec, by_span, "api.normals") * 1e-3 / frames
        if "api.normals" in has and frames else None)
    swept = rec.counters.get("block_pairs.pairs_swept", 0)
    out["pair_hit_pct"] = (
        100.0 * rec.counters.get("block_pairs.pairs_in_reach", 0) / swept
        if swept else None)
    return out


def lag_summary(lags: Sequence[int]) -> Dict[str, Optional[float]]:
    """Least, median and largest marker lag, in us."""
    if not lags:
        return {"min_us": None, "median_us": None, "max_us": None}
    return {"min_us": min(lags) * 1e-3,
            "median_us": statistics.median(lags) * 1e-3,
            "max_us": max(lags) * 1e-3}
