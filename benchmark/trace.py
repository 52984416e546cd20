"""The device trace of a traced run: ``torch.profiler`` over a steady part
of the window, cut into the benchmark's host spans by marker kernels.

While the profiler runs, the loop launches one marker kernel
(``torch.cuda._sleep(0)``, whose kernel is ``spin_kernel``) at the start of
every span (``step``, ``normals``, ``readback``, ``reset``) and notes the
span's name and the host's clock.  The program runs on one stream, so the
device ops between two markers are the ops that the span issued.  The n-th
marker of the trace is the n-th span noted; where the trace lost a few
markers (the profiler can drop records), each marker takes the last span
noted before it started, on the trace's clock (epoch nanoseconds, as
``time.time_ns``) moved by the first marker's lag.  Markers are left out of
every sum and count; an idle gap on the device counts for the span of the
op that ends it, since the host was on its way to launch that op.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

MARKER = "spin_kernel"


@dataclasses.dataclass
class DeviceRecord:
    """What the readers take from the trace of the profiled frames."""

    substeps: int                    # substeps the profiled frames ran
    window_s: float                  # first marker's start to last op's end
    busy_s: float                    # union of the ops' intervals
    n_ops: int                       # kernels, memcpys and memsets
    op_s: Dict[str, float]           # device seconds by symbol
    span_op_s: Dict[str, Dict[str, float]]   # span -> symbol -> seconds
    idle_s: Dict[str, float]         # span -> idle seconds before its ops
    gaps: List[Tuple[str, float]]    # the longest single gaps


class Session:
    """One profiler session over the frames the loop chooses."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self.names: List[str] = []
        self.noted_ns: List[int] = []
        self.substeps = 0
        self.on = False

    def start(self) -> None:
        self._prof.start()
        self.on = True

    def stop(self) -> None:
        self._torch.cuda.synchronize()
        self._prof.stop()
        self.on = False

    def mark(self, name: str) -> None:
        if self.on:
            self.names.append(name)
            self.noted_ns.append(time.time_ns())
            self._torch.cuda._sleep(0)

    def events(self):
        """``[(name, start_ns, end_ns)]`` of the device's events, by start."""
        from torch.autograd import DeviceType

        out = []
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() == DeviceType.CPU:
                continue
            out.append((ev.name(), ev.start_ns(), ev.end_ns()))
        out.sort(key=lambda e: e[1])
        return out

    def record(self) -> Optional[DeviceRecord]:
        events = self.events()
        self.n_events = len(events)
        self.n_markers = sum(MARKER in e[0] for e in events)
        return reduce(events, self.names, self.substeps, self.noted_ns)


def marker_spans(marks, names, noted_ns=None) -> Optional[List[str]]:
    """The span of each marker ``(symbol, start_ns, end_ns)``: the n-th
    name noted, or, where markers were lost, the last name noted before the
    marker started (host times ``noted_ns`` moved by the first marker's
    lag); None where that cannot be told."""
    if len(marks) == len(names):
        return list(names)
    if not noted_ns or len(marks) > len(names):
        return None
    lag = marks[0][1] - noted_ns[0]
    out, j = [], -1
    for mark in marks:
        t = mark[1] - lag
        j += 1                      # each marker is a later span than the last
        while j + 1 < len(names) and noted_ns[j + 1] <= t:
            j += 1
        if j >= len(names):
            return None
        out.append(names[j])
    return out


def reduce(events, names, substeps, noted_ns=None) -> Optional[DeviceRecord]:
    """Reduce the device events ``[(symbol, start_ns, end_ns)]`` sorted by
    start, with the span names noted at the markers (and the host's epoch
    nanoseconds when each was noted), to a :class:`DeviceRecord`; None when
    the trace holds no marker or its markers cannot be matched to spans."""
    marks = [e for e in events if MARKER in e[0]]
    spans = marker_spans(marks, names, noted_ns) if marks else None
    if spans is None or substeps <= 0:
        return None
    names = spans
    t0 = marks[0][1]
    span = None
    k = 0
    last_end = None
    busy = 0.0
    cover_end = t0
    n_ops = 0
    op_s: Dict[str, float] = {}
    span_op_s: Dict[str, Dict[str, float]] = {}
    idle_s: Dict[str, float] = {}
    gaps: List[Tuple[str, float]] = []
    end = t0
    for name, start, stop in events:
        if start < t0:
            continue
        if MARKER in name:
            span = names[k]
            k += 1
            continue
        dur = (stop - start) * 1e-9
        n_ops += 1
        op_s[name] = op_s.get(name, 0.0) + dur
        per = span_op_s.setdefault(span, {})
        per[name] = per.get(name, 0.0) + dur
        gap_from = t0 if last_end is None else last_end
        if start > gap_from:
            gap = (start - gap_from) * 1e-9
            idle_s[span] = idle_s.get(span, 0.0) + gap
            gaps.append((span, gap))
        # the union of intervals: ops of one stream do not overlap, but a
        # copy engine's may
        lo = max(start, cover_end)
        if stop > lo:
            busy += (stop - lo) * 1e-9
            cover_end = stop
        last_end = stop if last_end is None else max(last_end, stop)
        end = max(end, stop)
    gaps.sort(key=lambda g: -g[1])
    return DeviceRecord(substeps=substeps, window_s=(end - t0) * 1e-9,
                        busy_s=busy, n_ops=n_ops, op_s=op_s,
                        span_op_s=span_op_s,
                        idle_s=idle_s, gaps=gaps[:10])
