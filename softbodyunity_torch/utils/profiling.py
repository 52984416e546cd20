"""One recorder for the port: launch counters, host spans and device
counters.

Counterpart of ``softbodyunity_tpu/utils/profiling.py``, which wraps
``jax.profiler``.  Here the program notes what a device trace cannot see,
the host's phases and what a kernel found, on the clock the trace uses:

* **Counters**, always on.  Each kernel wrapper counts its launches here
  under its own name (:func:`add`); its ``launch_count()`` and
  ``reset_launch_count()`` are views of :func:`count` and
  :func:`reset_count`.  Thread-safe: the halo paths launch the pair
  kernel's dual form from one thread per rank.
* **Spans**, only while the recorder is on (:func:`enable`).  A span has a
  name (``module.phase``), a start and an end from ``time.time_ns()`` (the
  Unix clock onto which ``torch.profiler`` puts the device's timestamps),
  the span open around it on the same thread (its parent) and the frame it
  belongs to: ``api.step`` starts a frame, and every span until the next
  one, ``api.normals`` among them, shares its number.  A site costs one
  module-level check while the recorder is off::

      sp = profiling.begin("grid_euler.call") if profiling.on else -1
      ...
      if sp >= 0:
          profiling.end(sp)

  (cheaper than a context manager that returns a shared no-op object:
  ``PERF.md`` §3 gives both costs).  Spans are kept in arrays that
  :func:`enable` allocates, so recording never grows a list; spans past
  the capacity are counted as ``spans_dropped``, not kept.
* **Device counters**, only while the recorder is on.  A kernel with a
  counting instantiation (``csrc/block_pairs.cu``) adds into an int64
  buffer from :func:`device_counters`, allocated once with its step
  function.  :func:`enable` zeroes the buffers and :func:`read` reads them,
  synchronising once: neither runs between the frames it measures.

Use::

    from softbodyunity_torch.utils import profiling

    profiling.enable()
    for _ in range(60):
        state = sb.step(top, cfg, state)
        n = sb.normals(top, state)
    rec = profiling.read()   # rec.self_ns["grid_euler.call"], rec.counters
    profiling.disable()
"""

from __future__ import annotations

import array
import dataclasses
import itertools
import threading
import time
import weakref
from typing import Dict, List, Sequence

import torch

DEFAULT_CAPACITY = 1 << 20

on = False                  # spans and device counters are recorded

_lock = threading.Lock()
_counts: Dict[str, int] = {}
_buffers: list = []         # (counter names, weakref to the int64 buffer)

# A span is its begin's index; begin stores its name, thread and start,
# end its end.  Parents and frames are found by read(), not while
# recording: a clock read costs ~0.5 us on the H100's host, and every
# stored field ~0.1-0.4 us more (PERF.md §3).
_cap = 0
_issued = itertools.count()  # span indices; next() is atomic
_names: List[str] = []
_thread = array.array("q")
_root = array.array("b")    # 1: the first span of a frame
_start = array.array("q")
_end = array.array("q")     # 0 while the span is open
_now = time.time_ns
_ident = threading.get_ident


def add(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (a wrapper's launches)."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def count(name: str) -> int:
    return _counts.get(name, 0)


def reset_count(*names: str) -> None:
    with _lock:
        for name in names:
            _counts[name] = 0


def device_counters(names: Sequence[str], device) -> torch.Tensor:
    """A zeroed int64 buffer of one counter per name on ``device``, which
    :func:`enable` zeroes and :func:`read` sums by name while the caller
    keeps it.  Allocate it once, with the step function, not per call."""
    buf = torch.zeros(len(names), dtype=torch.int64, device=device)
    with _lock:
        _buffers[:] = [b for b in _buffers if b[1]() is not None]
        _buffers.append((tuple(names), weakref.ref(buf)))
    return buf


def _live_buffers():
    with _lock:
        return [(names, buf) for names, ref in _buffers
                if (buf := ref()) is not None]


def enable(capacity: int = DEFAULT_CAPACITY) -> None:
    """Start recording spans (up to ``capacity``) and device counters;
    forgets the spans of an earlier recording and zeroes the device
    counters.  Call it between frames, not inside one."""
    global on, _cap, _issued, _names, _thread, _root, _start, _end
    on = False
    _cap, _issued = int(capacity), itertools.count()
    # storage that recording fills without allocating an object
    _names = [""] * _cap
    _root = array.array("b", bytes(_cap))
    zeros = bytes(8 * _cap)
    _thread, _start, _end = (array.array("q", zeros) for _ in range(3))
    for _, buf in _live_buffers():
        buf.zero_()
    on = True


def disable() -> None:
    """Stop recording; what was recorded stays readable."""
    global on
    on = False


def begin(name: str, new_frame: bool = False) -> int:
    """Open the span ``name`` on this thread (``new_frame``: as the root of
    a new frame, which closes nothing but is the parent of no span that an
    exception left open); returns its index for :func:`end`, or -1 where
    the storage is full."""
    i = next(_issued)
    if i >= _cap:
        return -1
    _names[i] = name
    _thread[i] = _ident()
    if new_frame:
        _root[i] = 1
    _start[i] = _now()
    return i


def end(i: int) -> None:
    """Close the span ``i`` (one that an exception left open keeps no
    end)."""
    _end[i] = _now()


def _nest(n, start, end_, thread, root):
    """Each span's parent (the innermost span of its thread still open
    when it began, -1 for none and for a frame's first span) and frame
    (the number of frames begun up to it, on any thread)."""
    parent = array.array("q", [-1]) * n
    frame = array.array("q", bytes(8 * n))
    open_: Dict[int, List[int]] = {}
    f = 0
    for i in range(n):
        if root[i]:
            f += 1
            stack = open_[thread[i]] = []
        else:
            stack = open_.setdefault(thread[i], [])
            while stack and 0 < end_[stack[-1]] <= start[i]:
                stack.pop()
            if stack:
                parent[i] = stack[-1]
        frame[i] = f
        stack.append(i)
    return parent, frame


@dataclasses.dataclass
class Record:
    """What :func:`read` returns.  Span ``i`` is ``names[i]``,
    ``start_ns[i]``, ``end_ns[i]`` (0: never closed), ``parent[i]`` (-1: a
    root) and ``frame[i]``; by name, the closed spans' ``calls`` and
    ``self_ns``, each span's duration less the time its closed children
    cover."""

    names: List[str]
    start_ns: array.array
    end_ns: array.array
    parent: array.array
    frame: array.array
    spans_dropped: int
    calls: Dict[str, int]
    self_ns: Dict[str, int]
    counters: Dict[str, int]


def read() -> Record:
    """The spans recorded since :func:`enable`, self time by name, the
    launch counters and the device counters (one synchronise, where a
    buffer is on a card).  Call it after the frames, not during them."""
    global _issued
    issued = next(_issued)
    _issued = itertools.count(issued)
    n = min(issued, _cap)
    names, start, end_ = _names[:n], _start[:n], _end[:n]
    parent, frame = _nest(n, start, end_, _thread, _root)
    covered = [0] * n
    for i in range(n):
        p = parent[i]
        if p >= 0 and end_[i]:
            covered[p] += end_[i] - start[i]
    calls: Dict[str, int] = {}
    own: Dict[str, int] = {}
    for i in range(n):
        if not end_[i]:
            continue
        name, d = names[i], end_[i] - start[i]
        calls[name] = calls.get(name, 0) + 1
        own[name] = own.get(name, 0) + d - covered[i]
    with _lock:
        counters = dict(_counts)
    live = _live_buffers()
    for dev in {buf.device for _, buf in live if buf.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    for names_, buf in live:
        for name, v in zip(names_, buf.tolist()):
            counters[name] = counters.get(name, 0) + v
    return Record(names, start, end_, parent, frame, max(0, issued - _cap),
                  calls, own, counters)
