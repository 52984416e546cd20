"""The frame loop of the six CUDA step wrappers: :mod:`.grid_euler`,
:mod:`.grid_verlet`, :mod:`.grid_xpbd`, :mod:`.lattice_euler`,
:mod:`.lattice_verlet` and :mod:`.lattice_xpbd`.

A wrapper packs its scene once, types its C entry and builds a
:class:`FrameLoop`, which is its step function ``fn(state, dt,
n_substeps, top=None) -> State``.  The loop runs every frame the same way
and knows nothing of solvers:

- the state's layout on the card: each ``[N, 3]`` tensor the solver reads
  is checked and copied into a plane ``[3, *shape]``, ``shape`` that of the
  scene's inverse masses (a grid's ``(ny, nx)``, a lattice's ``(N,)``),
  alone or in a stack of planes, whose rotation the wrapper's kernel knows;
  after the frame the wrapper names the last planes and the loop copies
  them back;
- per call, the collider arguments of the call's topology
  (:meth:`.grid_scene.ColliderRows.args`) and the current stream's handle;
- the call schedule: the frame in one C call, or one call a substep where
  the wrapper says so (with a force plane, and for entries that run one
  substep); before each call the force plane of the substep's start
  positions; after each, its launches counted under the wrapper's name and
  a nonzero error raised with the library's string;
- the host-phase spans ``<name>.planes_in``, ``.pack``, ``.call`` (each C
  call) and ``.planes_out`` while the recorder is on;
- a grid's tear and plastic planes (:class:`.grid_features.CudaFeatures`):
  loaded before the calls, swapped after each launch that writes them (each
  substep's and the frame-end update), gathered to the edges after.

The planes are new tensors every call: the loop keeps nothing of a
frame for the next.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import profiling
from .grid_scene import check_input


def from_planes(p: torch.Tensor) -> torch.Tensor:
    """``[3, *shape]`` -> contiguous ``[N, 3]``."""
    return (p.reshape(3, -1) if p.dim() > 2 else p).t().contiguous()


class FrameLoop:
    """A wrapper's step function.  ``planes`` lists the planes of a call,
    the state's and any scratch of their shape: an entry is one
    ``[3, *shape]`` plane, filled from the state field it names (``"x"``,
    ``"v"``, ``"x_prev"``) or left empty (None), or a tuple of such slots,
    one ``[len(tuple), 3, *shape]`` stack.  The wrapper's hooks, each given
    what the one before returned:

    - ``buffers(planes, dt)``: its own buffers of the call (optional);
    - ``pack(planes, buffers, dt, colliders, stream) -> ctx``: the C
      arguments of the frame;
    - ``call(ctx, k0, n_run, last, f_ext, count) -> err``: one C call of
      substeps ``k0 .. k0 + n_run`` (``last``: the frame's last call;
      ``f_ext``: the force plane's pointer or None), writing its launches
      to ``count``;
    - ``after(ctx, k0, n_run, last) -> launches`` (optional): what follows
      a call, returning the launches it made itself;
    - ``planes_at(ctx, k) -> (x, second)``: the planes of x and of the
      second field read at the start of substep ``k``;
    - ``state(x, second, dt, state, edge_alive, rest_scale) -> State``: the
      next state from the last planes, copied back to ``[N, 3]``.

    ``per_substep``: one call a substep (else one with ``force``, the
    self-collision force plane of ``[3, *shape]`` positions, or None);
    ``features``: the grid's :class:`.grid_features.CudaFeatures` or
    None, also kept as ``fn.features``."""

    def __init__(self, name, lib, scene, planes, *, pack, call, planes_at,
                 state, buffers=None, after=None, per_substep=False,
                 force=None, features=None):
        self.name, self.lib = name, lib
        self.device, self.colliders = scene.device, scene.colliders
        shape = tuple(scene.inv_mass.shape)
        self.plane = (3, *shape)
        # a lattice's rows transposed are already its planes: no reshape
        # (a host dispatch each) on its path
        self.grid = len(shape) > 1
        self.planes = planes
        self.reads = [(f, f"state.{f}") for entry in planes
                      for f in (entry if isinstance(entry, tuple) else
                                (entry,)) if f]
        self.rows = (scene.inv_mass.numel(), 3)
        self.spans = [f"{name}.{phase}" for phase in (
            "planes_in", "pack", "call", "planes_out")]
        self.pack, self.call, self.planes_at, self.state = (pack, call,
                                                           planes_at, state)
        self.buffers, self.after = buffers, after
        self.per_substep = per_substep or force is not None
        self.force, self.features = force, features

    def __call__(self, state, dt: float, n_substeps: int, top=None):
        sp = profiling.begin(self.spans[0]) if profiling.on else -1
        for f, label in self.reads:
            check_input(label, getattr(state, f), self.rows, self.device)
        dt = float(dt)
        planes = []
        for entry in self.planes:
            if isinstance(entry, tuple):
                p = torch.empty((len(entry), *self.plane),
                                dtype=torch.float32, device=self.device)
                for i, f in enumerate(entry):
                    if f:
                        p[i].copy_(getattr(state, f).t().reshape(self.plane))
            elif entry:
                p = getattr(state, entry).t()
                p = (p.reshape(self.plane) if self.grid else p).contiguous()
            else:
                p = torch.empty(self.plane, dtype=torch.float32,
                                device=self.device)
            planes.append(p)
        buffers = self.buffers(planes, dt) if self.buffers else None
        if sp >= 0:
            profiling.end(sp)
        sp = profiling.begin(self.spans[1]) if profiling.on else -1
        colliders = self.colliders.args(self.colliders.built if top is None
                                        else top)
        feat = self.features
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            if feat:
                feat.begin(state)
            ctx = self.pack(planes, buffers, dt, colliders, stream)
            launched = ctypes.c_int()
            count = ctypes.byref(launched)
            calls = ([(k, 1) for k in range(n_substeps)] if self.per_substep
                     else [(0, n_substeps)])
            if sp >= 0:
                profiling.end(sp)
            for k0, n_run in calls:
                # held until the call has read it
                f_ext = (self.force(self.planes_at(ctx, k0)[0]) if self.force
                         else None)
                sp = profiling.begin(self.spans[2]) if profiling.on else -1
                last = k0 + n_run == n_substeps
                err = self.call(ctx, k0, n_run, last, None if f_ext is None
                                else f_ext.data_ptr(), count)
                profiling.add(self.name, launched.value)
                self.lib.check_launch(err, self.name)
                if feat and n_run % 2:
                    feat.swap()
                if self.after:
                    extra = self.after(ctx, k0, n_run, last)
                    if extra:
                        profiling.add(self.name, extra)
                if sp >= 0:
                    profiling.end(sp)
            edge_alive, rest_scale = state.edge_alive, state.rest_scale
            if feat:
                if n_substeps > 0:   # the frame-end update's swap
                    feat.swap()
                edge_alive, rest_scale = feat.end(state)
        sp = profiling.begin(self.spans[3]) if profiling.on else -1
        x, second = self.planes_at(ctx, n_substeps)
        out = self.state(from_planes(x), from_planes(second), dt, state,
                         edge_alive, rest_scale)
        if sp >= 0:
            profiling.end(sp)
        return out
