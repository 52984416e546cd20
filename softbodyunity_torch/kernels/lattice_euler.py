"""Wrapper of the hand-written fused Euler lattice substep, ``csrc/lattice_euler.cu``.

Counterpart of ``softbodyunity_tpu/kernels/pallas_lattice.py::make_lattice_step``.
The plain PyTorch version is :func:`softbodyunity_torch.solver.step.make_plain_step`;
:mod:`.dispatch` takes it for tensors on the CPU and this wrapper for
tensors on a CUDA device, where it launches the kernels or raises.

A substep is one ``ctypes`` call, ``lattice_euler_substep``, which
launches three kernels: integrate, then a tet pass (each tet evaluated
once) and a gather pass (the terms summed at each vertex); with no volume
constraint the integrate alone, with the contact (1 launch).  Each launch
counts once.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.config import SimConfig, Solver
from ..core.state import State
from ..core.topology import Topology
from ..utils import profiling
from .build import Library
from .frame import FrameLoop
from .grid_scene import CollidersStruct, WindStruct
from .lattice import pack_lattice_scene, use_volume


# launch_count(): kernel launches (integrate, tet and gather passes) since
# the last reset_launch_count()
launch_count, reset_launch_count = profiling.launch_views("lattice_euler")


def launches_per_substep(top: Topology, cfg: SimConfig) -> int:
    """Integrate plus, with the volume constraint on, the tet and gather
    passes."""
    return 1 + 2 * int(use_volume(top, cfg))


def launches_per_call(top: Topology, cfg: SimConfig, n_substeps: int) -> int:
    """Launches of one call ``fn(state, dt, n_substeps)``."""
    return n_substeps * launches_per_substep(top, cfg)


class _Params(ctypes.Structure):
    _fields_ = [(name, ctypes.c_float) for name in (
        "dt", "damping", "gx", "gy", "gz", "decay", "restitution",
        "restitution1", "keep", "vol_stiff")]


class _Substep(ctypes.Structure):
    """``csrc/lattice_euler.cu::LatticeEulerSubstep`` field by field."""

    _fields_ = [
        *[(name, ctypes.c_void_p) for name in (
            "inv_mass", "bits", "edges", "tets", "cnt", "tscr", "stream")],
        *[(name, ctypes.c_int) for name in ("n_edge", "n_tet", "n",
                                            "drag_on")],
        ("col", CollidersStruct),
        ("wind", WindStruct),
        ("p", _Params),
    ]


class _Planes(ctypes.Structure):
    """``csrc/lattice_euler.cu::LatticeEulerPlanes``: the call's planes,
    which each substep rotates."""

    _fields_ = [(name, ctypes.c_void_p)
                for name in ("x", "v", "x_out", "v_out")]


@functools.cache
def _library():
    lib = Library("lattice_euler", substep=_Substep)
    lib.declare("lattice_euler_substep", [
        ctypes.POINTER(_Substep), ctypes.POINTER(_Planes),
        ctypes.POINTER(ctypes.c_int)])
    return lib


def make_cuda_step(top: Topology, cfg: SimConfig):
    """Build ``fn(state, dt, n_substeps) -> state`` that runs each substep
    as one ``lattice_euler_substep`` call (integrate, tet and gather
    launches).  The result carries ``x_prev = x - dt * v``, as the plain
    version's.

    The ownership words, the group tables and the tet counts are packed
    once, here, on the device; the scratch planes of the tet terms
    (csrc/lattice_common.cuh ``kTetPlanes``) once a call, on the call's
    stream, as the other buffers; the collider rows once per topology a
    call brings (``fn(state, dt, n, top=)``, :class:`.grid_scene.ColliderRows`).
    Each frame runs through :class:`.frame.FrameLoop`."""
    sc = pack_lattice_scene(top, cfg, Solver.SEMI_IMPLICIT_EULER,
                            "lattice_euler")
    n, device = sc.n, sc.device
    col = cfg.collision
    gx, gy, gz = cfg.gravity
    w = cfg.wind
    lib = _library()
    substep = lib.lattice_euler_substep

    def buffers(planes, dt):
        # the planes by address: the C call rotates them in _Planes
        return (torch.empty((3 * sc.n_tet, n, 4), dtype=torch.float32,
                            device=device),
                {t.data_ptr(): t for t in planes})

    def pack(planes, bufs, dt, colliders, stream):
        (x, v, x_out, v_out), (tscr, by_ptr) = planes, bufs
        args = _Substep(
            sc.inv_mass.data_ptr(), sc.bits.data_ptr(),
            sc.edges.data_ptr(), sc.tets.data_ptr(), sc.cnt.data_ptr(),
            tscr.data_ptr(), stream, sc.n_edge, sc.n_tet, n,
            int(w.enabled), CollidersStruct(*colliders),
            WindStruct(*w.velocity, w.drag, 0.0),
            _Params(dt, cfg.springs.damping, gx, gy, gz,
                    1.0 - cfg.global_damping * dt, col.restitution,
                    1.0 + col.restitution, 1.0 - col.friction,
                    cfg.volume_stiffness))
        q = _Planes(x.data_ptr(), v.data_ptr(), x_out.data_ptr(),
                    v_out.data_ptr())
        return ctypes.byref(args), ctypes.byref(q), q, by_ptr

    def call(ctx, k0, n_run, last, f_ext, count):
        return substep(ctx[0], ctx[1], count)

    def planes_at(ctx, k):
        q, by_ptr = ctx[2:]
        return by_ptr[q.x], by_ptr[q.v]

    def state(x, v, dt, *_):
        return State(x=x, v=v, x_prev=x - dt * v)

    return FrameLoop(
        "lattice_euler", lib, sc, ("x", "v", None, None),
        buffers=buffers, pack=pack, call=call, planes_at=planes_at,
        state=state, per_substep=True)
