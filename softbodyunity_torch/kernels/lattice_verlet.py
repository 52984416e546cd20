"""Wrapper of the hand-written fused Verlet lattice substep, ``csrc/lattice_verlet.cu``.

Counterpart of ``softbodyunity_tpu/kernels/pallas_lattice.py::make_lattice_verlet_step``.
The plain PyTorch version is :func:`softbodyunity_torch.solver.step.make_plain_step`;
:mod:`.dispatch` takes it for tensors on the CPU and this wrapper for
tensors on a CUDA device, where it launches the kernels or raises.

A substep is one ``ctypes`` call, ``lattice_verlet_substep``, which
launches three kernels: integrate (the springs' damper reading each
neighbour's velocity estimate from a plane the last substep wrote), then a
tet pass (each tet evaluated once) and a gather pass (the terms summed at
each vertex; it writes the next velocity-estimate plane); with no volume
constraint the integrate alone, with the contact (1 launch).  The first
substep of a call launches the velocity estimate of the state's (x,
x_prev) before it.  Each launch counts once.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.config import SimConfig, Solver
from ..core.state import State
from ..core.topology import Topology
from ..solver.collide import SPHERE_CONTACT_SHELL
from ..utils import profiling
from .build import Library
from .frame import FrameLoop
from .grid_scene import CollidersStruct, WindStruct
from .lattice import pack_lattice_scene, use_volume


# launch_count(): kernel launches (velocity estimate, integrate, tet and
# gather passes) since the last reset_launch_count()
launch_count, reset_launch_count = profiling.launch_views("lattice_verlet")


def launches_per_substep(top: Topology, cfg: SimConfig) -> int:
    """Integrate plus, with the volume constraint on, the tet and gather
    passes."""
    return 1 + 2 * int(use_volume(top, cfg))


def launches_per_call(top: Topology, cfg: SimConfig, n_substeps: int) -> int:
    """Launches of one call ``fn(state, dt, n_substeps)``: its substeps and,
    before them, the velocity estimate of the state's (x, x_prev)."""
    return n_substeps * launches_per_substep(top, cfg) + int(n_substeps > 0)


class _Params(ctypes.Structure):
    _fields_ = [(name, ctypes.c_float) for name in (
        "dt", "damping", "gx", "gy", "gz", "decay", "mu", "keep", "shell",
        "vol_stiff")]


class _Substep(ctypes.Structure):
    """``csrc/lattice_verlet.cu::LatticeVerletSubstep`` field by field."""

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
    """``csrc/lattice_verlet.cu::LatticeVerletPlanes``: the call's planes,
    which each substep rotates."""

    _fields_ = [(name, ctypes.c_void_p)
                for name in ("x", "xp", "xs", "ve", "ve_out")]


@functools.cache
def _library():
    lib = Library("lattice_verlet", substep=_Substep)
    lib.declare("lattice_verlet_substep", [
        ctypes.POINTER(_Substep), ctypes.POINTER(_Planes), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)])
    return lib


def make_cuda_step(top: Topology, cfg: SimConfig):
    """Build ``fn(state, dt, n_substeps) -> state`` that runs each substep
    as one ``lattice_verlet_substep`` call (integrate, tet and gather
    launches), from ``state.x`` and its history ``state.x_prev``.

    Three position planes and two velocity-estimate planes rotate in C
    (csrc/lattice_verlet.cu ``LatticeVerletPlanes``).  The ownership words,
    the group tables and the tet counts are packed once, here, on the
    device; the scratch planes once a call, on the call's stream; the
    collider rows once per topology a call brings, as
    :func:`.lattice_euler.make_cuda_step` packs them.  Each frame runs
    through :class:`.frame.FrameLoop`."""
    sc = pack_lattice_scene(top, cfg, Solver.VERLET, "lattice_verlet")
    n, device = sc.n, sc.device
    mu = cfg.collision.friction
    gx, gy, gz = cfg.gravity
    w = cfg.wind
    lib = _library()
    substep = lib.lattice_verlet_substep

    def buffers(planes, dt):
        # the tet terms' scratch, and the position planes by address: the C
        # call rotates them in _Planes
        return (torch.empty((3 * sc.n_tet, n, 4), dtype=torch.float32,
                            device=device),
                {t.data_ptr(): t for t in planes[:3]})

    def pack(planes, bufs, dt, colliders, stream):
        (*x, ve, ve_out), (tscr, by_ptr) = planes, bufs
        args = _Substep(
            sc.inv_mass.data_ptr(), sc.bits.data_ptr(),
            sc.edges.data_ptr(), sc.tets.data_ptr(), sc.cnt.data_ptr(),
            tscr.data_ptr(), stream, sc.n_edge, sc.n_tet, n,
            int(w.enabled), CollidersStruct(*colliders),
            WindStruct(*w.velocity, w.drag, 0.0),
            _Params(dt, cfg.springs.damping, gx, gy, gz,
                    1.0 - cfg.global_damping * dt, mu, 1.0 - mu,
                    SPHERE_CONTACT_SHELL, cfg.volume_stiffness))
        q = _Planes(*(t.data_ptr() for t in x), ve.data_ptr(),
                    ve_out.data_ptr())
        return ctypes.byref(args), ctypes.byref(q), q, by_ptr

    def call(ctx, k0, n_run, last, f_ext, count):
        return substep(ctx[0], ctx[1], int(k0 == 0), count)

    def planes_at(ctx, k):
        q, by_ptr = ctx[2:]
        return by_ptr[q.x], by_ptr[q.xp]

    def state(x, xp, dt, *_):
        return State(x=x, v=(x - xp) / dt, x_prev=xp)

    return FrameLoop(
        "lattice_verlet", lib, sc, ("x", "x_prev", None, None, None),
        buffers=buffers, pack=pack, call=call, planes_at=planes_at,
        state=state, per_substep=True)
