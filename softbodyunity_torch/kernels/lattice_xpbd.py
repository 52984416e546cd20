"""Wrapper of the hand-written fused XPBD lattice substep, ``csrc/lattice_xpbd.cu``.

Counterpart of ``softbodyunity_tpu/kernels/pallas_lattice.py::make_lattice_xpbd_step``.
The plain PyTorch version is :func:`softbodyunity_torch.solver.step.make_plain_step`;
:mod:`.dispatch` takes it for tensors on the CPU and this wrapper for
tensors on a CUDA device, where it launches the kernels or raises.

A substep is one ``ctypes`` call, ``lattice_xpbd_substep``, which launches
``1 + 2 n_iterations`` kernels: one predict pass, then per Jacobi sweep a
constraint pass (each edge and tet evaluated once) and a gather pass (the
terms summed at each vertex), the grid-wide barriers between them (with no
sweep, one gather runs the epilogue alone: 2 launches).  Each launch counts
once.
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
from .lattice import pack_lattice_scene


# launch_count(): kernel launches (predict, constraint and gather passes)
# since the last reset_launch_count()
launch_count, reset_launch_count = profiling.launch_views("lattice_xpbd")


def launches_per_substep(top: Topology, cfg: SimConfig) -> int:
    """Predict plus a constraint and a gather pass per sweep (with no
    sweep, one gather for the epilogue)."""
    return 1 + max(2 * cfg.xpbd.n_iterations, 1)


def launches_per_call(top: Topology, cfg: SimConfig, n_substeps: int) -> int:
    """Launches of one call ``fn(state, dt, n_substeps)``."""
    return n_substeps * launches_per_substep(top, cfg)


class _Params(ctypes.Structure):
    _fields_ = [(name, ctypes.c_float) for name in (
        "dt", "gx", "gy", "gz", "decay", "mu", "keep", "shell", "relax",
        "alpha_v")]


class _Substep(ctypes.Structure):
    """``csrc/lattice_xpbd.cu::LatticeXpbdSubstep`` field by field."""

    _fields_ = [
        ("v", ctypes.c_void_p),
        *[(name, ctypes.c_void_p) for name in (
            "delta", "xe", "lam", "flag", "inv_mass", "bits", "edges", "tets", "cnt",
            "escr", "tscr", "stream")],
        *[(name, ctypes.c_int) for name in (
            "n_edge", "n_tet", "n", "n_iterations", "drag_on")],
        ("col", CollidersStruct),
        ("wind", WindStruct),
        ("p", _Params),
    ]


@functools.cache
def _library():
    lib = Library("lattice_xpbd", substep=_Substep)
    lib.declare("lattice_xpbd_substep", [
        ctypes.POINTER(_Substep), ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int)])
    return lib


def make_cuda_step(top: Topology, cfg: SimConfig):
    """Build ``fn(state, dt, n_substeps) -> state`` that runs each substep
    as one ``lattice_xpbd_substep`` call (a predict launch, then a
    constraint and a gather launch per Jacobi sweep).  The result carries
    ``x_prev = x - dt * v``, as the plain version's.

    The ownership words and the constraint counts are packed once, here;
    the scratch planes of each constraint's terms (csrc/lattice_xpbd.cu
    "Scratch") once a call, on the call's stream, as the other buffers; the
    collider rows once per topology a call brings (as
    :func:`.lattice_euler.make_cuda_step` packs them); the edge table
    (delta, rest, compliance / dt^2) once per substep size ``dt``, by the
    plain version's float32 divide.  Each frame runs through
    :class:`.frame.FrameLoop`, the positions in two planes that the
    substeps alternate."""
    sc = pack_lattice_scene(top, cfg, Solver.XPBD, "lattice_xpbd")
    n, device = sc.n, sc.device
    n_lam = sc.n_edge + sc.n_tet
    mu = cfg.collision.friction
    gx, gy, gz = cfg.gravity
    w = cfg.wind
    tables = {}
    lib = _library()
    substep = lib.lattice_xpbd_substep

    def buffers(planes, dt):
        if dt not in tables:
            table = sc.edges.clone()
            table[:, 2] = sc.edges[:, 2] / (dt * dt)
            tables[dt] = table
        f32 = dict(dtype=torch.float32, device=device)
        # lambda, the contact flag; an edge group's float4 (n, dlam), a tet
        # group's three (g_k, dlam)
        return (tables[dt], torch.empty((n_lam, n), **f32),
                torch.empty((n,), dtype=torch.uint8, device=device),
                torch.empty((sc.n_edge, n, 4), **f32),
                torch.empty((3 * sc.n_tet, n, 4), **f32))

    def pack(planes, bufs, dt, colliders, stream):
        x, v, x_out, delta, xe = planes
        edges, lam, flag, escr, tscr = bufs
        x = x, x_out
        args = _Substep(
            v.data_ptr(), delta.data_ptr(), xe.data_ptr(), lam.data_ptr(),
            flag.data_ptr(), sc.inv_mass.data_ptr(),
            sc.bits.data_ptr(), edges.data_ptr(), sc.tets.data_ptr(),
            sc.cnt.data_ptr(), escr.data_ptr(), tscr.data_ptr(), stream,
            sc.n_edge, sc.n_tet, n, cfg.xpbd.n_iterations,
            int(w.enabled),
            CollidersStruct(*colliders), WindStruct(*w.velocity, w.drag, 0.0),
            _Params(dt, gx, gy, gz, 1.0 - cfg.global_damping * dt, mu,
                    1.0 - mu, SPHERE_CONTACT_SHELL, cfg.xpbd.relaxation,
                    cfg.xpbd.compliance_volume / (dt * dt)))
        return x, v, ctypes.byref(args), [t.data_ptr() for t in x]

    def call(ctx, k0, n_run, last, f_ext, count):
        xp = ctx[3]
        return substep(ctx[2], xp[k0 % 2], xp[1 - k0 % 2], count)

    def planes_at(ctx, k):
        return ctx[0][k % 2], ctx[1]

    def state(x, v, dt, *_):
        return State(x=x, v=v, x_prev=x - dt * v)

    return FrameLoop(
        "lattice_xpbd", lib, sc, ("x", "v", None, None, None),
        buffers=buffers, pack=pack, call=call, planes_at=planes_at,
        state=state, per_substep=True)
