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
from .build import check_launch
from .grid_scene import CollidersStruct, WindStruct, check_input
from .lattice import from_planes, pack_lattice_scene, to_planes, use_volume


def launch_count() -> int:
    """Kernel launches (integrate, tet and gather passes) since the last
    :func:`reset_launch_count`."""
    return profiling.count("lattice_euler")


def reset_launch_count() -> None:
    profiling.reset_count("lattice_euler")


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
def _launchers():
    from .build import load_library

    lib = load_library("lattice_euler")
    size = lib.lattice_euler_substep_size
    size.restype = ctypes.c_int
    if size() != ctypes.sizeof(_Substep):
        raise RuntimeError(
            f"lattice_euler: the C substep struct has {size()} bytes, its "
            f"ctypes mirror {ctypes.sizeof(_Substep)}")
    substep = lib.lattice_euler_substep
    substep.argtypes = [ctypes.POINTER(_Substep), ctypes.POINTER(_Planes),
                        ctypes.POINTER(ctypes.c_int)]
    substep.restype = ctypes.c_int
    lib.lattice_euler_error_string.argtypes = [ctypes.c_int]
    lib.lattice_euler_error_string.restype = ctypes.c_char_p
    return substep, lib.lattice_euler_error_string


def make_cuda_step(top: Topology, cfg: SimConfig):
    """Build ``fn(state, dt, n_substeps) -> state`` that runs each substep
    as one ``lattice_euler_substep`` call (integrate, tet and gather
    launches).  The result carries ``x_prev = x - dt * v``, as the plain
    version's.

    The ownership words, the group tables and the tet counts are packed
    once, here, on the device; the scratch planes of the tet terms
    (csrc/lattice_common.cuh ``kTetPlanes``) once a call, on the call's
    stream, as the other buffers; the collider rows once per topology a
    call brings (``fn(state, dt, n, top=)``, :class:`.grid_scene.ColliderRows`)."""
    sc = pack_lattice_scene(top, cfg, Solver.SEMI_IMPLICIT_EULER,
                            "lattice_euler")
    n, device = sc.n, sc.device
    col = cfg.collision
    gx, gy, gz = cfg.gravity
    w = cfg.wind
    substep, error_string = _launchers()

    def fn(state: State, dt: float, n_substeps: int, top=None) -> State:
        # the host phases, spans while the recorder is on: planes in, the
        # struct packed, each substep's C call, planes out
        sp = profiling.begin("lattice_euler.planes_in") if profiling.on else -1
        check_input("state.x", state.x, (n, 3), device)
        check_input("state.v", state.v, (n, 3), device)
        dt = float(dt)
        xa, va = to_planes(state.x), to_planes(state.v)
        xb, vb = torch.empty_like(xa), torch.empty_like(va)
        tscr = torch.empty((3 * sc.n_tet, n, 4), dtype=torch.float32,
                           device=device)
        planes = {t.data_ptr(): t for t in (xa, va, xb, vb)}
        if sp >= 0:
            profiling.end(sp)
        sp = profiling.begin("lattice_euler.pack") if profiling.on else -1
        contact = sc.colliders.args(sc.colliders.built if top is None
                                    else top)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            args = _Substep(
                sc.inv_mass.data_ptr(), sc.bits.data_ptr(),
                sc.edges.data_ptr(), sc.tets.data_ptr(), sc.cnt.data_ptr(),
                tscr.data_ptr(), stream, sc.n_edge, sc.n_tet, n,
                int(w.enabled), CollidersStruct(*contact),
                WindStruct(*w.velocity, w.drag, 0.0),
                _Params(dt, cfg.springs.damping, gx, gy, gz,
                        1.0 - cfg.global_damping * dt, col.restitution,
                        1.0 + col.restitution, 1.0 - col.friction,
                        cfg.volume_stiffness))
            q = _Planes(xa.data_ptr(), va.data_ptr(), xb.data_ptr(),
                        vb.data_ptr())
            launched = ctypes.c_int()
            ref, qref, count = (ctypes.byref(args), ctypes.byref(q),
                                ctypes.byref(launched))
            if sp >= 0:
                profiling.end(sp)
            for _ in range(n_substeps):
                sp = (profiling.begin("lattice_euler.call") if profiling.on
                      else -1)
                err = substep(ref, qref, count)
                profiling.add("lattice_euler", launched.value)
                check_launch(err, "lattice_euler substep", error_string)
                if sp >= 0:
                    profiling.end(sp)
        sp = (profiling.begin("lattice_euler.planes_out") if profiling.on
              else -1)
        x, v = from_planes(planes[q.x]), from_planes(planes[q.v])
        out = State(x=x, v=v, x_prev=x - dt * v)
        if sp >= 0:
            profiling.end(sp)
        return out

    return fn
