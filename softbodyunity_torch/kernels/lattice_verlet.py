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
from .build import check_launch
from .grid_scene import CollidersStruct, WindStruct, check_input
from .lattice import from_planes, pack_lattice_scene, to_planes, use_volume


def launch_count() -> int:
    """Kernel launches (velocity estimate, integrate, tet and gather passes)
    since the last
    :func:`reset_launch_count`."""
    return profiling.count("lattice_verlet")


def reset_launch_count() -> None:
    profiling.reset_count("lattice_verlet")


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
def _launchers():
    from .build import load_library

    lib = load_library("lattice_verlet")
    size = lib.lattice_verlet_substep_size
    size.restype = ctypes.c_int
    if size() != ctypes.sizeof(_Substep):
        raise RuntimeError(
            f"lattice_verlet: the C substep struct has {size()} bytes, its "
            f"ctypes mirror {ctypes.sizeof(_Substep)}")
    substep = lib.lattice_verlet_substep
    substep.argtypes = [ctypes.POINTER(_Substep), ctypes.POINTER(_Planes),
                        ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    substep.restype = ctypes.c_int
    lib.lattice_verlet_error_string.argtypes = [ctypes.c_int]
    lib.lattice_verlet_error_string.restype = ctypes.c_char_p
    return substep, lib.lattice_verlet_error_string


def make_cuda_step(top: Topology, cfg: SimConfig):
    """Build ``fn(state, dt, n_substeps) -> state`` that runs each substep
    as one ``lattice_verlet_substep`` call (integrate, tet and gather
    launches), from ``state.x`` and its history ``state.x_prev``.

    Three position planes and two velocity-estimate planes rotate in C
    (csrc/lattice_verlet.cu ``LatticeVerletPlanes``).  The ownership words,
    the group tables and the tet counts are packed once, here, on the
    device; the scratch planes once a call, on the call's stream; the
    collider rows once per topology a call brings, as
    :func:`.lattice_euler.make_cuda_step` packs them."""
    sc = pack_lattice_scene(top, cfg, Solver.VERLET, "lattice_verlet")
    n, device = sc.n, sc.device
    mu = cfg.collision.friction
    gx, gy, gz = cfg.gravity
    w = cfg.wind
    substep, error_string = _launchers()

    def fn(state: State, dt: float, n_substeps: int, top=None) -> State:
        contact = sc.colliders.args(sc.colliders.built if top is None
                                    else top)
        check_input("state.x", state.x, (n, 3), device)
        check_input("state.x_prev", state.x_prev, (n, 3), device)
        dt = float(dt)
        x, xp = to_planes(state.x), to_planes(state.x_prev)
        xs, ve, ve_out = (torch.empty_like(x) for _ in range(3))
        tscr = torch.empty((3 * sc.n_tet, n, 4), dtype=torch.float32,
                           device=device)
        planes = {t.data_ptr(): t for t in (x, xp, xs)}
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            args = _Substep(
                sc.inv_mass.data_ptr(), sc.bits.data_ptr(),
                sc.edges.data_ptr(), sc.tets.data_ptr(), sc.cnt.data_ptr(),
                tscr.data_ptr(), stream, sc.n_edge, sc.n_tet, n,
                int(w.enabled), CollidersStruct(*contact),
                WindStruct(*w.velocity, w.drag, 0.0),
                _Params(dt, cfg.springs.damping, gx, gy, gz,
                        1.0 - cfg.global_damping * dt, mu, 1.0 - mu,
                        SPHERE_CONTACT_SHELL, cfg.volume_stiffness))
            q = _Planes(x.data_ptr(), xp.data_ptr(), xs.data_ptr(),
                        ve.data_ptr(), ve_out.data_ptr())
            launched = ctypes.c_int()
            ref, qref, count = (ctypes.byref(args), ctypes.byref(q),
                                ctypes.byref(launched))
            for k in range(n_substeps):
                err = substep(ref, qref, int(k == 0), count)
                profiling.add("lattice_verlet", launched.value)
                check_launch(err, "lattice_verlet substep", error_string)
        x3, xp3 = from_planes(planes[q.x]), from_planes(planes[q.xp])
        return State(x=x3, v=(x3 - xp3) / dt, x_prev=xp3)

    return fn
