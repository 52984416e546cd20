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
from .grid_scene import (CollidersStruct, WindStruct, check_input,
                         check_launch)
from .lattice import from_planes, pack_lattice_scene, to_planes

_launches = 0


def launch_count() -> int:
    """Kernel launches (predict, constraint and gather passes) since the
    last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


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
def _launchers():
    from .build import load_library

    lib = load_library("lattice_xpbd")
    size = lib.lattice_xpbd_substep_size
    size.restype = ctypes.c_int
    if size() != ctypes.sizeof(_Substep):
        raise RuntimeError(
            f"lattice_xpbd: the C substep struct has {size()} bytes, its "
            f"ctypes mirror {ctypes.sizeof(_Substep)}")
    substep = lib.lattice_xpbd_substep
    substep.argtypes = [ctypes.POINTER(_Substep), ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    substep.restype = ctypes.c_int
    lib.lattice_xpbd_error_string.argtypes = [ctypes.c_int]
    lib.lattice_xpbd_error_string.restype = ctypes.c_char_p
    return substep, lib.lattice_xpbd_error_string


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
    plain version's float32 divide."""
    sc = pack_lattice_scene(top, cfg, Solver.XPBD, "lattice_xpbd")
    n, device = sc.n, sc.device
    n_lam = sc.n_edge + sc.n_tet
    mu = cfg.collision.friction
    gx, gy, gz = cfg.gravity
    w = cfg.wind
    tables = {}
    substep, error_string = _launchers()

    def fn(state: State, dt: float, n_substeps: int, top=None) -> State:
        global _launches
        contact = sc.colliders.args(sc.colliders.built if top is None
                                    else top)
        check_input("state.x", state.x, (n, 3), device)
        check_input("state.v", state.v, (n, 3), device)
        dt = float(dt)
        if dt not in tables:
            table = sc.edges.clone()
            table[:, 2] = sc.edges[:, 2] / (dt * dt)
            tables[dt] = table
        edges = tables[dt]
        x, v = to_planes(state.x), to_planes(state.v)
        x_out = torch.empty_like(x)
        delta = torch.empty_like(x)
        xe = torch.empty_like(x)
        lam = torch.empty((n_lam, n), dtype=torch.float32, device=device)
        flag = torch.empty((n,), dtype=torch.uint8, device=device)
        # an edge group's float4 (n, dlam), a tet group's three (g_k, dlam)
        escr = torch.empty((sc.n_edge, n, 4), dtype=torch.float32,
                           device=device)
        tscr = torch.empty((3 * sc.n_tet, n, 4), dtype=torch.float32,
                           device=device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            args = _Substep(
                v.data_ptr(), delta.data_ptr(), xe.data_ptr(), lam.data_ptr(),
                flag.data_ptr(), sc.inv_mass.data_ptr(),
                sc.bits.data_ptr(), edges.data_ptr(), sc.tets.data_ptr(),
                sc.cnt.data_ptr(), escr.data_ptr(), tscr.data_ptr(), stream,
                sc.n_edge, sc.n_tet, n, cfg.xpbd.n_iterations,
                int(w.enabled),
                CollidersStruct(*contact), WindStruct(*w.velocity, w.drag, 0.0),
                _Params(dt, gx, gy, gz, 1.0 - cfg.global_damping * dt, mu,
                        1.0 - mu, SPHERE_CONTACT_SHELL, cfg.xpbd.relaxation,
                        cfg.xpbd.compliance_volume / (dt * dt)))
            launched = ctypes.c_int()
            ref, count = ctypes.byref(args), ctypes.byref(launched)
            for _ in range(n_substeps):
                err = substep(ref, x.data_ptr(), x_out.data_ptr(), count)
                _launches += launched.value
                check_launch(err, "lattice_xpbd substep", error_string)
                x, x_out = x_out, x
        x3, v3 = from_planes(x), from_planes(v)
        return State(x=x3, v=v3, x_prev=x3 - dt * v3)

    return fn
