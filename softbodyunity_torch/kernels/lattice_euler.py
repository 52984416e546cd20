"""Wrapper of the hand-written fused Euler lattice substep, ``csrc/lattice_euler.cu``.

Counterpart of ``softbodyunity_tpu/kernels/pallas_lattice.py::make_lattice_step``.
The plain PyTorch version is :func:`softbodyunity_torch.solver.step.make_plain_step`;
:mod:`.dispatch` takes it for tensors on the CPU and this wrapper for
tensors on a CUDA device, where it launches the kernels or raises.

A substep is two launches, integrate then volume, or one (integrate, with
the contact) when the scene has no volume constraint.  Each launch counts
once.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.config import SimConfig, Solver
from ..core.state import State
from ..core.topology import Topology
from .grid_scene import COLLIDER_ARGTYPES, check_input, check_launch
from .lattice import (DRAG_ARGTYPES, drag_args, from_planes,
                      pack_lattice_scene, to_planes, use_volume)

_launches = 0


def launch_count() -> int:
    """Kernel launches (integrate and volume) since the last
    :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def launches_per_substep(top: Topology, cfg: SimConfig) -> int:
    """Integrate plus, with the volume constraint on, the volume pass."""
    return 1 + int(use_volume(top, cfg))


@functools.cache
def _launchers():
    from .build import load_library

    lib = load_library("lattice_euler")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    integrate = lib.lattice_euler_integrate
    integrate.argtypes = [
        p, p, p, p,            # x, v, x_out, v_out
        p, p, p, i,            # inv_mass, bits, edges, n_edge
        *COLLIDER_ARGTYPES,    # the colliders
        i,                     # finish
        *DRAG_ARGTYPES,        # the wind's drag
        i,                     # n
        f, f, f, f, f,         # dt, damping, gx, gy, gz
        f, f, f, f,            # decay, restitution, restitution1, keep
        p,                     # stream
    ]
    integrate.restype = ctypes.c_int
    volume = lib.lattice_euler_volume
    volume.argtypes = [
        p, p, p, p,            # xs, vs, x_out, v_out
        p, p, p, i, p,         # inv_mass, bits, tets, n_tet, cnt
        *COLLIDER_ARGTYPES,    # the colliders
        i,                     # n
        f, f, f, f, f,         # dt, vol_stiff, restitution, restitution1, keep
        p,                     # stream
    ]
    volume.restype = ctypes.c_int
    lib.lattice_euler_error_string.argtypes = [ctypes.c_int]
    lib.lattice_euler_error_string.restype = ctypes.c_char_p
    return integrate, volume, lib.lattice_euler_error_string


def make_cuda_step(top: Topology, cfg: SimConfig):
    """Build ``fn(state, dt, n_substeps) -> state`` that runs each substep as
    the integrate and volume launches of the fused Euler lattice kernels.
    The result carries ``x_prev = x - dt * v``, as the plain version's.

    The ownership words, the group tables and the tet counts are packed
    once, here, on the device, the collider rows once per topology a call
    brings (``fn(state, dt, n, top=)``, :class:`.grid_scene.ColliderRows`)."""
    sc = pack_lattice_scene(top, cfg, Solver.SEMI_IMPLICIT_EULER,
                            "lattice_euler")
    n, device = sc.n, sc.device
    col = cfg.collision
    gx, gy, gz = cfg.gravity
    two_pass = sc.n_tet > 0
    drag = drag_args(cfg)
    integrate, volume, error_string = _launchers()

    def fn(state: State, dt: float, n_substeps: int, top=None) -> State:
        global _launches
        contact = sc.colliders.args(sc.colliders.built if top is None
                                    else top)
        check_input("state.x", state.x, (n, 3), device)
        check_input("state.v", state.v, (n, 3), device)
        dt = float(dt)
        bounce = (col.restitution, 1.0 + col.restitution, 1.0 - col.friction)
        xa, va = to_planes(state.x), to_planes(state.v)
        xb, vb = torch.empty_like(xa), torch.empty_like(va)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            for _ in range(n_substeps):
                check_launch(integrate(
                    xa.data_ptr(), va.data_ptr(), xb.data_ptr(), vb.data_ptr(),
                    sc.inv_mass.data_ptr(), sc.bits.data_ptr(),
                    sc.edges.data_ptr(), sc.n_edge, *contact,
                    int(not two_pass), *drag, n, dt, cfg.springs.damping,
                    gx, gy, gz,
                    1.0 - cfg.global_damping * dt, *bounce, stream),
                    "lattice_euler integrate", error_string)
                _launches += 1
                if two_pass:
                    check_launch(volume(
                        xb.data_ptr(), vb.data_ptr(), xa.data_ptr(),
                        va.data_ptr(), sc.inv_mass.data_ptr(),
                        sc.bits.data_ptr(), sc.tets.data_ptr(), sc.n_tet,
                        sc.cnt.data_ptr(), *contact, n, dt,
                        cfg.volume_stiffness, *bounce, stream),
                        "lattice_euler volume", error_string)
                    _launches += 1
                else:
                    xa, xb, va, vb = xb, xa, vb, va
        x, v = from_planes(xa), from_planes(va)
        return State(x=x, v=v, x_prev=x - dt * v)

    return fn
