"""Wrapper of the hand-written fused Verlet lattice substep, ``csrc/lattice_verlet.cu``.

Counterpart of ``softbodyunity_tpu/kernels/pallas_lattice.py::make_lattice_verlet_step``.
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
from ..solver.collide import SPHERE_CONTACT_SHELL
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

    lib = load_library("lattice_verlet")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    integrate = lib.lattice_verlet_integrate
    integrate.argtypes = [
        p, p, p, p, p, p, i,   # x, xp, xs, inv_mass, bits, edges, n_edge
        *COLLIDER_ARGTYPES,    # the colliders
        i,                     # finish
        *DRAG_ARGTYPES,        # the wind's drag
        i,                     # n
        f, f, f, f, f,         # dt, damping, gx, gy, gz
        f, f, f, f,            # decay, mu, keep, shell
        p,                     # stream
    ]
    integrate.restype = ctypes.c_int
    volume = lib.lattice_verlet_volume
    volume.argtypes = [
        p, p, p, p, p,         # xs, x, out, inv_mass, bits
        p, i, p,               # tets, n_tet, cnt
        *COLLIDER_ARGTYPES,    # the colliders
        i,                     # n
        f, f, f, f, f,         # dt, mu, keep, shell, vol_stiff
        p,                     # stream
    ]
    volume.restype = ctypes.c_int
    lib.lattice_verlet_error_string.argtypes = [ctypes.c_int]
    lib.lattice_verlet_error_string.restype = ctypes.c_char_p
    return integrate, volume, lib.lattice_verlet_error_string


def make_cuda_step(top: Topology, cfg: SimConfig):
    """Build ``fn(state, dt, n_substeps) -> state`` that runs each substep as
    the integrate and volume launches of the fused Verlet lattice kernels,
    from ``state.x`` and its history ``state.x_prev``.

    Three buffers rotate: integrate reads (x, xp) and writes the scratch
    buffer; volume reads the scratch buffer and x and writes over xp, which
    then holds the new x.  The ownership words, the group tables and the
    tet counts are packed once, here, on the device, the collider rows once
    per topology a call brings, as :func:`.lattice_euler.make_cuda_step`
    packs them."""
    sc = pack_lattice_scene(top, cfg, Solver.VERLET, "lattice_verlet")
    n, device = sc.n, sc.device
    mu = cfg.collision.friction
    gx, gy, gz = cfg.gravity
    two_pass = sc.n_tet > 0
    drag = drag_args(cfg)
    integrate, volume, error_string = _launchers()

    def fn(state: State, dt: float, n_substeps: int, top=None) -> State:
        global _launches
        contact = sc.colliders.args(sc.colliders.built if top is None
                                    else top)
        check_input("state.x", state.x, (n, 3), device)
        check_input("state.x_prev", state.x_prev, (n, 3), device)
        dt = float(dt)
        x, xp = to_planes(state.x), to_planes(state.x_prev)
        xs = torch.empty_like(x)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            for _ in range(n_substeps):
                check_launch(integrate(
                    x.data_ptr(), xp.data_ptr(), xs.data_ptr(),
                    sc.inv_mass.data_ptr(), sc.bits.data_ptr(),
                    sc.edges.data_ptr(), sc.n_edge, *contact,
                    int(not two_pass), *drag, n, dt, cfg.springs.damping,
                    gx, gy, gz, 1.0 - cfg.global_damping * dt, mu, 1.0 - mu,
                    SPHERE_CONTACT_SHELL, stream),
                    "lattice_verlet integrate", error_string)
                _launches += 1
                if two_pass:
                    check_launch(volume(
                        xs.data_ptr(), x.data_ptr(), xp.data_ptr(),
                        sc.inv_mass.data_ptr(), sc.bits.data_ptr(),
                        sc.tets.data_ptr(), sc.n_tet, sc.cnt.data_ptr(),
                        *contact, n, dt, mu, 1.0 - mu, SPHERE_CONTACT_SHELL,
                        cfg.volume_stiffness, stream),
                        "lattice_verlet volume", error_string)
                    _launches += 1
                    x, xp = xp, x
                else:
                    x, xp, xs = xs, x, xp
        x3, xp3 = from_planes(x), from_planes(xp)
        return State(x=x3, v=(x3 - xp3) / dt, x_prev=xp3)

    return fn
