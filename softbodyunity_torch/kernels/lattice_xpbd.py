"""Wrapper of the hand-written fused XPBD lattice substep, ``csrc/lattice_xpbd.cu``.

Counterpart of ``softbodyunity_tpu/kernels/pallas_lattice.py::make_lattice_xpbd_step``.
The plain PyTorch version is :func:`softbodyunity_torch.solver.step.make_plain_step`;
:mod:`.dispatch` takes it for tensors on the CPU and this wrapper for
tensors on a CUDA device, where it launches the kernels or raises.

A substep is ``1 + max(n_iterations, 1)`` launches: one predict pass, then
one launch per Jacobi sweep, the grid-wide barrier between sweeps (with no
sweep, one launch runs the epilogue alone).  Each launch counts once.
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
                      pack_lattice_scene, to_planes)

_launches = 0


def launch_count() -> int:
    """Kernel launches (predict and sweep) since the last
    :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def launches_per_substep(top: Topology, cfg: SimConfig) -> int:
    """Predict plus one launch per sweep (at least one, for the epilogue)."""
    return 1 + max(cfg.xpbd.n_iterations, 1)


@functools.cache
def _launchers():
    from .build import load_library

    lib = load_library("lattice_xpbd")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    predict = lib.lattice_xpbd_predict
    predict.argtypes = [
        p, p, p, i, p, p,      # v, delta, lam, n_lam, flag, inv_mass
        *DRAG_ARGTYPES,        # the wind's drag
        i,                     # n
        f, f, f, f, f,         # dt, gx, gy, gz, decay
        p,                     # stream
    ]
    predict.restype = ctypes.c_int
    sweep = lib.lattice_xpbd_sweep
    sweep.argtypes = [
        p, p, p,               # xp, delta_in, delta_out
        p, p, p,               # lam_in, lam_out, flag
        p, p, p, i,            # inv_mass, bits, edges, n_edge
        p, i, p,               # tets, n_tet, cnt
        *COLLIDER_ARGTYPES,    # the colliders
        i, i, p, p,            # project, last, x_out, v
        i,                     # n
        f, f, f, f, f, f,      # dt, mu, keep, shell, relax, alpha_v
        p,                     # stream
    ]
    sweep.restype = ctypes.c_int
    lib.lattice_xpbd_error_string.argtypes = [ctypes.c_int]
    lib.lattice_xpbd_error_string.restype = ctypes.c_char_p
    return predict, sweep, lib.lattice_xpbd_error_string


def make_cuda_step(top: Topology, cfg: SimConfig):
    """Build ``fn(state, dt, n_substeps) -> state`` that runs each substep as
    a predict launch and one launch per Jacobi sweep of the fused XPBD
    lattice kernels.  The result carries ``x_prev = x - dt * v``, as the
    plain version's.

    The ownership words and the constraint counts are packed once, here,
    the collider rows once per topology a call brings (as
    :func:`.lattice_euler.make_cuda_step` packs them); the edge table (delta, rest, compliance / dt^2) once
    per substep size ``dt``, by the plain version's float32 divide."""
    sc = pack_lattice_scene(top, cfg, Solver.XPBD, "lattice_xpbd")
    n, device = sc.n, sc.device
    n_lam = sc.n_edge + sc.n_tet
    mu = cfg.collision.friction
    n_sweeps = max(cfg.xpbd.n_iterations, 1)
    project = int(cfg.xpbd.n_iterations > 0)
    gx, gy, gz = cfg.gravity
    tables = {}
    drag = drag_args(cfg)
    predict, sweep, error_string = _launchers()

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
        d_in, d_out = torch.empty_like(x), torch.empty_like(x)
        lam_in = torch.empty((n_lam, n), dtype=torch.float32, device=device)
        lam_out = torch.empty_like(lam_in)
        flag = torch.empty((n,), dtype=torch.uint8, device=device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            for _ in range(n_substeps):
                check_launch(predict(
                    v.data_ptr(), d_in.data_ptr(), lam_in.data_ptr(), n_lam,
                    flag.data_ptr(), sc.inv_mass.data_ptr(), *drag, n, dt,
                    gx, gy, gz, 1.0 - cfg.global_damping * dt, stream),
                    "lattice_xpbd predict", error_string)
                _launches += 1
                for it in range(n_sweeps):
                    check_launch(sweep(
                        x.data_ptr(), d_in.data_ptr(), d_out.data_ptr(),
                        lam_in.data_ptr(), lam_out.data_ptr(),
                        flag.data_ptr(), sc.inv_mass.data_ptr(),
                        sc.bits.data_ptr(), edges.data_ptr(), sc.n_edge,
                        sc.tets.data_ptr(), sc.n_tet, sc.cnt.data_ptr(),
                        *contact, project, int(it == n_sweeps - 1),
                        x_out.data_ptr(), v.data_ptr(), n, dt, mu, 1.0 - mu,
                        SPHERE_CONTACT_SHELL, cfg.xpbd.relaxation,
                        cfg.xpbd.compliance_volume / (dt * dt), stream),
                        "lattice_xpbd sweep", error_string)
                    _launches += 1
                    d_in, d_out = d_out, d_in
                    lam_in, lam_out = lam_out, lam_in
                x, x_out = x_out, x
        x3, v3 = from_planes(x), from_planes(v)
        return State(x=x3, v=v3, x_prev=x3 - dt * v3)

    return fn
