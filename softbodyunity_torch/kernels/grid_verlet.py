"""Wrapper of the hand-written fused Verlet grid substep, ``csrc/grid_verlet.cu``.

Counterpart of
``softbodyunity_tpu/kernels/pallas_substep.py::make_pallas_verlet_step`` and,
for grids past its vertex cap, of
``softbodyunity_tpu/kernels/pallas_tiled.py::make_tiled_verlet_step``.  The
plain PyTorch version is :func:`.stencil.make_stencil_step` (its Verlet
branch, :func:`.stencil.verlet_substep_grid`); :mod:`.dispatch` takes it for
tensors on the CPU and this wrapper for tensors on a CUDA device, where it
launches the kernel or raises.

A substep is one launch, plus one under the strain limit, which runs every
sweep (:mod:`.grid_strain`); a frame is its substeps' launches and, under
tearing or plasticity, one more, the frame-end feature update
(:mod:`.grid_features`).  Each launch counts once.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.config import SimConfig, Solver
from ..core.state import State
from ..core.topology import EDGE_BEND, EDGE_SHEAR, Topology
from ..solver.collide import SPHERE_CONTACT_SHELL
from . import grid_features, grid_strain
from .blocks import self_collision_planes_cuda
from .grid_features import (FINISH_ARGTYPES, LAUNCH_ARGTYPES, NO_FEATURES,
                            CudaFeatures, features_on)
from .grid_scene import (COLLIDER_ARGTYPES, NO_CONTACT, WIND_ARGTYPES,
                         check_input, check_launch, pack_grid_scene,
                         wind_args)
from .grid_strain import CudaStrain
from .stencil import _offsets, from_planes, to_planes

_launches = 0


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def launches_per_substep(cfg: SimConfig) -> int:
    """The substep launch, plus the strain launch (all its sweeps)."""
    return 1 + grid_strain.sweeps(cfg)


def launches_per_frame(cfg: SimConfig, n_substeps: int) -> int:
    """Each substep's launches, plus the frame-end feature update."""
    return grid_features.launches_per_frame(cfg, n_substeps,
                                            launches_per_substep(cfg))


@functools.cache
def _launcher():
    from .build import load_library

    lib = load_library("grid_verlet")
    fn = lib.grid_verlet_substep
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [
        p, p, p,               # x, xp, out
        p, p, i,               # inv_mass, offsets, n_off
        *COLLIDER_ARGTYPES,    # the colliders
        p,                     # f_ext (or null)
        *LAUNCH_ARGTYPES,      # the feature planes and scalars
        *WIND_ARGTYPES,        # the wind
        i, i,                  # ny, nx
        f, f, f, f, f,         # dt, damping, gx, gy, gz
        f, f, f, f,            # decay, mu, keep, shell
        p,                     # stream
    ]
    fn.restype = ctypes.c_int
    lib.grid_verlet_features.argtypes = FINISH_ARGTYPES
    lib.grid_verlet_features.restype = ctypes.c_int
    strain = lib.grid_verlet_strain
    strain.argtypes = [
        ctypes.POINTER(grid_strain.SweepsStruct),   # the sweeps' struct
        p, p,                  # alive, scale
        p, p, p,               # epilogue: x0, x_start, out
        *COLLIDER_ARGTYPES,    # the colliders
        f, f, f, f,            # dt, mu, keep, shell
        p,                     # stream
    ]
    strain.restype = ctypes.c_int
    lib.grid_verlet_strain_size.restype = ctypes.c_int
    lib.grid_verlet_error_string.argtypes = [ctypes.c_int]
    lib.grid_verlet_error_string.restype = ctypes.c_char_p
    return (fn, lib.grid_verlet_features, strain,
            lib.grid_verlet_strain_size, lib.grid_verlet_error_string)


def make_cuda_step(top: Topology, cfg: SimConfig):
    """Build ``fn(state, dt, n_substeps) -> state`` that runs each substep as
    one launch of the fused Verlet grid kernel.  ``state.x_prev`` is the
    Verlet history; the result carries ``x_prev`` = the last substep's start
    and ``v = (x - x_prev) / dt``.

    The offset table (di, dj, k, rest) is packed once, here, into float32
    rows on the device, and the collider rows once per topology a call
    brings, as :func:`.grid_euler.make_cuda_step` packs them.  With self-collision on,
    each substep first computes the repulsion at ``x`` (method ``block``:
    one ``block_pairs`` launch), which the kernel adds to the spring
    forces.  Tearing and plasticity as :func:`.grid_euler.make_cuda_step`
    runs them (``fn.features``), and the wind and the strain limit too: the
    last sweep runs the contact and friction, and writes the new x over the
    history, which the integrate launch has read."""
    sc = pack_grid_scene(top, cfg, Solver.VERLET, "grid_verlet")
    ny, nx, device = sc.ny, sc.nx, sc.device
    n = ny * nx
    offsets = _offsets(cfg, top.grid_spacing,
                       EDGE_SHEAR in top.edge_classes_present,
                       EDGE_BEND in top.edge_classes_present)
    table = torch.tensor(offsets, dtype=torch.float32, device=device)
    mu = cfg.collision.friction
    gx, gy, gz = cfg.gravity
    sc_force = self_collision_planes_cuda(cfg, ny, nx, device)
    launch, finish, strain_fn, strain_size, error_string = _launcher()
    feat = (CudaFeatures(top, cfg, offsets, finish, error_string,
                         "grid_verlet") if features_on(cfg) else None)
    strain = (CudaStrain(cfg, offsets, sc.inv_mass, strain_fn, strain_size,
                         error_string, "grid_verlet")
              if cfg.strain_limit.enabled else None)
    wind = wind_args(cfg)

    def fn(state: State, dt: float, n_substeps: int, top=None) -> State:
        global _launches
        colliders = sc.colliders.args(sc.colliders.built if top is None
                                      else top)
        # under the strain limit the contact runs in the last sweep
        contact = NO_CONTACT if strain else colliders
        check_input("state.x", state.x, (n, 3), device)
        check_input("state.x_prev", state.x_prev, (n, 3), device)
        dt = float(dt)
        scalars = (dt, cfg.springs.damping, gx, gy, gz,
                   1.0 - cfg.global_damping * dt, mu, 1.0 - mu,
                   SPHERE_CONTACT_SHELL)
        x = torch.empty((3, ny, nx), dtype=torch.float32, device=device)
        xp = torch.empty_like(x)
        out = torch.empty_like(x)
        x.copy_(to_planes(state.x, ny, nx))
        xp.copy_(to_planes(state.x_prev, ny, nx))
        edge_alive, rest_scale = state.edge_alive, state.rest_scale
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            if feat:
                feat.begin(state)
            if strain:
                strain.begin(x, table)
            for k in range(n_substeps):
                f_ext = sc_force(x) if sc_force else None
                check_launch(launch(
                    x.data_ptr(), xp.data_ptr(), out.data_ptr(),
                    sc.inv_mass.data_ptr(), table.data_ptr(), len(offsets),
                    *contact, None if f_ext is None else f_ext.data_ptr(),
                    *(feat.launch_args(k == 0) if feat else NO_FEATURES),
                    *wind, ny, nx, *scalars, stream), "grid_verlet",
                    error_string)
                _launches += 1
                if feat:
                    feat.swap()
                if strain:
                    # sweeps from the integrated out; the last writes the
                    # new position over xp, which nothing reads any more
                    _launches += strain.launch(
                        feat.alive if feat else None,
                        feat.scale if feat else None,
                        out.data_ptr(), x.data_ptr(), xp.data_ptr(),
                        *colliders, dt, mu, 1.0 - mu, SPHERE_CONTACT_SHELL,
                        stream)
                    x, xp = xp, x
                else:
                    # the new position, the new history, the next output
                    x, xp, out = out, x, xp
            if feat:
                if n_substeps > 0:
                    feat.launch_finish(x, table, stream)
                    _launches += 1
                edge_alive, rest_scale = feat.end(state)
        x3, xp3 = from_planes(x), from_planes(xp)
        return State(x=x3, v=(x3 - xp3) / dt, x_prev=xp3,
                     edge_alive=edge_alive, rest_scale=rest_scale,
                     cluster_quat=state.cluster_quat)

    fn.features = feat
    return fn
