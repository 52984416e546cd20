"""Wrapper of the hand-written fused Euler grid substep, ``csrc/grid_euler.cu``.

Counterpart of ``softbodyunity_tpu/kernels/pallas_substep.py::make_pallas_step``
and, for grids past its vertex cap, of
``softbodyunity_tpu/kernels/pallas_tiled.py::make_tiled_step``: one kernel
serves every grid size.  The plain PyTorch version is
:func:`.stencil.make_stencil_step`; :mod:`.dispatch` takes it for tensors on
the CPU and this wrapper for tensors on a CUDA device, where it launches the
kernel or raises.

A substep is one launch, plus one per strain-limit sweep
(:mod:`.grid_strain`); a frame is its substeps' launches and, under tearing
or plasticity, one more, the frame-end feature update
(:mod:`.grid_features`).  Each launch counts once.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.config import SimConfig, Solver
from ..core.state import State
from ..core.topology import EDGE_BEND, EDGE_SHEAR, Topology
from . import grid_features, grid_strain
from .blocks import self_collision_planes_cuda
from .grid_features import (FINISH_ARGTYPES, LAUNCH_ARGTYPES, NO_FEATURES,
                            CudaFeatures, features_on)
from .grid_scene import (COLLIDER_ARGTYPES, NO_CONTACT, WIND_ARGTYPES,
                         check_input, check_launch, pack_grid_scene,
                         wind_args)
from .grid_strain import SWEEP_ARGTYPES, CudaStrain
from .stencil import _offsets, from_planes, to_planes

_launches = 0


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def launches_per_substep(cfg: SimConfig) -> int:
    """The substep launch, plus one per strain-limit sweep."""
    return 1 + grid_strain.sweeps(cfg)


def launches_per_frame(cfg: SimConfig, n_substeps: int) -> int:
    """Each substep's launches, plus the frame-end feature update."""
    return grid_features.launches_per_frame(cfg, n_substeps,
                                            launches_per_substep(cfg))


@functools.cache
def _launcher():
    from .build import load_library

    lib = load_library("grid_euler")
    fn = lib.grid_euler_substep
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [
        p, p, p, p,            # x, v, x_out, v_out
        p, p, i,               # inv_mass, offsets, n_off
        *COLLIDER_ARGTYPES,    # the colliders
        p,                     # f_ext (or null)
        *LAUNCH_ARGTYPES,      # the feature planes and scalars
        *WIND_ARGTYPES,        # the wind
        i, i,                  # ny, nx
        f, f, f, f, f,         # dt, damping, gx, gy, gz
        f, f, f, f,            # decay, restitution, restitution1, keep
        p,                     # stream
    ]
    fn.restype = ctypes.c_int
    lib.grid_euler_features.argtypes = FINISH_ARGTYPES
    lib.grid_euler_features.restype = ctypes.c_int
    strain = lib.grid_euler_strain
    strain.argtypes = [
        *SWEEP_ARGTYPES,       # the sweep
        p, p, p,               # epilogue: x0, x_out, v
        *COLLIDER_ARGTYPES,    # the colliders
        i, i,                  # ny, nx
        f, f, f, f,            # dt, restitution, restitution1, keep
        p,                     # stream
    ]
    strain.restype = ctypes.c_int
    lib.grid_euler_error_string.argtypes = [ctypes.c_int]
    lib.grid_euler_error_string.restype = ctypes.c_char_p
    return (fn, lib.grid_euler_features, strain,
            lib.grid_euler_error_string)


def make_cuda_step(top: Topology, cfg: SimConfig):
    """Build ``fn(state, dt, n_substeps) -> state`` that runs each substep as
    one launch of the fused Euler grid kernel.

    The offset table (di, dj, k, rest) is packed once, here, and the
    collider rows (plane, spheres, capsules, boxes) once per topology a call
    brings (:class:`.grid_scene.ColliderRows`: ``fn(state, dt, n, top=)``
    with a topology from :func:`softbodyunity_torch.api.move_colliders`),
    into float32 rows on the device; the kernel reads them from device
    memory, so a frame makes no host round trip.  With self-collision
    on, each substep first computes the repulsion at its start position
    (method ``block``: one launch of the ``block_pairs`` kernel) and the
    Euler kernel adds that force plane to the spring forces.  Under tearing
    or plasticity the state's ``edge_alive``/``rest_scale`` go into
    ping-pong planes once a frame, every launch but the first updates them
    at its start, and one frame-end launch updates them over the final
    positions (:class:`.grid_features.CudaFeatures`, kept as
    ``fn.features``).  Wind adds its force in the substep launch.  Under
    the strain limit that launch integrates with the contact left out, and
    the sweep launches follow (:class:`.grid_strain.CudaStrain`), the last
    adding the change to the velocity and running the contact."""
    sc = pack_grid_scene(top, cfg, Solver.SEMI_IMPLICIT_EULER, "grid_euler")
    ny, nx, device = sc.ny, sc.nx, sc.device
    n = ny * nx
    offsets = _offsets(cfg, top.grid_spacing,
                       EDGE_SHEAR in top.edge_classes_present,
                       EDGE_BEND in top.edge_classes_present)
    table = torch.tensor(offsets, dtype=torch.float32, device=device)
    col = cfg.collision
    gx, gy, gz = cfg.gravity
    sc_force = self_collision_planes_cuda(cfg, ny, nx, device)
    launch, finish, strain_fn, error_string = _launcher()
    feat = (CudaFeatures(top, cfg, offsets, finish, error_string, "grid_euler")
            if features_on(cfg) else None)
    strain = (CudaStrain(cfg, offsets, sc.inv_mass, strain_fn, error_string,
                         "grid_euler")
              if cfg.strain_limit.enabled else None)
    wind = wind_args(cfg)

    def fn(state: State, dt: float, n_substeps: int, top=None) -> State:
        global _launches
        colliders = sc.colliders.args(sc.colliders.built if top is None
                                      else top)
        # under the strain limit the contact runs in the last sweep
        contact = NO_CONTACT if strain else colliders
        check_input("state.x", state.x, (n, 3), device)
        check_input("state.v", state.v, (n, 3), device)
        dt = float(dt)
        scalars = (dt, cfg.springs.damping, gx, gy, gz,
                   1.0 - cfg.global_damping * dt, col.restitution,
                   1.0 + col.restitution, 1.0 - col.friction)
        scalars_strain = (dt, col.restitution, 1.0 + col.restitution,
                          1.0 - col.friction)
        xa = torch.empty((3, ny, nx), dtype=torch.float32, device=device)
        va = torch.empty_like(xa)
        xb = torch.empty_like(xa)
        vb = torch.empty_like(xa)
        xa.copy_(to_planes(state.x, ny, nx))
        va.copy_(to_planes(state.v, ny, nx))
        edge_alive, rest_scale = state.edge_alive, state.rest_scale
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            if feat:
                feat.begin(state)
            if strain:
                strain.begin(xa)
            for k in range(n_substeps):
                f_ext = sc_force(xa) if sc_force else None
                check_launch(launch(
                    xa.data_ptr(), va.data_ptr(), xb.data_ptr(), vb.data_ptr(),
                    sc.inv_mass.data_ptr(), table.data_ptr(), len(offsets),
                    *contact, None if f_ext is None else f_ext.data_ptr(),
                    *(feat.launch_args(k == 0) if feat else NO_FEATURES),
                    *wind, ny, nx, *scalars, stream),
                    "grid_euler", error_string)
                _launches += 1
                if feat:
                    feat.swap()
                if strain:
                    # sweeps from the integrated (xb, vb); the last writes
                    # x into xa, the substep's input, and v in place
                    _launches += strain.launch(
                        xb, None, table, feat.alive if feat else None,
                        feat.scale if feat else None,
                        (xb.data_ptr(), xa.data_ptr(), vb.data_ptr(),
                         *colliders, ny, nx, *scalars_strain, stream))
                    va, vb = vb, va
                else:
                    xa, xb, va, vb = xb, xa, vb, va
            if feat:
                if n_substeps > 0:
                    feat.launch_finish(xa, table, stream)
                    _launches += 1
                edge_alive, rest_scale = feat.end(state)
        x = from_planes(xa)
        v = from_planes(va)
        return State(x=x, v=v, x_prev=x - dt * v, edge_alive=edge_alive,
                     rest_scale=rest_scale, cluster_quat=state.cluster_quat)

    fn.features = feat
    return fn


def make_strain_correction(top: Topology, cfg: SimConfig):
    """Build ``fn(x3, alive=None, scale=None) -> x_new``: the strain
    limit's sweeps alone (:class:`.grid_strain.CudaStrain`) from the
    ``[3, ny, nx]`` positions ``x3`` on the card, the last sweep's epilogue
    run with the contact left out, so ``x_new = x3 + dxl`` as the Euler
    substep adds it.  ``alive``/``scale`` are tear and plastic planes or
    None.  Its plain version is ``x3 + stencil.strain_limit_planes(...)``;
    the card tests and ``chip_smoke.py`` hold the sweeps to it alone.  Each
    launch counts here and in :mod:`.grid_strain`."""
    sc = pack_grid_scene(top, cfg, Solver.SEMI_IMPLICIT_EULER, "grid_euler")
    offsets = _offsets(cfg, top.grid_spacing,
                       EDGE_SHEAR in top.edge_classes_present,
                       EDGE_BEND in top.edge_classes_present)
    table = torch.tensor(offsets, dtype=torch.float32, device=sc.device)
    _, _, strain_fn, error_string = _launcher()
    strain = CudaStrain(cfg, offsets, sc.inv_mass, strain_fn, error_string,
                        "grid_euler")

    def fn(x3: torch.Tensor, alive=None, scale=None) -> torch.Tensor:
        global _launches
        check_input("x3", x3, (3, sc.ny, sc.nx), sc.device)
        out = torch.empty_like(x3)
        v = torch.zeros_like(x3)
        with torch.cuda.device(sc.device):
            stream = torch.cuda.current_stream(sc.device).cuda_stream
            strain.begin(x3)
            _launches += strain.launch(
                x3, None, table, alive, scale,
                (x3.data_ptr(), out.data_ptr(), v.data_ptr(), *NO_CONTACT,
                 sc.ny, sc.nx, 1.0, 0.0, 1.0, 1.0, stream))
        return out

    return fn
