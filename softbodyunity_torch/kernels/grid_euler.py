"""Wrapper of the hand-written fused Euler grid substep, ``csrc/grid_euler.cu``.

Counterpart of ``softbodyunity_tpu/kernels/pallas_substep.py::make_pallas_step``
and, for grids past its vertex cap, of
``softbodyunity_tpu/kernels/pallas_tiled.py::make_tiled_step``: one kernel
serves every grid size.  The plain PyTorch version is
:func:`.stencil.make_stencil_step`; :mod:`.dispatch` takes it for tensors on
the CPU and this wrapper for tensors on a CUDA device, where it launches the
kernel or raises.

A substep is one launch, plus one under the strain limit, which runs every
sweep (:mod:`.grid_strain`); a frame is its substeps' launches and, under
tearing or plasticity, one more, the frame-end feature update
(:mod:`.grid_features`).  A frame is one ``ctypes`` call,
``grid_euler_substeps``, from a struct built once a call; with
self-collision, whose force plane the ``block_pairs`` call builds and
sweeps at each substep's start (:mod:`.blocks`), one call a substep.  Each launch counts once.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.config import SimConfig, Solver
from ..core.state import State
from ..core.topology import EDGE_BEND, EDGE_SHEAR, Topology
from ..utils import profiling
from . import grid_features, grid_strain
from .blocks import self_collision_planes_cuda
from .build import check_launch
from .grid_features import (FINISH_ARGTYPES, CudaFeatures, FeatParamsStruct,
                            _ptr, features_on)
from .grid_scene import (CollidersStruct, WindStruct, check_input,
                         pack_grid_scene, sweep_pattern)
from .grid_strain import CudaStrain
from .stencil import _offsets, from_planes, to_planes


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return profiling.count("grid_euler")


def reset_launch_count() -> None:
    profiling.reset_count("grid_euler")


def launches_per_substep(cfg: SimConfig) -> int:
    """The substep launch, plus the strain launch (all its sweeps)."""
    return 1 + grid_strain.sweeps(cfg)


def launches_per_frame(cfg: SimConfig, n_substeps: int) -> int:
    """Each substep's launches, plus the frame-end feature update."""
    return grid_features.launches_per_frame(cfg, n_substeps,
                                            launches_per_substep(cfg))


class _Params(ctypes.Structure):
    _fields_ = [(name, ctypes.c_float) for name in (
        "dt", "damping", "gx", "gy", "gz", "decay", "restitution",
        "restitution1", "keep")]


class _Frame(ctypes.Structure):
    """``csrc/grid_euler.cu::GridEulerFrame`` field by field."""

    _fields_ = [
        *[(name, ctypes.c_void_p * 2) for name in ("x", "v", "alive",
                                                   "scale")],
        *[(name, ctypes.c_void_p) for name in (
            "inv_mass", "offsets", "tear_limits", "stream")],
        *[(name, ctypes.c_int) for name in (
            "n_off", "pattern", "feat", "wind_on", "strain", "ny", "nx")],
        ("fp", FeatParamsStruct),
        ("col", CollidersStruct),
        ("wind", WindStruct),
        ("p", _Params),
        ("sweeps", grid_strain.SweepsStruct),
    ]


def _pair(a, b):
    return (ctypes.c_void_p * 2)(_ptr(a), _ptr(b))


@functools.cache
def _launcher():
    from .build import load_library

    lib = load_library("grid_euler")
    p, i = ctypes.c_void_p, ctypes.c_int
    size = lib.grid_euler_frame_size
    size.restype = i
    if size() != ctypes.sizeof(_Frame):
        raise RuntimeError(
            f"grid_euler: the C frame struct has {size()} bytes, its ctypes "
            f"mirror {ctypes.sizeof(_Frame)}")
    fn = lib.grid_euler_substeps
    fn.argtypes = [
        ctypes.POINTER(_Frame),   # the struct
        i, i, i,                  # first substep, substeps, finish
        p,                        # f_ext (or null)
        ctypes.POINTER(i),        # launches out
    ]
    fn.restype = i
    lib.grid_euler_features.argtypes = FINISH_ARGTYPES
    lib.grid_euler_features.restype = i
    strain = lib.grid_euler_strain
    strain.argtypes = [
        ctypes.POINTER(grid_strain.SweepsStruct),   # the sweeps' struct
        p, p,                     # alive, scale
        p, p, p,                  # x0, x_out, v
        p,                        # stream
    ]
    strain.restype = i
    lib.grid_euler_strain_size.restype = i
    lib.grid_euler_error_string.argtypes = [i]
    lib.grid_euler_error_string.restype = ctypes.c_char_p
    return (fn, lib.grid_euler_features, strain, lib.grid_euler_strain_size,
            lib.grid_euler_error_string)


def make_cuda_step(top: Topology, cfg: SimConfig):
    """Build ``fn(state, dt, n_substeps) -> state`` that runs a frame as one
    ``grid_euler_substeps`` call: each substep one launch of the fused
    Euler grid kernel, on CTAs that own a 32 x 8 tile of the grid.

    The offset table (di, dj, k, rest) is packed once, here, and the
    collider rows (plane, spheres, capsules, boxes) once per topology a call
    brings (:class:`.grid_scene.ColliderRows`: ``fn(state, dt, n, top=)``
    with a topology from :func:`softbodyunity_torch.api.move_colliders`),
    into float32 rows on the device; the kernel reads them from device
    memory, so a frame makes no host round trip.  With self-collision
    on, each substep first computes the repulsion at its start position
    (method ``block``: one launch of the ``block_pairs`` kernel) and the
    Euler kernel adds that force plane to the spring forces: one call a
    substep.  Under tearing or plasticity the state's
    ``edge_alive``/``rest_scale`` go into ping-pong planes once a frame,
    every launch but the first updates them at its start, and one frame-end
    launch updates them over the final positions
    (:class:`.grid_features.CudaFeatures`, kept as ``fn.features``).  Wind
    adds its force in the substep launch.  Under the strain limit that
    launch integrates with the contact left out, and one launch of the
    sweeps follows (:class:`.grid_strain.CudaStrain`), the last sweep
    adding the change to the velocity and running the contact."""
    sc = pack_grid_scene(top, cfg, Solver.SEMI_IMPLICIT_EULER, "grid_euler")
    ny, nx, device = sc.ny, sc.nx, sc.device
    n = ny * nx
    offsets = _offsets(cfg, top.grid_spacing,
                       EDGE_SHEAR in top.edge_classes_present,
                       EDGE_BEND in top.edge_classes_present)
    pattern = sweep_pattern(offsets)
    table = torch.tensor(offsets, dtype=torch.float32, device=device)
    col = cfg.collision
    gx, gy, gz = cfg.gravity
    sc_force = self_collision_planes_cuda(cfg, ny, nx, device)
    substeps, finish, strain_fn, strain_size, error_string = _launcher()
    feat = (CudaFeatures(top, cfg, offsets, finish, error_string, "grid_euler")
            if features_on(cfg) else None)
    strain = (CudaStrain(cfg, offsets, sc.inv_mass, strain_fn, strain_size,
                         error_string, "grid_euler")
              if cfg.strain_limit.enabled else None)
    w = cfg.wind

    def fn(state: State, dt: float, n_substeps: int, top=None) -> State:
        # the host phases, spans while the recorder is on: planes in, the
        # struct packed, each C call, planes out
        sp = profiling.begin("grid_euler.planes_in") if profiling.on else -1
        check_input("state.x", state.x, (n, 3), device)
        check_input("state.v", state.v, (n, 3), device)
        dt = float(dt)
        x = torch.empty((2, 3, ny, nx), dtype=torch.float32, device=device)
        v = torch.empty_like(x)
        x[0].copy_(to_planes(state.x, ny, nx))
        v[0].copy_(to_planes(state.v, ny, nx))
        edge_alive, rest_scale = state.edge_alive, state.rest_scale
        if sp >= 0:
            profiling.end(sp)
        sp = profiling.begin("grid_euler.pack") if profiling.on else -1
        colliders = sc.colliders.args(sc.colliders.built if top is None
                                      else top)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            if feat:
                feat.begin(state)
            planes = ((feat.alive, feat.alive_out, feat.scale,
                       feat.scale_out) if feat else (None,) * 4)
            args = _Frame(
                _pair(x[0], x[1]), _pair(v[0], v[1]), _pair(*planes[:2]),
                _pair(*planes[2:]),
                sc.inv_mass.data_ptr(), table.data_ptr(),
                feat.limits.data_ptr() if feat else None, stream,
                len(offsets), pattern, int(feat is not None), int(w.enabled),
                int(strain is not None), ny, nx,
                FeatParamsStruct(*(feat.scalars if feat else (0.0,) * 5)),
                CollidersStruct(*colliders),
                WindStruct(*w.velocity, w.drag, w.lift),
                _Params(dt, cfg.springs.damping, gx, gy, gz,
                        1.0 - cfg.global_damping * dt, col.restitution,
                        1.0 + col.restitution, 1.0 - col.friction),
                (strain.begin(x[0], table) if strain
                 else grid_strain.SweepsStruct()))
            launched = ctypes.c_int()
            ref, count = ctypes.byref(args), ctypes.byref(launched)
            # self-collision: one call a substep, its force plane at the
            # substep's start; else the frame in one call
            calls = ([(k, 1) for k in range(n_substeps)] if sc_force
                     else [(0, n_substeps)])
            if sp >= 0:
                profiling.end(sp)
            for k0, n_run in calls:
                f_ext = None
                if sc_force:
                    f_ext = sc_force(x[0] if strain else x[k0 % 2])
                sp = profiling.begin("grid_euler.call") if profiling.on else -1
                err = substeps(ref, k0, n_run, int(k0 + n_run == n_substeps),
                               _ptr(f_ext), count)
                profiling.add("grid_euler", launched.value)
                check_launch(err, "grid_euler substeps", error_string)
                if strain:   # one strain launch a substep, counted there too
                    grid_strain.add_launches(n_run)
                if sp >= 0:
                    profiling.end(sp)
            if feat:
                # a buffer swap a substep, and one for the frame-end update
                for _ in range((n_substeps + int(n_substeps > 0)) % 2):
                    feat.swap()
                edge_alive, rest_scale = feat.end(state)
        sp = profiling.begin("grid_euler.planes_out") if profiling.on else -1
        last = n_substeps % 2
        xf = from_planes(x[0] if strain else x[last])
        vf = from_planes(v[last])
        out = State(x=xf, v=vf, x_prev=xf - dt * vf, edge_alive=edge_alive,
                    rest_scale=rest_scale, cluster_quat=state.cluster_quat)
        if sp >= 0:
            profiling.end(sp)
        return out

    fn.features = feat
    return fn


def make_strain_correction(top: Topology, cfg: SimConfig):
    """Build ``fn(x3, alive=None, scale=None) -> x_new``: the strain
    limit's sweeps alone (:class:`.grid_strain.CudaStrain`, one launch)
    from the ``[3, ny, nx]`` positions ``x3`` on the card, the last sweep's
    epilogue run with the contact left out, so ``x_new = x3 + dxl`` as the
    Euler substep adds it.  ``alive``/``scale`` are tear and plastic planes
    or None.  Its plain version is ``x3 + stencil.strain_limit_planes(...)``;
    the card tests and ``chip_smoke.py`` hold the sweeps to it alone.  Each
    launch counts here and in :mod:`.grid_strain`."""
    sc = pack_grid_scene(top, cfg, Solver.SEMI_IMPLICIT_EULER, "grid_euler")
    offsets = _offsets(cfg, top.grid_spacing,
                       EDGE_SHEAR in top.edge_classes_present,
                       EDGE_BEND in top.edge_classes_present)
    table = torch.tensor(offsets, dtype=torch.float32, device=sc.device)
    _, _, strain_fn, strain_size, error_string = _launcher()
    strain = CudaStrain(cfg, offsets, sc.inv_mass, strain_fn, strain_size,
                        error_string, "grid_euler")

    def fn(x3: torch.Tensor, alive=None, scale=None) -> torch.Tensor:
        check_input("x3", x3, (3, sc.ny, sc.nx), sc.device)
        out = torch.empty_like(x3)
        v = torch.zeros_like(x3)
        with torch.cuda.device(sc.device):
            stream = torch.cuda.current_stream(sc.device).cuda_stream
            strain.begin(x3, table)
            profiling.add("grid_euler", strain.launch(
                alive, scale, x3.data_ptr(), out.data_ptr(), v.data_ptr(),
                stream))
        return out

    return fn
