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
from ..core.topology import Topology
from ..utils import profiling
from . import grid_features, grid_strain
from .blocks import self_collision_planes_cuda
from .build import Library
from .frame import FrameLoop
from .grid_features import CudaFeatures, FeatParamsStruct, _ptr, features_on
from .grid_scene import (CollidersStruct, WindStruct, check_input,
                         pack_grid_scene)
from .grid_strain import CudaStrain


# launch_count(): kernel launches since the last reset_launch_count()
launch_count, reset_launch_count = profiling.launch_views("grid_euler")


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
def _library():
    lib = Library("grid_euler", frame=_Frame, strain=grid_strain.SweepsStruct)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.declare("grid_euler_substeps", [
        ctypes.POINTER(_Frame),   # the struct
        i, i, i,                  # first substep, substeps, finish
        p,                        # f_ext (or null)
        ctypes.POINTER(i),        # launches out
    ])
    lib.declare("grid_euler_strain", [
        ctypes.POINTER(grid_strain.SweepsStruct),   # the sweeps' struct
        p, p,                     # alive, scale
        p, p, p,                  # x0, x_out, v
        p,                        # stream
    ])
    return lib


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
    adding the change to the velocity and running the contact.  Each frame
    runs through :class:`.frame.FrameLoop`."""
    sc = pack_grid_scene(top, cfg, Solver.SEMI_IMPLICIT_EULER, "grid_euler")
    ny, nx, offsets = sc.ny, sc.nx, sc.offsets
    table = torch.tensor(offsets, dtype=torch.float32, device=sc.device)
    col = cfg.collision
    gx, gy, gz = cfg.gravity
    lib = _library()
    substeps = lib.grid_euler_substeps
    feat = CudaFeatures(top, cfg, offsets, lib) if features_on(cfg) else None
    strain = (CudaStrain(cfg, offsets, sc.inv_mass, lib)
              if cfg.strain_limit.enabled else None)
    w = cfg.wind

    def pack(planes, _, dt, colliders, stream):
        # the pairs' planes once a frame, not a view a substep
        x, v = (p.unbind() for p in planes)
        fp = ((feat.alive, feat.alive_out, feat.scale, feat.scale_out)
              if feat else (None,) * 4)
        return x, v, ctypes.byref(_Frame(
            _pair(*x), _pair(*v), _pair(*fp[:2]),
            _pair(*fp[2:]), sc.inv_mass.data_ptr(), table.data_ptr(),
            feat.limits.data_ptr() if feat else None, stream,
            len(offsets), sc.pattern, int(feat is not None), int(w.enabled),
            int(strain is not None), ny, nx,
            FeatParamsStruct(*(feat.scalars if feat else (0.0,) * 5)),
            CollidersStruct(*colliders),
            WindStruct(*w.velocity, w.drag, w.lift),
            _Params(dt, cfg.springs.damping, gx, gy, gz,
                    1.0 - cfg.global_damping * dt, col.restitution,
                    1.0 + col.restitution, 1.0 - col.friction),
            (strain.begin(x[0], table) if strain
             else grid_strain.SweepsStruct())))

    def call(ctx, k0, n_run, last, f_ext, count):
        return substeps(ctx[2], k0, n_run, int(last), f_ext, count)

    def planes_at(ctx, k):
        # under the strain limit the last sweep writes x over buffer 0
        x, v, _ = ctx
        return x[0] if strain else x[k % 2], v[k % 2]

    def state(x, v, dt, s, edge_alive, rest_scale):
        return State(x=x, v=v, x_prev=x - dt * v, edge_alive=edge_alive,
                     rest_scale=rest_scale, cluster_quat=s.cluster_quat)

    # one strain launch a substep, counted there too
    after = ((lambda ctx, k0, n_run, last: grid_strain.add_launches(n_run))
             if strain else None)
    return FrameLoop(
        "grid_euler", lib, sc, (("x", None), ("v", None)), pack=pack,
        call=call, planes_at=planes_at, state=state, after=after,
        force=self_collision_planes_cuda(cfg, ny, nx, sc.device),
        features=feat)


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
    table = torch.tensor(sc.offsets, dtype=torch.float32, device=sc.device)
    lib = _library()
    strain = CudaStrain(cfg, sc.offsets, sc.inv_mass, lib,
                        lib.grid_euler_strain)

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
