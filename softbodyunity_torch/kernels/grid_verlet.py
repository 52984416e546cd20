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
(:mod:`.grid_features`).  A frame is one ``ctypes`` call,
``grid_verlet_substeps``, from a struct built once a call, which rotates
the three position buffers itself (:func:`buffers`); with self-collision,
whose force plane the ``block_pairs`` call builds and sweeps at each
substep's start (:mod:`.blocks`), one call a substep.  Each launch counts once.
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
from . import grid_features, grid_strain
from .blocks import self_collision_planes_cuda
from .build import Library
from .frame import FrameLoop
from .grid_features import CudaFeatures, FeatParamsStruct, _ptr, features_on
from .grid_scene import CollidersStruct, WindStruct, pack_grid_scene
from .grid_strain import CudaStrain


# launch_count(): kernel launches since the last reset_launch_count()
launch_count, reset_launch_count = profiling.launch_views("grid_verlet")


def launches_per_substep(cfg: SimConfig) -> int:
    """The substep launch, plus the strain launch (all its sweeps)."""
    return 1 + grid_strain.sweeps(cfg)


def launches_per_frame(cfg: SimConfig, n_substeps: int) -> int:
    """Each substep's launches, plus the frame-end feature update."""
    return grid_features.launches_per_frame(cfg, n_substeps,
                                            launches_per_substep(cfg))


def buffers(k: int, strain: bool) -> tuple:
    """The ``(x, x_prev, out)`` buffer indices of substep ``k``, as
    ``csrc/grid_verlet.cu::verlet_buffers`` names them: without the strain
    limit the rotation ``(x, xp, out) <- (out, x, xp)`` has period 3; under
    it ``(x, xp) <- (xp, x)``, the last sweep writing the new x over xp."""
    if strain:
        return k % 2, 1 - k % 2, 2
    r = -k % 3
    return r, (r + 1) % 3, (r + 2) % 3


class _Params(ctypes.Structure):
    _fields_ = [(name, ctypes.c_float) for name in (
        "dt", "damping", "gx", "gy", "gz", "decay", "mu", "keep", "shell")]


class _Frame(ctypes.Structure):
    """``csrc/grid_verlet.cu::GridVerletFrame`` field by field."""

    _fields_ = [
        ("x", ctypes.c_void_p * 3),
        *[(name, ctypes.c_void_p * 2) for name in ("alive", "scale")],
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


@functools.cache
def _library():
    lib = Library("grid_verlet", frame=_Frame,
                  strain=grid_strain.SweepsStruct)
    i = ctypes.c_int
    lib.declare("grid_verlet_substeps", [
        ctypes.POINTER(_Frame),   # the struct
        i, i, i,                  # first substep, substeps, finish
        ctypes.c_void_p,          # f_ext (or null)
        ctypes.POINTER(i),        # launches out
    ])
    return lib


def make_cuda_step(top: Topology, cfg: SimConfig):
    """Build ``fn(state, dt, n_substeps) -> state`` that runs a frame as one
    ``grid_verlet_substeps`` call: each substep one launch of the fused
    Verlet grid kernel, on CTAs that own a 32 x 8 tile of the grid.
    ``state.x_prev`` is the Verlet history; the result carries ``x_prev`` =
    the last substep's start and ``v = (x - x_prev) / dt``.

    The offset table (di, dj, k, rest) is packed once, here, and the
    collider rows once per topology a call brings, as
    :func:`.grid_euler.make_cuda_step` packs them.  With self-collision on,
    each substep first computes the repulsion at ``x`` (method ``block``:
    one ``block_pairs`` launch), which the kernel adds to the spring
    forces: one call a substep.  Tearing and plasticity as
    :func:`.grid_euler.make_cuda_step` runs them (``fn.features``), and the
    wind and the strain limit too: the last sweep runs the contact and
    friction, and writes the new x over the history, which the integrate
    launch has read.  Each frame runs through :class:`.frame.FrameLoop`."""
    sc = pack_grid_scene(top, cfg, Solver.VERLET, "grid_verlet")
    ny, nx, offsets = sc.ny, sc.nx, sc.offsets
    table = torch.tensor(offsets, dtype=torch.float32, device=sc.device)
    mu = cfg.collision.friction
    gx, gy, gz = cfg.gravity
    lib = _library()
    substeps = lib.grid_verlet_substeps
    feat = CudaFeatures(top, cfg, offsets, lib) if features_on(cfg) else None
    # the sweeps launch from grid_verlet_substeps, never from CudaStrain
    strain = (CudaStrain(cfg, offsets, sc.inv_mass, lib)
              if cfg.strain_limit.enabled else None)
    w = cfg.wind

    def pack(planes, _, dt, colliders, stream):
        x = planes[0].unbind()   # the planes once a frame
        fp = ((feat.alive, feat.alive_out, feat.scale, feat.scale_out)
              if feat else (None,) * 4)
        return x, ctypes.byref(_Frame(
            (ctypes.c_void_p * 3)(*(b.data_ptr() for b in x)),
            (ctypes.c_void_p * 2)(*map(_ptr, fp[:2])),
            (ctypes.c_void_p * 2)(*map(_ptr, fp[2:])),
            sc.inv_mass.data_ptr(), table.data_ptr(),
            feat.limits.data_ptr() if feat else None, stream,
            len(offsets), sc.pattern, int(feat is not None), int(w.enabled),
            int(strain is not None), ny, nx,
            FeatParamsStruct(*(feat.scalars if feat else (0.0,) * 5)),
            CollidersStruct(*colliders),
            WindStruct(*w.velocity, w.drag, w.lift),
            _Params(dt, cfg.springs.damping, gx, gy, gz,
                    1.0 - cfg.global_damping * dt, mu, 1.0 - mu,
                    SPHERE_CONTACT_SHELL),
            (strain.begin(x[2], table) if strain
             else grid_strain.SweepsStruct())))

    def call(ctx, k0, n_run, last, f_ext, count):
        return substeps(ctx[1], k0, n_run, int(last), f_ext, count)

    def planes_at(ctx, k):
        b = buffers(k, strain is not None)
        return ctx[0][b[0]], ctx[0][b[1]]

    def state(x, xp, dt, s, edge_alive, rest_scale):
        return State(x=x, v=(x - xp) / dt, x_prev=xp, edge_alive=edge_alive,
                     rest_scale=rest_scale, cluster_quat=s.cluster_quat)

    # one strain launch a substep, counted there too
    after = ((lambda ctx, k0, n_run, last: grid_strain.add_launches(n_run))
             if strain else None)
    return FrameLoop(
        "grid_verlet", lib, sc, (("x", "x_prev", None),), pack=pack,
        call=call, planes_at=planes_at, state=state, after=after,
        force=self_collision_planes_cuda(cfg, ny, nx, sc.device),
        features=feat)
