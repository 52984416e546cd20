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
from ..core.topology import EDGE_BEND, EDGE_SHEAR, Topology
from ..solver.collide import SPHERE_CONTACT_SHELL
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
    return profiling.count("grid_verlet")


def reset_launch_count() -> None:
    profiling.reset_count("grid_verlet")


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
def _launcher():
    from .build import load_library

    lib = load_library("grid_verlet")
    p, i = ctypes.c_void_p, ctypes.c_int
    size = lib.grid_verlet_frame_size
    size.restype = i
    if size() != ctypes.sizeof(_Frame):
        raise RuntimeError(
            f"grid_verlet: the C frame struct has {size()} bytes, its "
            f"ctypes mirror {ctypes.sizeof(_Frame)}")
    fn = lib.grid_verlet_substeps
    fn.argtypes = [
        ctypes.POINTER(_Frame),   # the struct
        i, i, i,                  # first substep, substeps, finish
        p,                        # f_ext (or null)
        ctypes.POINTER(i),        # launches out
    ]
    fn.restype = i
    lib.grid_verlet_features.argtypes = FINISH_ARGTYPES
    lib.grid_verlet_features.restype = i
    lib.grid_verlet_strain_size.restype = i
    lib.grid_verlet_error_string.argtypes = [i]
    lib.grid_verlet_error_string.restype = ctypes.c_char_p
    return (fn, lib.grid_verlet_features, lib.grid_verlet_strain_size,
            lib.grid_verlet_error_string)


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
    launch has read."""
    sc = pack_grid_scene(top, cfg, Solver.VERLET, "grid_verlet")
    ny, nx, device = sc.ny, sc.nx, sc.device
    n = ny * nx
    offsets = _offsets(cfg, top.grid_spacing,
                       EDGE_SHEAR in top.edge_classes_present,
                       EDGE_BEND in top.edge_classes_present)
    pattern = sweep_pattern(offsets)
    table = torch.tensor(offsets, dtype=torch.float32, device=device)
    mu = cfg.collision.friction
    gx, gy, gz = cfg.gravity
    sc_force = self_collision_planes_cuda(cfg, ny, nx, device)
    substeps, finish, strain_size, error_string = _launcher()
    feat = (CudaFeatures(top, cfg, offsets, finish, error_string,
                         "grid_verlet") if features_on(cfg) else None)
    # the sweeps launch from grid_verlet_substeps, never from CudaStrain
    strain = (CudaStrain(cfg, offsets, sc.inv_mass, None, strain_size,
                         error_string, "grid_verlet")
              if cfg.strain_limit.enabled else None)
    w = cfg.wind

    def fn(state: State, dt: float, n_substeps: int, top=None) -> State:
        colliders = sc.colliders.args(sc.colliders.built if top is None
                                      else top)
        check_input("state.x", state.x, (n, 3), device)
        check_input("state.x_prev", state.x_prev, (n, 3), device)
        dt = float(dt)
        x = torch.empty((3, 3, ny, nx), dtype=torch.float32, device=device)
        x[0].copy_(to_planes(state.x, ny, nx))
        x[1].copy_(to_planes(state.x_prev, ny, nx))
        edge_alive, rest_scale = state.edge_alive, state.rest_scale
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            if feat:
                feat.begin(state)
            planes = ((feat.alive, feat.alive_out, feat.scale,
                       feat.scale_out) if feat else (None,) * 4)
            args = _Frame(
                (ctypes.c_void_p * 3)(*(b.data_ptr() for b in x)),
                (ctypes.c_void_p * 2)(*map(_ptr, planes[:2])),
                (ctypes.c_void_p * 2)(*map(_ptr, planes[2:])),
                sc.inv_mass.data_ptr(), table.data_ptr(),
                feat.limits.data_ptr() if feat else None, stream,
                len(offsets), pattern, int(feat is not None), int(w.enabled),
                int(strain is not None), ny, nx,
                FeatParamsStruct(*(feat.scalars if feat else (0.0,) * 5)),
                CollidersStruct(*colliders),
                WindStruct(*w.velocity, w.drag, w.lift),
                _Params(dt, cfg.springs.damping, gx, gy, gz,
                        1.0 - cfg.global_damping * dt, mu, 1.0 - mu,
                        SPHERE_CONTACT_SHELL),
                (strain.begin(x[2], table) if strain
                 else grid_strain.SweepsStruct()))
            launched = ctypes.c_int()
            ref, count = ctypes.byref(args), ctypes.byref(launched)
            # self-collision: one call a substep, its force plane at the
            # substep's start; else the frame in one call
            calls = ([(k, 1) for k in range(n_substeps)] if sc_force
                     else [(0, n_substeps)])
            for k0, n_run in calls:
                f_ext = None
                if sc_force:
                    f_ext = sc_force(x[buffers(k0, strain is not None)[0]])
                err = substeps(ref, k0, n_run, int(k0 + n_run == n_substeps),
                               _ptr(f_ext), count)
                profiling.add("grid_verlet", launched.value)
                check_launch(err, "grid_verlet substeps", error_string)
                if strain:   # one strain launch a substep, counted there too
                    grid_strain.add_launches(n_run)
            if feat:
                # a buffer swap a substep, and one for the frame-end update
                for _ in range((n_substeps + int(n_substeps > 0)) % 2):
                    feat.swap()
                edge_alive, rest_scale = feat.end(state)
        last, prev, _ = buffers(n_substeps, strain is not None)
        x3, xp3 = from_planes(x[last]), from_planes(x[prev])
        return State(x=x3, v=(x3 - xp3) / dt, x_prev=xp3,
                     edge_alive=edge_alive, rest_scale=rest_scale,
                     cluster_quat=state.cluster_quat)

    fn.features = feat
    return fn
