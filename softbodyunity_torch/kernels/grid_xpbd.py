"""Wrapper of the hand-written fused XPBD grid substep, ``csrc/grid_xpbd.cu``.

Counterpart of ``softbodyunity_tpu/kernels/pallas_xpbd.py::make_pallas_xpbd_step``
and, for grids past its vertex cap, of
``softbodyunity_tpu/kernels/pallas_tiled.py::make_tiled_xpbd_step``.
The plain PyTorch version is :func:`.stencil.make_stencil_step` (its XPBD
branch, :func:`.stencil.xpbd_substep_grid`); :mod:`.dispatch` takes it for
tensors on the CPU and this wrapper for tensors on a CUDA device, where it
launches the kernels or raises.

A substep is one ``ctypes`` call, ``grid_xpbd_substep``, which launches
``1 + max(n_iterations, 1)`` kernels: one predict pass, then one tiled
launch per Jacobi sweep, the grid-wide barrier between sweeps (with no
sweep, one launch runs the epilogue alone).  Under the strain limit the
one launch of :mod:`.grid_strain` (all its sweeps, from its own ``ctypes``
call) follows the ``n_iterations`` Jacobi sweeps and runs the epilogue:
``1 + n_iterations + 1``.
Under tearing or plasticity the predict also updates the feature planes
(and, under tearing, the substep's Jacobi weights), and a frame ends with
one more launch, the frame-end feature update (:mod:`.grid_features`).
Each launch counts once.
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
from .grid_scene import (COLLIDER_ARGTYPES, CollidersStruct, WindStruct,
                         check_input, pack_grid_scene, sweep_pattern)
from .grid_strain import CudaStrain
from .stencil import (_valid_mask, _xpbd_offsets, from_planes, jacobi_count,
                      to_planes)


def launch_count() -> int:
    """Kernel launches (predict and sweep) since the last
    :func:`reset_launch_count`."""
    return profiling.count("grid_xpbd")


def reset_launch_count() -> None:
    profiling.reset_count("grid_xpbd")


def jacobi_launches(cfg: SimConfig) -> int:
    """The Jacobi sweep launches of a substep: one per iteration, at least
    one (for the epilogue) unless the strain sweeps run it."""
    it = cfg.xpbd.n_iterations
    return it if cfg.strain_limit.enabled else max(it, 1)


def launches_per_substep(cfg: SimConfig) -> int:
    """Predict, the Jacobi sweeps and the strain-limit sweeps."""
    return 1 + jacobi_launches(cfg) + grid_strain.sweeps(cfg)


def launches_per_frame(cfg: SimConfig, n_substeps: int) -> int:
    """Each substep's launches, plus the frame-end feature update."""
    return grid_features.launches_per_frame(cfg, n_substeps,
                                            launches_per_substep(cfg))


class _Params(ctypes.Structure):
    _fields_ = [(name, ctypes.c_float) for name in (
        "dt", "gx", "gy", "gz", "decay", "mu", "keep", "shell")]


class _Substep(ctypes.Structure):
    """``csrc/grid_xpbd.cu::GridXpbdSubstep`` field by field."""

    _fields_ = [
        ("v", ctypes.c_void_p),
        ("delta", ctypes.c_void_p * 2),
        ("lam", ctypes.c_void_p * 2),
        *[(name, ctypes.c_void_p) for name in (
            "flag", "inv_mass", "inv_cnt", "inv_cnt_out", "offsets",
            "tear_limits", "stream")],
        *[(name, ctypes.c_int) for name in (
            "n_off", "pattern", "feat", "wind_on",
            "n_sweeps", "project", "epilogue", "ny", "nx")],
        ("relaxation", ctypes.c_float),
        ("fp", FeatParamsStruct),
        ("col", CollidersStruct),
        ("wind", WindStruct),
        ("p", _Params),
    ]


@functools.cache
def _launchers():
    from .build import load_library

    lib = load_library("grid_xpbd")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    size = lib.grid_xpbd_substep_size
    size.restype = i
    if size() != ctypes.sizeof(_Substep):
        raise RuntimeError(
            f"grid_xpbd: the C substep struct has {size()} bytes, its "
            f"ctypes mirror {ctypes.sizeof(_Substep)}")
    substep = lib.grid_xpbd_substep
    substep.argtypes = [
        ctypes.POINTER(_Substep), p, p,   # the struct, x, x_out
        p,                                # f_ext (or null)
        p, p, p, p,                       # alive in, out, scale in, out
        i, ctypes.POINTER(i),             # first, launches out
    ]
    substep.restype = i
    lib.grid_xpbd_features.argtypes = FINISH_ARGTYPES
    lib.grid_xpbd_features.restype = i
    strain = lib.grid_xpbd_strain
    strain.argtypes = [
        ctypes.POINTER(grid_strain.SweepsStruct),   # the sweeps' struct
        p, p,                  # alive, scale
        p, p, p,               # epilogue: xp, delta, flag
        *COLLIDER_ARGTYPES,    # the colliders
        p, p,                  # x_out, v
        f, f, f, f,            # dt, mu, keep, shell
        p,                     # stream
    ]
    strain.restype = i
    lib.grid_xpbd_strain_size.restype = i
    lib.grid_xpbd_error_string.argtypes = [i]
    lib.grid_xpbd_error_string.restype = ctypes.c_char_p
    return (substep, lib.grid_xpbd_features, strain,
            lib.grid_xpbd_strain_size, lib.grid_xpbd_error_string)


def make_cuda_step(top: Topology, cfg: SimConfig):
    """Build ``fn(state, dt, n_substeps) -> state`` that runs each substep as
    one ``grid_xpbd_substep`` call (a predict launch and one launch per
    Jacobi sweep, on CTAs that own a 32 x 8 tile of the grid).  The result
    carries ``x_prev = x - dt * v``, as the plain version's.

    ``inv_cnt = relaxation / max(count, 1)`` is packed once, here, the
    collider rows once per topology a call brings (as
    :func:`.grid_euler.make_cuda_step` packs them); the offset table (di, dj, alpha / dt^2, rest) once
    per substep size ``dt``.  With self-collision on, each substep first
    computes the repulsion at its start position (method ``block``: one
    ``block_pairs`` launch), which the predict launch takes into the
    velocity; the sweeps cover only the springs.  Under tearing or
    plasticity the predict runs the launch-start feature update of
    :func:`.grid_euler.make_cuda_step` (``fn.features``) and, under
    tearing, writes the substep's ``relaxation / max(count, 1)`` from the
    live edges, which the sweeps read in place of the scene's.  Wind enters
    the predict.  Under the strain limit every Jacobi sweep stores its
    delta, and the strain sweeps (:class:`.grid_strain.CudaStrain`) start
    from ``xp + delta``; the last projects the contact once more and runs
    the epilogue."""
    sc = pack_grid_scene(top, cfg, Solver.XPBD, "grid_xpbd")
    ny, nx, device = sc.ny, sc.nx, sc.device
    n = ny * nx
    xoffsets = _xpbd_offsets(cfg, top.grid_spacing,
                             EDGE_SHEAR in top.edge_classes_present,
                             EDGE_BEND in top.edge_classes_present)
    n_off = len(xoffsets)
    pattern = sweep_pattern(xoffsets)
    masks = [_valid_mask(ny, nx, di, dj, device, torch.float32)
             for di, dj, _, _ in xoffsets]
    inv_cnt = (cfg.xpbd.relaxation / jacobi_count(xoffsets, masks)).contiguous()
    mu = cfg.collision.friction
    n_sweeps = jacobi_launches(cfg)
    gx, gy, gz = cfg.gravity
    tables = {}
    sc_force = self_collision_planes_cuda(cfg, ny, nx, device)
    substep, finish, strain_fn, strain_size, error_string = _launchers()
    feat = (CudaFeatures(top, cfg, xoffsets, finish, error_string,
                         "grid_xpbd") if features_on(cfg) else None)
    strain = (CudaStrain(cfg, xoffsets, sc.inv_mass, strain_fn, strain_size,
                         error_string, "grid_xpbd")
              if cfg.strain_limit.enabled else None)
    w = cfg.wind
    tearing = cfg.tear.enabled

    def fn(state: State, dt: float, n_substeps: int, top=None) -> State:
        colliders = sc.colliders.args(sc.colliders.built if top is None
                                      else top)
        check_input("state.x", state.x, (n, 3), device)
        check_input("state.v", state.v, (n, 3), device)
        dt = float(dt)
        if dt not in tables:
            tables[dt] = torch.tensor(
                [(di, dj, alpha / (dt * dt), rest)
                 for di, dj, alpha, rest in xoffsets],
                dtype=torch.float32, device=device)
        table = tables[dt]
        x = torch.empty((3, ny, nx), dtype=torch.float32, device=device)
        x_out = torch.empty_like(x)
        v = torch.empty_like(x)
        delta = torch.empty((2, 3, ny, nx), dtype=torch.float32,
                            device=device)
        lam = torch.empty((2, n_off, ny, nx), dtype=torch.float32,
                          device=device)
        flag = torch.empty((ny, nx), dtype=torch.uint8, device=device)
        x.copy_(to_planes(state.x, ny, nx))
        v.copy_(to_planes(state.v, ny, nx))
        edge_alive, rest_scale = state.edge_alive, state.rest_scale
        # under tearing the predict writes each substep's Jacobi weights
        cnt = torch.empty_like(inv_cnt) if tearing else inv_cnt
        # the Jacobi loop's last delta, where the strain sweeps start
        d_last = delta[n_sweeps % 2]
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            args = _Substep(
                v.data_ptr(),
                (ctypes.c_void_p * 2)(delta[0].data_ptr(),
                                      delta[1].data_ptr()),
                (ctypes.c_void_p * 2)(lam[0].data_ptr(), lam[1].data_ptr()),
                flag.data_ptr(), sc.inv_mass.data_ptr(), cnt.data_ptr(),
                cnt.data_ptr() if tearing else None, table.data_ptr(),
                feat.limits.data_ptr() if feat else None, stream,
                n_off, pattern, int(feat is not None),
                int(w.enabled), n_sweeps, int(cfg.xpbd.n_iterations > 0),
                int(strain is None), ny, nx, cfg.xpbd.relaxation,
                FeatParamsStruct(*(feat.scalars if feat else (0.0,) * 5)),
                CollidersStruct(*colliders),
                WindStruct(*w.velocity, w.drag, w.lift),
                _Params(dt, gx, gy, gz, 1.0 - cfg.global_damping * dt, mu,
                        1.0 - mu, SPHERE_CONTACT_SHELL))
            launched = ctypes.c_int()
            ref, count = ctypes.byref(args), ctypes.byref(launched)
            if feat:
                feat.begin(state)
            if strain:
                strain.begin(x, table)
            for k in range(n_substeps):
                f_ext = sc_force(x) if sc_force else None
                err = substep(
                    ref, x.data_ptr(), x_out.data_ptr(), _ptr(f_ext),
                    *((_ptr(feat.alive), _ptr(feat.alive_out),
                       _ptr(feat.scale), _ptr(feat.scale_out)) if feat
                      else (None,) * 4),
                    int(k == 0), count)
                profiling.add("grid_xpbd", launched.value)
                check_launch(err, "grid_xpbd substep", error_string)
                if feat:
                    feat.swap()
                if strain:
                    # sweeps from xp + delta; the last projects the contact
                    # once more and runs the epilogue
                    profiling.add("grid_xpbd", strain.launch(
                        feat.alive if feat else None,
                        feat.scale if feat else None,
                        x.data_ptr(), d_last.data_ptr(), flag.data_ptr(),
                        *colliders, x_out.data_ptr(), v.data_ptr(), dt, mu,
                        1.0 - mu, SPHERE_CONTACT_SHELL, stream))
                x, x_out = x_out, x
            if feat:
                if n_substeps > 0:
                    feat.launch_finish(x, table, stream)
                    profiling.add("grid_xpbd", 1)
                edge_alive, rest_scale = feat.end(state)
        x3, v3 = from_planes(x), from_planes(v)
        return State(x=x3, v=v3, x_prev=x3 - dt * v3, edge_alive=edge_alive,
                     rest_scale=rest_scale, cluster_quat=state.cluster_quat)

    fn.features = feat
    return fn
