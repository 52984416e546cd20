"""Wrapper of the hand-written fused XPBD grid substep, ``csrc/grid_xpbd.cu``.

Counterpart of ``softbodyunity_tpu/kernels/pallas_xpbd.py::make_pallas_xpbd_step``
and, for grids past its vertex cap, of
``softbodyunity_tpu/kernels/pallas_tiled.py::make_tiled_xpbd_step``.
The plain PyTorch version is :func:`.stencil.make_stencil_step` (its XPBD
branch, :func:`.stencil.xpbd_substep_grid`); :mod:`.dispatch` takes it for
tensors on the CPU and this wrapper for tensors on a CUDA device, where it
launches the kernels or raises.

A substep is one ``ctypes`` call, ``grid_xpbd_substep``, on one of two
schedules of the same work, bit for bit (:func:`plan` picks it from the
grid's shape and the card's occupancy):

- resident, where every 32 x 8 tile of the grid fits on the card at once
  (:func:`resident_slots`) and ``n_iterations > 0``: one cooperative
  launch, each CTA a tile through the predict, the Jacobi sweeps and the
  epilogue, its state kept on the SM, ordered by its neighbours' stage
  flags (``flags``, one int a tile, allocated once);
- per sweep otherwise: ``1 + max(n_iterations, 1)`` launches, one predict
  pass, then one tiled launch per Jacobi sweep, the grid-wide barrier
  between sweeps (with no sweep, one launch runs the epilogue alone).

Under the strain limit the one launch of :mod:`.grid_strain` (all its
sweeps, from its own ``ctypes`` call) follows the ``n_iterations`` Jacobi
sweeps and runs the epilogue: ``1 + 1`` resident, ``1 + n_iterations + 1``
per sweep.
Under tearing or plasticity the predict also updates the feature planes
(and, under tearing, the substep's Jacobi weights), and a frame ends with
one more launch, the frame-end feature update (:mod:`.grid_features`).
Each launch counts once.

While the recorder is on (:mod:`softbodyunity_torch.utils.profiling`) each
substep's last Jacobi sweep is the kernel's counting instantiation, with
the same launches: it adds the live constraints it evaluates
(``grid_xpbd.edges_checked``) and those unmet by more than a thousandth
of their rest length at its evaluation point (``grid_xpbd.edges_unmet``)
into the recorder's device counters; the resident launch also adds the
polls of its neighbours' flags that found one not ready
(``grid_xpbd.flag_polls``).  Always on, beside the launches: the
substeps the resident schedule ran (``grid_xpbd.resident_substeps``).
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
from .grid_scene import (COLLIDER_ARGTYPES, CollidersStruct, WindStruct,
                         pack_grid_scene)
from .grid_strain import CudaStrain
from .stencil import _valid_mask, jacobi_count


# launch_count(): kernel launches (predict and sweep, or resident) since
# the last reset_launch_count()
launch_count = profiling.launch_views("grid_xpbd")[0]
RESIDENT = "grid_xpbd.resident_substeps"


def resident_substep_count() -> int:
    """Substeps that ran as one resident launch since the last
    :func:`reset_launch_count`."""
    return profiling.count(RESIDENT)


def reset_launch_count() -> None:
    """Zero the launch count and the resident substeps' count."""
    profiling.reset_count("grid_xpbd", RESIDENT)


# the device counters of the counting sweep, in csrc/grid_xpbd.cu's order
COUNTERS = ("edges_checked", "edges_unmet", "flag_polls")

# the sweep's tile, csrc/grid_common.cuh's kTileX x kTileY
TILE = (8, 32)


def jacobi_launches(cfg: SimConfig) -> int:
    """The Jacobi sweep launches of a per-sweep substep: one per
    iteration, at least one (for the epilogue) unless the strain sweeps
    run it."""
    it = cfg.xpbd.n_iterations
    return it if cfg.strain_limit.enabled else max(it, 1)


def tiles(shape) -> int:
    """The 32 x 8 tiles of a ``(ny, nx)`` grid, one CTA each."""
    ny, nx = shape
    return -(-ny // TILE[0]) * -(-nx // TILE[1])


def plan(cfg: SimConfig, shape, slots: int) -> bool:
    """Whether a substep of ``cfg`` on a ``(ny, nx)`` grid runs as one
    resident launch: it has Jacobi sweeps, and the card holds every tile's
    CTA at once (``slots``, :func:`resident_slots`)."""
    return cfg.xpbd.n_iterations > 0 and tiles(shape) <= slots


def resident_slots() -> int:
    """The CTAs of the resident kernel that the current card holds at
    once, the fewest of any of its instantiations (the C side asks the
    occupancy once a process)."""
    lib = _library()
    slots = ctypes.c_int()
    lib.check_launch(lib.grid_xpbd_resident_slots(ctypes.byref(slots)),
                     "grid_xpbd_resident_slots")
    return slots.value


def launches_per_substep(cfg: SimConfig, shape, slots=None) -> int:
    """The predict and the Jacobi sweeps (one resident launch where
    :func:`plan` says so, ``slots`` by default the card's), and the
    strain-limit sweeps."""
    slots = resident_slots() if slots is None else slots
    sweeps = 0 if plan(cfg, shape, slots) else jacobi_launches(cfg)
    return 1 + sweeps + grid_strain.sweeps(cfg)


def launches_per_frame(cfg: SimConfig, n_substeps: int, shape,
                       slots=None) -> int:
    """Each substep's launches, plus the frame-end feature update."""
    return grid_features.launches_per_frame(
        cfg, n_substeps, launches_per_substep(cfg, shape, slots))


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
        ("counters", ctypes.c_void_p),
        ("resident", ctypes.c_int),
        ("flags", ctypes.c_void_p),
        ("epoch", ctypes.c_void_p),
        ("relaxation", ctypes.c_float),
        ("fp", FeatParamsStruct),
        ("col", CollidersStruct),
        ("wind", WindStruct),
        ("p", _Params),
    ]


@functools.cache
def _library():
    lib = Library("grid_xpbd", substep=_Substep,
                  strain=grid_strain.SweepsStruct)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.declare("grid_xpbd_substep", [
        ctypes.POINTER(_Substep), p, p,   # the struct, x, x_out
        p,                                # f_ext (or null)
        p, p, p, p,                       # alive in, out, scale in, out
        i, ctypes.POINTER(i),             # first, launches out
    ])
    lib.declare("grid_xpbd_strain", [
        ctypes.POINTER(grid_strain.SweepsStruct),   # the sweeps' struct
        p, p,                  # alive, scale
        p, p, p,               # epilogue: xp, delta, flag
        *COLLIDER_ARGTYPES,    # the colliders
        p, p,                  # x_out, v
        f, f, f, f,            # dt, mu, keep, shell
        p,                     # stream
    ])
    lib.declare("grid_xpbd_resident_slots", [ctypes.POINTER(i)])
    return lib


def make_cuda_step(top: Topology, cfg: SimConfig):
    """Build ``fn(state, dt, n_substeps) -> state`` that runs each substep as
    one ``grid_xpbd_substep`` call on CTAs that own a 32 x 8 tile of the
    grid: one resident launch where :func:`plan` says so
    (``fn.resident``; its stage flags ``fn.flags``, zeroed once here),
    else a predict launch and one launch per Jacobi sweep.  The result
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
    the epilogue.  With the recorder on, each substep's last sweep counts
    into ``counters`` (allocated here, once).  Each frame runs through
    :class:`.frame.FrameLoop`, the positions in two planes that the
    substeps alternate."""
    sc = pack_grid_scene(top, cfg, Solver.XPBD, "grid_xpbd")
    ny, nx, device, xoffsets = sc.ny, sc.nx, sc.device, sc.offsets
    n_off = len(xoffsets)
    masks = [_valid_mask(ny, nx, di, dj, device, torch.float32)
             for di, dj, _, _ in xoffsets]
    inv_cnt = (cfg.xpbd.relaxation / jacobi_count(xoffsets, masks)).contiguous()
    mu = cfg.collision.friction
    n_sweeps = jacobi_launches(cfg)
    gx, gy, gz = cfg.gravity
    tables = {}
    lib = _library()
    substep = lib.grid_xpbd_substep
    feat = CudaFeatures(top, cfg, xoffsets, lib) if features_on(cfg) else None
    strain = (CudaStrain(cfg, xoffsets, sc.inv_mass, lib,
                         lib.grid_xpbd_strain)
              if cfg.strain_limit.enabled else None)
    w = cfg.wind
    tearing = cfg.tear.enabled
    counters = profiling.device_counters(
        [f"grid_xpbd.{name}" for name in COUNTERS], device)
    resident = plan(cfg, (ny, nx), resident_slots())
    flags = torch.zeros(tiles((ny, nx)), dtype=torch.int32, device=device)
    epoch = ctypes.c_uint(0)   # the C side advances it every resident launch

    def buffers(planes, dt):
        if dt not in tables:
            tables[dt] = torch.tensor(
                [(di, dj, alpha / (dt * dt), rest)
                 for di, dj, alpha, rest in xoffsets],
                dtype=torch.float32, device=device)
        lam = torch.empty((2, n_off, ny, nx), dtype=torch.float32,
                          device=device)
        flag = torch.empty((ny, nx), dtype=torch.uint8, device=device)
        # under tearing the predict writes each substep's Jacobi weights
        cnt = torch.empty_like(inv_cnt) if tearing else inv_cnt
        return tables[dt], lam, flag, cnt

    def pack(planes, bufs, dt, colliders, stream):
        x, x_out, v, delta = planes
        table, lam, flag, cnt = bufs
        x = x, x_out
        args = _Substep(
            v.data_ptr(),
            (ctypes.c_void_p * 2)(delta[0].data_ptr(), delta[1].data_ptr()),
            (ctypes.c_void_p * 2)(lam[0].data_ptr(), lam[1].data_ptr()),
            flag.data_ptr(), sc.inv_mass.data_ptr(), cnt.data_ptr(),
            cnt.data_ptr() if tearing else None, table.data_ptr(),
            feat.limits.data_ptr() if feat else None, stream,
            n_off, sc.pattern, int(feat is not None),
            int(w.enabled), n_sweeps, int(cfg.xpbd.n_iterations > 0),
            int(strain is None), ny, nx,
            counters.data_ptr() if profiling.on else None,
            int(resident), flags.data_ptr(), ctypes.addressof(epoch),
            cfg.xpbd.relaxation,
            FeatParamsStruct(*(feat.scalars if feat else (0.0,) * 5)),
            CollidersStruct(*colliders),
            WindStruct(*w.velocity, w.drag, w.lift),
            _Params(dt, gx, gy, gz, 1.0 - cfg.global_damping * dt, mu,
                    1.0 - mu, SPHERE_CONTACT_SHELL))
        if strain:
            strain.begin(x[0], table)
        return (x, v, ctypes.byref(args), [t.data_ptr() for t in x],
                table, delta[n_sweeps % 2], flag, colliders, dt, stream)

    def call(ctx, k0, n_run, last, f_ext, count):
        xp = ctx[3]
        fp = ((_ptr(feat.alive), _ptr(feat.alive_out), _ptr(feat.scale),
               _ptr(feat.scale_out)) if feat else (None,) * 4)
        return substep(ctx[2], xp[k0 % 2], xp[1 - k0 % 2], f_ext, *fp,
                       int(k0 == 0), count)

    def after(ctx, k0, n_run, last):
        x, v, _, xp, table, d_last, flag, colliders, dt, stream = ctx
        launches = 0
        if strain:
            # sweeps from xp + delta (the Jacobi loop's last delta); the
            # last projects the contact once more and runs the epilogue
            launches += strain.launch(
                feat.alive if feat else None, feat.scale if feat else None,
                xp[k0 % 2], d_last.data_ptr(), flag.data_ptr(), *colliders,
                xp[1 - k0 % 2], v.data_ptr(), dt, mu, 1.0 - mu,
                SPHERE_CONTACT_SHELL, stream)
        if last and feat:
            feat.launch_finish(x[1 - k0 % 2], table, stream)
            launches += 1
        if last and resident:
            profiling.add(RESIDENT, k0 + n_run)
        return launches

    def planes_at(ctx, k):
        return ctx[0][k % 2], ctx[1]

    def state(x, v, dt, s, edge_alive, rest_scale):
        return State(x=x, v=v, x_prev=x - dt * v, edge_alive=edge_alive,
                     rest_scale=rest_scale, cluster_quat=s.cluster_quat)

    fn = FrameLoop(
        "grid_xpbd", lib, sc, ("x", None, "v", (None, None)),
        buffers=buffers, pack=pack, call=call, after=after,
        planes_at=planes_at, state=state, per_substep=True,
        force=self_collision_planes_cuda(cfg, ny, nx, device), features=feat)
    fn.resident, fn.flags = resident, flags
    return fn
