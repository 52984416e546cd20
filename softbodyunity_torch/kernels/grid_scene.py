"""What the CUDA kernel wrappers share: the grid scene's checks and fixed
inputs (:mod:`.grid_euler`, :mod:`.grid_verlet`, :mod:`.grid_xpbd`), the
collider rows of every grid and lattice kernel, packed on the card from the
topology of each call (:class:`ColliderRows`), the wind's launch arguments,
the checks of each tensor handed to a kernel, and the check of a kernel's
solver and device (:func:`check_card`).

Counterpart of ``softbodyunity_tpu/kernels/pallas_substep.py``'s
``_pack_plane``/``_pack_spheres``/``_pack_capsules``/``_pack_boxes``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..core.config import SimConfig, Solver
from ..core.topology import EDGE_BEND, EDGE_SHEAR, Topology, check_same_scene
from .stencil import _offsets, _xpbd_offsets, check_grid_ported


# The grid's offset patterns (csrc/grid_common.cuh Pattern), as (di, dj) rows
# of the offsets tables (kernels/stencil.py::_offsets and ::_xpbd_offsets
# list them alike): structural, with shear, with bend, with both
PATTERNS = (((0, 1), (1, 0)),
            ((0, 1), (1, 0), (1, 1), (1, -1)),
            ((0, 1), (1, 0), (0, 2), (2, 0)),
            ((0, 1), (1, 0), (1, 1), (1, -1), (0, 2), (2, 0)))


def sweep_pattern(offsets) -> int:
    """The index in :data:`PATTERNS` of the tiled kernels compiled for the
    offsets table's (di, dj, ...) rows; raises for a pattern none is
    compiled for."""
    rows = tuple((int(o[0]), int(o[1])) for o in offsets)
    if rows not in PATTERNS:
        raise ValueError(f"no tiled kernel is compiled for the offsets {rows}")
    return PATTERNS.index(rows)


def pack_plane(top: Topology) -> torch.Tensor:
    """[1, 4] row: plane height, plane surface (conveyor) velocity."""
    return torch.cat([top.plane_height.reshape(1),
                      top.plane_velocity.reshape(3)]).reshape(1, 4).contiguous()


def pack_spheres(top: Topology) -> torch.Tensor:
    """[S, 7] rows: center (3), radius, kinematic velocity (3)."""
    return torch.cat([top.sphere_centers, top.sphere_radii[:, None],
                      top.sphere_velocities], dim=1).contiguous()


def pack_capsules(top: Topology) -> torch.Tensor:
    """[C, 10] rows: p0 (3), p1 (3), radius, kinematic velocity (3)."""
    return torch.cat([top.capsule_p0, top.capsule_p1,
                      top.capsule_radii[:, None], top.capsule_velocities],
                     dim=1).contiguous()


def pack_boxes(top: Topology) -> torch.Tensor:
    """[B, 18] rows: center (3), half extents (3), the rotation row-major
    (9: R[c][i] at 6 + 3c + i, its columns the box's axes), kinematic
    velocity (3)."""
    return torch.cat([top.box_centers, top.box_half_extents,
                      top.box_rotations.reshape(-1, 9), top.box_velocities],
                     dim=1).contiguous()


# ctypes argument types of the colliders in every grid and lattice launch
# that runs contact (csrc/grid_common.cuh::COLLIDER_PARAMS): plane,
# plane_on, plane_fric, spheres, n_spheres, sphere_fric, capsules,
# n_capsules, boxes, n_boxes, rest_fric
COLLIDER_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_void_p, ctypes.c_int, ctypes.c_int]


class CollidersStruct(ctypes.Structure):
    """``csrc/grid_common.cuh::Colliders`` field by field, for the structs
    of the substep entries (``grid_{euler,verlet}_substeps``,
    ``grid_xpbd_substep``, ``lattice_xpbd_substep``);
    built from :meth:`ColliderRows.args`, whose order is the struct's."""

    _fields_ = [(name, t) for name, t in zip(
        ("plane", "plane_on", "plane_fric", "spheres", "n_spheres",
         "sphere_fric", "capsules", "n_capsules", "boxes", "n_boxes",
         "rest_fric"), COLLIDER_ARGTYPES)]


class WindStruct(ctypes.Structure):
    """``csrc/grid_common.cuh::Wind``: velocity, drag, lift."""

    _fields_ = [(name, ctypes.c_float)
                for name in ("vx", "vy", "vz", "drag", "lift")]


class ColliderRows:
    """The collider rows a kernel reads, as launch arguments
    (:data:`COLLIDER_ARGTYPES`): float32 rows on the card, packed from a
    topology, with the count of a collider that is off forced to 0 and the
    friction flags of the position-level solvers.  :meth:`args` packs them
    again only when a call brings another topology than the last, one that
    :func:`softbodyunity_torch.api.move_colliders` made from the built one:
    a moved collider costs a few hundred bytes, not a new step function."""

    def __init__(self, top: Topology, cfg: SimConfig):
        self.built = top
        self.collision = cfg.collision
        self.top = None
        self.args(top)

    def args(self, top: Topology) -> tuple:
        """The launch arguments of ``top``'s colliders."""
        if top is self.top:
            return self._args
        check_same_scene(self.built, top)
        rows = (pack_plane(top), pack_spheres(top), pack_capsules(top),
                pack_boxes(top))
        for name, t, shape in zip(
                ("plane", "spheres", "capsules", "boxes"), rows,
                ((1, 4), (top.n_spheres, 7), (top.n_capsules, 10),
                 (top.n_boxes, 18))):
            check_input(name, t, shape, self.built.device)
        col = self.collision
        n_spheres = top.n_spheres if col.enable_spheres else 0
        n_caps = top.n_capsules if col.enable_capsules else 0
        n_boxes = top.n_boxes if col.enable_boxes else 0
        fric = col.friction != 0.0
        # the rows stay referenced while launches may read them; a later
        # call's rows are written in stream order after those launches
        self.rows, self.top = rows, top
        self._args = (
            rows[0].data_ptr(), int(col.enable_plane),
            int(col.enable_plane and fric),
            rows[1].data_ptr(), n_spheres, int(n_spheres > 0 and fric),
            rows[2].data_ptr(), n_caps, rows[3].data_ptr(), n_boxes,
            int(n_caps + n_boxes > 0 and fric))
        return self._args


@dataclasses.dataclass(frozen=True)
class GridScene:
    """A grid scene's kernel inputs: fixed from frame to frame, but for the
    collider rows, which each call reads from its topology."""

    device: torch.device
    ny: int
    nx: int
    inv_mass: torch.Tensor   # [ny, nx]
    colliders: ColliderRows
    offsets: list            # the solver's (di, dj, k or compliance, rest)
    pattern: int             # their index in PATTERNS


def check_input(name: str, t: torch.Tensor, shape, device) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on
    ``device`` that needs no gradient: what a kernel takes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the topology on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} is {t.dtype}; the kernel takes float32 only")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if t.requires_grad:
        raise NotImplementedError(
            f"{name} requires grad; the backward kernel is not ported yet "
            "(ROADMAP Queue 1 item 9)")


def check_card(top: Topology, cfg: SimConfig, solver: Solver,
               kernel: str) -> None:
    """Raise unless ``kernel``, which runs ``solver``, is given that
    solver's config and a topology on a CUDA device."""
    if cfg.solver != solver:
        raise ValueError(f"{kernel} runs the {solver.value} solver, not "
                         f"{cfg.solver.value}")
    if top.device.type != "cuda":
        raise ValueError(f"make_cuda_step needs a topology on a CUDA device, "
                         f"not {top.device}")


def pack_grid_scene(top: Topology, cfg: SimConfig, solver: Solver,
                    kernel: str) -> GridScene:
    """Check that ``kernel``, which runs ``solver``, can run ``(top, cfg)``
    on the card, and pack the scene's inputs there."""
    check_grid_ported(cfg)
    if top.grid_shape is None or top.grid_spacing is None:
        raise ValueError("make_cuda_step needs a structured grid topology")
    check_card(top, cfg, solver, kernel)
    ny, nx = top.grid_shape
    inv_mass = top.inv_mass.reshape(ny, nx)
    check_input("inv_mass", inv_mass, (ny, nx), top.device)
    offsets = (_xpbd_offsets if solver == Solver.XPBD else _offsets)(
        cfg, top.grid_spacing, EDGE_SHEAR in top.edge_classes_present,
        EDGE_BEND in top.edge_classes_present)
    return GridScene(device=top.device, ny=ny, nx=nx, inv_mass=inv_mass,
                     colliders=ColliderRows(top, cfg), offsets=offsets,
                     pattern=sweep_pattern(offsets))
