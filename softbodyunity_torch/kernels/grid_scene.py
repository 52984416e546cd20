"""What the grid-cloth CUDA kernel wrappers (:mod:`.grid_euler`,
:mod:`.grid_verlet`, :mod:`.grid_xpbd`) share: the scene's checks and its
collider rows packed once on the card, the wind's launch arguments, the
checks of each tensor handed to a kernel, and the launch-error check.

Counterpart of ``softbodyunity_tpu/kernels/pallas_substep.py``'s
``_pack_plane``/``_pack_spheres``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..core.config import SimConfig, Solver
from ..core.topology import Topology
from .stencil import check_grid_ported


@dataclasses.dataclass(frozen=True)
class GridScene:
    """A grid scene's kernel inputs that stay fixed from frame to frame."""

    device: torch.device
    ny: int
    nx: int
    inv_mass: torch.Tensor   # [ny, nx]
    plane: torch.Tensor      # [1, 4] height, surface (conveyor) velocity
    spheres: torch.Tensor    # [S, 7] center, radius, kinematic velocity
    plane_on: int
    n_spheres: int           # 0 when spheres are off
    plane_fric: int          # position-level friction (Verlet, XPBD) is on
    sphere_fric: int


def pack_plane(top: Topology) -> torch.Tensor:
    """[1, 4] row: plane height, plane surface (conveyor) velocity."""
    return torch.cat([top.plane_height.reshape(1),
                      top.plane_velocity.reshape(3)]).reshape(1, 4).contiguous()


def pack_spheres(top: Topology) -> torch.Tensor:
    """[S, 7] rows: center (3), radius, kinematic velocity (3)."""
    return torch.cat([top.sphere_centers, top.sphere_radii[:, None],
                      top.sphere_velocities], dim=1).contiguous()


# ctypes argument types of the wind in each grid library's substep (or XPBD
# predict) launch: wind_on, wind velocity xyz, drag, lift
WIND_ARGTYPES = [ctypes.c_int, *[ctypes.c_float] * 5]


def wind_args(cfg: SimConfig) -> tuple:
    """The wind arguments of a launch (:data:`WIND_ARGTYPES`); wind_on is 0
    without wind, which runs the launch's instantiation without it."""
    w = cfg.wind
    return (int(w.enabled), *w.velocity, w.drag, w.lift)


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


def check_launch(err: int, what: str, error_string) -> None:
    """Raise on a nonzero ``cudaError_t`` from a launch, with its string."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err} "
                           f"({error_string(err).decode()})")


def pack_grid_scene(top: Topology, cfg: SimConfig, solver: Solver,
                    kernel: str) -> GridScene:
    """Check that ``kernel``, which runs ``solver``, can run ``(top, cfg)``
    on the card, and pack the scene's fixed inputs there."""
    check_grid_ported(cfg)
    if cfg.solver != solver:
        raise ValueError(f"{kernel} runs the {solver.value} solver, not "
                         f"{cfg.solver.value}")
    if top.grid_shape is None or top.grid_spacing is None:
        raise ValueError("make_cuda_step needs a structured grid topology")
    device = top.device
    if device.type != "cuda":
        raise ValueError(f"make_cuda_step needs a topology on a CUDA device, "
                         f"not {device}")
    ny, nx = top.grid_shape
    inv_mass = top.inv_mass.reshape(ny, nx)
    plane = pack_plane(top)
    spheres = pack_spheres(top)
    for name, t, shape in (("inv_mass", inv_mass, (ny, nx)),
                           ("plane", plane, (1, 4)),
                           ("spheres", spheres, (top.n_spheres, 7))):
        check_input(name, t, shape, device)
    col = cfg.collision
    n_spheres = top.n_spheres if col.enable_spheres else 0
    return GridScene(
        device=device, ny=ny, nx=nx, inv_mass=inv_mass, plane=plane,
        spheres=spheres, plane_on=int(col.enable_plane), n_spheres=n_spheres,
        plane_fric=int(col.enable_plane and col.friction != 0.0),
        sphere_fric=int(n_spheres > 0 and col.friction != 0.0))
