"""Wrapper of the hand-written fused Euler grid substep, ``csrc/grid_euler.cu``.

Counterpart of ``softbodyunity_tpu/kernels/pallas_substep.py::make_pallas_step``
and its ``_pack_plane``/``_pack_spheres``.  The plain PyTorch version is
:func:`.stencil.make_stencil_step`; :mod:`.dispatch` takes it for tensors on
the CPU and this wrapper for tensors on a CUDA device, where it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.config import SimConfig
from ..core.state import State
from ..core.topology import EDGE_BEND, EDGE_SHEAR, Topology
from .stencil import _offsets, check_ported, from_planes, to_planes

_launches = 0


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


@functools.cache
def _launcher():
    from .build import load_library

    lib = load_library("grid_euler")
    fn = lib.grid_euler_substep
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [
        p, p, p, p,            # x, v, x_out, v_out
        p, p, i,               # inv_mass, offsets, n_off
        p, i, p, i,            # plane, plane_on, spheres, n_spheres
        i, i,                  # ny, nx
        f, f, f, f, f,         # dt, damping, gx, gy, gz
        f, f, f, f,            # decay, restitution, restitution1, keep
        p,                     # stream
    ]
    fn.restype = ctypes.c_int
    lib.grid_euler_error_string.argtypes = [ctypes.c_int]
    lib.grid_euler_error_string.restype = ctypes.c_char_p
    return fn, lib.grid_euler_error_string


def _pack_plane(top: Topology) -> torch.Tensor:
    """[1, 4] row: plane height, plane surface (conveyor) velocity."""
    return torch.cat([top.plane_height.reshape(1),
                      top.plane_velocity.reshape(3)]).reshape(1, 4).contiguous()


def _pack_spheres(top: Topology) -> torch.Tensor:
    """[S, 7] rows: center (3), radius, kinematic velocity (3)."""
    return torch.cat([top.sphere_centers, top.sphere_radii[:, None],
                      top.sphere_velocities], dim=1).contiguous()


def _check_input(name: str, t: torch.Tensor, shape, device) -> None:
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


def make_cuda_step(top: Topology, cfg: SimConfig):
    """Build ``fn(state, dt, n_substeps) -> state`` that runs each substep as
    one launch of the fused Euler grid kernel.

    The collider geometry and the offset table (di, dj, k, rest) are packed
    once, here, into float32 rows on the device; the kernel reads them from
    device memory, so a frame makes no host round trip."""
    check_ported(cfg)
    if top.grid_shape is None or top.grid_spacing is None:
        raise ValueError("make_cuda_step needs a structured grid topology")
    device = top.device
    if device.type != "cuda":
        raise ValueError(f"make_cuda_step needs a topology on a CUDA device, "
                         f"not {device}")
    ny, nx = top.grid_shape
    n = ny * nx
    offsets = _offsets(cfg, top.grid_spacing,
                       EDGE_SHEAR in top.edge_classes_present,
                       EDGE_BEND in top.edge_classes_present)
    table = torch.tensor(offsets, dtype=torch.float32, device=device)
    inv_mass = top.inv_mass.reshape(ny, nx)
    plane = _pack_plane(top)
    spheres = _pack_spheres(top)
    for name, t, shape in (("inv_mass", inv_mass, (ny, nx)),
                           ("plane", plane, (1, 4)),
                           ("spheres", spheres, (top.n_spheres, 7))):
        _check_input(name, t, shape, device)
    col = cfg.collision
    n_spheres = top.n_spheres if col.enable_spheres else 0
    gx, gy, gz = cfg.gravity
    launch, error_string = _launcher()

    def fn(state: State, dt: float, n_substeps: int) -> State:
        global _launches
        _check_input("state.x", state.x, (n, 3), device)
        _check_input("state.v", state.v, (n, 3), device)
        dt = float(dt)
        scalars = (dt, cfg.springs.damping, gx, gy, gz,
                   1.0 - cfg.global_damping * dt, col.restitution,
                   1.0 + col.restitution, 1.0 - col.friction)
        xa = torch.empty((3, ny, nx), dtype=torch.float32, device=device)
        va = torch.empty_like(xa)
        xb = torch.empty_like(xa)
        vb = torch.empty_like(xa)
        xa.copy_(to_planes(state.x, ny, nx))
        va.copy_(to_planes(state.v, ny, nx))
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            for _ in range(n_substeps):
                err = launch(
                    xa.data_ptr(), va.data_ptr(), xb.data_ptr(), vb.data_ptr(),
                    inv_mass.data_ptr(), table.data_ptr(), len(offsets),
                    plane.data_ptr(), int(col.enable_plane),
                    spheres.data_ptr(), n_spheres, ny, nx, *scalars, stream)
                if err != 0:
                    raise RuntimeError(
                        f"grid_euler launch failed: cudaError {err} "
                        f"({error_string(err).decode()})")
                _launches += 1
                xa, xb, va, vb = xb, xa, vb, va
        x = from_planes(xa)
        v = from_planes(va)
        return State(x=x, v=v, x_prev=x - dt * v)

    return fn
