"""Stencil (shift-based) Euler path for structured grid cloth, in plain PyTorch.

This is the plain version of the hand-written fused Euler substep kernel
(``csrc/grid_euler.cu``, wrapped by :mod:`.grid_euler`): the CPU runs it, and
``chip_smoke.py`` holds the kernel to it on the card.  It ports the Euler
branch of ``softbodyunity_tpu/kernels/stencil.py``, the XLA twin of the TPU
kernel, with the same operations in the same order.

A cloth grid has regular topology: every spring class is a constant offset
``(di, dj)`` on the grid —

  structural: (0,1), (1,0)        shear: (1,1), (1,-1)      bend: (0,2), (2,0)

— so spring-force accumulation is six shifted-window subtractions on dense
``[3, ny, nx]`` component planes.  Vertex (i, j) owns the edge to
(i+di, j+dj); the equal and opposite reaction is the force plane shifted back
by ``-(di, dj)``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import SimConfig, Solver
from ..core.state import State
from ..core.topology import EDGE_BEND, EDGE_SHEAR, Topology

# Config branches of the fused Euler grid kernel that the port does not run
# yet, each with the ROADMAP item that ports it.  Both the kernel and this
# plain version refuse them, so a scene never silently loses a feature.
_UNPORTED = (
    ("wind", lambda c: c.wind.enabled, "Queue 1 item 6, Queue 2 item 1"),
    ("strain limit", lambda c: c.strain_limit.enabled,
     "Queue 1 item 6, Queue 2 item 1"),
    ("capsule colliders", lambda c: c.collision.enable_capsules,
     "Queue 1 item 2, Queue 2 item 1"),
    ("box colliders", lambda c: c.collision.enable_boxes,
     "Queue 1 item 2, Queue 2 item 1"),
    ("SDF colliders", lambda c: c.collision.enable_sdf, "Queue 1 item 6"),
    ("tearing", lambda c: c.tear.enabled, "Queue 1 item 6, Queue 2 item 1"),
    ("plasticity", lambda c: c.plasticity.enabled,
     "Queue 1 item 6, Queue 2 item 1"),
    ("self-collision", lambda c: c.self_collision.enabled, "Queue 1 item 5"),
    ("pressure", lambda c: c.pressure.enabled, "Queue 1 item 6"),
    ("shape matching", lambda c: c.shape_match.enabled, "Queue 1 item 7"),
    ("motion constraints", lambda c: c.motion.enabled, "Queue 1 item 6"),
)


def check_ported(cfg: SimConfig) -> None:
    """Raise ``NotImplementedError`` naming every enabled branch of ``cfg``
    that the port does not run yet, and its ROADMAP item."""
    missing = [f"{name} (ROADMAP {item})" for name, on, item in _UNPORTED
               if on(cfg)]
    if cfg.solver != Solver.SEMI_IMPLICIT_EULER:
        missing.append(f"the {cfg.solver.value} solver "
                       "(ROADMAP Queue 1 item 4, Queue 2 items 2-3)")
    if missing:
        raise NotImplementedError(
            "not ported to softbodyunity_torch yet: " + ", ".join(missing))


def _shift(a: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """out[..., i, j] = a[..., i+di, j+dj], zero outside."""
    ny, nx = a.shape[-2], a.shape[-1]
    out = torch.zeros_like(a)
    r0, r1 = max(0, -di), ny - max(0, di)
    c0, c1 = max(0, -dj), nx - max(0, dj)
    if r1 > r0 and c1 > c0:
        out[..., r0:r1, c0:c1] = a[..., r0 + di:r1 + di, c0 + dj:c1 + dj]
    return out


def _valid_mask(ny: int, nx: int, di: int, dj: int, device,
                dtype) -> torch.Tensor:
    """Mask of vertices whose (i+di, j+dj) neighbour exists, built on
    ``device`` (no host-to-device copy)."""
    return _shift(torch.ones((ny, nx), dtype=dtype, device=device), di, dj)


def _offsets(cfg: SimConfig, spacing: float, has_shear: bool, has_bend: bool):
    """(di, dj, stiffness, rest_length) per spring class present."""
    s = cfg.springs
    offs = [
        (0, 1, s.k_structural, spacing),
        (1, 0, s.k_structural, spacing),
    ]
    if has_shear:
        r2 = spacing * float(np.sqrt(2.0))
        offs += [(1, 1, s.k_shear, r2), (1, -1, s.k_shear, r2)]
    if has_bend:
        offs += [(0, 2, s.k_bend, 2 * spacing), (2, 0, s.k_bend, 2 * spacing)]
    return offs


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Component-plane dot product, summed in the order 0, 1, 2."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def stencil_spring_forces(
    x3: torch.Tensor,     # [3, ny, nx]
    v3: torch.Tensor,     # [3, ny, nx]
    offsets,              # from _offsets
    masks,                # per offset, [ny, nx] from _valid_mask
    damping: float,
) -> torch.Tensor:
    """Hooke + axial damper over all spring classes, stencil-accumulated.

    For each offset o every vertex (i, j) owns the edge to (i, j) + o; the
    reaction is applied by shifting the force plane back by -o.  The norm is
    sqrt, then a multiply by ``1 / max(len, 1e-12)``, the op order of the
    JAX twin (``solver/forces.py::length_dir_planes_mul``)."""
    f_total = torch.zeros_like(x3)
    for (di, dj, k, rest), mask in zip(offsets, masks):
        xn = _shift(x3, di, dj)
        vn = _shift(v3, di, dj)
        d = xn - x3
        length = torch.sqrt(_dot(d, d))
        inv_len = 1.0 / torch.clamp_min(length, 1e-12)
        n = d * inv_len
        rel_v = _dot(vn - v3, n)
        fmag = (k * (length - rest) + damping * rel_v) * mask
        f = fmag * n                       # force on (i,j), toward neighbour
        f_total = f_total + f - _shift(f, -di, -dj)
    return f_total


def euler_substep_grid(x3, v3, inv_mass2, offsets, masks, gravity,
                       cfg: SimConfig, dt: float, top: Topology):
    """One semi-implicit Euler substep on grid planes (oracle
    ``substep_euler`` semantics): springs, gravity and global damping,
    pinning, then plane and sphere contact relative to the colliders'
    kinematic velocities.  ``gravity`` is ``[3, 1, 1]`` on the planes'
    device.  Returns ``(x3, v3)``."""
    movable = inv_mass2 > 0.0
    f = stencil_spring_forces(x3, v3, offsets, masks, cfg.springs.damping)
    v3 = (v3 + dt * (gravity + f * inv_mass2)) * (1.0 - cfg.global_damping * dt)
    v3 = torch.where(movable, v3, 0.0)
    x3 = x3 + dt * v3

    col = cfg.collision
    if col.enable_plane:
        # plane surface (conveyor) velocity: response relative to wp
        wp = top.plane_velocity
        ph = top.plane_height
        contact = (x3[1] < ph) & movable[0]
        x3 = torch.stack([x3[0], torch.where(contact, ph, x3[1]), x3[2]])
        vy = v3[1]
        uy = vy - wp[1]
        vy = torch.where(
            contact, torch.where(uy < 0.0, wp[1] - col.restitution * uy, vy), vy)
        fr = 1.0 - col.friction
        v3 = torch.stack([
            torch.where(contact, wp[0] + (v3[0] - wp[0]) * fr, v3[0]), vy,
            torch.where(contact, wp[2] + (v3[2] - wp[2]) * fr, v3[2]),
        ])
    if col.enable_spheres:
        for s in range(top.n_spheres):
            c = top.sphere_centers[s].reshape(3, 1, 1)
            w = top.sphere_velocities[s].reshape(3, 1, 1)
            d = x3 - c
            dist = torch.sqrt(_dot(d, d))
            pen = top.sphere_radii[s] - dist
            contact = (pen > 0.0) & movable[0]
            n = d / torch.clamp_min(dist, 1e-12)
            x3 = x3 + torch.where(contact, pen, 0.0) * n
            un = _dot(v3 - w, n)
            inward = contact & (un < 0.0)
            v3 = v3 - torch.where(inward, (1.0 + col.restitution) * un, 0.0) * n
            u2 = v3 - w
            un2 = _dot(u2, n) * n
            ut = u2 - un2
            v3 = torch.where(contact, w + un2 + ut * (1.0 - col.friction), v3)
    return x3, v3


def to_planes(a: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
    """[N, 3] -> [3, ny, nx]."""
    return a.t().reshape(3, ny, nx)


def from_planes(a: torch.Tensor) -> torch.Tensor:
    """[3, ny, nx] -> contiguous [N, 3]."""
    return a.reshape(3, -1).t().contiguous()


def make_stencil_step(top: Topology, cfg: SimConfig):
    """Build ``fn(state, dt, n_substeps) -> state`` for a grid-cloth Euler
    scene, in plain PyTorch on whatever device ``top`` lives on."""
    check_ported(cfg)
    ny, nx = top.grid_shape
    offsets = _offsets(cfg, top.grid_spacing,
                       EDGE_SHEAR in top.edge_classes_present,
                       EDGE_BEND in top.edge_classes_present)
    masks = [_valid_mask(ny, nx, di, dj, top.device, top.dtype)
             for di, dj, _, _ in offsets]
    gravity = torch.tensor(cfg.gravity, dtype=top.dtype,
                           device=top.device).reshape(3, 1, 1)
    inv_mass2 = top.inv_mass.reshape(1, ny, nx)

    def fn(state: State, dt: float, n_substeps: int) -> State:
        x3 = to_planes(state.x, ny, nx)
        v3 = to_planes(state.v, ny, nx)
        for _ in range(n_substeps):
            x3, v3 = euler_substep_grid(x3, v3, inv_mass2, offsets, masks,
                                        gravity, cfg, dt, top)
        # the Euler solver never reads x_prev; rebuild the natural value
        # (position before the final integrate) as the JAX fast paths do
        xp3 = x3 - dt * v3
        return State(x=from_planes(x3), v=from_planes(v3),
                     x_prev=from_planes(xp3))

    return fn
