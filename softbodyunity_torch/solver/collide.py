"""Plane and sphere contact on flat ``[N, 3]`` positions: the plain versions.

Counterpart of ``softbodyunity_tpu/solver/collide.py`` for the plane and
the spheres, with the kinematic collider velocities: the velocity-level
resolve of the Euler solver and the position-level chain of the Verlet and
XPBD solvers (pre-clamp contact record, projection, plane and sphere
friction, and the XPBD delta forms).  The tet-lattice paths run these
(:mod:`softbodyunity_torch.solver.step`); their CUDA kernels compute the
same per vertex.  Capsule, box and SDF colliders are refused by
:func:`softbodyunity_torch.kernels.stencil.check_ported` before any of
this runs.  ``tests/test_torch_lattice.py`` holds the chain to the JAX
package's.
"""

from __future__ import annotations

import torch

# Sphere-contact shell for position-level friction (oracle
# SPHERE_CONTACT_SHELL): projected vertices sit within ulps of the surface,
# so exact dist == r is a knife edge.
SPHERE_CONTACT_SHELL = 1.0 + 1e-5


def _rowdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot product of [N, 3] arrays, summed in the order 0, 1, 2."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _sphere_normal(x, center):
    """(distance to the center, unit direction away from it)."""
    d = x - center
    dist = torch.sqrt(_rowdot(d, d))
    return dist, d / torch.clamp_min(dist, 1e-12)[:, None]


def _set_col(x: torch.Tensor, ax: int, col: torch.Tensor) -> torch.Tensor:
    cols = [x[:, 0], x[:, 1], x[:, 2]]
    cols[ax] = col
    return torch.stack(cols, dim=1)


def resolve_plane(x, v, plane_y, restitution, friction, movable, w):
    """Clamp onto the plane and respond relative to its surface velocity
    ``w``: bounce the normal part by ``restitution``, damp the tangential
    part by ``1 - friction``."""
    contact = (x[:, 1] < plane_y) & movable
    x = _set_col(x, 1, torch.where(contact, plane_y, x[:, 1]))
    vy = v[:, 1]
    uy = vy - w[1]
    vy_new = torch.where(
        contact, torch.where(uy < 0.0, w[1] - restitution * uy, vy), vy)
    vx = torch.where(
        contact, w[0] + (v[:, 0] - w[0]) * (1.0 - friction), v[:, 0])
    vz = torch.where(
        contact, w[2] + (v[:, 2] - w[2]) * (1.0 - friction), v[:, 2])
    return x, torch.stack([vx, vy_new, vz], dim=1)


def _resolve_one_sphere(x, v, center, radius, restitution, friction,
                        movable, w):
    dist, n = _sphere_normal(x, center)
    pen = radius - dist
    contact = (pen > 0.0) & movable
    x = x + torch.where(contact, pen, 0.0)[:, None] * n
    un = _rowdot(v - w[None, :], n)
    inward = contact & (un < 0.0)
    v = v - torch.where(inward, (1.0 + restitution) * un, 0.0)[:, None] * n
    u2 = v - w[None, :]
    un2 = _rowdot(u2, n)[:, None] * n
    ut = u2 - un2
    return x, torch.where(contact[:, None],
                          w[None, :] + un2 + ut * (1.0 - friction), v)


def resolve_velocity_level(top, cfg, x, v, movable):
    """Euler-path resolve: position projection and velocity response, plane
    first, then the spheres in order."""
    col = cfg.collision
    if col.enable_plane:
        x, v = resolve_plane(x, v, top.plane_height, col.restitution,
                             col.friction, movable, top.plane_velocity)
    if col.enable_spheres:
        for s in range(top.n_spheres):
            x, v = _resolve_one_sphere(
                x, v, top.sphere_centers[s], top.sphere_radii[s],
                col.restitution, col.friction, movable,
                top.sphere_velocities[s])
    return x, v


def _push_out_spheres(top, x, movable):
    """Move each movable vertex inside a sphere out to its surface, sphere
    by sphere."""
    for s in range(top.n_spheres):
        dist, n = _sphere_normal(x, top.sphere_centers[s])
        pen = top.sphere_radii[s] - dist
        contact = (pen > 0.0) & movable
        x = x + torch.where(contact, pen, 0.0)[:, None] * n
    return x


def project_positions_only(top, cfg, x, movable):
    """Verlet/XPBD-path resolve: positions only (velocity is implicit)."""
    if cfg.collision.enable_plane:
        contact = (x[:, 1] < top.plane_height) & movable
        x = _set_col(x, 1, torch.where(contact, top.plane_height, x[:, 1]))
    if cfg.collision.enable_spheres and top.n_spheres > 0:
        x = _push_out_spheres(top, x, movable)
    return x


def project_positions_delta(top, cfg, x_prev, delta, movable):
    """Delta form of :func:`project_positions_only` for the XPBD
    accumulation: the plane clamp as ``plane_y - x_prev`` (no rounding
    crumb), the spheres as the push-out displacement at the evaluation
    point.  Returns ``(delta, plane_contact)``, the plane's pre-clamp mask."""
    plane_contact = torch.zeros_like(movable)
    if cfg.collision.enable_plane:
        plane_contact = (x_prev[:, 1] + delta[:, 1] < top.plane_height) & movable
        delta = _set_col(delta, 1, torch.where(
            plane_contact, top.plane_height - x_prev[:, 1], delta[:, 1]))
    if cfg.collision.enable_spheres and top.n_spheres > 0:
        xe = x_prev + delta
        delta = delta + (_push_out_spheres(top, xe, movable) - xe)
    return delta, plane_contact


def plane_contact_preclamp(top, cfg, x, movable):
    """Pre-clamp plane penetration mask of the substep's final projection,
    the set the plane friction acts on."""
    if not cfg.collision.enable_plane:
        return torch.zeros_like(movable)
    return (x[:, 1] < top.plane_height) & movable


def plane_friction_positions(top, cfg, x, x_start, dt, contact):
    """Plane friction of the position-projection solvers: where ``contact``
    is set, damp the substep's tangential displacement relative to the
    plane's surface velocity by ``1 - friction``.  Once per substep."""
    mu = cfg.collision.friction
    if not cfg.collision.enable_plane or mu == 0.0:
        return x
    cols = [x[:, 0], x[:, 1], x[:, 2]]
    for ax in (0, 2):
        target = x_start[:, ax] + top.plane_velocity[ax] * dt
        cols[ax] = torch.where(
            contact, target + (x[:, ax] - target) * (1.0 - mu), x[:, ax])
    return torch.stack(cols, dim=1)


def plane_friction_delta(top, cfg, delta, dt, contact):
    """Delta form of :func:`plane_friction_positions`: the substep's
    displacement is ``delta``, so its damped tangential part is
    ``w dt + (1 - mu)(delta - w dt)``."""
    mu = cfg.collision.friction
    if not cfg.collision.enable_plane or mu == 0.0:
        return delta
    for ax in (0, 2):
        wdt = top.plane_velocity[ax] * dt
        delta = _set_col(delta, ax, torch.where(
            contact, wdt + (delta[:, ax] - wdt) * (1.0 - mu), delta[:, ax]))
    return delta


def sphere_friction_positions(top, cfg, x, x_start, dt, movable):
    """Substep-end sphere friction of the position-projection solvers:
    vertices ending the substep within ``radius * SPHERE_CONTACT_SHELL`` of
    a sphere have the tangential part of their substep displacement,
    relative to the sphere's velocity, damped by ``1 - friction``; sphere by
    sphere, once per substep, after the plane friction."""
    mu = cfg.collision.friction
    if not cfg.collision.enable_spheres or mu == 0.0 or top.n_spheres == 0:
        return x
    for s in range(top.n_spheres):
        dist, n = _sphere_normal(x, top.sphere_centers[s])
        contact = (dist <= top.sphere_radii[s] * SPHERE_CONTACT_SHELL) & movable
        rel = (x - x_start) - top.sphere_velocities[s][None, :] * dt
        rel_t = rel - _rowdot(rel, n)[:, None] * n
        x = torch.where(contact[:, None], x - mu * rel_t, x)
    return x
