"""Plane, sphere, capsule and box contact: the plain versions.

Counterpart of ``softbodyunity_tpu/solver/collide.py`` for the plane, the
spheres, the capsules and the oriented boxes, with the kinematic collider
velocities: the velocity-level resolve of the Euler solver and the
position-level chain of the Verlet and XPBD solvers (pre-clamp contact
record, projection, plane, sphere and capsule/box friction, and the XPBD
delta forms).  The tet-lattice paths run these on flat ``[N, 3]`` positions
(:mod:`softbodyunity_torch.solver.step`); the grid paths
(:mod:`softbodyunity_torch.kernels.stencil`) run the capsule/box stages on
``[3, ny, nx]`` planes through the same component-list primitives, as the
JAX package writes them once for all of its paths; the CUDA kernels compute
the same per vertex (``kernels/csrc/grid_common.cuh``).  SDF colliders are
refused by :func:`softbodyunity_torch.kernels.stencil.check_ported` before
any of this runs.  ``tests/test_torch_lattice.py`` and
``tests/test_torch_colliders.py`` hold the chain to the JAX package's.
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
    first, then the spheres, the capsules and the boxes in order."""
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
    if needs_capsule_box(top, cfg):
        xz, vz = resolve_capsules_boxes_components(
            top, cfg, _cols(x), _cols(v), movable)
        x, v = torch.stack(xz, dim=1), torch.stack(vz, dim=1)
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
    if needs_capsule_box(top, cfg):
        x = torch.stack(project_capsules_boxes_components(
            top, cfg, _cols(x), movable), dim=1)
    return x


def project_positions_delta(top, cfg, x_prev, delta, movable):
    """Delta form of :func:`project_positions_only` for the XPBD
    accumulation: the plane clamp as ``plane_y - x_prev`` (no rounding
    crumb), the spheres, then the capsules and boxes, each stage as its
    push-out displacement at the evaluation point.  Returns ``(delta, plane_contact)``, the plane's pre-clamp mask."""
    plane_contact = torch.zeros_like(movable)
    if cfg.collision.enable_plane:
        plane_contact = (x_prev[:, 1] + delta[:, 1] < top.plane_height) & movable
        delta = _set_col(delta, 1, torch.where(
            plane_contact, top.plane_height - x_prev[:, 1], delta[:, 1]))
    if cfg.collision.enable_spheres and top.n_spheres > 0:
        xe = x_prev + delta
        delta = delta + (_push_out_spheres(top, xe, movable) - xe)
    if needs_capsule_box(top, cfg):
        xe = x_prev + delta
        delta = delta + (torch.stack(project_capsules_boxes_components(
            top, cfg, _cols(xe), movable), dim=1) - xe)
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


# --- capsules and oriented boxes: component-list primitives -----------------
#
# ``xz`` is a list of three same-shaped component tensors (the columns of
# ``[N, 3]`` positions or the planes of ``[3, ny, nx]`` ones); collider
# scalars are 0-d tensors of the topology.  The operations and their order
# are those of the JAX package's primitives (``softbodyunity_tpu/solver/
# collide.py:30-285`` and ``:488-615``), so both round alike.

# box contact shell for the position-level friction, relative to the largest
# half extent (oracle BOX_CONTACT_SHELL)
BOX_CONTACT_SHELL = 1e-5


def _cols(x: torch.Tensor):
    return [x[:, 0], x[:, 1], x[:, 2]]


def _capsule_closest_components(xz, p0, p1):
    """The closest point on the segment p0 -> p1, per element: ``t = (x -
    p0) . ax / max(|ax|^2, 1e-12)`` clipped to [0, 1]."""
    ax = [p1[c] - p0[c] for c in range(3)]
    l2 = ax[0] * ax[0] + ax[1] * ax[1] + ax[2] * ax[2]
    dp = [xz[c] - p0[c] for c in range(3)]
    t = ((dp[0] * ax[0] + dp[1] * ax[1] + dp[2] * ax[2])
         / torch.clamp_min(l2, 1e-12))
    t = torch.clamp(t, 0.0, 1.0)
    return [p0[c] + t * ax[c] for c in range(3)]


def _radial_pen_normal(xz, center, radius):
    """(penetration, outward unit normal) of the sphere of ``radius`` about
    ``center``: ``n = d * (1 / max(|d|, 1e-12))``."""
    d = [xz[c] - center[c] for c in range(3)]
    dist = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    inv = 1.0 / torch.clamp_min(dist, 1e-12)
    return radius - dist, [d[c] * inv for c in range(3)]


def capsule_project_components(xz, movable, p0, p1, radius):
    """Position-only capsule push-out of the movable elements."""
    pen, n = _radial_pen_normal(xz, _capsule_closest_components(xz, p0, p1),
                                radius)
    pen_pos = torch.where((pen > 0.0) & movable, pen, 0.0)
    return [xz[c] + pen_pos * n[c] for c in range(3)]


def _normal_velocity_response(xz, vz, contact, pen, n, restitution,
                              friction, w):
    """Push out by ``pen`` along ``n``, reflect the inward normal velocity
    relative to the collider's velocity ``w`` by ``1 + restitution``, then
    damp the relative tangential velocity by ``1 - friction``."""
    pen_pos = torch.where(contact, pen, 0.0)
    xz = [xz[c] + pen_pos * n[c] for c in range(3)]
    uz = [vz[c] - w[c] for c in range(3)]
    un = uz[0] * n[0] + uz[1] * n[1] + uz[2] * n[2]
    inward = contact & (un < 0.0)
    rem = torch.where(inward, (1.0 + restitution) * un, 0.0)
    vz = [vz[c] - rem * n[c] for c in range(3)]
    uz = [vz[c] - w[c] for c in range(3)]
    un2 = uz[0] * n[0] + uz[1] * n[1] + uz[2] * n[2]
    fr = 1.0 - friction
    vz = [torch.where(contact, w[c] + un2 * n[c] + (uz[c] - un2 * n[c]) * fr,
                      vz[c]) for c in range(3)]
    return xz, vz


def capsule_resolve_components(xz, vz, movable, p0, p1, radius, restitution,
                               friction, w):
    """Velocity-level capsule resolve; ``w`` is the capsule's velocity."""
    pen, n = _radial_pen_normal(xz, _capsule_closest_components(xz, p0, p1),
                                radius)
    return _normal_velocity_response(xz, vz, (pen > 0.0) & movable, pen, n,
                                     restitution, friction, w)


def _box_local(xz, center, half, rot):
    """(q, pen): the local coordinates ``q_i = sum_c d_c R[c, i]`` of
    ``d = x - center`` and the per-axis penetrations ``half_i - |q_i|``."""
    d = [xz[c] - center[c] for c in range(3)]
    q = [d[0] * rot[0][i] + d[1] * rot[1][i] + d[2] * rot[2][i]
         for i in range(3)]
    return q, [half[i] - torch.abs(q[i]) for i in range(3)]


def box_face_push_components(xz, center, half, rot):
    """(inside, push, n) of an oriented box: inside where every ``pen_i >
    0``; the exit face is the axis of least penetration, ties broken x < y
    < z; ``n`` is that axis (column k of R) on the side of ``q_k >= 0``."""
    q, pen = _box_local(xz, center, half, rot)
    inside = (pen[0] > 0.0) & (pen[1] > 0.0) & (pen[2] > 0.0)
    k0 = (pen[0] <= pen[1]) & (pen[0] <= pen[2])
    k1 = (~k0) & (pen[1] <= pen[2])
    k = [k0, k1, ~(k0 | k1)]
    sgn = [torch.where(q[i] >= 0.0, 1.0, -1.0).to(q[i].dtype)
           for i in range(3)]
    n = [sum(torch.where(k[i], sgn[i], 0.0) * rot[c][i] for i in range(3))
         for c in range(3)]
    push = sum(torch.where(k[i], pen[i], 0.0) for i in range(3))
    return inside, push, n


def box_project_components(xz, movable, center, half, rot):
    """Position-only box push-out of the movable elements."""
    inside, push, n = box_face_push_components(xz, center, half, rot)
    pen_pos = torch.where(inside & movable, push, 0.0)
    return [xz[c] + pen_pos * n[c] for c in range(3)]


def box_resolve_components(xz, vz, movable, center, half, rot, restitution,
                           friction, w):
    """Velocity-level box resolve; ``w`` is the box's velocity."""
    inside, push, n = box_face_push_components(xz, center, half, rot)
    return _normal_velocity_response(xz, vz, inside & movable, push, n,
                                     restitution, friction, w)


def _capsule_scalars(top, s: int):
    return ([top.capsule_p0[s, c] for c in range(3)],
            [top.capsule_p1[s, c] for c in range(3)], top.capsule_radii[s])


def _box_scalars(top, s: int):
    return ([top.box_centers[s, c] for c in range(3)],
            [top.box_half_extents[s, c] for c in range(3)],
            [[top.box_rotations[s, c, i] for i in range(3)]
             for c in range(3)])


def _velocity(rows, s: int):
    return [rows[s, c] for c in range(3)]


def needs_capsule_box(top, cfg) -> bool:
    """Whether a capsule or box collider is enabled and present."""
    col = cfg.collision
    return ((col.enable_capsules and top.n_capsules > 0)
            or (col.enable_boxes and top.n_boxes > 0))


def _capsule_ids(top, cfg):
    return range(top.n_capsules if cfg.collision.enable_capsules else 0)


def _box_ids(top, cfg):
    return range(top.n_boxes if cfg.collision.enable_boxes else 0)


def resolve_capsules_boxes_components(top, cfg, xz, vz, movable):
    """Every enabled capsule, then every enabled box, velocity level, each
    reading the previous one's output."""
    r, f = cfg.collision.restitution, cfg.collision.friction
    for s in _capsule_ids(top, cfg):
        xz, vz = capsule_resolve_components(
            xz, vz, movable, *_capsule_scalars(top, s), r, f,
            _velocity(top.capsule_velocities, s))
    for s in _box_ids(top, cfg):
        xz, vz = box_resolve_components(
            xz, vz, movable, *_box_scalars(top, s), r, f,
            _velocity(top.box_velocities, s))
    return xz, vz


def project_capsules_boxes_components(top, cfg, xz, movable):
    """Every enabled capsule, then every enabled box, position only."""
    for s in _capsule_ids(top, cfg):
        xz = capsule_project_components(xz, movable, *_capsule_scalars(top, s))
    for s in _box_ids(top, cfg):
        xz = box_project_components(xz, movable, *_box_scalars(top, s))
    return xz


def _friction_tangent_components(xz, xsz, contact, n, w, mu, dt):
    """Damp the tangential part of the substep's displacement ``x - x_start``
    relative to the collider's velocity ``w`` by ``1 - mu`` where
    ``contact`` is set."""
    rel = [xz[c] - xsz[c] - w[c] * dt for c in range(3)]
    rel_n = rel[0] * n[0] + rel[1] * n[1] + rel[2] * n[2]
    return [torch.where(contact, xz[c] - mu * (rel[c] - rel_n * n[c]), xz[c])
            for c in range(3)]


def capsule_friction_components(xz, xsz, movable, p0, p1, radius, w, mu, dt):
    """Capsule friction within the contact shell ``radius *
    SPHERE_CONTACT_SHELL`` of the closest core point."""
    cpt = _capsule_closest_components(xz, p0, p1)
    d = [xz[c] - cpt[c] for c in range(3)]
    dist = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    inv = 1.0 / torch.clamp_min(dist, 1e-12)
    n = [d[c] * inv for c in range(3)]
    contact = (dist <= radius * SPHERE_CONTACT_SHELL) & movable
    return _friction_tangent_components(xz, xsz, contact, n, w, mu, dt)


def box_friction_components(xz, xsz, movable, center, half, rot, w, mu, dt):
    """Box friction within ``BOX_CONTACT_SHELL * max(half)`` of the nearest
    face, along that face's normal."""
    _, pen = _box_local(xz, center, half, rot)
    mn = torch.minimum(torch.minimum(pen[0], pen[1]), pen[2])
    shell = BOX_CONTACT_SHELL * torch.maximum(torch.maximum(half[0], half[1]),
                                              half[2])
    contact = (mn >= -shell) & (mn <= shell) & movable
    _, _, n = box_face_push_components(xz, center, half, rot)
    return _friction_tangent_components(xz, xsz, contact, n, w, mu, dt)


def rest_friction_components(top, cfg, xz, xsz, movable, dt):
    """Capsule, then box, position-level friction against the substep's
    start ``xsz``; once per substep, after the sphere friction, and only
    when ``friction != 0``."""
    mu = cfg.collision.friction
    if mu == 0.0:
        return xz
    for s in _capsule_ids(top, cfg):
        xz = capsule_friction_components(
            xz, xsz, movable, *_capsule_scalars(top, s),
            _velocity(top.capsule_velocities, s), mu, dt)
    for s in _box_ids(top, cfg):
        xz = box_friction_components(
            xz, xsz, movable, *_box_scalars(top, s),
            _velocity(top.box_velocities, s), mu, dt)
    return xz


def rest_friction_positions(top, cfg, x, x_start, dt, movable):
    """:func:`rest_friction_components` on ``[N, 3]`` positions."""
    if cfg.collision.friction == 0.0 or not needs_capsule_box(top, cfg):
        return x
    return torch.stack(rest_friction_components(
        top, cfg, _cols(x), _cols(x_start), movable, dt), dim=1)
