"""Row-sharded grid cloth over a ring of ranks: one large cloth stepped by
several devices, with halo exchange and exact self-collision.

Counterpart of the grid-cloth part of ``softbodyunity_tpu/parallel/halo.py``
(lines 1-1320), the spatial decomposition of one ``ny x nx`` cloth by rows.
Rank r of the ring (:mod:`.ring`, standing where the JAX mesh's rows axis
stands) holds rows ``[r * h, (r + 1) * h)``, h = ny / P, as ``[3, h, nx]``
planes.  Each substep it exchanges a ``HALO``-row halo with its neighbours,
runs the stencil substep of :mod:`softbodyunity_torch.kernels.stencil` on
its extended block and keeps the interior:

- every spring offset points down or right, so an edge is owned by its
  upper vertex; with two rows of halo above and below, the interior sees
  the neighbours of the edges it owns, and the reactions of the edges that
  the two halo rows above own come back through the ``-offset`` shift;
- whether an edge exists is judged by global row (:func:`_owned_mask_ext`),
  so the zero halos at the cloth's ends never make a spring;
- self-collision pairs are unbounded in row distance (a fold brings far
  rows together), so no halo can carry them: each substep all-gathers the
  cloth's positions and runs the dual block-sparse pair form, the rank's
  rows as i-tiles against the gathered cloth's tiles
  (:func:`_rows_self_collision`).  On a CUDA tensor that is the dual form
  of the hand-written pair kernel (``kernels/csrc/block_pairs.cu``, TPU
  kernel #11); on the CPU its plain version.

The rest of each substep is plain PyTorch, as the JAX halo path is plain
XLA around its one Pallas kernel.  The step functions
(:func:`make_halo_step`, :func:`make_halo_verlet_step`,
:func:`make_halo_xpbd_step`) run on each rank with the rank's planes:

    ring = LocalRing(4)          # or DistRing() in each of 4 processes

    def rank_main():
        x3, v3, im3, ph = shard_grid_state(top, state, ring)
        x3, v3 = fn(x3, v3, im3, ph, cfg.dt, 96)
        return unshard_to_state(x3, v3, cfg.dt, ring)

    fn = make_halo_step(top, cfg, ring)
    states = ring.run(rank_main)

Not ported: SDF colliders and motion tethers (ROADMAP Queue 1 item 6), the
tet lattices' slab halos (``halo.py:1321-2254``, Queue 1 item 11); each
raises ``NotImplementedError`` naming its item.
"""

from __future__ import annotations

import threading

import torch

from ..core.config import SimConfig
from ..core.state import State
from ..core.topology import EDGE_BEND, EDGE_SHEAR, Topology
from ..kernels import stencil as st
from ..kernels.blocks import make_block_pairs_dual
from ..kernels.grid_scene import pack_boxes, pack_capsules
from ..solver.blocksparse import self_collision_forces_block_dual
from ..solver.collide import (SPHERE_CONTACT_SHELL, box_friction_components,
                              box_project_components, box_resolve_components,
                              capsule_friction_components,
                              capsule_project_components,
                              capsule_resolve_components, needs_capsule_box)
from .ring import HALO, ROWS_AXIS, DistRing

def _interior(a: torch.Tensor, h: int) -> torch.Tensor:
    """The rank's own rows of an extended ``[..., h + 2 * HALO, nx]`` block."""
    return a[..., HALO:HALO + h, :]


def _owned_mask_ext(h: int, nx: int, ny_global: int, di: int, dj: int,
                    rank: int, device, dtype) -> torch.Tensor:
    """Validity of the owned edge (di, dj) at each vertex of the rank's
    extended block (its rows with the halos), judged by global row and
    column: 1.0 where both ends lie on the cloth."""
    rows = (torch.arange(h + 2 * HALO, device=device)[:, None] - HALO
            + rank * h)
    cols = torch.arange(nx, device=device)[None, :]
    row_ok = ((rows >= 0) & (rows + di >= 0) & (rows + di <= ny_global - 1)
              & (rows <= ny_global - 1))
    col_ok = (cols + dj >= 0) & (cols + dj <= nx - 1)
    return (row_ok & col_ok).to(dtype)


def _rows_self_collision(cfg: SimConfig, ring, ny: int, nx: int):
    """``forces(x3 [3, h, nx]) -> [3, h, nx]``, the self-collision repulsion
    on the rank's rows from the whole cloth, exact against the global pair
    set (``halo.py:66-94``); None when self-collision is off.  The rows are
    all-gathered over the ring (one ``[3, ny, nx]`` gather a substep; folds
    make the pairs unbounded in row distance), then the dual block form
    runs: on CUDA the pair kernel's dual form, one per rank and device (its
    scratch serves one launch at a time), on the CPU its plain version."""
    p = cfg.self_collision
    if not p.enabled:
        return None
    ni, n = ny // ring.size * nx, ny * nx
    kernels = {}
    lock = threading.Lock()

    def forces(x3: torch.Tensor) -> torch.Tensor:
        xall = ring.gather_rows(x3).reshape(3, -1).t()
        xi = x3.reshape(3, -1).t()
        if x3.device.type == "cuda":
            key = (ring.rank, x3.device)
            with lock:
                if key not in kernels:
                    kernels[key] = make_block_pairs_dual(p, ni, n, x3.device)
            return kernels[key](xi, xall).reshape(x3.shape)
        return self_collision_forces_block_dual(xi, xall, p).t().reshape(
            x3.shape)

    return forces


def _check_halo_colliders(top: Topology, cfg: SimConfig) -> None:
    """What the row-sharded grid paths run, enforced loudly (the cloth-rows
    rules of ``halo.py:293-377``): grid cloth only, self-collision by method
    ``block`` only, and no branch the port does not run yet."""
    if top.grid_shape is None or top.n_tets > 0:
        raise NotImplementedError(
            "the row-sharded halo paths take grid cloth; the tet lattices' "
            "slab halos (softbodyunity_tpu/parallel/halo.py:1321-2254) are "
            "not ported to softbodyunity_torch yet (ROADMAP Queue 1 item 11)")
    sc = cfg.self_collision
    if sc.enabled and sc.method != "block":
        raise NotImplementedError(
            "halo-sharded self-collision runs the block method only "
            f"(got method={sc.method!r})")
    # SDF colliders and motion tethers (Queue 1 item 6), shape matching,
    # pressure
    st.check_ported(cfg)


def _prepare(top: Topology, cfg: SimConfig, ring, xpbd: bool = False):
    """The checks and the static tables of a halo step function:
    ``(ring, ny, nx, offsets)``."""
    _check_halo_colliders(top, cfg)
    ring = DistRing() if ring is None else ring
    ny, nx = top.grid_shape
    if ny % ring.size != 0 or ny // ring.size < HALO:
        raise ValueError(f"ny={ny} must divide over {ring.size} ranks into "
                         f"blocks of at least {HALO} rows")
    has_shear = EDGE_SHEAR in top.edge_classes_present
    has_bend = EDGE_BEND in top.edge_classes_present
    table = st._xpbd_offsets if xpbd else st._offsets
    return ring, ny, nx, table(cfg, top.grid_spacing, has_shear, has_bend)


def _require_inputs(cfg: SimConfig, spheres_on: bool, caps_on: bool,
                    sphere_centers, alive3, scale3, capsules) -> None:
    if cfg.tear.enabled and alive3 is None:
        raise ValueError(
            "cfg enables tearing: pass alive3 (tear_plane_shard_maps)")
    if cfg.plasticity.enabled and scale3 is None:
        raise ValueError(
            "cfg enables plasticity: pass scale3 (tear_plane_shard_maps)")
    if caps_on and capsules is None:
        raise ValueError("cfg enables capsules/boxes: pass capsules/boxes "
                         "(pack_capsule_box_geometry(top))")
    if spheres_on and sphere_centers is None:
        raise ValueError("cfg enables spheres: pass sphere_centers/"
                         "sphere_radii (e.g. top.sphere_centers, "
                         "top.sphere_radii)")


def _rank_tables(x3, offsets, ny: int, ring, cfg: SimConfig):
    """The tensors of one call on one rank: gravity ``[3, 1, 1]`` and the
    owned-edge masks of its extended block."""
    h, nx = x3.shape[-2], x3.shape[-1]
    gravity = torch.tensor(cfg.gravity, dtype=x3.dtype,
                           device=x3.device).reshape(3, 1, 1)
    owned = [_owned_mask_ext(h, nx, ny, off[0], off[1], ring.rank, x3.device,
                             x3.dtype) for off in offsets]
    return gravity, owned


def _exchange(ring, *blocks):
    """``ring.exchange_halo`` of each block (``[C_i, h, nx]`` or None), in
    one collective: the blocks are stacked along their first dimension, so
    a substep's positions, velocities and feature planes travel together."""
    present = [b for b in blocks if b is not None]
    ext = ring.exchange_halo(torch.cat(present) if len(present) > 1
                             else present[0])
    out, i = [], 0
    for b in blocks:
        if b is None:
            out.append(None)
        else:
            out.append(ext[i:i + b.shape[0]])
            i += b.shape[0]
    return out


def _plane_height(plane_height, x3) -> torch.Tensor:
    return torch.as_tensor(plane_height, dtype=x3.dtype,
                           device=x3.device).reshape(())


def _features_out(x3, second, alive, scale):
    return (x3, second) + ((alive,) if alive is not None else ()) + (
        (scale,) if scale is not None else ())


# --- the Euler substep ------------------------------------------------------

def _wind_force_ext(xe, ve, cfg: SimConfig, h: int, ny_global: int, ring):
    """The WindParams force on an extended block; the interior rows are exact
    (lift's one-ring normals stay inside the two-row halo), the triangles
    judged by global row."""
    cell = _owned_mask_ext(h, xe.shape[-1], ny_global, 1, 1, ring.rank,
                           xe.device, xe.dtype)
    return st.wind_forces_grid(xe, ve, cfg.wind, cell_mask=cell)


def _halo_substep(x3, v3, inv_mass2, offsets, cfg: SimConfig, dt: float,
                  plane_height, ny_global: int, ring, gravity, owned,
                  sc_forces=None, spheres=None, alive=None, scale=None,
                  capsules=None, boxes=None, plane_velocity=None, we=None):
    """One semi-implicit Euler substep on the rank's rows (``halo.py:97-159``).
    ``alive`` (tear liveness planes ``[n_off, h, nx]``) takes the owned
    masks' place, ``scale`` (plastic rest scales) rescales the rest lengths.
    Returns ``(x3, v3, alive, scale)``, Nones kept."""
    h = x3.shape[-2]
    xe, ve, ae, se = _exchange(ring, x3, v3, alive, scale)
    f = st.stencil_spring_forces(xe, ve, offsets,
                                 owned if ae is None else ae,
                                 cfg.springs.damping, rest_scale=se)
    if cfg.wind.enabled:
        f = f + _wind_force_ext(xe, ve, cfg, h, ny_global, ring)
    f = _interior(f, h)
    if sc_forces is not None:
        f = f + sc_forces(x3)
    movable = inv_mass2 > 0.0
    v3 = ((v3 + dt * (gravity + f * inv_mass2))
          * (1.0 - cfg.global_damping * dt))
    v3 = torch.where(movable, v3, 0.0)
    x3 = x3 + dt * v3
    if cfg.strain_limit.enabled:
        # before contact, the change fed back into v (oracle substep_euler)
        dxl = _strain_limit_halo(x3, offsets, cfg, inv_mass2, ring, owned,
                                 ae=ae, se=se, we=we)
        x3 = x3 + dxl
        v3 = v3 + dxl / dt
    x3, v3 = _resolve_colliders(x3, v3, movable, cfg, plane_height, spheres,
                                capsules, boxes, plane_velocity)
    if alive is not None or scale is not None:
        alive, scale = _feature_halo_update(x3, alive, scale, offsets, cfg,
                                            ring)
    return x3, v3, alive, scale


def _capsule_rows(capsules):
    """(p0, p1, radius, velocity) of each packed ``[C, 10]`` capsule row, as
    0-dim tensors."""
    for row in capsules if capsules is not None else ():
        yield ([row[c] for c in range(3)], [row[3 + c] for c in range(3)],
               row[6], [row[7 + c] for c in range(3)])


def _box_rows(boxes):
    """(center, half extents, rotation, velocity) of each packed ``[B, 18]``
    box row, as 0-dim tensors."""
    for row in boxes if boxes is not None else ():
        yield ([row[c] for c in range(3)], [row[3 + c] for c in range(3)],
               [[row[6 + 3 * c + i] for i in range(3)] for c in range(3)],
               [row[15 + c] for c in range(3)])


def _resolve_colliders(x3, v3, movable, cfg: SimConfig, plane_height,
                       spheres, capsules=None, boxes=None,
                       plane_velocity=None):
    """Velocity-level contact on plane-layout blocks (``halo.py:162-223``):
    the plane relative to its surface velocity, the spheres ``(centers,
    radii, velocities)``, then each capsule and box of the packed rows (the
    collider geometry is global, so the rows need no sharding)."""
    col = cfg.collision
    if col.enable_plane:
        wp = ([0.0, 0.0, 0.0] if plane_velocity is None
              else [plane_velocity[c] for c in range(3)])
        contact = (x3[1] < plane_height) & movable[0]
        x3 = torch.stack([x3[0], torch.where(contact, plane_height, x3[1]),
                          x3[2]])
        vy = v3[1]
        uy = vy - wp[1]
        vy = torch.where(
            contact,
            torch.where(uy < 0.0, wp[1] - col.restitution * uy, vy), vy)
        fr = 1.0 - col.friction
        v3 = torch.stack([
            torch.where(contact, wp[0] + (v3[0] - wp[0]) * fr, v3[0]), vy,
            torch.where(contact, wp[2] + (v3[2] - wp[2]) * fr, v3[2])])
    if col.enable_spheres and spheres is not None:
        centers, radii, velocities = spheres
        for s in range(radii.shape[0]):
            c = centers[s].reshape(3, 1, 1)
            w = velocities[s].reshape(3, 1, 1)
            d = x3 - c
            dist = torch.sqrt(st._dot(d, d))
            pen = radii[s] - dist
            contact = (pen > 0.0) & movable[0]
            n = d / torch.clamp_min(dist, 1e-12)
            x3 = x3 + torch.where(contact, pen, 0.0) * n
            un = st._dot(v3 - w, n)
            inward = contact & (un < 0.0)
            v3 = v3 - torch.where(inward, (1.0 + col.restitution) * un,
                                  0.0) * n
            u2 = v3 - w
            un2 = st._dot(u2, n) * n
            ut = u2 - un2
            v3 = torch.where(contact, w + un2 + ut * (1.0 - col.friction), v3)
    xz, vz = list(x3), list(v3)
    touched = False
    for p0, p1, radius, w in _capsule_rows(capsules):
        xz, vz = capsule_resolve_components(xz, vz, movable[0], p0, p1,
                                            radius, col.restitution,
                                            col.friction, w)
        touched = True
    for center, half, rot, w in _box_rows(boxes):
        xz, vz = box_resolve_components(xz, vz, movable[0], center, half,
                                        rot, col.restitution, col.friction,
                                        w)
        touched = True
    if touched:
        x3, v3 = torch.stack(xz), torch.stack(vz)
    return x3, v3


def pack_capsule_box_geometry(top: Topology):
    """``(capsules [C, 10], boxes [B, 18])``, the packed rows of
    :mod:`softbodyunity_torch.kernels.grid_scene` (kinematic velocities in
    the tails), for the halo step functions' ``capsules``/``boxes``."""
    return pack_capsules(top), pack_boxes(top)


def _project_capsules_boxes(x3, movable, capsules, boxes):
    """Position-only push-out of each capsule, then each box, of the packed
    rows (the Verlet and XPBD paths)."""
    xz = list(x3)
    touched = False
    for p0, p1, radius, _ in _capsule_rows(capsules):
        xz = capsule_project_components(xz, movable[0], p0, p1, radius)
        touched = True
    for center, half, rot, _ in _box_rows(boxes):
        xz = box_project_components(xz, movable[0], center, half, rot)
        touched = True
    return torch.stack(xz) if touched else x3


def _feature_halo_update(x3_new, alive, scale, offsets, cfg: SimConfig,
                         ring):
    """The end-of-substep tear and plastic updates on the rank's planes
    (``halo.py:381-417``): the new positions are exchanged once, so the
    owners near the block's edge see their neighbours on the next rank; the
    planes get inert halo rows (no exchange: only the interior is kept).
    Plastic flow first, then the tear check against the flowed rest."""
    h = x3_new.shape[-2]
    xne = ring.exchange_halo(x3_new)

    def pad(planes):
        one = torch.ones_like(planes[:, :HALO])
        return torch.cat([one, planes, one], dim=ROWS_AXIS)

    if scale is not None:
        scale = _interior(st.plastic_update_grid(xne, offsets, pad(scale),
                                                 cfg.plasticity), h)
    if alive is not None:
        ok = st.tear_ok_planes(
            xne, offsets, cfg.tear.strain_limit,
            rest_scale=pad(scale) if scale is not None else None)
        alive = torch.stack([alive[o] * _interior(ok[o], h)
                             for o in range(len(offsets))])
    return alive, scale


def _strain_limit_halo(x3, offsets, cfg: SimConfig, inv_mass2, ring, owned,
                       ae=None, se=None, we=None):
    """The strain limit's Jacobi sweeps on the rank's rows
    (``halo.py:419-470``): each sweep exchanges the positions again, so the
    updated rows of the neighbours are the next sweep's halo and any number
    of sweeps stays exact with the two-row halo.  ``ae``/``se`` are the
    exchanged tear and plastic planes (a torn edge limits nothing), ``we``
    the exchanged inverse masses when the caller holds them.  Returns the
    total change on the rank's rows."""
    sl = cfg.strain_limit
    h = x3.shape[-2]
    if we is None:
        we = ring.exchange_halo(inv_mass2)[0]
    masks = owned if ae is None else list(ae)
    inv_cnt = _interior(1.0 / st.jacobi_count(offsets, masks), h)
    x0 = x3
    for _ in range(sl.iterations):
        xe = ring.exchange_halo(x3)
        dx = st.strain_sweep_dx(xe, offsets, masks, we, sl, se)
        x3 = x3 + _interior(dx, h) * inv_cnt
    return x3 - x0


def make_halo_step(top: Topology, cfg: SimConfig, ring=None):
    """The row-sharded semi-implicit Euler step (``halo.py:519-685``):
    ``fn(x3, v3, inv_mass3, plane_height, dt, n_substeps, sphere_centers=,
    sphere_radii=, alive3=, capsules=, boxes=, scale3=, plane_velocity=,
    sphere_velocities=) -> (x3, v3[, alive3][, scale3])`` on each rank's
    ``[3, h, nx]`` planes (``[1, h, nx]`` inverse masses, ``[n_off, h, nx]``
    tear and plastic planes; :func:`shard_grid_state`,
    :func:`tear_plane_shard_maps`), h = ny / P for the P ranks of ``ring``
    (default :class:`~softbodyunity_torch.parallel.ring.DistRing` over the
    default process group).  Collider geometry is global: every rank passes
    all of it (:func:`pack_capsule_box_geometry`)."""
    ring, ny, nx, offsets = _prepare(top, cfg, ring)
    spheres_on = cfg.collision.enable_spheres and top.n_spheres > 0
    caps_on = needs_capsule_box(top, cfg)
    sc_forces = _rows_self_collision(cfg, ring, ny, nx)

    def steps(x3, v3, inv_mass3, plane_height, dt, n_substeps,
              sphere_centers=None, sphere_radii=None, alive3=None,
              capsules=None, boxes=None, scale3=None, plane_velocity=None,
              sphere_velocities=None):
        _require_inputs(cfg, spheres_on, caps_on, sphere_centers, alive3,
                        scale3, capsules)
        gravity, owned = _rank_tables(x3, offsets, ny, ring, cfg)
        spheres = None
        if spheres_on:
            spheres = (sphere_centers, sphere_radii,
                       torch.zeros_like(sphere_centers)
                       if sphere_velocities is None else sphere_velocities)
        caps, bxs = (capsules, boxes) if caps_on else (None, None)
        ph = _plane_height(plane_height, x3)
        # the inverse masses' halo does not change: exchanged once
        we = (ring.exchange_halo(inv_mass3)[0]
              if cfg.strain_limit.enabled else None)
        alive = alive3 if cfg.tear.enabled else None
        scale = scale3 if cfg.plasticity.enabled else None
        for _ in range(n_substeps):
            x3, v3, alive, scale = _halo_substep(
                x3, v3, inv_mass3, offsets, cfg, dt, ph, ny, ring, gravity,
                owned, sc_forces=sc_forces, spheres=spheres, alive=alive,
                scale=scale, capsules=caps, boxes=bxs,
                plane_velocity=plane_velocity, we=we)
        return _features_out(x3, v3, alive, scale)

    return steps


def shard_grid_state(top: Topology, state: State, ring):
    """The ring's rank's ``(x3 [3, h, nx], v3 [3, h, nx], inv_mass3
    [1, h, nx], plane_height [1])`` of ``state`` (``halo.py:688-696``)."""
    ny, nx = top.grid_shape
    rows = _rank_rows(ring, ny)
    x3 = st.to_planes(state.x, ny, nx)[:, rows].contiguous()
    v3 = st.to_planes(state.v, ny, nx)[:, rows].contiguous()
    im3 = top.inv_mass.reshape(1, ny, nx)[:, rows].contiguous()
    return x3, v3, im3, top.plane_height.reshape(1)


def _rank_rows(ring, ny: int) -> slice:
    h = ny // ring.size
    return slice(ring.rank * h, (ring.rank + 1) * h)


def unshard_to_state(x3, v3, dt: float, ring) -> State:
    """The whole cloth's ``State`` from every rank's planes, gathered over
    the ring (``halo.py:699-702``: ``x_prev = x - dt v``)."""
    x = st.from_planes(ring.gather_rows(x3))
    v = st.from_planes(ring.gather_rows(v3))
    return State(x=x, v=v, x_prev=x - dt * v)


def tear_plane_shard_maps(top: Topology, cfg: SimConfig, ring):
    """``(shard, unshard)`` for per-edge values on the halo paths
    (``halo.py:705-723``): ``shard(values [E])`` is the rank's rows of the
    per-offset planes ``[n_off, h, nx]``; ``unshard(planes)`` gathers every
    rank's rows and returns ``[E]``.  It serves tear liveness and plastic
    rest scales alike."""
    ny, nx = top.grid_shape
    has_shear = EDGE_SHEAR in top.edge_classes_present
    has_bend = EDGE_BEND in top.edge_classes_present
    offsets = st._offsets(cfg, top.grid_spacing, has_shear, has_bend)
    edge_to_planes, planes_to_edge, _ = st.tear_plane_maps(top, offsets, ny,
                                                           nx)

    def shard(values: torch.Tensor) -> torch.Tensor:
        return edge_to_planes(values)[:, _rank_rows(ring, ny)].contiguous()

    def unshard(planes: torch.Tensor) -> torch.Tensor:
        return planes_to_edge(ring.gather_rows(planes))

    return shard, unshard


# --- position-level contact (Verlet and XPBD) --------------------------------

def _push_out_spheres(x3, movable, spheres):
    centers, radii = spheres
    for s in range(radii.shape[0]):
        c = centers[s].reshape(3, 1, 1)
        d = x3 - c
        dist = torch.sqrt(st._dot(d, d))
        pen = radii[s] - dist
        contact = (pen > 0.0) & movable[0]
        n = d / torch.clamp_min(dist, 1e-12)
        x3 = x3 + torch.where(contact, pen, 0.0) * n
    return x3


def _sphere_friction_planes(x_new, x_start, movable, cfg: SimConfig, spheres,
                            mu: float):
    """Substep-end sphere friction (``halo.py:892-910``): the halo Verlet
    and XPBD paths run static spheres, so the relative frame is the rest
    frame."""
    if not cfg.collision.enable_spheres or spheres is None or mu == 0.0:
        return x_new
    centers, radii = spheres
    for s in range(radii.shape[0]):
        c = centers[s].reshape(3, 1, 1)
        d = x_new - c
        dist = torch.sqrt(st._dot(d, d))
        n = d / torch.clamp_min(dist, 1e-12)
        contact = (dist <= radii[s] * SPHERE_CONTACT_SHELL) & movable[0]
        rel = x_new - x_start
        rel_t = rel - st._dot(rel, n) * n
        x_new = torch.where(contact, x_new - mu * rel_t, x_new)
    return x_new


def _rest_friction_planes(x_new, x_start, movable, capsules, boxes,
                          mu: float, dt: float):
    """Substep-end capsule, then box, friction of the packed rows
    (``halo.py:913-943``; the rows carry each collider's velocity)."""
    if mu == 0.0:
        return x_new
    xz, xsz = list(x_new), list(x_start)
    touched = False
    for p0, p1, radius, w in _capsule_rows(capsules):
        xz = capsule_friction_components(xz, xsz, movable[0], p0, p1, radius,
                                         w, mu, dt)
        touched = True
    for center, half, rot, w in _box_rows(boxes):
        xz = box_friction_components(xz, xsz, movable[0], center, half, rot,
                                     w, mu, dt)
        touched = True
    return torch.stack(xz) if touched else x_new


# --- the Verlet substep ------------------------------------------------------

def _halo_verlet_substep(x3, xp3, inv_mass2, offsets, cfg: SimConfig,
                         dt: float, plane_height, ny_global: int, ring,
                         gravity, owned, sc_forces=None, spheres=None,
                         alive=None, scale=None, capsules=None, boxes=None,
                         we=None):
    """One position-Verlet substep on the rank's rows
    (``halo.py:946-1031``): the forces as :func:`_halo_substep`'s at the
    velocity estimate ``(x - x_prev) / dt``, the damped update, the strain
    limit, then position-only contact and the substep-end friction.
    Returns ``(x_new, x3, alive, scale)``."""
    h = x3.shape[-2]
    v_est = (x3 - xp3) / dt
    xe, ve, ae, se = _exchange(ring, x3, v_est, alive, scale)
    f = st.stencil_spring_forces(xe, ve, offsets,
                                 owned if ae is None else ae,
                                 cfg.springs.damping, rest_scale=se)
    if cfg.wind.enabled:
        f = f + _wind_force_ext(xe, ve, cfg, h, ny_global, ring)
    f = _interior(f, h)
    if sc_forces is not None:
        # at the current positions, as verlet_integrate -> total_forces
        f = f + sc_forces(x3)
    movable = inv_mass2 > 0.0
    accel = gravity + f * inv_mass2
    x_new = (x3 + (x3 - xp3) * (1.0 - cfg.global_damping * dt)
             + accel * dt * dt)
    x_new = torch.where(movable, x_new, x3)
    if cfg.strain_limit.enabled:
        x_new = x_new + _strain_limit_halo(x_new, offsets, cfg, inv_mass2,
                                           ring, owned, ae=ae, se=se, we=we)
    contact_pf = (x_new[1] < plane_height) & movable[0]   # pre-clamp mask
    if cfg.collision.enable_plane:
        x_new = torch.stack([x_new[0],
                             torch.where(contact_pf, plane_height, x_new[1]),
                             x_new[2]])
    if cfg.collision.enable_spheres and spheres is not None:
        x_new = _push_out_spheres(x_new, movable, spheres)
    x_new = _project_capsules_boxes(x_new, movable, capsules, boxes)
    mu = cfg.collision.friction
    if cfg.collision.enable_plane and mu != 0.0:
        # the static plane: the halo Verlet and XPBD paths take no conveyor
        out = list(x_new)
        for ax in (0, 2):
            out[ax] = torch.where(
                contact_pf, x3[ax] + (x_new[ax] - x3[ax]) * (1.0 - mu),
                x_new[ax])
        x_new = torch.stack(out)
    x_new = _sphere_friction_planes(x_new, x3, movable, cfg, spheres, mu)
    x_new = _rest_friction_planes(x_new, x3, movable, capsules, boxes, mu, dt)
    if alive is not None or scale is not None:
        alive, scale = _feature_halo_update(x_new, alive, scale, offsets, cfg,
                                            ring)
    return x_new, x3, alive, scale


def make_halo_verlet_step(top: Topology, cfg: SimConfig, ring=None):
    """The row-sharded position-Verlet step (``halo.py:1034-1160``):
    ``fn(x3, xp3, inv_mass3, plane_height, dt, n_substeps, sphere_centers=,
    sphere_radii=, alive3=, capsules=, boxes=, scale3=) -> (x3, v3[,
    alive3][, scale3])``, carrying ``(x, x_prev)`` and returning ``v = (x -
    x_prev) / dt``; the rest as :func:`make_halo_step` (static colliders)."""
    ring, ny, nx, offsets = _prepare(top, cfg, ring)
    spheres_on = cfg.collision.enable_spheres and top.n_spheres > 0
    caps_on = needs_capsule_box(top, cfg)
    sc_forces = _rows_self_collision(cfg, ring, ny, nx)

    def steps(x3, xp3, inv_mass3, plane_height, dt, n_substeps,
              sphere_centers=None, sphere_radii=None, alive3=None,
              capsules=None, boxes=None, scale3=None):
        _require_inputs(cfg, spheres_on, caps_on, sphere_centers, alive3,
                        scale3, capsules)
        gravity, owned = _rank_tables(x3, offsets, ny, ring, cfg)
        spheres = (sphere_centers, sphere_radii) if spheres_on else None
        caps, bxs = (capsules, boxes) if caps_on else (None, None)
        ph = _plane_height(plane_height, x3)
        we = (ring.exchange_halo(inv_mass3)[0]
              if cfg.strain_limit.enabled else None)
        alive = alive3 if cfg.tear.enabled else None
        scale = scale3 if cfg.plasticity.enabled else None
        for _ in range(n_substeps):
            x3, xp3, alive, scale = _halo_verlet_substep(
                x3, xp3, inv_mass3, offsets, cfg, dt, ph, ny, ring, gravity,
                owned, sc_forces=sc_forces, spheres=spheres, alive=alive,
                scale=scale, capsules=caps, boxes=bxs, we=we)
        return _features_out(x3, (x3 - xp3) / dt, alive, scale)

    return steps


# --- the XPBD substep --------------------------------------------------------

def _halo_xpbd_substep(x3, v3, inv_mass2, xoffsets, cfg: SimConfig,
                       dt: float, plane_height, ny_global: int, ring,
                       gravity, owned, cnt_inv, sc_forces=None, spheres=None,
                       alive=None, scale=None, capsules=None, boxes=None):
    """One XPBD substep on the rank's rows (``halo.py:730-889``).  Each
    Jacobi sweep exchanges the positions and every lambda plane: a
    constraint owned by a halo row is computed alike on both neighbouring
    ranks (the same x and lambda inputs), so each rank rebuilds the
    corrections landing in its rows without any scatter.  Under tearing the
    liveness planes take the owned masks' place and the Jacobi count
    ``cnt_inv`` is recomputed from them every substep.  Delta form as the
    single-device XPBD (``kernels/stencil.py::xpbd_substep_grid``)."""
    h = x3.shape[-2]
    movable = inv_mass2 > 0.0
    w = inv_mass2[0]
    accel = gravity
    if cfg.wind.enabled:
        # external forces enter through the predict (oracle substep_xpbd)
        fw = _wind_force_ext(*_exchange(ring, x3, v3), cfg, h, ny_global,
                             ring)
        accel = accel + _interior(fw, h) * inv_mass2
    if sc_forces is not None:
        accel = accel + sc_forces(x3) * inv_mass2
    v3 = (v3 + dt * accel) * (1.0 - cfg.global_damping * dt)
    v3 = torch.where(movable, v3, 0.0)
    x_prev = x3
    delta = dt * v3

    # the plastic scales are constant over the substep: one exchange serves
    # every sweep (the update runs after them)
    we, se, ae = _exchange(ring, w[None], scale, alive)
    we = we[0]
    if ae is not None:
        cnt_inv = _interior(1.0 / st.jacobi_count(xoffsets, list(ae)), h)
    masks = owned if ae is None else list(ae)
    col = cfg.collision
    has_rows = (capsules is not None and capsules.shape[0] > 0) or (
        boxes is not None and boxes.shape[0] > 0)

    def project_contacts(delta, contact):
        """Position-only contact in delta form; the plane's pre-clamp mask
        ORed into ``contact`` (for the substep-end friction)."""
        if col.enable_plane:
            pc = ((x_prev[1] + delta[1]) < plane_height) & movable[0]
            delta = torch.stack([
                delta[0], torch.where(pc, plane_height - x_prev[1], delta[1]),
                delta[2]])
            contact = contact | pc
        if col.enable_spheres and spheres is not None:
            xev = x_prev + delta
            delta = delta + (_push_out_spheres(xev, movable, spheres) - xev)
        if has_rows:
            xev = x_prev + delta
            delta = delta + (_project_capsules_boxes(xev, movable, capsules,
                                                     boxes) - xev)
        return delta, contact

    lams = [torch.zeros_like(w) for _ in xoffsets]
    contact = torch.zeros_like(movable[0])
    for _ in range(cfg.xpbd.n_iterations):
        # the positions and the lambda planes in one exchange (the JAX path
        # makes one per plane; the values are the same)
        xe, lam_e = _exchange(ring, x_prev + delta, torch.stack(lams))
        dx = torch.zeros_like(xe)
        new_lams = []
        for o, ((di, dj, alpha, rest), m) in enumerate(zip(xoffsets, masks)):
            d = st._shift(xe, di, dj) - xe
            length = torch.sqrt(st._dot(d, d))
            n = d / torch.clamp_min(length, 1e-12)
            rest_eff = rest if se is None else rest * se[o]
            c_val = length - rest_eff
            alpha_t = alpha / (dt * dt)
            wn = st._shift(we, di, dj)
            denom = torch.clamp_min(we + wn + alpha_t, 1e-12)
            dlam = -(c_val + alpha_t * lam_e[o]) / denom * m
            new_lams.append(_interior(dlam, h) + lams[o])
            dx = dx + (-(we * dlam)) * n + st._shift((wn * dlam) * n, -di, -dj)
        lams = new_lams
        delta = delta + cfg.xpbd.relaxation * _interior(dx, h) * cnt_inv
        delta, contact = project_contacts(delta, contact)
    if cfg.strain_limit.enabled:
        # after the sweeps, then one more contact projection so the clamp
        # leaves no penetration (oracle substep_xpbd)
        xev = x_prev + delta
        xev = xev + _strain_limit_halo(xev, xoffsets, cfg, inv_mass2, ring,
                                       owned, ae=ae, se=se, we=we)
        delta = xev - x_prev
        delta, contact = project_contacts(delta, contact)
    mu = col.friction
    if col.enable_plane and mu != 0.0:
        # once per substep at the ORed pre-clamp mask (static plane)
        out = list(delta)
        for ax in (0, 2):
            out[ax] = torch.where(contact, delta[ax] * (1.0 - mu), delta[ax])
        delta = torch.stack(out)
    xe_f = x_prev + delta
    xf = _sphere_friction_planes(xe_f, x_prev, movable, cfg, spheres, mu)
    xf = _rest_friction_planes(xf, x_prev, movable, capsules, boxes, mu, dt)
    delta = delta + (xf - xe_f)
    delta = torch.where(movable, delta, 0.0)
    x_new = x_prev + delta
    if alive is not None or scale is not None:
        alive, scale = _feature_halo_update(x_new, alive, scale, xoffsets,
                                            cfg, ring)
    return x_new, delta / dt, alive, scale


def make_halo_xpbd_step(top: Topology, cfg: SimConfig, ring=None):
    """The row-sharded XPBD step (``halo.py:1163-1301``), the interface of
    :func:`make_halo_verlet_step` with ``v3`` in place of ``xp3``: ``fn(x3,
    v3, inv_mass3, plane_height, dt, n_substeps, ...) -> (x3, v3[, alive3][,
    scale3])``.  Position-level contact: kinematic collider velocities do not
    enter this solver."""
    ring, ny, nx, xoffsets = _prepare(top, cfg, ring, xpbd=True)
    spheres_on = cfg.collision.enable_spheres and top.n_spheres > 0
    caps_on = needs_capsule_box(top, cfg)
    sc_forces = _rows_self_collision(cfg, ring, ny, nx)

    def steps(x3, v3, inv_mass3, plane_height, dt, n_substeps,
              sphere_centers=None, sphere_radii=None, alive3=None,
              capsules=None, boxes=None, scale3=None):
        _require_inputs(cfg, spheres_on, caps_on, sphere_centers, alive3,
                        scale3, capsules)
        gravity, owned = _rank_tables(x3, xoffsets, ny, ring, cfg)
        spheres = (sphere_centers, sphere_radii) if spheres_on else None
        caps, bxs = (capsules, boxes) if caps_on else (None, None)
        ph = _plane_height(plane_height, x3)
        alive = alive3 if cfg.tear.enabled else None
        scale = scale3 if cfg.plasticity.enabled else None
        # the Jacobi count over the owned and owning edges, judged by global
        # row on the extended block (under tearing: per substep, from the
        # live planes)
        cnt_inv = _interior(1.0 / st.jacobi_count(xoffsets, owned),
                            x3.shape[-2])
        for _ in range(n_substeps):
            x3, v3, alive, scale = _halo_xpbd_substep(
                x3, v3, inv_mass3, xoffsets, cfg, dt, ph, ny, ring, gravity,
                owned, cnt_inv, sc_forces=sc_forces, spheres=spheres,
                alive=alive, scale=scale, capsules=caps, boxes=bxs)
        return _features_out(x3, v3, alive, scale)

    return steps
