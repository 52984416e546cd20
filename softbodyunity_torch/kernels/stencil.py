"""Stencil (shift-based) grid-cloth paths in plain PyTorch: Euler, Verlet, XPBD.

These are the plain versions of the hand-written fused substep kernels
(``csrc/grid_euler.cu``, ``csrc/grid_verlet.cu``, ``csrc/grid_xpbd.cu``,
wrapped by :mod:`.grid_euler`, :mod:`.grid_verlet` and :mod:`.grid_xpbd`):
the CPU runs them, and ``chip_smoke.py`` holds each kernel to its plain
version on the card.  They port the three solver branches of
``softbodyunity_tpu/kernels/stencil.py``, the XLA twin of the TPU kernels,
with the same operations in the same order, tearing (TearParams) and
plasticity (PlasticityParams) included: tear liveness and plastic rest
scales ride as per-offset ``[n_off, ny, nx]`` planes and are updated at the
end of every substep, plastic flow first, then the tear check against the
flowed rest (:func:`update_features`).  Wind (WindParams: drag, and lift
along the grid's vertex normals, :func:`wind_forces_grid`) enters the
forces, and strain limiting (StrainLimitParams) runs its Jacobi sweeps
between integration and contact (:func:`strain_limit_planes`), as the TPU
kernels run them (``pallas_substep.py::_strain_limit_planes``); the JAX
stencil has no sweeps and routes such scenes elsewhere.  Capsule and
oriented-box contact runs after the plane and the spheres, through the
component-list primitives of :mod:`softbodyunity_torch.solver.collide`,
with the JAX stencil's stages.

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
from ..core.topology import (EDGE_BEND, EDGE_SHEAR, Topology,
                             check_same_scene)
from ..solver.collide import (SPHERE_CONTACT_SHELL, needs_capsule_box,
                              project_capsules_boxes_components,
                              resolve_capsules_boxes_components,
                              rest_friction_components)
from ..solver.forces import self_collision_planes

# Config branches of the fused grid kernels that the port does not run yet,
# for every solver, each with the ROADMAP item that ports it.  The kernels
# and these plain versions refuse them, so a scene never silently loses a
# feature.
_UNPORTED = (
    ("SDF colliders", lambda c: c.collision.enable_sdf, "Queue 1 item 6"),
    ("self-collision methods hash and dense_mxu",
     lambda c: (c.self_collision.enabled
                and c.self_collision.method in ("hash", "dense_mxu")),
     "Queue 1 item 5"),
    ("pressure", lambda c: c.pressure.enabled, "Queue 1 item 6"),
    ("shape matching", lambda c: c.shape_match.enabled, "Queue 1 item 7"),
    ("motion constraints", lambda c: c.motion.enabled, "Queue 1 item 6"),
)


def check_ported(cfg: SimConfig) -> None:
    """Raise ``NotImplementedError`` naming every enabled branch of ``cfg``
    that the port does not run yet, and its ROADMAP item."""
    missing = [f"{name} (ROADMAP {item})" for name, on, item in _UNPORTED
               if on(cfg)]
    if missing:
        raise NotImplementedError(
            "not ported to softbodyunity_torch yet: " + ", ".join(missing))


def check_grid_ported(cfg: SimConfig) -> None:
    """:func:`check_ported`, and the grid branch that the JAX package runs
    only on its general edge-list path: strain limiting with self-collision
    (``softbodyunity_tpu/kernels/dispatch.py:60-95``)."""
    check_ported(cfg)
    if cfg.strain_limit.enabled and cfg.self_collision.enabled:
        raise NotImplementedError(
            "not ported to softbodyunity_torch yet: strain limiting with "
            "self-collision, which the JAX package runs on its general "
            "edge-list path (ROADMAP Queue 1 item 3)")


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


def _xpbd_offsets(cfg: SimConfig, spacing: float, has_shear: bool,
                  has_bend: bool):
    """(di, dj, compliance, rest_length) per spring class, mirroring the
    per-edge compliance of ``core/topology._edge_arrays``; the offset order
    is :func:`_offsets`'."""
    xp = cfg.xpbd
    offs = [
        (0, 1, xp.compliance_distance, spacing),
        (1, 0, xp.compliance_distance, spacing),
    ]
    if has_shear:
        r2 = spacing * float(np.sqrt(2.0))
        offs += [(1, 1, xp.compliance_distance, r2),
                 (1, -1, xp.compliance_distance, r2)]
    if has_bend:
        offs += [(0, 2, xp.compliance_bend, 2 * spacing),
                 (2, 0, xp.compliance_bend, 2 * spacing)]
    return offs


def jacobi_count(offsets, masks) -> torch.Tensor:
    """Per-vertex XPBD constraint count, at least 1: the edges a vertex owns
    plus the edges that own it (the Jacobi average's divisor)."""
    cnt = torch.zeros_like(masks[0])
    for (di, dj, _, _), m in zip(offsets, masks):
        cnt = cnt + m + _shift(m, -di, -dj)
    return torch.clamp_min(cnt, 1.0)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Component-plane dot product, summed in the order 0, 1, 2."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def stencil_spring_forces(
    x3: torch.Tensor,     # [3, ny, nx]
    v3: torch.Tensor,     # [3, ny, nx]
    offsets,              # from _offsets
    masks,                # per offset, [ny, nx]: _valid_mask or tear liveness
    damping: float,
    rest_scale=None,      # [n_off, ny, nx] plastic rest scales, or None
) -> torch.Tensor:
    """Hooke + axial damper over all spring classes, stencil-accumulated.

    For each offset o every vertex (i, j) owns the edge to (i, j) + o; the
    reaction is applied by shifting the force plane back by -o.  The norm is
    sqrt, then a multiply by ``1 / max(len, 1e-12)``, the op order of the
    JAX twin (``solver/forces.py::length_dir_planes_mul``).  Tear liveness
    planes take the masks' place (they are 0 at invalid grid positions);
    ``rest_scale`` rescales the rest lengths."""
    f_total = torch.zeros_like(x3)
    for o, ((di, dj, k, rest), mask) in enumerate(zip(offsets, masks)):
        xn = _shift(x3, di, dj)
        vn = _shift(v3, di, dj)
        d = xn - x3
        length = torch.sqrt(_dot(d, d))
        inv_len = 1.0 / torch.clamp_min(length, 1e-12)
        n = d * inv_len
        rel_v = _dot(vn - v3, n)
        rest_eff = rest if rest_scale is None else rest * rest_scale[o]
        fmag = (k * (length - rest_eff) + damping * rel_v) * mask
        f = fmag * n                       # force on (i,j), toward neighbour
        f_total = f_total + f - _shift(f, -di, -dj)
    return f_total


# --- tearing and plasticity: per-offset feature planes -----------------------

def _edge_lengths(x3, di: int, dj: int) -> torch.Tensor:
    """|x(i+di, j+dj) - x(i, j)| with |d|^2 summed (d0^2 + d1^2) + d2^2."""
    d = _shift(x3, di, dj) - x3
    return torch.sqrt(_dot(d, d))


def tear_ok_planes(x3, offsets, strain_limit: float, rest_scale=None):
    """Per-offset survival masks of the tear check (the oracle's
    ``tear_update`` comparison): 1.0 where the edge owned at (i, j) is
    within its strain limit.  ``rest_scale`` (plasticity) rescales the rest
    lengths first.  The threshold is ``rest * (1 + strain_limit)`` rounded
    once from double without plasticity, else ``(rest * scale) * (1 +
    strain_limit)`` in the planes' type, as the JAX package's twin rounds
    it."""
    ok = []
    for o, off in enumerate(offsets):
        di, dj, rest = off[0], off[1], off[3]
        length = _edge_lengths(x3, di, dj)
        limit = (rest * (1.0 + strain_limit) if rest_scale is None
                 else rest * rest_scale[o] * (1.0 + strain_limit))
        ok.append((length <= limit).to(x3.dtype))
    return ok


def tear_update_grid(x3, offsets, alive, strain_limit: float,
                     rest_scale=None) -> torch.Tensor:
    """End-of-substep tear check on liveness planes (the oracle's
    ``tear_update``): an edge past its strain limit dies for good.
    Invalid grid positions are 0 in ``alive`` and stay 0."""
    ok = tear_ok_planes(x3, offsets, strain_limit, rest_scale=rest_scale)
    return torch.stack([alive[o] * ok[o] for o in range(len(offsets))])


def plastic_update_grid(x3, offsets, scale, pp) -> torch.Tensor:
    """End-of-substep plastic flow on rest-scale planes (the oracle's
    ``plastic_update``; PlasticityParams ``pp``): an edge strained past the
    yield point creeps its rest scale toward the deformed length.  Invalid
    grid positions carry scales that nothing reads (the force masks zero
    them; the plane-to-edge gather takes valid owners only)."""
    out = []
    for o, off in enumerate(offsets):
        di, dj, rest = off[0], off[1], off[3]
        length = _edge_lengths(x3, di, dj)
        rest_eff = torch.clamp_min(rest * scale[o], 1e-12)
        strain = (length - rest_eff) / rest_eff
        excess = torch.sign(strain) * torch.clamp_min(
            strain.abs() - pp.yield_strain, 0.0)
        out.append(torch.clamp(scale[o] * (1.0 + pp.creep * excess),
                               pp.min_scale, pp.max_scale))
    return torch.stack(out)


def update_features(x3, offsets, alive, scale, cfg: SimConfig):
    """The feature update at the end of a substep, from its final positions
    ``x3``: plastic flow first, then the tear check against the flowed rest
    (the oracle's order).  ``alive``/``scale`` are planes or None (the
    feature is off); returns the new ``(alive, scale)``."""
    if scale is not None:
        scale = plastic_update_grid(x3, offsets, scale, cfg.plasticity)
    if alive is not None:
        alive = tear_update_grid(x3, offsets, alive, cfg.tear.strain_limit,
                                 rest_scale=scale)
    return alive, scale


def tear_plane_maps(top: Topology, offsets, ny: int, nx: int):
    """``(edge_to_planes, planes_to_edge, plane_idx)``: the flat ``[E]`` <->
    ``[n_off, ny, nx]`` conversion of per-edge values.  Edge e maps to
    (offset o, owner vertex) with owner + (di, dj) = its other end.  The
    index is built once, here, on the host from the edge list, then kept on
    the topology's device (``plane_idx``, int64 ``[E]``): a frame scatters
    once and gathers once.  The (di, dj) order of :func:`_offsets` and
    :func:`_xpbd_offsets` is the same, so one map serves every solver."""
    edges = top.edges.cpu().numpy()
    a, b = edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64)
    di_e = b // nx - a // nx
    dj_e = b % nx - a % nx
    o_e = np.zeros_like(a)
    owner = a.copy()
    for o, off in enumerate(offsets):
        di, dj = off[0], off[1]
        fwd = (di_e == di) & (dj_e == dj)
        rev = (di_e == -di) & (dj_e == -dj)
        o_e = np.where(fwd | rev, o, o_e)
        owner = np.where(rev, b, owner)
    plane_idx = torch.from_numpy(o_e * (ny * nx) + owner).to(top.device)
    n_off = len(offsets)

    def edge_to_planes(vals: torch.Tensor) -> torch.Tensor:
        flat = torch.zeros(n_off * ny * nx, dtype=vals.dtype,
                           device=vals.device)
        flat[plane_idx] = vals
        return flat.reshape(n_off, ny, nx)

    def planes_to_edge(planes: torch.Tensor) -> torch.Tensor:
        return planes.reshape(-1)[plane_idx]

    return edge_to_planes, planes_to_edge, plane_idx


# --- wind and strain limiting ------------------------------------------------

def _cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product of ``[3, ...]`` component planes."""
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def grid_vertex_normals(x3: torch.Tensor, cell_mask=None) -> torch.Tensor:
    """Unit area-weighted vertex normals of the grid's triangles (the
    oracle's ``vertex_normals`` over ``cloth_grid``'s triangulation), as
    shifts: cell (i, j) holds the triangles ``(p(i,j), p(i+1,j), p(i,j+1))``
    and ``(p(i,j+1), p(i+1,j), p(i+1,j+1))``, whose face normals are zero at
    the cells past the last row or column; each vertex sums the six faces
    around it, ``f1 + f1(-1,0) + f1(0,-1) + f2(0,-1) + f2(-1,0) + f2(-1,-1)``,
    and divides by ``max(|sum|, 1e-12)``
    (``softbodyunity_tpu/kernels/stencil.py::grid_vertex_normals``).
    ``cell_mask`` ([ny, nx], or None for the block's own last row and
    column) marks the cells that hold triangles: a row-sharded block with
    its halos (``parallel/halo.py``) judges them by global row."""
    ny, nx = x3.shape[-2], x3.shape[-1]
    cell = (_valid_mask(ny, nx, 1, 1, x3.device, x3.dtype)
            if cell_mask is None else cell_mask)
    pi = _shift(x3, 1, 0)      # p(i+1, j)
    pj = _shift(x3, 0, 1)      # p(i, j+1)
    pij = _shift(x3, 1, 1)     # p(i+1, j+1)
    f1 = _cross3(pi - x3, pj - x3) * cell
    f2 = _cross3(pi - pj, pij - pj) * cell
    acc = (f1 + _shift(f1, -1, 0) + _shift(f1, 0, -1)
           + _shift(f2, 0, -1) + _shift(f2, -1, 0) + _shift(f2, -1, -1))
    norm2 = acc[0] * acc[0] + acc[1] * acc[1] + acc[2] * acc[2]
    return acc / torch.clamp_min(torch.sqrt(norm2), 1e-12)


def wind_forces_grid(x3: torch.Tensor, v3: torch.Tensor, wind,
                     cell_mask=None) -> torch.Tensor:
    """The WindParams force on grid planes (the oracle's ``wind_forces``):
    ``drag * v_rel``, plus ``lift * (v_rel . n) * n`` along the vertex
    normals when lift is on, with ``v_rel = velocity - v``.  The wind
    velocity enters as three Python floats; ``cell_mask`` goes to
    :func:`grid_vertex_normals`."""
    vrel = torch.stack([wind.velocity[c] - v3[c] for c in range(3)])
    f = wind.drag * vrel
    if wind.lift != 0.0:
        n = grid_vertex_normals(x3, cell_mask=cell_mask)
        vn = vrel[0] * n[0] + vrel[1] * n[1] + vrel[2] * n[2]
        f = f + wind.lift * vn * n
    return f


def _clip(t: torch.Tensor, lo, hi) -> torch.Tensor:
    """``min(max(t, lo), hi)`` for bounds that are floats or tensors."""
    t = (torch.clamp_min(t, lo) if isinstance(lo, float)
         else torch.maximum(t, lo))
    return (torch.clamp_max(t, hi) if isinstance(hi, float)
            else torch.minimum(t, hi))


def strain_limit_planes(x3, offsets, masks, inv_mass2, sl, scales=None):
    """The strain limit's position change on grid planes (StrainLimitParams
    ``sl``; the oracle's ``strain_limit_dx``): ``sl.iterations`` Jacobi
    sweeps, each projecting every live edge whose length lies outside
    ``[rest * (1 - max_compress), rest * (1 + max_stretch)]`` back onto the
    nearer bound, the endpoints' shares weighted by inverse mass, each
    vertex's update divided by its count of live edges, owned and owning
    (:func:`jacobi_count`).  ``masks`` are the edge-ownership masks (the
    tear liveness planes under tearing: a torn edge limits nothing and
    leaves the count), ``scales`` the plastic rest scales (or None).
    Returns the total change ``x_final - x3``; pinned vertices (inverse
    mass 0) do not move.

    This ports ``softbodyunity_tpu/kernels/pallas_substep.py::
    _strain_limit_planes``, the TPU kernels' form, with this module's
    zero-fill shift for its wrap-roll, and follows ``solver/strainlimit.py``'s
    banded form in the norm: ``sqrt`` and an IEEE divide by
    ``max(length, 1e-12)``, where the TPU kernel multiplies by an
    ``rsqrt``."""
    w = inv_mass2[0]
    inv_cnt = 1.0 / jacobi_count(offsets, masks)
    xst = x3
    for _ in range(sl.iterations):
        dx = strain_sweep_dx(xst, offsets, masks, w, sl, scales)
        xst = xst + dx * inv_cnt
    return xst - x3


def strain_sweep_dx(xst, offsets, masks, w, sl, scales=None):
    """One strain-limit sweep's summed corrections at ``xst`` (before the
    division by the count), inverse masses ``w`` [ny, nx]: the body of
    :func:`strain_limit_planes`, and of the row-sharded sweeps on a block
    with its halos (``parallel/halo.py``)."""
    dx = torch.zeros_like(xst)
    for o, ((di, dj, _, rest), m) in enumerate(zip(offsets, masks)):
        d = _shift(xst, di, dj) - xst
        length = torch.sqrt(_dot(d, d))
        n = d / torch.clamp_min(length, 1e-12)
        rest_eff = rest if scales is None else rest * scales[o]
        hi = rest_eff * (1.0 + sl.max_stretch)
        lo = (rest_eff * (1.0 - sl.max_compress)
              if sl.max_compress >= 0.0 else 0.0)
        c_val = (length - _clip(length, lo, hi)) * m
        wn = _shift(w, di, dj)
        corr = c_val / torch.clamp_min(w + wn, 1e-12)
        dx = dx + (w * corr) * n - _shift((wn * corr) * n, -di, -dj)
    return dx


def euler_substep_grid(x3, v3, inv_mass2, offsets, masks, gravity,
                       cfg: SimConfig, dt: float, top: Topology, f_ext=None,
                       scale=None):
    """One semi-implicit Euler substep on grid planes (oracle
    ``substep_euler`` semantics): springs, gravity and global damping,
    pinning, then plane, sphere, capsule and box contact, in that order,
    relative to the colliders' kinematic velocities.  ``gravity`` is
    ``[3, 1, 1]`` on the planes' device.  ``f_ext`` (``[3, ny, nx]`` or None) is an external force at
    ``x3``, the self-collision repulsion, added to the spring forces as
    ``total_forces`` adds it.  ``masks`` are the tear liveness planes under
    tearing, ``scale`` the plastic rest scales (or None); the feature
    update is the caller's (:func:`update_features`).  Wind adds its force
    after ``f_ext``, as ``total_forces`` sums them; the strain limit's
    change ``dxl`` comes after the integration, before contact, and feeds
    the velocity: ``x += dxl``, ``v += dxl / dt``.  Returns ``(x3, v3)``."""
    movable = inv_mass2 > 0.0
    f = stencil_spring_forces(x3, v3, offsets, masks, cfg.springs.damping,
                              rest_scale=scale)
    if f_ext is not None:
        f = f + f_ext
    if cfg.wind.enabled:
        f = f + wind_forces_grid(x3, v3, cfg.wind)
    v3 = (v3 + dt * (gravity + f * inv_mass2)) * (1.0 - cfg.global_damping * dt)
    v3 = torch.where(movable, v3, 0.0)
    x3 = x3 + dt * v3
    if cfg.strain_limit.enabled:
        dxl = strain_limit_planes(x3, offsets, masks, inv_mass2,
                                  cfg.strain_limit, scales=scale)
        x3 = x3 + dxl
        v3 = v3 + dxl / dt

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
    if needs_capsule_box(top, cfg):
        xz, vz = resolve_capsules_boxes_components(
            top, cfg, list(x3), list(v3), movable[0])
        x3, v3 = torch.stack(xz), torch.stack(vz)
    return x3, v3


# --- position-level contact (Verlet and XPBD) --------------------------------

def _push_out_spheres(x3, movable, top: Topology):
    """Move each movable vertex inside a sphere out to its surface, sphere
    by sphere (``_project_positions_grid``'s sphere loop)."""
    for s in range(top.n_spheres):
        c = top.sphere_centers[s].reshape(3, 1, 1)
        d = x3 - c
        dist = torch.sqrt(_dot(d, d))
        pen = top.sphere_radii[s] - dist
        contact = (pen > 0.0) & movable[0]
        n = d / torch.clamp_min(dist, 1e-12)
        x3 = x3 + torch.where(contact, pen, 0.0) * n
    return x3


def _project_positions_grid(x3, movable, cfg: SimConfig, top: Topology):
    """Position-only contact: clamp to the plane, then push out of the
    spheres, the capsules and the boxes.  SDFs are refused by
    :func:`check_ported`."""
    col = cfg.collision
    if col.enable_plane:
        ph = top.plane_height
        contact = (x3[1] < ph) & movable[0]
        x3 = torch.stack([x3[0], torch.where(contact, ph, x3[1]), x3[2]])
    if col.enable_spheres:
        x3 = _push_out_spheres(x3, movable, top)
    if needs_capsule_box(top, cfg):
        x3 = torch.stack(project_capsules_boxes_components(
            top, cfg, list(x3), movable[0]))
    return x3


def _plane_friction_grid(x3, x_start3, cfg: SimConfig, dt: float, contact,
                         top: Topology):
    """Damp the substep's tangential displacement, relative to the plane's
    surface velocity, by ``1 - friction`` where the final projection's
    pre-clamp ``contact`` mask is set.  Once per substep."""
    mu = cfg.collision.friction
    if contact is None or not cfg.collision.enable_plane or mu == 0.0:
        return x3
    out = [x3[0], x3[1], x3[2]]
    for ax in (0, 2):
        target = x_start3[ax] + top.plane_velocity[ax] * dt
        out[ax] = torch.where(
            contact, target + (x3[ax] - target) * (1.0 - mu), x3[ax])
    return torch.stack(out)


def _sphere_friction_grid(x3, x_start3, cfg: SimConfig, dt: float, movable,
                          top: Topology):
    """Damp the tangential substep displacement, relative to each sphere's
    kinematic velocity, by ``1 - friction`` for vertices ending the substep
    within the contact shell ``radius * SPHERE_CONTACT_SHELL``.  Once per
    substep, after the plane friction."""
    mu = cfg.collision.friction
    if not cfg.collision.enable_spheres or mu == 0.0 or top.n_spheres == 0:
        return x3
    for s in range(top.n_spheres):
        c = top.sphere_centers[s].reshape(3, 1, 1)
        d = x3 - c
        dist = torch.sqrt(_dot(d, d))
        n = d / torch.clamp_min(dist, 1e-12)
        contact = ((dist <= top.sphere_radii[s] * SPHERE_CONTACT_SHELL)
                   & movable[0])
        w = top.sphere_velocities[s].reshape(3, 1, 1)
        rel = (x3 - x_start3) - w * dt
        rel_t = rel - _dot(rel, n) * n
        x3 = torch.where(contact, x3 - mu * rel_t, x3)
    return x3


def _rest_friction_grid(x3, x_start3, cfg: SimConfig, dt: float, movable,
                        top: Topology):
    """Capsule, then box, position-level friction
    (``collide.rest_friction_components``) on grid planes; once per
    substep, after the sphere friction."""
    if cfg.collision.friction == 0.0 or not needs_capsule_box(top, cfg):
        return x3
    return torch.stack(rest_friction_components(
        top, cfg, list(x3), list(x_start3), movable[0], dt))


def verlet_substep_grid(x3, xp3, inv_mass2, offsets, masks, gravity,
                        cfg: SimConfig, dt: float, top: Topology, f_ext=None,
                        scale=None):
    """One position-Verlet substep on grid planes (oracle ``substep_verlet``
    semantics): springs on the velocity estimate ``(x - xp) / dt``, plus
    ``f_ext`` at ``x3`` when given, the damped position update, pinning,
    then position-only plane and sphere contact and their friction.
    ``masks``/``scale`` and the wind as :func:`euler_substep_grid`'s (the
    wind at ``v_est``); the strain limit moves positions only, after the
    update and before contact.  Returns ``(x_new, x3)``: the new position
    and the new history ``x_prev``."""
    movable = inv_mass2 > 0.0
    v_est = (x3 - xp3) / dt
    f = stencil_spring_forces(x3, v_est, offsets, masks, cfg.springs.damping,
                              rest_scale=scale)
    if f_ext is not None:
        f = f + f_ext
    if cfg.wind.enabled:
        f = f + wind_forces_grid(x3, v_est, cfg.wind)
    accel = gravity + f * inv_mass2
    x_new = (x3 + (x3 - xp3) * (1.0 - cfg.global_damping * dt)
             + accel * dt * dt)
    x_new = torch.where(movable, x_new, x3)
    if cfg.strain_limit.enabled:
        x_new = x_new + strain_limit_planes(x_new, offsets, masks, inv_mass2,
                                            cfg.strain_limit, scales=scale)
    contact = ((x_new[1] < top.plane_height) & movable[0]
               if cfg.collision.enable_plane else None)
    x_new = _project_positions_grid(x_new, movable, cfg, top)
    x_new = _plane_friction_grid(x_new, x3, cfg, dt, contact, top)
    x_new = _sphere_friction_grid(x_new, x3, cfg, dt, movable, top)
    x_new = _rest_friction_grid(x_new, x3, cfg, dt, movable, top)
    return x_new, x3


def _project_delta_grid(x_prev, delta, contact, movable, cfg: SimConfig,
                        top: Topology):
    """XPBD's position contact in delta form: the plane clamp as ``plane -
    x_prev`` (its pre-clamp mask ORed into ``contact``), then the spheres'
    push-out as a displacement, then the capsules' and boxes' as another.
    Returns ``(delta, contact)``."""
    if cfg.collision.enable_plane:
        ph = top.plane_height
        pc = ((x_prev[1] + delta[1]) < ph) & movable[0]
        delta = torch.stack(
            [delta[0], torch.where(pc, ph - x_prev[1], delta[1]), delta[2]])
        contact = contact | pc
    if cfg.collision.enable_spheres and top.n_spheres > 0:
        xe = x_prev + delta
        delta = delta + (_push_out_spheres(xe, movable, top) - xe)
    if needs_capsule_box(top, cfg):
        xe = x_prev + delta
        delta = delta + (torch.stack(project_capsules_boxes_components(
            top, cfg, list(xe), movable[0])) - xe)
    return delta, contact


def xpbd_substep_grid(x3, v3, inv_mass2, xoffsets, masks, cnt, gravity,
                      cfg: SimConfig, dt: float, top: Topology, f_ext=None,
                      scale=None):
    """One XPBD substep on grid planes (oracle ``substep_xpbd`` semantics):
    predict, then ``n_iterations`` Jacobi sweeps of distance-constraint
    projection with compliance, count-averaged and under-relaxed, contact
    projected inside the loop, friction once after it, and the velocity
    recovered from the position change.  ``cnt`` is
    :func:`jacobi_count` of ``masks`` (the tear liveness planes under
    tearing, so a torn edge leaves the constraints and the count).
    ``scale`` (or None) holds the plastic rest scales, constant over the
    substep.  ``f_ext`` (or None), an external force at ``x3``, enters the
    predict as ``f_ext * inv_mass``, as ``substep_xpbd`` takes the
    self-collision repulsion, after the wind force, which enters the same
    way; the constraints cover only the springs.  The strain limit runs
    after the Jacobi loop, on ``x_prev + delta``, followed by one more
    contact projection (its plane contact joins the friction mask), as
    ``pallas_xpbd.py`` orders them.  Returns ``(x_new, v_new)``.

    Delta form: the loop carries the substep's accumulated position change
    ``delta`` and never a rounded ``x``; only the evaluation point
    ``x_prev + delta`` rounds large plus small, and it is never stored.  The
    f32 drift bound rests on this (``tests/test_oracle_parity.py``)."""
    col = cfg.collision
    movable = inv_mass2 > 0.0
    w = inv_mass2[0]
    accel = gravity
    if cfg.wind.enabled:
        accel = accel + wind_forces_grid(x3, v3, cfg.wind) * inv_mass2
    if f_ext is not None:
        accel = accel + f_ext * inv_mass2
    v3 = (v3 + dt * accel) * (1.0 - cfg.global_damping * dt)
    v3 = torch.where(movable, v3, 0.0)
    x_prev = x3
    delta = dt * v3
    lams = [torch.zeros_like(w) for _ in xoffsets]
    contact = torch.zeros_like(movable[0])
    for _ in range(cfg.xpbd.n_iterations):
        xe = x_prev + delta            # evaluation point, never stored
        dx = torch.zeros_like(xe)
        for o, ((di, dj, alpha, rest), m) in enumerate(zip(xoffsets, masks)):
            d = _shift(xe, di, dj) - xe
            length = torch.sqrt(_dot(d, d))
            n = d / torch.clamp_min(length, 1e-12)   # divide form
            c_val = length - (rest if scale is None else rest * scale[o])
            alpha_t = alpha / (dt * dt)
            wn = _shift(w, di, dj)
            denom = torch.clamp_min(w + wn + alpha_t, 1e-12)
            dlam = -(c_val + alpha_t * lams[o]) / denom * m
            lams[o] = lams[o] + dlam
            # -w * dlam * n at the owner, +wn * dlam * n at the neighbour
            # (scattered by the reverse shift)
            contrib_a = -(w * dlam) * n
            contrib_b = (wn * dlam) * n
            dx = dx + contrib_a + _shift(contrib_b, -di, -dj)
        delta = delta + cfg.xpbd.relaxation * dx / cnt
        delta, contact = _project_delta_grid(x_prev, delta, contact,
                                             movable, cfg, top)
    if cfg.strain_limit.enabled:
        delta = delta + strain_limit_planes(x_prev + delta, xoffsets, masks,
                                            inv_mass2, cfg.strain_limit,
                                            scales=scale)
        delta, contact = _project_delta_grid(x_prev, delta, contact,
                                             movable, cfg, top)
    # plane friction once per substep, on the OR of the iterations'
    # pre-clamp contact masks
    mu = col.friction
    if col.enable_plane and mu != 0.0:
        out = [delta[0], delta[1], delta[2]]
        for ax in (0, 2):
            wdt = top.plane_velocity[ax] * dt
            out[ax] = torch.where(
                contact, wdt + (delta[ax] - wdt) * (1.0 - mu), delta[ax])
        delta = torch.stack(out)
    xe = x_prev + delta
    xf = _sphere_friction_grid(xe, x_prev, cfg, dt, movable, top)
    xf = _rest_friction_grid(xf, x_prev, cfg, dt, movable, top)
    delta = delta + (xf - xe)
    delta = torch.where(movable, delta, 0.0)
    return x_prev + delta, delta / dt


def to_planes(a: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
    """[N, 3] -> [3, ny, nx]."""
    return a.t().reshape(3, ny, nx)


def from_planes(a: torch.Tensor) -> torch.Tensor:
    """[3, ny, nx] -> contiguous [N, 3]."""
    return a.reshape(3, -1).t().contiguous()


def edge_values(state_field, n_edges: int, like: torch.Tensor):
    """A per-edge feature field of a state, or all ones where the state has
    none yet (what ``api.ensure_tear_state``/``ensure_plastic_state``
    supply)."""
    if state_field is not None:
        return state_field
    return torch.ones(n_edges, dtype=like.dtype, device=like.device)


def make_stencil_step(top: Topology, cfg: SimConfig):
    """Build ``fn(state, dt, n_substeps) -> state`` for a grid-cloth scene
    under ``cfg.solver`` (Euler, Verlet or XPBD), in plain PyTorch on
    whatever device ``top`` lives on.  With self-collision on, each substep
    first evaluates its force planes at the substep's start position
    (method ``block`` by the pair kernel's plain version).  Under tearing
    and plasticity the state's ``edge_alive``/``rest_scale`` go into planes
    once a frame, every substep ends with :func:`update_features`, and the
    planes come back to the edges at the end; under tearing the XPBD
    Jacobi count follows the liveness planes every substep.  The collider
    rows are read from ``top`` (the call's, when it passes one that shares
    everything else with the built one, :func:`softbodyunity_torch.api.move_colliders`)."""
    check_grid_ported(cfg)
    sc_force = self_collision_planes(cfg)
    ny, nx = top.grid_shape
    has_shear = EDGE_SHEAR in top.edge_classes_present
    has_bend = EDGE_BEND in top.edge_classes_present
    offsets = _offsets(cfg, top.grid_spacing, has_shear, has_bend)
    masks = [_valid_mask(ny, nx, di, dj, top.device, top.dtype)
             for di, dj, _, _ in offsets]
    gravity = torch.tensor(cfg.gravity, dtype=top.dtype,
                           device=top.device).reshape(3, 1, 1)
    inv_mass2 = top.inv_mass.reshape(1, ny, nx)
    if cfg.solver == Solver.XPBD:
        # the same (di, dj) order as offsets, so the masks serve both
        xoffsets = _xpbd_offsets(cfg, top.grid_spacing, has_shear, has_bend)
        cnt = jacobi_count(xoffsets, masks)
    tearing, plastic = cfg.tear.enabled, cfg.plasticity.enabled
    if tearing or plastic:
        edge_to_planes, planes_to_edge, _ = tear_plane_maps(top, offsets,
                                                            ny, nx)
    n_edges = int(top.edges.shape[0])

    built = top

    def fn(state: State, dt: float, n_substeps: int, top=None) -> State:
        # the call's topology (api.move_colliders) carries the colliders
        if top is None:
            top = built
        check_same_scene(built, top)
        x3 = to_planes(state.x, ny, nx)
        alive = scale = None
        if tearing:
            alive = edge_to_planes(edge_values(state.edge_alive, n_edges,
                                               state.x))
        if plastic:
            scale = edge_to_planes(edge_values(state.rest_scale, n_edges,
                                               state.x))
        if cfg.solver == Solver.VERLET:
            xp3 = to_planes(state.x_prev, ny, nx)
            for _ in range(n_substeps):
                f_ext = sc_force(x3) if sc_force else None
                x3, xp3 = verlet_substep_grid(
                    x3, xp3, inv_mass2, offsets,
                    masks if alive is None else alive, gravity, cfg, dt,
                    top, f_ext, scale)
                alive, scale = update_features(x3, offsets, alive, scale, cfg)
            v3 = (x3 - xp3) / dt
        else:
            v3 = to_planes(state.v, ny, nx)
            for _ in range(n_substeps):
                f_ext = sc_force(x3) if sc_force else None
                m = masks if alive is None else alive
                if cfg.solver == Solver.XPBD:
                    c = cnt if alive is None else jacobi_count(xoffsets, m)
                    x3, v3 = xpbd_substep_grid(x3, v3, inv_mass2, xoffsets,
                                               m, c, gravity, cfg, dt, top,
                                               f_ext, scale)
                else:
                    x3, v3 = euler_substep_grid(x3, v3, inv_mass2, offsets,
                                                m, gravity, cfg, dt, top,
                                                f_ext, scale)
                alive, scale = update_features(x3, offsets, alive, scale, cfg)
            # neither solver reads x_prev; rebuild the natural value (the
            # position before the final integrate) as the JAX fast paths do
            xp3 = x3 - dt * v3
        return State(
            x=from_planes(x3), v=from_planes(v3), x_prev=from_planes(xp3),
            edge_alive=(planes_to_edge(alive) if tearing
                        else state.edge_alive),
            rest_scale=(planes_to_edge(scale) if plastic
                        else state.rest_scale),
            cluster_quat=state.cluster_quat)

    return fn
