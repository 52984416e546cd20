"""Mesh topology: the host-side NumPy builders and the device ``Topology``.

The builders (``HostTopology``, ``add_colliders``, ``cloth_grid``,
``tet_cube`` and their helpers) are copies of ``softbodyunity_tpu/core/topology.py``: that module
imports jax to register its device pytree, so the port carries the NumPy
parts itself and ``tests/test_torch_port.py`` and
``tests/test_torch_lattice.py`` hold the copies equal to the originals.
``tet_box`` is the cube's builder with a size on each side; the JAX
package has the cube alone.

:class:`Topology` is the device side, built by
:func:`softbodyunity_torch.api.device_topology`: a frozen dataclass of
tensors holding what the grid-cloth and tet-lattice paths read.  Later
slices add the fields their paths need; ``HostTopology`` already carries
all of them.  A built step function depends on a topology's
:class:`SceneKey`: everything but the colliders' rows, which
:func:`softbodyunity_torch.api.move_colliders` replaces between frames.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Tuple

import numpy as np
import torch

if TYPE_CHECKING:
    from ..solver.banded import OffsetGroups, TetGroups

EDGE_STRUCTURAL = 0
EDGE_SHEAR = 1
EDGE_BEND = 2


# eq=False: identity equality and hashing (field-wise == on tensors is
# elementwise, not a bool); the cache of built step functions is keyed by
# SceneKey instead
@dataclasses.dataclass(frozen=True, eq=False)
class Topology:
    """Static scene description on one device.

    Shapes: N vertices, E edges, F triangles, S spheres, C capsules, B
    boxes (zero rows where the scene has none).  Float tensors share
    one dtype (float32 on the kernel path; the tests also run float64), index
    tensors are int64.  ``offset_groups``/``tet_groups`` are the banded
    (delta-grouped) springs and tets of :mod:`..solver.banded`, built for
    every non-grid scene and for grids of at most 65,536 vertices, as the
    JAX package builds them; the tet-lattice paths read them.
    """

    inv_mass: torch.Tensor            # [N]     0.0 for pinned vertices
    plane_height: torch.Tensor        # []      ground plane y
    plane_velocity: torch.Tensor      # [3]     plane SURFACE velocity
    sphere_centers: torch.Tensor      # [S, 3]
    sphere_radii: torch.Tensor        # [S]
    sphere_velocities: torch.Tensor   # [S, 3]  kinematic sphere velocities
    capsule_p0: torch.Tensor          # [C, 3]  segment start
    capsule_p1: torch.Tensor          # [C, 3]  segment end
    capsule_radii: torch.Tensor       # [C]
    capsule_velocities: torch.Tensor  # [C, 3]  kinematic capsule velocities
    box_centers: torch.Tensor         # [B, 3]
    box_half_extents: torch.Tensor    # [B, 3]
    box_rotations: torch.Tensor       # [B, 3, 3] columns = the box's axes
    box_velocities: torch.Tensor      # [B, 3]  kinematic box velocities
    triangles: torch.Tensor           # i64[F, 3] for vertex normals
    edges: torch.Tensor               # i64[E, 2] endpoint vertex ids (a, b)
    rest_length: torch.Tensor         # [E]
    n_vertices: int
    grid_shape: Optional[Tuple[int, int]] = None   # (ny, nx) for grid cloth
    grid_spacing: Optional[float] = None           # uniform rest spacing
    edge_classes_present: Tuple[int, ...] = (0,)   # spring classes present
    offset_groups: Optional["OffsetGroups"] = None
    tet_groups: Optional["TetGroups"] = None
    n_tets: int = 0

    @property
    def device(self) -> torch.device:
        return self.inv_mass.device

    @property
    def dtype(self) -> torch.dtype:
        return self.inv_mass.dtype

    @property
    def n_spheres(self) -> int:
        return self.sphere_radii.shape[0]

    @property
    def n_capsules(self) -> int:
        return self.capsule_radii.shape[0]

    @property
    def n_boxes(self) -> int:
        return self.box_centers.shape[0]


# The fields of a Topology that api.move_colliders replaces between frames:
# the colliders' geometry and kinematic velocities.
COLLIDER_FIELDS = (
    "plane_height", "plane_velocity", "sphere_centers", "sphere_radii",
    "sphere_velocities", "capsule_p0", "capsule_p1", "capsule_radii",
    "capsule_velocities", "box_centers", "box_half_extents", "box_rotations",
    "box_velocities")


class SceneKey:
    """What a step function built for a topology depends on: every field of
    the topology but the colliders' rows (compared by identity, so a
    topology from :func:`softbodyunity_torch.api.move_colliders`, which
    shares them, has the same key) and the collider counts.  ``top`` is the
    topology the key was made from; it takes no part in the comparison."""

    def __init__(self, top: Topology):
        self.top = top
        self._fields = tuple(getattr(top, f.name)
                             for f in dataclasses.fields(top)
                             if f.name not in COLLIDER_FIELDS)
        self._counts = (top.n_spheres, top.n_capsules, top.n_boxes)
        self._hash = hash((tuple(map(id, self._fields)), self._counts))

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other) -> bool:
        return (isinstance(other, SceneKey) and self._counts == other._counts
                and all(a is b for a, b in zip(self._fields, other._fields)))


def check_same_scene(built: Topology, top: Topology) -> None:
    """Raise ``ValueError`` unless ``top`` is ``built`` with other collider
    rows (same :class:`SceneKey`): what a step function built for
    ``built`` accepts as the topology of a call."""
    if top is not built and SceneKey(top) != SceneKey(built):
        raise ValueError(
            "this step function was built for another scene: a call's "
            "topology may differ from the one it was built for only in its "
            "collider rows (api.move_colliders), with the same counts")


def _build_incidence(n: int, edges: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vertex -> incident-edge table, padded to the max degree.

    Padding entries point at edge id E (one past the end); callers append a
    zero "ghost" force row so padded gathers contribute nothing.  Fully
    vectorized (a python-loop version took 7 s alone at 262k vertices);
    per-vertex entries are ordered by edge id, exactly the order the loop
    formulation produced.
    """
    e = edges.shape[0]
    if e == 0 or n == 0:
        return (np.full((n, 1), e, dtype=np.int32),
                np.zeros((n, 1), dtype=np.float64))
    ends = np.concatenate([edges[:, 0], edges[:, 1]]).astype(np.int64)
    eids = np.concatenate([np.arange(e), np.arange(e)])
    signs = np.concatenate([np.ones(e), -np.ones(e)])
    order = np.lexsort((eids, ends))          # by vertex, then edge id
    ends_s, eids_s, signs_s = ends[order], eids[order], signs[order]
    counts = np.bincount(ends, minlength=n)
    d = max(int(counts.max()), 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(2 * e) - starts[ends_s]  # position within the group
    incident = np.full((n, d), e, dtype=np.int32)
    sign = np.zeros((n, d), dtype=np.float64)
    incident[ends_s, slot] = eids_s
    sign[ends_s, slot] = signs_s
    return incident, sign


def _edge_arrays(
    edge_list,
    positions: np.ndarray,
    springs,
    xpbd,
) -> Tuple[np.ndarray, ...]:
    """Pack (a, b, class) triples — a list of tuples or an i64[E, 3]
    array — into sorted topology arrays."""
    if isinstance(edge_list, np.ndarray):
        triples = edge_list.astype(np.int64, copy=False)
    else:
        # np.array() on millions of tuples is pathologically slow;
        # fromiter over the flattened stream is ~10x faster
        import itertools

        triples = np.fromiter(
            itertools.chain.from_iterable(edge_list), np.int64,
            count=3 * len(edge_list),
        ).reshape(-1, 3)
    edges = triples[:, :2]
    cls = triples[:, 2]
    # sort by first endpoint for contiguous segment_sum fallback
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    edges, cls = edges[order], cls[order]
    rest = np.linalg.norm(positions[edges[:, 1]] - positions[edges[:, 0]], axis=1)
    k_by_class = np.array(
        [springs.k_structural, springs.k_shear, springs.k_bend], dtype=np.float64
    )
    a_by_class = np.array(
        [xpbd.compliance_distance, xpbd.compliance_distance, xpbd.compliance_bend],
        dtype=np.float64,
    )
    return (
        edges.astype(np.int32),
        rest,
        cls.astype(np.int32),
        k_by_class[cls],
        a_by_class[cls],
    )



@dataclasses.dataclass
class HostTopology:
    """float64 NumPy scene description, consumed by
    :func:`softbodyunity_torch.api.init` (which casts the fields the device
    path reads into a :class:`Topology`).  Same fields as the JAX package's
    ``HostTopology``, so :mod:`softbodyunity_torch.convert` carries one across
    field by field and the JAX oracle accepts this one as it is.
    """

    positions0: np.ndarray      # f64[N, 3] rest positions (initial state)
    edges: np.ndarray
    rest_length: np.ndarray
    edge_class: np.ndarray
    edge_stiffness: np.ndarray
    edge_compliance: np.ndarray
    inv_mass: np.ndarray
    incident: np.ndarray
    incident_sign: np.ndarray
    tets: np.ndarray
    rest_volume: np.ndarray
    triangles: np.ndarray
    plane_height: float
    sphere_centers: np.ndarray
    sphere_radii: np.ndarray
    grid_shape: Optional[Tuple[int, int]]
    grid_spacing: Optional[float] = None
    edge_classes_present: Tuple[int, ...] = (0,)
    # capsule / box colliders (None = none; see add_colliders)
    capsule_p0: Optional[np.ndarray] = None       # f64[C, 3]
    capsule_p1: Optional[np.ndarray] = None       # f64[C, 3]
    capsule_radii: Optional[np.ndarray] = None    # f64[C]
    box_centers: Optional[np.ndarray] = None      # f64[B, 3]
    box_half_extents: Optional[np.ndarray] = None  # f64[B, 3]
    box_rotations: Optional[np.ndarray] = None    # f64[B, 3, 3]
    # mesh (SDF) colliders (None = none; see add_colliders / core/sdf.py)
    sdf_grids: Optional[np.ndarray] = None        # f64[Sg, gx, gy, gz]
    sdf_origins: Optional[np.ndarray] = None      # f64[Sg, 3]
    sdf_spacings: Optional[np.ndarray] = None     # f64[Sg]
    # pressure bodies (None = none; see enable_pressure): per-triangle
    # body id (-1 = triangle encloses no gas) + per-body rest volume
    tri_body: Optional[np.ndarray] = None             # i64[F]
    pressure_rest_volume: Optional[np.ndarray] = None  # f64[P]
    # BFS reorder bookkeeping (from_triangle_mesh / from_tet_mesh with
    # reorder=True): new id of input vertex i is old_to_new[i]; None when
    # the input ordering was kept.  Map caller-side ids (stitch, anchor,
    # pins) through this before using them on the built topology.
    old_to_new: Optional[np.ndarray] = None           # i64[N]
    # kinematic collider velocities (None = static; see set_collider_velocities):
    # contact friction/restitution act on the velocity RELATIVE to the
    # collider, so a dragged sphere carries the cloth and a plane with a
    # surface velocity is a conveyor belt.  Geometry itself is animated
    # separately (api.move_colliders) — these only shape the contact
    # response on the velocity-level (Euler) paths.
    plane_velocity: Optional[np.ndarray] = None       # f64[3] surface velocity
    sphere_velocities: Optional[np.ndarray] = None    # f64[S, 3]
    capsule_velocities: Optional[np.ndarray] = None   # f64[C, 3]
    box_velocities: Optional[np.ndarray] = None       # f64[B, 3]
    sdf_velocities: Optional[np.ndarray] = None       # f64[Sg, 3]
    # rigid attachments (None = none; see attach): cloth vertices welded
    # to a point in a rigid sphere's body frame, resolved by the coupled
    # solvers (solver/rigid.py)
    attach_ids: Optional[np.ndarray] = None           # i64[A]
    attach_body: Optional[np.ndarray] = None          # i64[A]
    attach_local: Optional[np.ndarray] = None         # f64[A, 3]
    # box attachments (attach_box): welds to a dynamic box's body frame
    attach_box_ids: Optional[np.ndarray] = None       # i64[Ab]
    attach_box_body: Optional[np.ndarray] = None      # i64[Ab]
    attach_box_local: Optional[np.ndarray] = None     # f64[Ab, 3]
    # rigid-rigid joints (None = none; see add_rigid_joint): Unity
    # FixedJoint-anchor / HingeJoint / SpringJoint analogues between
    # DYNAMIC rigid bodies (spheres/boxes promoted by make_rigid_state)
    # and/or the world, resolved by the coupled solvers.  joint_meta is
    # one static record per joint: (jtype, kind_a, idx_a, kind_b, idx_b)
    # with jtype in {"ball", "hinge", "distance"} and kind in {"sphere",
    # "box", "world"}; the arrays carry the (movable) anchor data.
    joint_meta: Optional[Tuple] = None                # static, len J
    joint_local_a: Optional[np.ndarray] = None        # f64[J, 3] anchor in
    #                                  body a's frame (world point for a
    #                                  "world" side)
    joint_local_b: Optional[np.ndarray] = None        # f64[J, 3]
    joint_axis_a: Optional[np.ndarray] = None         # f64[J, 3] hinge axis
    #                                  in body a's frame (zeros otherwise)
    joint_axis_b: Optional[np.ndarray] = None         # f64[J, 3]
    joint_rest: Optional[np.ndarray] = None           # f64[J] distance rest
    joint_compliance: Optional[np.ndarray] = None     # f64[J] XPBD
    #                                  compliance (distance joints only)
    joint_ref_a: Optional[np.ndarray] = None          # f64[J, 3] hinge
    #                                  angle reference (perp to axis),
    #                                  body a's frame
    joint_ref_b: Optional[np.ndarray] = None          # f64[J, 3]
    joint_limit: Optional[np.ndarray] = None          # f64[J, 2] hinge
    #                                  angle (lo, hi) rad; lo > hi = off
    joint_motor: Optional[np.ndarray] = None          # f64[J, 2] hinge
    #                                  motor (target rad/s, max torque);
    #                                  max torque 0 = off
    # shape-matching clusters (None = none; see enable_shape_matching):
    # per-vertex cluster id (-1 = no cluster) + rest offset from the
    # cluster's mass-weighted rest centroid; behaviour set by
    # ShapeMatchParams
    cluster_id: Optional[np.ndarray] = None           # i64[N]
    cluster_rest: Optional[np.ndarray] = None         # f64[N, 3]
    n_clusters: int = 0
    # per-vertex motion constraints (None = none; see
    # set_motion_constraints): tether sphere anchor + max distance per
    # vertex (inf = unconstrained); behaviour set by MotionConstraintParams
    tether_anchor: Optional[np.ndarray] = None        # f64[N, 3]
    tether_radius: Optional[np.ndarray] = None        # f64[N]
    # raster dims (nx, ny, nz) when the body is a regular lattice with
    # vid(i,j,k) = (i*ny + j)*nz + k (set by tet_cube / lattice_from_mesh;
    # None for general topologies and merged scenes)
    lattice_shape: Optional[Tuple[int, int, int]] = None


def add_colliders(
    host: HostTopology,
    *,
    capsule_p0=None,
    capsule_p1=None,
    capsule_radii=None,
    box_centers=None,
    box_half_extents=None,
    box_rotations=None,
    sdf_grids=None,
    sdf_origins=None,
    sdf_spacings=None,
    plane_velocity=None,
    sphere_velocities=None,
    capsule_velocities=None,
    box_velocities=None,
    sdf_velocities=None,
) -> HostTopology:
    """Attach capsule / box / mesh(SDF) colliders to any built topology (the
    analogue of adding a Unity CapsuleCollider / BoxCollider / MeshCollider
    to the scene).

    Capsules are segments ``p0 -> p1`` with a radius; boxes are oriented
    boxes given by center, per-axis half extents, and a world-from-local
    rotation matrix (columns = the box's local axes in world space;
    defaults to identity = axis-aligned).  Mesh colliders are baked signed
    distance grids from the JAX package's ``core.sdf.sdf_from_mesh``:
    pass one or more ``(grid, origin, spacing)`` bakes as stacked arrays
    (all grids in a scene must share voxel dimensions).  Enable resolution
    with ``CollisionParams(enable_capsules=True)`` / ``enable_boxes=True``
    / ``enable_sdf=True``.
    """
    caps_args = (capsule_p0, capsule_p1, capsule_radii)
    if any(a is not None for a in caps_args) and any(
            a is None for a in caps_args):
        # a partial capsule spec silently attaching nothing means the cloth
        # falls straight through where the user placed a collider
        raise ValueError(
            "capsules need all of capsule_p0, capsule_p1, capsule_radii"
        )
    if (box_half_extents is not None or box_rotations is not None) \
            and box_centers is None:
        raise ValueError(
            "boxes need box_centers (with box_half_extents; box_rotations "
            "defaults to identity)"
        )
    if box_centers is not None and box_half_extents is None:
        raise ValueError("boxes need box_half_extents")
    if capsule_radii is not None:
        host.capsule_p0 = np.asarray(capsule_p0, np.float64).reshape(-1, 3)
        host.capsule_p1 = np.asarray(capsule_p1, np.float64).reshape(-1, 3)
        host.capsule_radii = np.asarray(capsule_radii, np.float64).reshape(-1)
        if not (host.capsule_p0.shape[0] == host.capsule_p1.shape[0]
                == host.capsule_radii.shape[0]):
            # on device a mismatched count silently CLAMPS out-of-range
            # indices (jit gather semantics) => a phantom collider at the
            # wrong geometry, with no error anywhere downstream
            raise ValueError(
                f"capsule_p0/p1/radii row counts disagree: "
                f"{host.capsule_p0.shape[0]}/{host.capsule_p1.shape[0]}/"
                f"{host.capsule_radii.shape[0]}"
            )
    if box_centers is not None:
        host.box_centers = np.asarray(box_centers, np.float64).reshape(-1, 3)
        host.box_half_extents = np.asarray(
            box_half_extents, np.float64
        ).reshape(-1, 3)
        if host.box_half_extents.shape[0] != host.box_centers.shape[0]:
            raise ValueError(
                f"box_centers/half_extents row counts disagree: "
                f"{host.box_centers.shape[0]}/"
                f"{host.box_half_extents.shape[0]}"
            )
        nb = host.box_centers.shape[0]
        if box_rotations is None:
            host.box_rotations = np.broadcast_to(
                np.eye(3), (nb, 3, 3)
            ).copy()
        else:
            host.box_rotations = np.asarray(
                box_rotations, np.float64
            ).reshape(-1, 3, 3)
            if host.box_rotations.shape[0] != nb:
                raise ValueError(
                    f"box_rotations rows ({host.box_rotations.shape[0]}) "
                    f"must match box_centers ({nb})"
                )
    if sdf_grids is not None:
        g = np.asarray(sdf_grids, np.float64)
        if g.ndim == 3:
            g = g[None]
        if g.ndim != 4:
            raise ValueError("sdf_grids must be [gx,gy,gz] or [S,gx,gy,gz]")
        if sdf_origins is None or sdf_spacings is None:
            raise ValueError(
                "sdf colliders need all of sdf_grids, sdf_origins, "
                "sdf_spacings (from core.sdf.sdf_from_mesh)"
            )
        host.sdf_grids = g
        host.sdf_origins = np.asarray(
            sdf_origins, np.float64).reshape(-1, 3)
        host.sdf_spacings = np.asarray(
            sdf_spacings, np.float64).reshape(-1)
        if not (host.sdf_origins.shape[0] == g.shape[0]
                == host.sdf_spacings.shape[0]):
            raise ValueError("sdf_grids / sdf_origins / sdf_spacings "
                             "leading dimensions disagree")
    # kinematic collider velocities: contact friction/restitution act on
    # the velocity RELATIVE to the collider (see Topology *_velocities)
    if plane_velocity is not None:
        host.plane_velocity = np.asarray(
            plane_velocity, np.float64).reshape(3)
    for name, vel, count in (
        ("sphere_velocities", sphere_velocities,
         np.asarray(host.sphere_radii).shape[0]),
        ("capsule_velocities", capsule_velocities,
         0 if host.capsule_radii is None else host.capsule_radii.shape[0]),
        ("box_velocities", box_velocities,
         0 if host.box_centers is None else host.box_centers.shape[0]),
        ("sdf_velocities", sdf_velocities,
         0 if host.sdf_spacings is None else host.sdf_spacings.shape[0]),
    ):
        if vel is not None:
            v = np.asarray(vel, np.float64).reshape(-1, 3)
            if v.shape[0] != count:
                raise ValueError(
                    f"{name} rows ({v.shape[0]}) must match the collider "
                    f"count ({count})"
                )
            setattr(host, name, v)
    return host


def cloth_grid(
    nx: int,
    ny: int,
    *,
    spacing: float = 0.05,
    mass: float = 1.0,
    pinned: Tuple[str, ...] = (),
    shear: bool = True,
    bend: bool = True,
    springs=None,
    xpbd=None,
    plane_height: float = -1.0,
    sphere_centers: Optional[np.ndarray] = None,
    sphere_radii: Optional[np.ndarray] = None,
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    orientation: str = "xz",
) -> HostTopology:
    """Build an ``nx × ny`` cloth grid (BASELINE.json:7-8).

    Vertex (i, j) — row i in [0, ny), column j in [0, nx) — lies in the
    ``xz`` plane (horizontal cloth falling under gravity) or ``xy`` plane
    (hanging cloth) at ``origin``.

    Edge classes (BASELINE.json:8 "structural/shear/bend springs"):
      * structural: 4-neighbour (i,j)-(i,j+1) and (i,j)-(i+1,j)
      * shear: diagonals (i,j)-(i+1,j+1) and (i,j+1)-(i+1,j)
      * bend: 2-apart (i,j)-(i,j+2) and (i,j)-(i+2,j)

    ``pinned`` mixes named anchors {"tl","tr","bl","br","top","bottom",
    "left","right","corners"} and integer vertex ids, marking
    vertices with inv_mass = 0 ("pinned mask", BASELINE.json:5) — the
    branch-free pinning mechanism (SURVEY.md C10).  Unknown names raise.
    """
    from .config import SpringParams, XPBDParams

    springs = springs or SpringParams()
    xpbd = xpbd or XPBDParams()

    def vid(i: int, j: int) -> int:
        return i * nx + j

    n = nx * ny
    ii, jj = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    pos = np.zeros((n, 3), dtype=np.float64)
    if orientation == "xz":
        pos[:, 0] = (jj * spacing).ravel()
        pos[:, 1] = 0.0
        pos[:, 2] = (ii * spacing).ravel()
    elif orientation == "xy":
        pos[:, 0] = (jj * spacing).ravel()
        pos[:, 1] = (-ii * spacing).ravel()  # rows hang downward
        pos[:, 2] = 0.0
    else:
        raise ValueError(f"unknown orientation {orientation!r}")
    pos += np.asarray(origin, dtype=np.float64)

    # vectorized edge enumeration (the loop formulation took ~30 s at 262k
    # vertices); _edge_arrays lexsorts, so only the (a, b, class) triple
    # SET and orientations matter, and these match the loop exactly
    ids = np.arange(n, dtype=np.int64).reshape(ny, nx)

    def _pairs(a, b, c):
        t = np.empty((a.size, 3), np.int64)
        t[:, 0] = a.ravel()
        t[:, 1] = b.ravel()
        t[:, 2] = c
        return t

    parts = [
        _pairs(ids[:, :-1], ids[:, 1:], EDGE_STRUCTURAL),     # (i,j)-(i,j+1)
        _pairs(ids[:-1, :], ids[1:, :], EDGE_STRUCTURAL),     # (i,j)-(i+1,j)
    ]
    if shear:
        parts.append(_pairs(ids[:-1, :-1], ids[1:, 1:], EDGE_SHEAR))
        parts.append(_pairs(ids[:-1, 1:], ids[1:, :-1], EDGE_SHEAR))
    if bend:
        if nx > 2:
            parts.append(_pairs(ids[:, :-2], ids[:, 2:], EDGE_BEND))
        if ny > 2:
            parts.append(_pairs(ids[:-2, :], ids[2:, :], EDGE_BEND))
    edge_triples = np.concatenate(parts)

    edges, rest, cls, k, alpha = _edge_arrays(edge_triples, pos, springs, xpbd)
    incident, sign = _build_incidence(n, edges)

    inv_mass = np.full(n, 1.0 / mass, dtype=np.float64)  # mass is per-vertex
    pin_ids: set[int] = set()
    known = {"tl", "tr", "bl", "br", "top", "bottom", "left", "right",
             "corners"}
    for p in pinned:
        if isinstance(p, (int, np.integer)):
            if not 0 <= int(p) < n:
                raise ValueError(f"pinned vertex id {p} out of range [0, {n})")
            pin_ids.add(int(p))
            continue
        if p not in known:
            # a typo here means the cloth the user believes is anchored
            # silently free-falls
            raise ValueError(f"unknown pin spec {p!r}; use one of {sorted(known)} "
                             "or an integer vertex id")
        if p == "tl" or p == "corners":
            pin_ids.add(vid(0, 0))
        if p == "tr" or p == "corners":
            pin_ids.add(vid(0, nx - 1))
        if p == "bl":
            pin_ids.add(vid(ny - 1, 0))
        if p == "br":
            pin_ids.add(vid(ny - 1, nx - 1))
        if p == "top":
            pin_ids.update(vid(0, j) for j in range(nx))
        if p == "bottom":
            pin_ids.update(vid(ny - 1, j) for j in range(nx))
        if p == "left":
            pin_ids.update(vid(i, 0) for i in range(ny))
        if p == "right":
            pin_ids.update(vid(i, nx - 1) for i in range(ny))
    for v in pin_ids:
        inv_mass[v] = 0.0

    # two triangles per quad, row-major, preserving the loop emission order
    if nx > 1 and ny > 1:
        q00 = ids[:-1, :-1]
        q01 = ids[:-1, 1:]
        q10 = ids[1:, :-1]
        q11 = ids[1:, 1:]
        tri2 = np.stack([
            np.stack([q00, q10, q01], axis=-1),
            np.stack([q01, q10, q11], axis=-1),
        ], axis=2)                              # [ny-1, nx-1, 2, 3]
        triangles = tri2.reshape(-1, 3).astype(np.int32)
    else:
        triangles = np.zeros((0, 3), np.int32)

    sc = (
        np.asarray(sphere_centers, dtype=np.float64).reshape(-1, 3)
        if sphere_centers is not None
        else np.zeros((0, 3), np.float64)
    )
    sr = (
        np.asarray(sphere_radii, dtype=np.float64).reshape(-1)
        if sphere_radii is not None
        else np.zeros((0,), np.float64)
    )

    return HostTopology(
        positions0=pos,
        edges=edges,
        rest_length=rest,
        edge_class=cls,
        edge_stiffness=k,
        edge_compliance=alpha,
        inv_mass=inv_mass,
        incident=incident,
        incident_sign=sign,
        tets=np.zeros((0, 4), np.int32),
        rest_volume=np.zeros((0,), np.float64),
        triangles=triangles,
        plane_height=float(plane_height),
        sphere_centers=sc,
        sphere_radii=sr,
        grid_shape=(ny, nx),
        grid_spacing=float(spacing),
        edge_classes_present=tuple(sorted(set(int(c) for c in cls))),
    )


# 5-tet decomposition of a lattice cell, parity-alternated so the diagonals
# of shared faces match between neighbouring cells.
_FIVE = [
    [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1)],
    [(1, 1, 0), (1, 0, 0), (0, 1, 0), (1, 1, 1)],
    [(1, 0, 1), (1, 0, 0), (1, 1, 1), (0, 0, 1)],
    [(0, 1, 1), (0, 1, 0), (0, 0, 1), (1, 1, 1)],
    [(1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 1)],
]
_FIVE_ALT = [
    [(1, 0, 0), (1, 1, 0), (0, 0, 0), (1, 0, 1)],
    [(0, 1, 0), (1, 1, 0), (0, 0, 0), (0, 1, 1)],
    [(0, 0, 1), (0, 0, 0), (1, 0, 1), (0, 1, 1)],
    [(1, 1, 1), (1, 1, 0), (1, 0, 1), (0, 1, 1)],
    [(1, 1, 0), (0, 0, 0), (1, 0, 1), (0, 1, 1)],
]


def tet_cube(
    n: int,
    *,
    spacing: float = 0.1,
    mass: float = 1.0,
    springs=None,
    xpbd=None,
    plane_height: float = 0.0,
    origin: Tuple[float, float, float] = (0.0, 0.5, 0.0),
) -> HostTopology:
    """Volumetric soft-body cube: ``n³`` vertex lattice, each lattice cell
    split into 5 tetrahedra; tet edges become structural springs and tets
    carry rest volumes for the volume-preservation constraint
    (BASELINE.json:10 "tet-mesh edge springs + volume-preservation
    constraint").  :func:`tet_box` with ``n`` vertices on every side.
    """
    return tet_box(n, n, n, spacing=spacing, mass=mass, springs=springs,
                   xpbd=xpbd, plane_height=plane_height, origin=origin)


def tet_box(
    nx: int,
    ny: int,
    nz: int,
    *,
    spacing: float = 0.1,
    mass: float = 1.0,
    springs=None,
    xpbd=None,
    plane_height: float = 0.0,
    origin: Tuple[float, float, float] = (0.0, 0.5, 0.0),
) -> HostTopology:
    """Volumetric soft-body box: an ``nx × ny × nz`` vertex lattice, vertex
    ``(i, j, k)`` at ``origin + spacing (i, j, k)`` with index
    ``(i ny + j) nz + k``, built as :func:`tet_cube` builds the cube; the
    surface triangles cover the faces ``k = 0`` and ``k = nz - 1``."""
    from .config import SpringParams, XPBDParams

    springs = springs or SpringParams()
    xpbd = xpbd or XPBDParams()

    def vid(i: int, j: int, k: int) -> int:
        return (i * ny + j) * nz + k

    nv = nx * ny * nz
    pos = np.zeros((nv, 3), dtype=np.float64)
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                pos[vid(i, j, k)] = (i * spacing, j * spacing, k * spacing)
    pos += np.asarray(origin, dtype=np.float64)

    FIVE, FIVE_ALT = _FIVE, _FIVE_ALT
    tets = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            for k in range(nz - 1):
                pat = FIVE if (i + j + k) % 2 == 0 else FIVE_ALT
                for t in pat:
                    tets.append(
                        tuple(vid(i + di, j + dj, k + dk) for di, dj, dk in t)
                    )
    def tet_vol(t):
        p = pos[np.asarray(t)]
        return float(np.dot(np.cross(p[1] - p[0], p[2] - p[0]), p[3] - p[0]) / 6.0)

    # canonicalize orientation: swap two vertices when the signed volume is
    # negative so every tet has positive rest volume
    tets = [t if tet_vol(t) > 0 else (t[0], t[1], t[3], t[2]) for t in tets]
    tets_arr = np.array(tets, dtype=np.int32) if tets else np.zeros((0, 4), np.int32)
    rest_vol = np.array([tet_vol(t) for t in tets], dtype=np.float64)

    # unique tet edges -> structural springs
    eset = set()
    for t in tets:
        for a in range(4):
            for b in range(a + 1, 4):
                u, v = sorted((t[a], t[b]))
                eset.add((u, v))
    edge_list = [(a, b, EDGE_STRUCTURAL) for a, b in sorted(eset)]
    edges, rest, cls, k, alpha = _edge_arrays(edge_list, pos, springs, xpbd)
    incident, sign = _build_incidence(nv, edges)
    inv_mass = np.full(nv, 1.0 / mass, dtype=np.float64)  # mass is per-vertex

    # surface triangles: boundary faces of the lattice (for normals)
    tris = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            # bottom (k=0) and top (k=nz-1) faces in each axis-aligned plane
            tris.append((vid(i, j, 0), vid(i + 1, j, 0), vid(i, j + 1, 0)))
            tris.append((vid(i + 1, j, 0), vid(i + 1, j + 1, 0), vid(i, j + 1, 0)))
            kk = nz - 1
            tris.append((vid(i, j, kk), vid(i, j + 1, kk), vid(i + 1, j, kk)))
            tris.append((vid(i + 1, j, kk), vid(i, j + 1, kk), vid(i + 1, j + 1, kk)))
    triangles = np.array(tris, dtype=np.int32) if tris else np.zeros((0, 3), np.int32)

    return HostTopology(
        positions0=pos,
        edges=edges,
        rest_length=rest,
        edge_class=cls,
        edge_stiffness=k,
        edge_compliance=alpha,
        inv_mass=inv_mass,
        incident=incident,
        incident_sign=sign,
        tets=tets_arr,
        rest_volume=rest_vol,
        triangles=triangles,
        plane_height=float(plane_height),
        sphere_centers=np.zeros((0, 3), np.float64),
        sphere_radii=np.zeros((0,), np.float64),
        grid_shape=None,
        lattice_shape=(nx, ny, nz),
    )
