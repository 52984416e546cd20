"""Scene / solver configuration — a copy of ``softbodyunity_tpu/core/config.py``.

The port cannot import the JAX package (importing any of its submodules runs
``softbodyunity_tpu/__init__.py``, which imports jax), so it carries this
framework-free module as a copy; ``tests/test_torch_port.py`` holds the two
equal field by field.  The class docstrings describe the shared semantics;
the JAX package's oracle (``oracle/reference.py``) stays the binding
definition.

Everything here is plain Python data (ints / floats / tuples / enums), never
tensors: tensors live in :mod:`softbodyunity_torch.core.topology` and
:mod:`softbodyunity_torch.core.state`.  ``SimConfig`` is frozen and hashable,
so it can key caches of built step functions.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class Solver(enum.Enum):
    """Which time-integration scheme drives the substep.

    The reference supports "semi-implicit Euler / Verlet integration (or XPBD
    constraint projection with compliance)" (BASELINE.json:5).
    """

    SEMI_IMPLICIT_EULER = "euler"
    VERLET = "verlet"
    XPBD = "xpbd"


@dataclasses.dataclass(frozen=True)
class SpringParams:
    """Hookean spring + damper coefficients per edge class.

    The reference accumulates "spring-force accumulation over edge lists"
    (BASELINE.json:5); a cloth grid has three edge classes
    (structural / shear / bend, BASELINE.json:8).
    """

    k_structural: float = 800.0
    k_shear: float = 400.0
    k_bend: float = 200.0
    damping: float = 1.0  # spring-axis damper coefficient (shared)


@dataclasses.dataclass(frozen=True)
class XPBDParams:
    """XPBD compliance / iteration parameters (BASELINE.json:9).

    ``compliance_*`` are the alpha values (inverse stiffness, m/N); the solver
    uses alpha_tilde = alpha / dt^2 inside each substep.  ``n_iterations`` is
    the Jacobi-projection iteration count per substep and ``relaxation`` the
    under-relaxation factor omega applied to accumulated Jacobi corrections
    (Jacobi needs omega < 1 to converge on meshes; see SURVEY.md §7).
    """

    compliance_distance: float = 1e-6
    compliance_bend: float = 1e-4
    compliance_volume: float = 0.0
    n_iterations: int = 8
    relaxation: float = 1.0


@dataclasses.dataclass(frozen=True)
class WindParams:
    """Wind / aerodynamic forcing (the Unity WindZone-on-cloth analogue).

    Per-vertex force, added to the spring forces in every solver's force
    evaluation (oracle/reference.py _total_forces is the binding form)::

        v_rel  = velocity - v                 # wind-relative velocity
        f     += drag * v_rel                 # isotropic air drag
        f     += lift * (v_rel . n) * n       # normal-projected (flutter)

    ``n`` is the unit area-weighted vertex normal (C11 semantics).  The
    lift term is what makes cloth billow and flutter; it needs vertex
    normals each substep, which the grid paths compute with rolls and the
    general path with the C11 segment-sum.
    """

    velocity: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    drag: float = 0.0
    lift: float = 0.0

    @property
    def enabled(self) -> bool:
        return self.drag != 0.0 or self.lift != 0.0


@dataclasses.dataclass(frozen=True)
class TearParams:
    """Cloth tearing (the classic Unity soft-body demo feature): an edge
    whose strain exceeds ``strain_limit`` fails PERMANENTLY.

    Semantics (oracle/reference.py is binding): edge liveness is dynamic
    state — ``State.edge_alive`` f32[E] of {0, 1} — threaded through the
    substep.  Dead edges contribute no spring force and no XPBD distance
    constraint (they also leave the Jacobi count).  The tear check runs at
    the END of every substep on the post-collision positions::

        alive *= (length <= rest_length * (1 + strain_limit))

    Shapes stay static (the edge list never changes; liveness is a mask),
    so tearing is jit/vmap/scan-friendly.  Grid cloth tears inside the
    fused Pallas kernels (liveness as per-offset planes in the
    VMEM-resident carry), on the XLA stencil twin, and on the row-sharded
    multi-chip halo paths (planes exchanged with the state); non-grid
    scenes take the exact jnp gather path.
    """

    enabled: bool = False
    strain_limit: float = 0.5   # relative elongation at failure


@dataclasses.dataclass(frozen=True)
class PlasticityParams:
    """Plastic (permanent) deformation — the soft-body "memory foam" /
    bent-metal behaviour: an edge strained past ``yield_strain`` creeps
    its rest length toward the deformed length and keeps the new shape
    when the load is removed.

    Semantics (oracle/reference.py::plastic_update is binding): rest
    scale is dynamic state — ``State.rest_scale`` f32[E], starting at 1 —
    multiplying ``rest_length`` wherever springs or XPBD distance
    constraints read it (and in the tearing strain check, so plastic flow
    delays tearing).  At the END of every substep, before the tear
    check::

        strain = (length - rest*scale) / (rest*scale)
        excess = sign(strain) * max(|strain| - yield_strain, 0)
        scale  = clip(scale * (1 + creep * excess), min_scale, max_scale)

    ``creep`` is a per-substep rate (halve it if you double n_substeps
    for the same flow per frame).  Shapes stay static, so plasticity is
    jit/vmap/scan-friendly; grid scenes carry the scales as per-offset
    planes through the fused Pallas kernels (or the XLA stencil twin,
    kernels/stencil.py plastic_update_grid), irregular meshes take the
    exact jnp gather path (per-edge rest breaks the banded shared-rest
    layout).
    """

    enabled: bool = False
    yield_strain: float = 0.1   # elastic limit (relative elongation)
    creep: float = 0.1          # per-substep flow rate toward the load
    min_scale: float = 0.25     # rest-length scale clamp (sanity bounds)
    max_scale: float = 4.0


@dataclasses.dataclass(frozen=True)
class PressureParams:
    """Closed-shell gas pressure — the classic Unity "inflatable" /
    balloon soft body: a closed triangle shell (or a tet body's surface)
    encloses a gas whose pressure resists volume change.

    Semantics (oracle/reference.py::pressure_forces is binding).  Per
    pressure body ``b`` (see :func:`core.topology.enable_pressure`;
    triangles carry a body id, so merged scenes hold several independent
    gas volumes)::

        V_b = sum_{t in b} dot(x_a, cross(x_b, x_c)) / 6     # signed volume
        P_b = stiffness * (inflation * V0_b / max(V_b, eps) - 1)
        f_i += sum_{t incident to i, t in b} P_b * cross_t / 6

    ``cross_t = (x_b - x_a) x (x_c - x_a)`` is twice the outward area
    vector, so each corner receives ``P * A * n_hat / 3`` — the discrete
    pressure force on the face, split between its vertices.  The ideal-gas
    form ``P ~ 1/V`` stiffens under compression and the net force on a
    closed shell is EXACTLY zero (divergence theorem holds discretely:
    the cross products telescope over a closed mesh), so pressure never
    injects momentum.  ``inflation`` scales the target volume: > 1 pumps
    the balloon up, < 1 deflates it.  Winding is canonicalized outward at
    :func:`enable_pressure` time.
    """

    enabled: bool = False
    stiffness: float = 50.0     # gas stiffness (force per unit relative
    #                             volume error, spread over the surface)
    inflation: float = 1.0      # target volume multiplier vs rest volume


@dataclasses.dataclass(frozen=True)
class ShapeMatchParams:
    """Meshless shape matching (Muller et al., "Meshless Deformations
    Based on Shape Matching") — the other classic Unity soft-body
    technique next to mass-spring/pressure: vertex CLUSTERS remember
    their rest shape and are pulled toward the best-fit rigid transform
    of it every substep, giving rubbery, volume-ish bodies from ANY
    mesh with unconditional stability (goal positions never overshoot).

    Semantics (oracle/reference.py::shape_match_dx is binding).  Per
    cluster k (built by :func:`core.topology.enable_shape_matching`;
    weights ``m_i = 1/inv_mass`` over the cluster's MOVABLE vertices,
    pinned vertices don't participate)::

        c_k  = sum m_i x_i / sum m_i                  # current centroid
        A_k  = sum m_i (x_i - c_k) q_i^T              # q_i = rest offset
        R_k  = rotation part of A_k                   # warm-started APD
        g_i  = R_k q_i + c_k                          # goal positions
        dx_i = stiffness * (g_i - x_i)                # movable only

    Rest offsets use the same mass-weighted rest centroid, so
    ``sum m_i q_i = 0`` and shape matching conserves linear momentum
    exactly (``sum m_i dx_i = 0``); the rotation extraction is the
    branchless warm-started quaternion iteration of Muller et al. 2016
    ("A Robust Method to Extract the Rotational Part of Deformations"),
    ``iterations`` sweeps per substep from the previous substep's
    quaternion (``State.cluster_quat``, populated lazily by api.step).
    Runs after the tet volume projection, before collision, on all
    three solvers; general jnp path (clusters are irregular — the fast
    grid kernels gate off loudly)."""

    enabled: bool = False
    stiffness: float = 1.0      # per-substep pull toward the goal, in [0,1]
    iterations: int = 4         # APD rotation-extraction sweeps per substep


@dataclasses.dataclass(frozen=True)
class StrainLimitParams:
    """Strain limiting (Provot 1995) — the production-cloth hard bound on
    stretch that spring stiffness alone can't give: springs within the
    band stay soft, but no edge may stretch past ``max_stretch`` (or
    compress past ``max_compress``, when set).  Prevents the rubbery
    super-elongation of heavy/fast cloth without exploding dt.

    Semantics (oracle/reference.py::strain_limit_dx is binding).  After
    integration and shape matching, before contact, ``iterations``
    Jacobi sweeps over the edge list::

        L      = |x_b - x_a|
        target = clip(L, rest*(1 - max_compress), rest*(1 + max_stretch))
        C      = L - target                      # 0 inside the band
        dx_a  += w_a / (w_a + w_b) * C * n;  dx_b -= w_b / (w_a + w_b) ...
        x     += dx / count(alive edges at the vertex)   # Jacobi mean

    ``rest`` honours plasticity's rest scale, torn edges are inert, and
    pinned vertices never move (w = 0).  The contact resolve runs after
    and always wins.  On the Euler solver the position change feeds back
    into velocity (``v += dx/dt``); Verlet/XPBD are position-level.
    ``max_compress < 0`` disables the compression bound (cloth folds
    freely — the common setting)."""

    enabled: bool = False
    max_stretch: float = 0.1    # relative elongation bound (0.1 = 10%)
    max_compress: float = -1.0  # relative compression bound; < 0 = off
    iterations: int = 4         # Jacobi sweeps per substep


@dataclasses.dataclass(frozen=True)
class MotionConstraintParams:
    """Per-vertex motion constraints — the Unity Cloth ``maxDistance``
    coefficient: every vertex is tethered inside a sphere of radius
    ``tether_radius[i]`` around its anchor point ``tether_anchor[i]``
    (painted per-vertex in the Unity editor; here set by
    :func:`core.topology.set_motion_constraints`, animated with
    :func:`api.move_tethers`).  The workhorse of character cloth: the
    simulated surface may flutter freely but can never leave the
    animated body by more than the painted slack.

    Semantics (oracle/reference.py::tether_dx is binding).  After
    integration, shape matching and strain limiting, before contact::

        d      = x_i - anchor_i
        excess = max(|d| - radius_i * scale, 0)
        x_i   -= excess * d / |d|                 # movable vertices only

    A radius of ``inf`` leaves a vertex unconstrained; pinned vertices
    never move.  On the Euler solver the clamp feeds back into velocity
    (``v += dx/dt``); Verlet/XPBD are position-level.  The contact
    resolve runs after and always wins (anchors inside a collider do
    not push cloth through it).  ``scale`` is the global slack
    multiplier (Unity's Max Distance scale): 0 hard-welds every
    constrained vertex to its anchor.  Anchors/radii are Topology
    ARRAY data — animate them per frame (skinned-body targets) with
    zero recompiles.  General jnp path on all three solvers (the fast
    grid/lattice kernels gate off loudly)."""

    enabled: bool = False
    scale: float = 1.0          # global multiplier on the painted radii


@dataclasses.dataclass(frozen=True)
class CollisionParams:
    """Environment collision behaviour ("plane/sphere collision resolve",
    BASELINE.json:5).  The collider *geometry* (plane height, sphere
    centers/radii) is array data on :class:`~softbodyunity_tpu.core.topology.Topology`
    so it can differ per batched scene; these are the scalar response knobs.
    """

    restitution: float = 0.0    # normal velocity bounce factor in [0, 1]
    friction: float = 0.2       # tangential velocity damping in [0, 1] on contact
    enable_plane: bool = True
    enable_spheres: bool = False
    # Unity's other standard primitive colliders (CapsuleCollider /
    # BoxCollider); geometry lives on Topology like the spheres.
    enable_capsules: bool = False
    enable_boxes: bool = False
    # mesh colliders via baked signed-distance grids (Unity MeshCollider
    # analogue; bake with core.sdf.sdf_from_mesh, attach via add_colliders)
    enable_sdf: bool = False


@dataclasses.dataclass(frozen=True)
class SelfCollisionParams:
    """Vertex-vertex self-collision via an on-device spatial hash
    (BASELINE.json:5 "on-device spatial hashing so no host round-trips",
    config BASELINE.json:11).

    ``grid_dim`` fixes the (static-shape) hash grid resolution per axis;
    ``max_per_cell`` caps the candidates examined per neighbour cell, keeping
    every shape static under ``jit``.
    """

    enabled: bool = False
    # "block": Morton-tiled block-sparse MXU (large single scenes, 8k+);
    # "hash": sort-based spatial hash; "dense_mxu": MXU pairwise (fastest
    # below ~2-4k vertices/scene); "dense": O(N^2) oracle twin
    method: str = "hash"
    radius: float = 0.05        # repulsion distance between non-neighbour vertices
    stiffness: float = 0.5      # positional correction factor per contact
    cell_size: float = 0.05     # hash/Morton cell edge (should be >= radius)
    grid_dim: int = 64          # cells per axis (grid_dim**3 virtual cells)
    max_per_cell: int = 4       # candidate cap per neighbour cell (static shapes)
    block_partners: int = 8     # method="block": candidate-tile budget per tile
    # method="block": vertices per Morton tile.  256 measured best at
    # 16k-64k: 128 halves the per-pair plane work but doubles the tile
    # count and partner-loop trips, saturates the partner budget sooner,
    # and lost ~5% end-to-end (64k preset, v5e).  Never go below 128 —
    # tile vertices sit on the 128 VPU lanes and a smaller minor dim
    # idles lanes.
    block_size: int = 256


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Full, hashable solver configuration — static under ``jit``.

    Mirrors the reference's MonoBehaviour fields; defaults follow the first
    workload config (BASELINE.json:7).
    """

    solver: Solver = Solver.SEMI_IMPLICIT_EULER
    dt: float = 1.0 / 60.0 / 16.0          # substep dt
    n_substeps: int = 16                   # substeps per `step` call
    gravity: Tuple[float, float, float] = (0.0, -9.81, 0.0)
    global_damping: float = 0.1            # per-second velocity damping rate
    springs: SpringParams = SpringParams()
    xpbd: XPBDParams = XPBDParams()
    collision: CollisionParams = CollisionParams()
    self_collision: SelfCollisionParams = SelfCollisionParams()
    wind: WindParams = WindParams()
    tear: TearParams = TearParams()
    plasticity: PlasticityParams = PlasticityParams()
    pressure: PressureParams = PressureParams()
    shape_match: ShapeMatchParams = ShapeMatchParams()
    strain_limit: StrainLimitParams = StrainLimitParams()
    motion: MotionConstraintParams = MotionConstraintParams()
    # Volume preservation for tet meshes (BASELINE.json:10): PBD-style
    # projection strength in [0,1] applied after integration when tets exist.
    volume_stiffness: float = 1.0
    backend: str = "auto"                  # "auto" | "jnp" | "stencil" | "pallas"

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)
