"""Workload presets of the grid-cloth (any size, with and without
self-collision, tearing, plasticity, wind and strain limiting) and tet-cube
slices (Euler, Verlet, XPBD), under the JAX package's names (``softbodyunity_tpu/models/presets.py``).

Each preset returns ``(HostTopology, SimConfig)``; feed the topology to
:func:`softbodyunity_torch.api.init` and the pair to ``step``.  The other
presets of the JAX package come with the slices that port their paths.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

from ..core.config import (CollisionParams, PlasticityParams,
                           SelfCollisionParams, SimConfig, Solver,
                           SpringParams, StrainLimitParams, TearParams,
                           WindParams, XPBDParams)
from ..core.topology import HostTopology, cloth_grid, tet_cube

_REGISTRY: Dict[str, Callable[[], Tuple[HostTopology, SimConfig]]] = {}


def register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def names():
    return sorted(_REGISTRY)


def build(name: str) -> Tuple[HostTopology, SimConfig]:
    return _REGISTRY[name]()


@register("cloth_32_euler")
def cloth_32_euler():
    """BASELINE.json:7 — '32x32 cloth grid: structural springs, semi-implicit
    Euler, ground-plane collision'."""
    cfg = SimConfig(
        solver=Solver.SEMI_IMPLICIT_EULER,
        springs=SpringParams(k_structural=600.0, damping=0.5),
        collision=CollisionParams(enable_plane=True, friction=0.3),
        global_damping=0.2,
    )
    top = cloth_grid(
        32, 32, spacing=0.05, shear=False, bend=False,
        springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=-0.4, origin=(0.0, 0.0, 0.0), orientation="xz",
    )
    return top, cfg


@register("cloth_hanging_sphere")
def cloth_hanging_sphere():
    """BASELINE.json:8 — 'Pinned-corner hanging cloth with structural/shear/
    bend springs + sphere collider'."""
    cfg = SimConfig(
        solver=Solver.SEMI_IMPLICIT_EULER,
        springs=SpringParams(k_structural=800.0, k_shear=400.0, k_bend=150.0, damping=0.8),
        collision=CollisionParams(enable_plane=True, enable_spheres=True, friction=0.2),
        global_damping=0.3,
    )
    top = cloth_grid(
        32, 32, spacing=0.05, shear=True, bend=True,
        pinned=("tl", "tr"),
        springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=-3.0,
        sphere_centers=np.array([[0.8, -1.0, 0.15]]),
        sphere_radii=np.array([0.35]),
        origin=(0.0, 0.0, 0.0), orientation="xy",
    )
    return top, cfg


@register("cloth_xpbd")
def cloth_xpbd():
    """BASELINE.json:9 — 'XPBD cloth: distance + bending constraints with
    compliance, substepped Jacobi solver'."""
    cfg = SimConfig(
        solver=Solver.XPBD,
        xpbd=XPBDParams(
            compliance_distance=1e-6,
            compliance_bend=5e-4,
            n_iterations=8,
            relaxation=1.0,
        ),
        collision=CollisionParams(enable_plane=True),
        global_damping=0.2,
    )
    top = cloth_grid(
        32, 32, spacing=0.05, shear=True, bend=True,
        pinned=("tl", "tr"),
        springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=-3.0, origin=(0.0, 0.0, 0.0), orientation="xy",
    )
    return top, cfg


@register("cloth_bench_64k")
def cloth_bench_64k():
    """Headline benchmark scene: 256x256 = 65,536-vertex curtain pinned along
    the top row, structural/shear/bend springs, Euler, ground plane below the
    cloth's reach.  Per-vertex mass 0.01 kg and damping 2.0/s let it settle
    to |v| = 0 within ~300 frames, so an f32-vs-f64 comparison measures
    solver error rather than phase drift; the BASELINE.json:5 bound (<= 1e-3
    positional drift over 1k steps) is checked on this scene.  The JAX
    package's docstring gives the measurements behind these choices."""
    cfg = SimConfig(
        solver=Solver.SEMI_IMPLICIT_EULER,
        springs=SpringParams(k_structural=800.0, k_shear=400.0, k_bend=150.0, damping=0.8),
        collision=CollisionParams(enable_plane=True, friction=0.2),
        global_damping=2.0,
        backend="auto",
    )
    top = cloth_grid(
        256, 256, spacing=0.01, mass=0.01, shear=True, bend=True,
        pinned=("top",),
        springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=-8.0, origin=(0.0, 0.0, 0.0), orientation="xy",
    )
    return top, cfg


@register("cloth_batch_rl")
def cloth_batch_rl():
    """BASELINE.json:11 — '1024-scene vmapped cloth batch with spatial-hash
    self-collision for RL rollouts'.  Returns ONE 16x16 scene.  Its shipping
    self-collision method ``dense_mxu`` (the MXU pairwise form) and the batch
    are not ported yet (ROADMAP Queue 1 item 5): stepping it as shipped
    raises; replace the method with ``dense`` or ``block`` to run it."""
    cfg = SimConfig(
        solver=Solver.SEMI_IMPLICIT_EULER,
        springs=SpringParams(k_structural=600.0, k_shear=300.0, damping=0.5),
        collision=CollisionParams(enable_plane=True, friction=0.3),
        global_damping=0.2,
        self_collision=SelfCollisionParams(
            enabled=True, method="dense_mxu", radius=0.03, stiffness=40.0,
            cell_size=0.03, grid_dim=32, max_per_cell=4,
        ),
        n_substeps=8,
    )
    top = cloth_grid(
        16, 16, spacing=0.04, shear=True, bend=False,
        pinned=("tl", "tr"),
        springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=-1.0, origin=(0.0, 0.0, 0.0), orientation="xy",
    )
    return top, cfg


@register("cloth_selfcollide_16k")
def cloth_selfcollide_16k():
    """Large single-scene self-collision: a 128x128 = 16,384-vertex curtain
    pinned along the top, folding onto itself under gravity, on the
    block-sparse Morton-tiled path.  block_partners = 64 = the tile count,
    so the partner budget can never overflow."""
    spacing = 0.01
    cfg = SimConfig(
        solver=Solver.SEMI_IMPLICIT_EULER,
        springs=SpringParams(k_structural=800.0, k_shear=400.0, damping=0.8),
        collision=CollisionParams(enable_plane=True, friction=0.3),
        global_damping=1.0,
        self_collision=SelfCollisionParams(
            enabled=True, method="block", radius=0.008, stiffness=60.0,
            cell_size=0.016, block_partners=64,
        ),
    )
    top = cloth_grid(
        128, 128, spacing=spacing, mass=0.01, shear=True, bend=False,
        pinned=("top",),
        springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=-0.9, origin=(0.0, 0.0, 0.0), orientation="xy",
    )
    return top, cfg


@register("cloth_selfcollide_64k")
def cloth_selfcollide_64k():
    """64k-vertex self-colliding curtain (256x256) on the block-sparse path:
    the dense rule would be 4.3 billion pairs.  ``cell_size`` is the Morton
    sort granularity (0.32: each cell holds ~4 whole tiles, so tiles stay
    compact); ``block_partners`` = 96 covers the heavy partner tail of the
    draping curtain (the JAX package's docstring gives the measurements)."""
    cfg = SimConfig(
        solver=Solver.SEMI_IMPLICIT_EULER,
        springs=SpringParams(k_structural=800.0, k_shear=400.0, damping=0.8),
        collision=CollisionParams(enable_plane=True, friction=0.3),
        global_damping=1.0,
        self_collision=SelfCollisionParams(
            enabled=True, method="block", radius=0.008, stiffness=60.0,
            cell_size=0.32, block_partners=96,
        ),
    )
    top = cloth_grid(
        256, 256, spacing=0.01, mass=0.01, shear=True, bend=False,
        pinned=("top",),
        springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=-2.2, origin=(0.0, 0.0, 0.0), orientation="xy",
    )
    return top, cfg


@register("cloth_bench_64k_xpbd")
def cloth_bench_64k_xpbd():
    """XPBD variant of the headline 64k benchmark scene (BASELINE.json:9
    constraints at BASELINE.json:5 scale): distance + bending compliance,
    8 Jacobi iterations per substep."""
    cfg = SimConfig(
        solver=Solver.XPBD,
        xpbd=XPBDParams(
            compliance_distance=1e-6,
            compliance_bend=5e-4,
            n_iterations=8,
            relaxation=1.0,
        ),
        collision=CollisionParams(enable_plane=True),
        global_damping=0.2,
        backend="auto",
    )
    top = cloth_grid(
        256, 256, spacing=0.01, mass=0.01, shear=True, bend=True,
        pinned=("top",),
        springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=-8.0, origin=(0.0, 0.0, 0.0), orientation="xy",
    )
    return top, cfg


@register("cloth_bench_64k_verlet")
def cloth_bench_64k_verlet():
    """Verlet variant of the headline 64k benchmark scene (BASELINE.json:5
    'Euler / Verlet').  Axial damping 0.1: the v-estimate damper
    destabilizes explicit Verlet beyond ~0.2 (the JAX package's docstring
    gives the measurement); global damping carries the dissipation
    instead."""
    cfg = SimConfig(
        solver=Solver.VERLET,
        springs=SpringParams(k_structural=800.0, k_shear=400.0, k_bend=150.0, damping=0.1),
        collision=CollisionParams(enable_plane=True, friction=0.2),
        global_damping=2.0,
        backend="auto",
    )
    top = cloth_grid(
        256, 256, spacing=0.01, mass=0.01, shear=True, bend=True,
        pinned=("top",),
        springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=-8.0, origin=(0.0, 0.0, 0.0), orientation="xy",
    )
    return top, cfg


@register("softbody_cube")
def softbody_cube():
    """BASELINE.json:10 — 'Volumetric softbody cube: tet-mesh edge springs +
    volume-preservation constraint'.  Drops onto the ground plane."""
    cfg = SimConfig(
        solver=Solver.SEMI_IMPLICIT_EULER,
        springs=SpringParams(k_structural=1500.0, damping=2.0),
        collision=CollisionParams(enable_plane=True, friction=0.4),
        global_damping=0.5,
        volume_stiffness=0.5,
    )
    top = tet_cube(
        6, spacing=0.08, springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=0.0, origin=(0.0, 0.4, 0.0),
    )
    return top, cfg


@register("softbody_cube_xpbd_sub")
def softbody_cube_xpbd_sub():
    """Small substepped-XPBD tet cube for the oracle-parity tier: one Jacobi
    iteration per substep with proportionally more, shorter substeps (32 per
    frame), XPBD's own recommendation (Macklin et al. 2019, "Small Steps in
    Physics Simulation")."""
    cfg = SimConfig(
        solver=Solver.XPBD,
        dt=1.0 / 60.0 / 32.0,
        n_substeps=32,
        xpbd=XPBDParams(
            compliance_distance=1e-6,
            compliance_volume=1e-7,
            n_iterations=1,
            relaxation=1.0,
        ),
        collision=CollisionParams(enable_plane=True, friction=0.4),
        global_damping=0.5,
    )
    top = tet_cube(
        6, spacing=0.08, springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=0.0, origin=(0.0, 0.4, 0.0),
    )
    return top, cfg


@register("softbody_cube_64k")
def softbody_cube_64k():
    """Scale variant of BASELINE.json:10: 40^3 = 64,000-vertex tet cube
    (296k tets, 370k edge springs) dropping onto the ground plane, the
    volumetric counterpart of the 64k cloth benchmark: 9 edge delta groups,
    10 tet delta patterns, no residual elements."""
    cfg = SimConfig(
        solver=Solver.SEMI_IMPLICIT_EULER,
        springs=SpringParams(k_structural=500.0, damping=0.5),
        collision=CollisionParams(enable_plane=True, friction=0.4),
        global_damping=0.5,
        volume_stiffness=0.5,
    )
    top = tet_cube(
        40, spacing=0.02, mass=0.01, springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=0.0, origin=(0.0, 1.0, 0.0),
    )
    return top, cfg


@register("softbody_cube_64k_verlet")
def softbody_cube_64k_verlet():
    """Verlet variant of the 64k tet cube: damped position update, banded
    volume projection, position-only contact."""
    cfg = SimConfig(
        solver=Solver.VERLET,
        springs=SpringParams(k_structural=500.0, damping=0.5),
        collision=CollisionParams(enable_plane=True, friction=0.4),
        global_damping=0.5,
        volume_stiffness=0.5,
    )
    top = tet_cube(
        40, spacing=0.02, mass=0.01, springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=0.0, origin=(0.0, 1.0, 0.0),
    )
    return top, cfg


@register("softbody_cube_64k_xpbd")
def softbody_cube_64k_xpbd():
    """XPBD variant of the 64k tet cube: distance and volume compliance
    constraints, 8 Jacobi iterations per substep."""
    cfg = SimConfig(
        solver=Solver.XPBD,
        xpbd=XPBDParams(
            compliance_distance=1e-6,
            compliance_volume=1e-7,
            n_iterations=8,
            relaxation=1.0,
        ),
        collision=CollisionParams(enable_plane=True, friction=0.4),
        global_damping=0.5,
    )
    top = tet_cube(
        40, spacing=0.02, mass=0.01, springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=0.0, origin=(0.0, 1.0, 0.0),
    )
    return top, cfg


@register("cloth_bench_1m")
def cloth_bench_1m():
    """Scaling showcase: 1024x1024 = 1,048,576-vertex curtain (6.3M springs).

    dt = 1/1920 (32 substeps/frame): explicit integration needs dt to
    shrink with the spacing (half the 64k preset's spacing and mass
    doubles the spring frequency; the 64k dt of 1/960 is past the
    stability edge here: the JAX package's curtain NaN'd by frame 12
    before this)."""
    cfg = SimConfig(
        solver=Solver.SEMI_IMPLICIT_EULER,
        springs=SpringParams(k_structural=800.0, k_shear=400.0, k_bend=150.0, damping=0.8),
        collision=CollisionParams(enable_plane=True, friction=0.2),
        global_damping=2.0,
        dt=1.0 / 60.0 / 32.0,
        n_substeps=32,
        backend="auto",
    )
    top = cloth_grid(
        1024, 1024, spacing=0.005, mass=0.005, shear=True, bend=True,
        pinned=("top",),
        springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=-30.0, origin=(0.0, 0.0, 0.0), orientation="xy",
    )
    return top, cfg


@register("cloth_bench_262k")
def cloth_bench_262k():
    """512x512 = 262,144-vertex curtain, the first stop past the TPU's
    whole-VMEM kernel cap of 128k vertices.  dt = 1/1920: see
    cloth_bench_1m (same spacing; the 64k dt is unstable at this
    resolution)."""
    cfg = SimConfig(
        solver=Solver.SEMI_IMPLICIT_EULER,
        springs=SpringParams(k_structural=800.0, k_shear=400.0, k_bend=150.0,
                             damping=0.8),
        collision=CollisionParams(enable_plane=True, friction=0.2),
        global_damping=2.0,
        dt=1.0 / 60.0 / 32.0,
        n_substeps=32,
        backend="auto",
    )
    top = cloth_grid(
        512, 512, spacing=0.005, mass=0.005, shear=True, bend=True,
        pinned=("top",),
        springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=-15.0, origin=(0.0, 0.0, 0.0), orientation="xy",
    )
    return top, cfg


@register("cloth_tearing_64k")
def cloth_tearing_64k():
    """64k-vertex banner that rips under its own weight (TearParams): edge
    liveness rides as per-offset planes through the grid kernels."""
    cfg = SimConfig(
        solver=Solver.SEMI_IMPLICIT_EULER,
        springs=SpringParams(k_structural=300.0, k_shear=150.0, k_bend=60.0,
                             damping=0.3),
        tear=TearParams(enabled=True, strain_limit=0.05),
        global_damping=0.1,
    )
    top = cloth_grid(
        256, 256, spacing=0.01, shear=True, bend=True, pinned=("top",),
        springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=-50.0, origin=(0.0, 0.0, 0.0), orientation="xy",
    )
    return top, cfg


@register("cloth_plastic_64k")
def cloth_plastic_64k():
    """64k-vertex awning that sags permanently under load
    (PlasticityParams): rest-length scales ride as per-offset planes
    through the grid kernels."""
    cfg = SimConfig(
        solver=Solver.SEMI_IMPLICIT_EULER,
        springs=SpringParams(k_structural=800.0, k_shear=400.0, k_bend=150.0,
                             damping=0.8),
        plasticity=PlasticityParams(enabled=True, yield_strain=0.03,
                                    creep=0.05),
        global_damping=0.5,
    )
    top = cloth_grid(
        256, 256, spacing=0.01, shear=True, bend=True, pinned=("top",),
        springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=-50.0, origin=(0.0, 0.0, 0.0), orientation="xy",
    )
    return top, cfg


@register("cloth_tearing_262k")
def cloth_tearing_262k():
    """512x512 = 262k-vertex ripping banner, past the TPU's whole-VMEM
    tearing cap (64k): there it runs the row-tiled kernels, whose liveness
    planes tear at launch start, as the port's grid kernels do at any
    size."""
    cfg = SimConfig(
        solver=Solver.SEMI_IMPLICIT_EULER,
        springs=SpringParams(k_structural=300.0, k_shear=150.0, k_bend=60.0,
                             damping=0.3),
        tear=TearParams(enabled=True, strain_limit=0.05),
        global_damping=0.1,
    )
    top = cloth_grid(
        512, 512, spacing=0.005, shear=True, bend=True, pinned=("top",),
        springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=-50.0, origin=(0.0, 0.0, 0.0), orientation="xy",
    )
    return top, cfg


@register("cloth_plastic_262k")
def cloth_plastic_262k():
    """512x512 = 262k-vertex permanently sagging banner, past the TPU's
    whole-VMEM plasticity cap (64k): there it runs the row-tiled kernels,
    whose rest-scale planes flow at launch start, as the port's grid
    kernels do at any size."""
    cfg = SimConfig(
        solver=Solver.SEMI_IMPLICIT_EULER,
        springs=SpringParams(k_structural=300.0, k_shear=150.0, k_bend=60.0,
                             damping=0.3),
        plasticity=PlasticityParams(enabled=True, yield_strain=0.03,
                                    creep=0.05),
        global_damping=0.1,
    )
    top = cloth_grid(
        512, 512, spacing=0.005, shear=True, bend=True, pinned=("top",),
        springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=-50.0, origin=(0.0, 0.0, 0.0), orientation="xy",
    )
    return top, cfg


@register("cloth_strain_limited")
def cloth_strain_limited():
    """Strain-limited hanging banner (StrainLimitParams semantics; oracle
    strain_limit_dx is binding): deliberately SOFT springs would stretch
    >40% under gravity — the 10% hard limit holds the weave together
    (the production-cloth stretch bound).  Pins down the Jacobi edge
    clamp against the oracle in the golden/f64 tiers."""
    cfg = SimConfig(
        solver=Solver.SEMI_IMPLICIT_EULER,
        strain_limit=StrainLimitParams(enabled=True, max_stretch=0.1),
        springs=SpringParams(k_structural=25.0, k_shear=12.0, k_bend=5.0,
                             damping=0.5),
        global_damping=0.5,
    )
    host = cloth_grid(
        16, 16, spacing=0.06, mass=0.05, pinned=("top",), shear=True,
        bend=True, springs=cfg.springs, xpbd=cfg.xpbd, plane_height=-50.0,
        orientation="xy",
    )
    return host, cfg


@register("cloth_strain_64k")
def cloth_strain_64k():
    """64k cloth with strain limiting (soft springs, 10% hard bound): the
    sweeps run in the grid kernels' strain-sweep launches."""
    cfg = SimConfig(
        solver=Solver.SEMI_IMPLICIT_EULER,
        strain_limit=StrainLimitParams(enabled=True, max_stretch=0.1),
        springs=SpringParams(k_structural=60.0, k_shear=30.0, k_bend=12.0,
                             damping=0.4),
        global_damping=0.3,
    )
    top = cloth_grid(
        256, 256, spacing=0.01, mass=0.02, pinned=("top",), shear=True,
        bend=True, springs=cfg.springs, xpbd=cfg.xpbd, plane_height=-50.0,
        orientation="xy",
    )
    return top, cfg


@register("cloth_wind_64k")
def cloth_wind_64k():
    """64k cloth in a strong cross-wind (WindParams drag + lift): the lift
    normals are computed from each vertex's 1-ring inside the grid kernels
    every substep."""
    cfg = SimConfig(
        solver=Solver.SEMI_IMPLICIT_EULER,
        springs=SpringParams(k_structural=800.0, k_shear=400.0,
                             k_bend=150.0, damping=0.8),
        wind=WindParams(velocity=(3.0, 0.0, 1.0), drag=0.3, lift=0.8),
        collision=CollisionParams(enable_plane=True, friction=0.2),
        global_damping=0.3,
    )
    top = cloth_grid(
        256, 256, spacing=0.01, shear=True, bend=True, pinned=("top",),
        springs=cfg.springs, xpbd=cfg.xpbd,
        plane_height=-50.0, origin=(0.0, 0.0, 0.0), orientation="xy",
    )
    return top, cfg
