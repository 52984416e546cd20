"""Workload presets of the grid-cloth Euler slice, under the JAX package's
names (``softbodyunity_tpu/models/presets.py``).

Each preset returns ``(HostTopology, SimConfig)``; feed the topology to
:func:`softbodyunity_torch.api.init` and the pair to ``step``.  The other
presets of the JAX package come with the slices that port their paths.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

from ..core.config import CollisionParams, SimConfig, Solver, SpringParams
from ..core.topology import HostTopology, cloth_grid

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
