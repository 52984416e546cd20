"""What the tet-lattice CUDA kernel wrappers (:mod:`.lattice_euler`,
:mod:`.lattice_verlet`, :mod:`.lattice_xpbd`) share: the gates and the
scene's inputs packed on the card (the collider rows by
:class:`.grid_scene.ColliderRows`, from the topology of each call).

Counterpart of ``softbodyunity_tpu/kernels/pallas_lattice.py``'s gates
(``lattice_applicable``, ``lattice_verlet_applicable``,
``lattice_xpbd_applicable``) without their VMEM budget: on the H100 the
state lives in device memory between launches, so there is no vertex cap.
The TPU kernels burn each group's scalars in as compile-time constants and
carry 0/1 mask planes; here the scalars are a small table on the device and
a vertex's edge and tet ownership bits are one packed ``int32`` word, read
once per launch in place of 19 float planes.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.config import SimConfig, Solver
from ..core.topology import Topology
from ..solver import banded
from .grid_scene import ColliderRows, check_card, check_input
from .stencil import _UNPORTED, check_ported

# The ownership word holds the edge groups in bits 0..15 and the tet groups
# in bits 16..31 (``csrc/lattice_common.cuh``, ``kTetBit``).
MAX_GROUPS = 16
TET_BIT = 16


def use_volume(top: Topology, cfg: SimConfig) -> bool:
    """Whether the substep runs the tet-volume constraint: always for XPBD
    on a mesh with tets, for Euler and Verlet when ``volume_stiffness`` is
    not 0 (``pallas_lattice.py``'s ``use_volume``)."""
    t = top.tet_groups
    if t is None or len(t.deltas) == 0:
        return False
    return cfg.solver == Solver.XPBD or cfg.volume_stiffness != 0.0


def _gate_failure(top: Topology, cfg: SimConfig):
    """Why the lattice path cannot run ``(top, cfg)``, or None."""
    g, t = top.offset_groups, top.tet_groups
    if cfg.self_collision.enabled:
        return "self-collision on a tet scene"
    if cfg.tear.enabled or cfg.plasticity.enabled:
        # the lattice kernels carry no feature planes (nor do the TPU's)
        return "tearing or plasticity on a tet scene"
    if cfg.wind.lift != 0.0:
        # lift needs surface-triangle normals, which the lattice kernels do
        # not compute (nor do the TPU's: pallas_lattice.py:211); the drag
        # alone runs here
        return "wind lift on a tet scene"
    if cfg.strain_limit.enabled:
        # the JAX package runs it on its banded or gather jnp path
        # (kernels/dispatch.py:60-95), never in a lattice kernel
        return "strain limiting on a tet scene"
    if g is None or t is None:
        return "no banded groups were built for this topology"
    if len(g.deltas) == 0 or g.n_residual > 0:
        return f"{g.n_residual} springs outside the delta bands"
    if any(u is None for u in g.uniform):
        return "a spring band with non-uniform stiffness, rest or compliance"
    if t.n_residual > 0:
        return f"{t.n_residual} tets outside the delta patterns"
    if use_volume(top, cfg) and any(u is None for u in t.uniform_rest_volume):
        return "a tet pattern with non-uniform rest volume"
    if len(g.deltas) > MAX_GROUPS or len(t.deltas) > MAX_GROUPS:
        return (f"{len(g.deltas)} spring bands and {len(t.deltas)} tet "
                f"patterns (the packed ownership word holds {MAX_GROUPS} each)")
    return None


def lattice_gate(top: Topology, cfg: SimConfig) -> None:
    """Raise ``NotImplementedError`` unless the tet-lattice path (a kernel
    on the card, its plain version on the CPU) runs ``(top, cfg)``: every
    enabled branch ported, every spring and tet in a uniform band."""
    check_ported(cfg)
    why = _gate_failure(top, cfg)
    if why is not None:
        raise NotImplementedError(
            f"not ported to softbodyunity_torch yet: {why}; such meshes take "
            "the general edge-list path (ROADMAP Queue 1 item 3)")


def _applicable(top: Topology, cfg: SimConfig, solver: Solver) -> bool:
    return (cfg.solver == solver and top.n_tets > 0
            and not any(on(cfg) for _, on, _ in _UNPORTED)
            and _gate_failure(top, cfg) is None)


def lattice_applicable(top: Topology, cfg: SimConfig) -> bool:
    """Whether the Euler lattice kernel runs ``(top, cfg)``."""
    return _applicable(top, cfg, Solver.SEMI_IMPLICIT_EULER)


def lattice_verlet_applicable(top: Topology, cfg: SimConfig) -> bool:
    """Whether the Verlet lattice kernel runs ``(top, cfg)``."""
    return _applicable(top, cfg, Solver.VERLET)


def lattice_xpbd_applicable(top: Topology, cfg: SimConfig) -> bool:
    """Whether the XPBD lattice kernel runs ``(top, cfg)``."""
    return _applicable(top, cfg, Solver.XPBD)


@dataclasses.dataclass(frozen=True)
class LatticeScene:
    """A lattice scene's kernel inputs: fixed from frame to frame, but for
    the collider rows, which each call reads from its topology."""

    device: torch.device
    n: int
    inv_mass: torch.Tensor   # [N]
    bits: torch.Tensor       # i32[N] edge bits 0..15, tet bits 16..31
    edges: torch.Tensor      # [Ge, 3] (delta, k, rest); XPBD (delta, rest,
    #                          compliance)
    tets: torch.Tensor       # [Gt, 4] (d1, d2, d3, rest volume); Gt = 0
    #                          without the volume constraint
    cnt: torch.Tensor        # [N] Euler/Verlet: tet count; XPBD: constraint
    #                          count; at least 1
    colliders: ColliderRows

    @property
    def n_edge(self) -> int:
        return self.edges.shape[0]

    @property
    def n_tet(self) -> int:
        return self.tets.shape[0]


def ownership_bits(top: Topology, with_tets: bool) -> torch.Tensor:
    """Each vertex's edge-group and tet-group mask bits in one int32."""
    bits = torch.zeros(top.n_vertices, dtype=torch.int32, device=top.device)
    for gi in range(len(top.offset_groups.deltas)):
        bits |= (top.offset_groups.mask[gi] != 0).to(torch.int32) << gi
    if with_tets:
        for ti in range(len(top.tet_groups.deltas)):
            bits |= ((top.tet_groups.mask[ti] != 0).to(torch.int32)
                     << (TET_BIT + ti))
    return bits


def pack_lattice_scene(top: Topology, cfg: SimConfig, solver: Solver,
                       kernel: str) -> LatticeScene:
    """Check that ``kernel``, which runs ``solver``, can run ``(top, cfg)``
    on the card, and pack the scene's inputs there."""
    lattice_gate(top, cfg)
    check_card(top, cfg, solver, kernel)
    device = top.device
    n = top.n_vertices
    g, t = top.offset_groups, top.tet_groups
    volume = use_volume(top, cfg)
    f32 = dict(dtype=torch.float32, device=device)
    if solver == Solver.XPBD:
        edges = [(d, rest, c) for d, (_k, rest, c) in zip(g.deltas, g.uniform)]
        cnt = banded.xpbd_constraint_count(top)
    else:
        edges = [(d, k, rest) for d, (k, rest, _c) in zip(g.deltas, g.uniform)]
        cnt = torch.clamp_min(banded.tet_count(t, n, top.dtype, device), 1.0)
    tets = ([(*p, rv) for p, rv in zip(t.deltas, t.uniform_rest_volume)]
            if volume else [])
    check_input("inv_mass", top.inv_mass, (n,), device)
    return LatticeScene(
        device=device, n=n, inv_mass=top.inv_mass,
        bits=ownership_bits(top, volume),
        edges=torch.tensor(edges, **f32).reshape(-1, 3),
        tets=torch.tensor(tets, **f32).reshape(-1, 4),
        cnt=cnt.contiguous(), colliders=ColliderRows(top, cfg))

