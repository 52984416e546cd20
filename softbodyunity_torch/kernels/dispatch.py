"""Backend dispatch: pick the step function for a scene.

Counterpart of ``softbodyunity_tpu/kernels/dispatch.py::maybe_fast_step``
for the paths ported so far: grid cloth and banded tet lattices, each under
the Euler, Verlet and XPBD solvers.  The device the topology's tensors live
on decides: CUDA runs the solver's hand-written kernel, the CPU runs the
plain PyTorch version (:func:`.stencil.make_stencil_step`,
:func:`softbodyunity_torch.solver.step.make_plain_step`).  Anything else
raises ``NotImplementedError`` naming the ROADMAP item that ports it;
nothing degrades to another path.

Which TPU kernels (``PERF.md``'s table) each CUDA kernel stands for:

- ``grid_euler`` for #1 (``pallas_substep.py::_pallas_substeps``, whole
  state in VMEM, up to 128k vertices) and #4
  (``pallas_tiled.py::_tiled_substeps``, row tiles past that cap);
- ``grid_verlet`` for #2 (``_pallas_verlet_substeps``) and #5
  (``_tiled_verlet_substeps``);
- ``grid_xpbd`` for #3 (``pallas_xpbd.py::_pallas_xpbd_substeps``) and #6
  (``_tiled_xpbd_substeps``);
- ``lattice_euler``, ``lattice_xpbd``, ``lattice_verlet`` for #7-9;
- ``block_pairs`` for #10.

The JAX dispatcher picks between #1-3 and #4-6 by the vertex count, the cap
halved by each of tearing and plasticity, since their planes share VMEM with
the state.  The grid kernels here keep the state in device memory between
launches and have no cap: every grid scene, of any size and with or without
tear and plastic planes, takes its solver's kernel, and that kernel runs the
row-tiled kernels' launch-start form of the feature planes
(:mod:`.grid_features`).

Grid scenes with self-collision (methods ``block`` and ``dense``) take the
grid path too, on either device: each substep computes the repulsion as a
``[3, ny, nx]`` force plane (method ``block`` on the card: the
``block_pairs`` kernel, :mod:`.blocks`), and the solver's grid kernel adds
it where the JAX package's general path adds ``self_collision_force``.  The
JAX dispatcher sends such scenes off its fused grid kernels instead
(``softbodyunity_tpu/kernels/dispatch.py:168-169``), because those keep the
whole state in VMEM and have no input for an outside force; these kernels
read the plane from device memory like the rest of their state.  Routing as
the TPU does would put the plain spring code on the card's main path.

Wind and the strain limit run on the grid kernels of every solver, as on
the TPU's fused and row-tiled kernels (wind also with self-collision, where
the force plane and the wind force add), and the wind's drag on the lattice
kernels.  Capsule and oriented-box contact, static or kinematic, runs in
all six grid and lattice kernels and their plain versions, after the plane
and the spheres, with every other branch, as in TPU kernels #1-9; the rows
are read from the topology of each call, so a collider moved between frames
(:func:`softbodyunity_torch.api.move_colliders`) builds no new step
function.  SDF colliders still raise (ROADMAP Queue 1 item 6).  What the JAX package runs only on its general jnp path raises,
naming ROADMAP Queue 1 item 3: wind lift and the strain limit on tet
lattices (``pallas_lattice.py:211``, ``softbodyunity_tpu/kernels/
dispatch.py:60-95``) and the strain limit with self-collision
(:func:`.stencil.check_grid_ported`).
"""

from __future__ import annotations

import importlib

from ..core.config import SimConfig, Solver
from ..core.topology import Topology
from .stencil import check_ported, make_stencil_step

# the CUDA wrapper of each solver, a module <kind>_<solver> for each kind of
# scene (grid, lattice); any other solver takes the Euler wrapper, which
# refuses it
_SOLVERS = {Solver.XPBD: "xpbd", Solver.VERLET: "verlet"}


def _step(top: Topology, cfg: SimConfig, kind: str, make_plain_step):
    if top.device.type == "cuda":
        name = f"{kind}_{_SOLVERS.get(cfg.solver, 'euler')}"
        return importlib.import_module(f"{__package__}.{name}").make_cuda_step(
            top, cfg)
    if top.device.type == "cpu":
        return make_plain_step(top, cfg)
    raise NotImplementedError(f"no step function for tensors on {top.device}")


def _lattice_step(top: Topology, cfg: SimConfig):
    from ..solver.step import make_plain_step
    from .lattice import lattice_gate

    lattice_gate(top, cfg)
    return _step(top, cfg, "lattice", make_plain_step)


def maybe_fast_step(top: Topology, cfg: SimConfig):
    """Return ``fn(state, dt, n_substeps) -> state`` for ``(top, cfg)``, or
    raise.  Unlike the JAX dispatcher it never returns ``None``: the general
    edge-list path it would fall back to is not ported yet."""
    check_ported(cfg)
    if cfg.backend == "jnp":
        raise NotImplementedError(
            "not ported to softbodyunity_torch yet: backend='jnp', the "
            "general edge-list path (ROADMAP Queue 1 item 3)")
    if top.n_tets > 0:
        # volumetric lattices: the banded tet-lattice kernels
        return _lattice_step(top, cfg)
    if top.grid_shape is None or top.grid_spacing is None:
        raise NotImplementedError(
            "not ported to softbodyunity_torch yet: the general edge-list "
            "path for scenes that are neither grid cloth nor tet lattices "
            "(ROADMAP Queue 1 item 3)")
    return _step(top, cfg, "grid", make_stencil_step)
