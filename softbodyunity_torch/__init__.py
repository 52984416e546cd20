"""softbodyunity_torch — the soft-body engine on PyTorch and CUDA.

A port of ``softbodyunity_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100,
with the same module layout and names.  The port covers grid cloth and the
volumetric tet cube (banded tet lattices) under the semi-implicit Euler,
Verlet and XPBD solvers with plane, sphere, capsule and oriented-box
contact (static or kinematic, moved between frames by ``move_colliders``),
vertex-vertex self-collision on grid cloth (methods ``block`` and
``dense``), and grid cloth of any size with tearing, plasticity, wind and
strain limiting; each hot
loop is a hand-written CUDA kernel (``kernels/csrc/grid_euler.cu``,
``grid_verlet.cu``, ``grid_xpbd.cu`` for cloth; ``lattice_euler.cu``,
``lattice_verlet.cu``, ``lattice_xpbd.cu`` for lattices; ``block_pairs.cu``
for the block-sparse self-collision pairs), built with nvcc at first use.
On the CPU the same API runs the kernels' plain PyTorch versions.

    import softbodyunity_torch as sb

    host, cfg = sb.presets.build("cloth_bench_64k")   # or "softbody_cube_64k",
                                                      # "cloth_selfcollide_64k"
    top, state = sb.init(host, device="cuda")
    for _ in range(300):
        state = sb.step(top, cfg, state)
    n = sb.normals(top, state)

The package imports torch and numpy, never jax and never
``softbodyunity_tpu``: the card's machine has no JAX.
"""

from .api import init, move_colliders, normals, rollout, step, suggest_dt
from .core.config import (
    CollisionParams,
    MotionConstraintParams,
    PlasticityParams,
    PressureParams,
    SelfCollisionParams,
    ShapeMatchParams,
    SimConfig,
    Solver,
    SpringParams,
    StrainLimitParams,
    TearParams,
    WindParams,
    XPBDParams,
)
from .core.state import State, make_state
from .core.topology import (HostTopology, Topology, add_colliders,
                            cloth_grid, tet_cube)
from .models import presets

__version__ = "0.1.0"
__all__ = [
    "init", "step", "rollout", "normals", "suggest_dt", "move_colliders",
    "SimConfig", "Solver", "SpringParams", "XPBDParams", "WindParams",
    "TearParams", "PlasticityParams", "PressureParams", "ShapeMatchParams",
    "StrainLimitParams", "MotionConstraintParams", "CollisionParams",
    "SelfCollisionParams",
    "State", "make_state", "Topology", "HostTopology", "cloth_grid",
    "tet_cube", "add_colliders",
    "presets",
]
