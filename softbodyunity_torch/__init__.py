"""softbodyunity_torch — the soft-body engine on PyTorch and CUDA.

A port of ``softbodyunity_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100,
with the same module layout and names.  This slice covers the grid-cloth
semi-implicit Euler path with plane and sphere contact; its hot loop is the
hand-written CUDA kernel ``kernels/csrc/grid_euler.cu``, built with nvcc at
first use.  On the CPU the same API runs the kernel's plain PyTorch version.

    import softbodyunity_torch as sb

    host, cfg = sb.presets.build("cloth_bench_64k")
    top, state = sb.init(host, device="cuda")
    for _ in range(300):
        state = sb.step(top, cfg, state)
    n = sb.normals(top, state)

The package imports torch and numpy, never jax and never
``softbodyunity_tpu``: the card's machine has no JAX.
"""

from .api import init, normals, rollout, step, suggest_dt
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
from .core.topology import HostTopology, Topology, cloth_grid
from .models import presets

__version__ = "0.1.0"
__all__ = [
    "init", "step", "rollout", "normals", "suggest_dt",
    "SimConfig", "Solver", "SpringParams", "XPBDParams", "WindParams",
    "TearParams", "PlasticityParams", "PressureParams", "ShapeMatchParams",
    "StrainLimitParams", "MotionConstraintParams", "CollisionParams",
    "SelfCollisionParams",
    "State", "make_state", "Topology", "HostTopology", "cloth_grid",
    "presets",
]
