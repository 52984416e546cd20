"""Backend dispatch: pick the step function for a scene.

Counterpart of ``softbodyunity_tpu/kernels/dispatch.py::maybe_fast_step``
for the paths ported so far.  The device the topology's tensors live on
decides: CUDA runs the hand-written kernel, the CPU runs its plain PyTorch
version.  Anything else raises ``NotImplementedError`` naming the ROADMAP
item that ports it; nothing degrades to another path.
"""

from __future__ import annotations

from ..core.config import SimConfig
from ..core.topology import Topology
from .stencil import check_ported


def maybe_fast_step(top: Topology, cfg: SimConfig):
    """Return ``fn(state, dt, n_substeps) -> state`` for ``(top, cfg)``, or
    raise.  Unlike the JAX dispatcher it never returns ``None``: the general
    edge-list path it would fall back to is not ported yet."""
    check_ported(cfg)
    if cfg.backend == "jnp" or top.grid_shape is None or top.grid_spacing is None:
        raise NotImplementedError(
            "not ported to softbodyunity_torch yet: the general edge-list "
            "path for non-grid scenes or backend='jnp' (ROADMAP Queue 1 "
            "item 3)")
    if top.device.type == "cuda":
        from .grid_euler import make_cuda_step

        return make_cuda_step(top, cfg)
    if top.device.type == "cpu":
        from .stencil import make_stencil_step

        return make_stencil_step(top, cfg)
    raise NotImplementedError(f"no step function for tensors on {top.device}")
