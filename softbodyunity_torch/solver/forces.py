"""Pair forces in plain PyTorch.

Counterpart of ``softbodyunity_tpu/solver/forces.py``: so far only its
dense self-collision rule, which the JAX package runs as plain XLA ops (no
kernel), so it runs here on either device, and the self-collision force
planes of the plain grid substeps.  The spring gathers come with the
general edge-list path (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import torch

from ..core.config import SimConfig
from ..utils import profiling
from .blocksparse import self_collision_forces_block

# Most bytes of the [rows, N, 3] difference tensor the dense rule forms at
# once: all 16,384 rows of a 128x128 sheet would take 3.2 GB
DENSE_CHUNK_BYTES = 1 << 28


def self_collision_forces_dense(x: torch.Tensor, radius: float,
                                stiffness: float) -> torch.Tensor:
    """Brute-force O(N^2) pairwise repulsion on ``x`` [N, 3]: every pair
    closer than ``radius`` pushes apart with ``stiffness * overlap``.  The
    oracle rule, with the JAX package's operations in its order.

    The rows are evaluated in chunks whose difference tensor fits
    :data:`DENSE_CHUNK_BYTES` (one chunk up to ~4,700 vertices in float32);
    each row's terms are the same either way."""
    n = x.shape[0]
    rows = max(1, min(n, DENSE_CHUNK_BYTES // (3 * n * x.element_size())))
    out = []
    for r0 in range(0, n, rows):
        r1 = min(r0 + rows, n)
        diff = x[None, :, :] - x[r0:r1, None, :]                # [R, N, 3]
        dist = torch.sqrt(torch.sum(diff * diff, dim=-1))
        eye = (torch.arange(r0, r1, device=x.device)[:, None]
               == torch.arange(n, device=x.device)[None, :])
        dist = torch.where(eye, torch.inf, dist)
        overlap = radius - dist
        active = overlap > 0.0
        dirs = diff / torch.clamp_min(dist, 1e-12)[:, :, None]
        f = -(stiffness * torch.where(active, overlap, 0.0))[:, :, None] * dirs
        out.append(torch.sum(f, dim=1))
    return torch.cat(out) if len(out) > 1 else out[0]


def self_collision_planes(cfg: SimConfig):
    """``fn(x3) -> [3, ny, nx]`` self-collision force planes of the
    positions ``x3`` [3, ny, nx] in plain PyTorch, or None when
    self-collision is off: method ``dense`` the rule above, method ``block``
    the plain version of the pair kernel
    (:func:`.blocksparse.self_collision_forces_block`).  The methods that
    are not ported (``hash``, ``dense_mxu``) are refused earlier, by
    ``kernels.stencil.check_ported``."""
    sc = cfg.self_collision
    if not sc.enabled:
        return None
    if sc.method == "dense":
        def rule(x):
            return self_collision_forces_dense(x, sc.radius, sc.stiffness)
    elif sc.method == "block":
        def rule(x):
            return self_collision_forces_block(x, sc)
    else:
        raise ValueError(
            f"unknown self-collision method {sc.method!r}; use 'block', "
            "'hash', 'dense_mxu', or 'dense'")

    def planes(x3):
        sp = profiling.begin("selfcollide") if profiling.on else -1
        f = rule(x3.reshape(3, -1).t()).t().reshape(x3.shape).contiguous()
        if sp >= 0:
            profiling.end(sp)
        return f

    return planes
