"""Vertex-normal recompute for rendering (Unity ``RecalculateNormals``
analogue): area-weighted face normals summed to vertices, then normalized.
Counterpart of ``softbodyunity_tpu/solver/normals.py``; runs once per
rendered frame, outside the substep loop.
"""

from __future__ import annotations

import torch


def vertex_normals(triangles: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Area-weighted unit vertex normals ``[N, 3]`` of the mesh
    ``triangles`` (int64 ``[F, 3]``) at positions ``x``.

    On CUDA ``index_add_`` accumulates with atomics, so the summation order
    (and the last bit of the result) can change from run to run."""
    p0 = x[triangles[:, 0]]
    p1 = x[triangles[:, 1]]
    p2 = x[triangles[:, 2]]
    fn = torch.linalg.cross(p1 - p0, p2 - p0)  # |fn| = 2*area: area weighting
    out = torch.zeros_like(x)
    for c in range(3):
        out.index_add_(0, triangles[:, c], fn)
    norm = torch.linalg.vector_norm(out, dim=1)
    return out / torch.clamp_min(norm, 1e-12)[:, None]
