"""Vertex-normal recompute for rendering (Unity ``RecalculateNormals``
analogue): area-weighted face normals summed to vertices, then normalized.
Counterpart of ``softbodyunity_tpu/solver/normals.py``; runs once per
rendered frame, outside the substep loop.

The sum is a gather in a fixed order, from a per-vertex table of incident
faces built once per topology (:func:`incident_faces`): no atomics, so the
card gives the same bits on every run.
"""

from __future__ import annotations

from typing import Optional

import torch


def incident_faces(triangles: torch.Tensor, n_vertices: int) -> torch.Tensor:
    """``[N, D]`` int64: row v lists the faces that have v as a corner, in
    the order corner 0 over all faces, then corner 1, then corner 2 (the
    order in which ``index_add_`` on the CPU adds them, a corner at a time),
    padded with ``F``, the index of an appended zero face; D is the largest
    count of faces at a vertex.  A normals call gathers N x D faces, so the
    table suits meshes of bounded valence (a cloth grid's D is 6, a tet
    lattice's surface 6); one pole of valence D costs every vertex D
    gathers."""
    n_faces = triangles.shape[0]
    corner = triangles.t().reshape(-1)   # corner-major: (c, f) at c * F + f
    face = torch.arange(n_faces, device=triangles.device).repeat(3)
    order = torch.sort(corner, stable=True).indices
    counts = torch.bincount(corner, minlength=n_vertices)
    starts = torch.cumsum(counts, 0) - counts
    depth = int(counts.max()) if n_faces else 0
    table = torch.full((n_vertices, depth), n_faces, dtype=torch.int64,
                       device=triangles.device)
    v = corner[order]
    slot = torch.arange(order.shape[0], device=triangles.device) - starts[v]
    table[v, slot] = face[order]
    return table


def vertex_normals(triangles: torch.Tensor, x: torch.Tensor,
                   table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Area-weighted unit vertex normals ``[N, 3]`` of the mesh
    ``triangles`` (int64 ``[F, 3]``) at positions ``x``.  ``table`` is
    :func:`incident_faces` of the mesh (built here when None).  Each
    vertex's face normals are added one at a time from zero in the table's
    order, so the result is the CPU's ``index_add_`` sum to the bit, on any
    device."""
    if table is None:
        table = incident_faces(triangles, x.shape[0])
    p0 = x[triangles[:, 0]]
    p1 = x[triangles[:, 1]]
    p2 = x[triangles[:, 2]]
    fn = torch.linalg.cross(p1 - p0, p2 - p0)  # |fn| = 2*area: area weighting
    fn = torch.cat([fn, torch.zeros_like(fn[:1])])   # the padding face
    out = torch.zeros_like(x)
    for k in range(table.shape[1]):
        out = out + fn[table[:, k]]
    norm = torch.linalg.vector_norm(out, dim=1)
    return out / torch.clamp_min(norm, 1e-12)[:, None]
