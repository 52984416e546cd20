"""Offset-grouped ("banded") springs and tets: the plain PyTorch lattice forms.

Counterpart of ``softbodyunity_tpu/solver/banded.py``.  For a mesh with
index locality most edges share one index delta ``b - a`` and most tets one
delta pattern ``(t1 - t0, t2 - t0, t3 - t0)``: a ``tet_cube`` lattice has 9
edge deltas and 10 tet patterns covering every element.  Grouped at build
time, each group is a dense ``[N]`` mask plane over its owner vertices, and
the forces and projections are rolls of ``[3, N]`` planes:

    xb = roll(x, -delta);  f_g = mask * hooke(xb - x);  F += f_g - roll(f_g, delta)

These are the plain versions of the tet-lattice CUDA kernels
(``kernels/csrc/lattice_*.cu``), which read a neighbour as ``i + delta``
where the JAX package rolls; the same operations run here in the same order
as there.  A wrapped roll lane always multiplies into a mask-zeroed position.

The builders are NumPy and return float32/int32 planes exactly as the JAX
package's do (``tests/test_torch_lattice.py`` holds them bit-equal);
:meth:`OffsetGroups.to` and :meth:`TetGroups.to` move them to a device once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


def _to(a, device, dtype):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True, eq=False)
class OffsetGroups:
    """Dense per-delta spring planes.  For group g with delta d_g, vertex i
    owns the edge (i, i + d_g) iff ``mask[g, i] == 1``; its stiffness, rest
    length and compliance sit at ``[g, i]``.  ``residual_*`` hold the edges
    of no group."""

    mask: torch.Tensor          # [G, N] 1.0 where the edge exists
    stiffness: torch.Tensor     # [G, N]
    rest: torch.Tensor          # [G, N]
    compliance: torch.Tensor    # [G, N]
    residual_edges: torch.Tensor       # i64[R, 2]
    residual_rest: torch.Tensor        # [R]
    residual_stiffness: torch.Tensor   # [R]
    deltas: Tuple[int, ...] = ()
    # per-group (k, rest, compliance) when constant across the group, else
    # None: the fused kernels read these scalars instead of the planes
    uniform: Tuple[Optional[Tuple[float, float, float]], ...] = ()

    @property
    def n_residual(self) -> int:
        return self.residual_edges.shape[0]

    def to(self, device, dtype) -> "OffsetGroups":
        """The planes as tensors on ``device`` in ``dtype`` (indices int64)."""
        f = lambda a: _to(a, device, dtype)   # noqa: E731
        return dataclasses.replace(
            self, mask=f(self.mask), stiffness=f(self.stiffness),
            rest=f(self.rest), compliance=f(self.compliance),
            residual_edges=_to(self.residual_edges, device, torch.int64),
            residual_rest=f(self.residual_rest),
            residual_stiffness=f(self.residual_stiffness))


def build_offset_groups(n: int, edges: np.ndarray, rest: np.ndarray,
                        stiffness: np.ndarray, compliance: np.ndarray,
                        min_count: int = 32) -> OffsetGroups:
    """Host-side grouping of edges by ``b - a`` (builders orient a < b);
    NumPy planes, float32 as the JAX package stores them."""
    a = edges[:, 0].astype(np.int64)
    b = edges[:, 1].astype(np.int64)
    delta = b - a
    uniq, counts = np.unique(delta, return_counts=True)
    banded_deltas = [int(d) for d, c in zip(uniq, counts) if c >= min_count]
    g = len(banded_deltas)
    mask = np.zeros((max(g, 1), n), np.float64)
    k_pl = np.zeros((max(g, 1), n), np.float64)
    r_pl = np.zeros((max(g, 1), n), np.float64)
    c_pl = np.zeros((max(g, 1), n), np.float64)
    banded = np.zeros(edges.shape[0], bool)
    uniform = []
    for gi, d in enumerate(banded_deltas):
        sel = delta == d
        banded |= sel
        ai = a[sel]
        mask[gi, ai] = 1.0
        k_pl[gi, ai] = stiffness[sel]
        r_pl[gi, ai] = rest[sel]
        c_pl[gi, ai] = compliance[sel]
        ks, rs, cs = (
            np.unique(stiffness[sel].astype(np.float32)),
            np.unique(rest[sel].astype(np.float32)),
            np.unique(compliance[sel].astype(np.float32)),
        )
        uniform.append(
            (float(ks[0]), float(rs[0]), float(cs[0]))
            if len(ks) == 1 and len(rs) == 1 and len(cs) == 1
            else None
        )
    resid = ~banded
    return OffsetGroups(
        mask=mask.astype(np.float32),
        stiffness=k_pl.astype(np.float32),
        rest=r_pl.astype(np.float32),
        compliance=c_pl.astype(np.float32),
        residual_edges=edges[resid].astype(np.int32),
        residual_rest=rest[resid].astype(np.float32),
        residual_stiffness=stiffness[resid].astype(np.float32),
        deltas=tuple(banded_deltas),
        uniform=tuple(uniform),
    )


def _roll(a: torch.Tensor, shift: int) -> torch.Tensor:
    """Roll along the vertex (last) axis."""
    return torch.roll(a, shift, dims=-1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Component-plane dot product of [3, N] planes, summed in the order
    0, 1, 2 (``jnp.sum(a * b, axis=0)``)."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product of two [3, N] plane stacks."""
    return torch.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def _length_dir(d: torch.Tensor):
    """(length, unit direction) of [3, N] planes: sqrt, then a divide by
    ``max(length, 1e-12)`` (``solver/forces.py::length_dir_planes``)."""
    length = torch.sqrt(_dot(d, d))
    return length, d / torch.clamp_min(length, 1e-12)


def banded_spring_forces(groups: OffsetGroups, xT: torch.Tensor,
                         vT: torch.Tensor, damping: float) -> torch.Tensor:
    """Hooke + axial damper over the banded groups: [3, N] planes.  Each
    group is enumerated once, its force applied at the owner (+) and, by the
    reverse roll, at the neighbour (-)."""
    f = torch.zeros_like(xT)
    for gi, delta in enumerate(groups.deltas):
        xb = _roll(xT, -delta)
        vb = _roll(vT, -delta)
        d = xb - xT
        length, nrm = _length_dir(d)
        rel = _dot(vb - vT, nrm)
        fmag = groups.mask[gi] * (
            groups.stiffness[gi] * (length - groups.rest[gi]) + damping * rel)
        fg = fmag * nrm
        f = f + fg - _roll(fg, delta)
    return f


@dataclasses.dataclass(frozen=True, eq=False)
class TetGroups:
    """Tetrahedra grouped by their vertex-index delta pattern
    ``(t1 - t0, t2 - t0, t3 - t0)``: a ``tet_cube`` lattice has 10 patterns
    (5 tets x 2 parities).  ``mask[g, i] == 1`` where a tet of group g is
    based at vertex i.  Irregular tets fall into ``residual_*``."""

    mask: torch.Tensor           # [G, N]
    rest_volume: torch.Tensor    # [G, N]
    residual_tets: torch.Tensor          # i64[R, 4]
    residual_rest_volume: torch.Tensor   # [R]
    deltas: Tuple[Tuple[int, int, int], ...] = ()
    # per-group rest volume when constant across the group, else None
    uniform_rest_volume: Tuple[Optional[float], ...] = ()

    @property
    def n_residual(self) -> int:
        return self.residual_tets.shape[0]

    def to(self, device, dtype) -> "TetGroups":
        """The planes as tensors on ``device`` in ``dtype`` (indices int64)."""
        return dataclasses.replace(
            self, mask=_to(self.mask, device, dtype),
            rest_volume=_to(self.rest_volume, device, dtype),
            residual_tets=_to(self.residual_tets, device, torch.int64),
            residual_rest_volume=_to(self.residual_rest_volume, device,
                                     dtype))


def build_tet_groups(n: int, tets: np.ndarray, rest_volume: np.ndarray,
                     min_count: int = 32) -> TetGroups:
    """Host-side grouping of tets by delta pattern; NumPy planes, float32
    as the JAX package stores them."""
    if tets.shape[0] == 0:
        z = np.zeros((1, n), np.float32)
        return TetGroups(
            mask=z, rest_volume=z.copy(),
            residual_tets=np.zeros((0, 4), np.int32),
            residual_rest_volume=np.zeros((0,), np.float32),
            deltas=(),
        )
    t0 = tets[:, 0].astype(np.int64)
    d = tets[:, 1:].astype(np.int64) - t0[:, None]        # [T, 3]
    patterns, inverse, counts = np.unique(
        d, axis=0, return_inverse=True, return_counts=True
    )
    # the shape of ``inverse`` for axis=0 changed across numpy 2.0.x
    inverse = inverse.ravel()
    keep = [i for i in range(len(patterns)) if counts[i] >= min_count]
    g = len(keep)
    mask = np.zeros((max(g, 1), n), np.float64)
    rv = np.zeros((max(g, 1), n), np.float64)
    banded = np.zeros(tets.shape[0], bool)
    deltas = []
    uniform_rv = []
    for gi, pi in enumerate(keep):
        sel = inverse == pi
        banded |= sel
        mask[gi, t0[sel]] = 1.0
        rv[gi, t0[sel]] = rest_volume[sel]
        deltas.append(tuple(int(x) for x in patterns[pi]))
        rvs = np.unique(rest_volume[sel].astype(np.float32))
        uniform_rv.append(float(rvs[0]) if len(rvs) == 1 else None)
    resid = ~banded
    return TetGroups(
        mask=mask.astype(np.float32),
        rest_volume=rv.astype(np.float32),
        residual_tets=tets[resid].astype(np.int32),
        residual_rest_volume=rest_volume[resid].astype(np.float32),
        deltas=tuple(deltas),
        uniform_rest_volume=tuple(uniform_rv),
    )


def _tet_gradients(xT: torch.Tensor, d1: int, d2: int, d3: int):
    """Volume gradients ``g0..g3`` and signed volume of the tets based at
    every vertex with corner deltas (d1, d2, d3)."""
    p1 = _roll(xT, -d1)
    p2 = _roll(xT, -d2)
    p3 = _roll(xT, -d3)
    e1, e2, e3 = p1 - xT, p2 - xT, p3 - xT
    g1 = _cross(e2, e3) / 6.0
    g2 = _cross(e3, e1) / 6.0
    g3 = _cross(e1, e2) / 6.0
    g0 = -(g1 + g2 + g3)
    vol = _dot(_cross(e1, e2), e3) / 6.0
    return g0, g1, g2, g3, vol


def _tet_denominator(wN, gs, d1: int, d2: int, d3: int):
    """(sum_k w_k |g_k|^2, (w1, w2, w3)) of the tets based at every vertex."""
    g0, g1, g2, g3 = gs
    w1 = _roll(wN, -d1)
    w2 = _roll(wN, -d2)
    w3 = _roll(wN, -d3)
    denom = (wN * _dot(g0, g0) + w1 * _dot(g1, g1) + w2 * _dot(g2, g2)
             + w3 * _dot(g3, g3))
    return denom, (w1, w2, w3)


def _scatter_corners(dx, wN, ws, s, gs, deltas):
    """dx + each corner's correction ``(w_k s) g_k``, the corners' rolled
    back to the vertex they belong to."""
    (w1, w2, w3), (g0, g1, g2, g3), (d1, d2, d3) = ws, gs, deltas
    dx = dx + (wN * s) * g0
    dx = dx + _roll((w1 * s) * g1, d1)
    dx = dx + _roll((w2 * s) * g2, d2)
    dx = dx + _roll((w3 * s) * g3, d3)
    return dx


def tet_count(groups: TetGroups, n: int, dtype, device) -> torch.Tensor:
    """Per-vertex count of the tets that touch it (as any corner)."""
    cnt = torch.zeros((n,), dtype=dtype, device=device)
    for gi, (d1, d2, d3) in enumerate(groups.deltas):
        m = groups.mask[gi]
        cnt = cnt + m + _roll(m, d1) + _roll(m, d2) + _roll(m, d3)
    return cnt


def banded_volume_projection(groups: TetGroups, xT: torch.Tensor,
                             wN: torch.Tensor,
                             stiffness: float) -> torch.Tensor:
    """PBD volume projection in banded form: dx planes [3, N], averaged over
    each vertex's tet count, scaled by ``stiffness``, zero on pinned
    vertices (oracle ``volume_projection`` semantics)."""
    dx = torch.zeros_like(xT)
    for gi, (d1, d2, d3) in enumerate(groups.deltas):
        m = groups.mask[gi]
        g0, g1, g2, g3, vol = _tet_gradients(xT, d1, d2, d3)
        c_val = vol - groups.rest_volume[gi]
        gs = (g0, g1, g2, g3)
        denom, ws = _tet_denominator(wN, gs, d1, d2, d3)
        s = m * (-c_val) / torch.clamp_min(denom, 1e-12)
        dx = _scatter_corners(dx, wN, ws, s, gs, (d1, d2, d3))
    cnt = tet_count(groups, xT.shape[-1], xT.dtype, xT.device)
    dx = stiffness * dx / torch.clamp_min(cnt, 1.0)
    return torch.where(wN > 0.0, dx, 0.0)


def xpbd_iteration_banded(top, cfg, xT: torch.Tensor, lams, lam_vols,
                          cnt: torch.Tensor, dt: float):
    """One Jacobi sweep over the banded distance and volume constraints at
    the evaluation point ``xT``: returns the relaxed position increment
    planes and the updated lambda planes (the caller accumulates the
    increment in delta form; :func:`..solver.step.substep_xpbd`)."""
    groups: OffsetGroups = top.offset_groups
    tgroups: TetGroups = top.tet_groups
    wN = top.inv_mass
    dx = torch.zeros_like(xT)
    new_lams = []
    for gi, delta in enumerate(groups.deltas):
        m = groups.mask[gi]
        d = _roll(xT, -delta) - xT
        length, nrm = _length_dir(d)
        c_val = length - groups.rest[gi]
        alpha_t = groups.compliance[gi] / (dt * dt)
        wn = _roll(wN, -delta)
        denom = torch.clamp_min(wN + wn + alpha_t, 1e-12)
        dlam = -(c_val + alpha_t * lams[gi]) / denom * m
        new_lams.append(lams[gi] + dlam)
        dx = dx + (-(wN * dlam)) * nrm + _roll((wn * dlam) * nrm, delta)
    new_lam_vols = []
    if tgroups is not None and len(tgroups.deltas) > 0:
        alpha_v = cfg.xpbd.compliance_volume / (dt * dt)
        for gi, (d1, d2, d3) in enumerate(tgroups.deltas):
            m = tgroups.mask[gi]
            g0, g1, g2, g3, vol = _tet_gradients(xT, d1, d2, d3)
            c_v = vol - tgroups.rest_volume[gi]
            gs = (g0, g1, g2, g3)
            denom, ws = _tet_denominator(wN, gs, d1, d2, d3)
            dlam_v = (-(c_v + alpha_v * lam_vols[gi])
                      / torch.clamp_min(denom + alpha_v, 1e-12) * m)
            new_lam_vols.append(lam_vols[gi] + dlam_v)
            dx = _scatter_corners(dx, wN, ws, dlam_v, gs, (d1, d2, d3))
    return (cfg.xpbd.relaxation * dx / cnt, tuple(new_lams),
            tuple(new_lam_vols))


def xpbd_constraint_count(top) -> torch.Tensor:
    """Per-vertex constraint count [N], at least 1, over the banded edge and
    tet groups (owned and owning edges, every tet corner)."""
    groups: OffsetGroups = top.offset_groups
    tgroups: TetGroups = top.tet_groups
    n = top.n_vertices
    cnt = torch.zeros((n,), dtype=top.dtype, device=top.device)
    for gi, delta in enumerate(groups.deltas):
        m = groups.mask[gi]
        cnt = cnt + m + _roll(m, delta)
    if tgroups is not None:
        cnt = cnt + tet_count(tgroups, n, top.dtype, top.device)
    return torch.clamp_min(cnt, 1.0)
