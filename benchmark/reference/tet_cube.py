"""Plain reference of a tet-lattice cube under semi-implicit Euler with the
PBD volume term, written from the configuration file alone (the reference
module of the configurations whose ``builder`` is ``tet_box``: a cube is a
box with the same size on every side).

It reads the scene's sizes and coefficients from the benchmark's
configuration (``configs/<name>.json``) and nothing else: it imports neither
the program under test nor the JAX package, and builds its own lattice,
springs, tets, rest lengths, rest volumes and surface.  Every operation is
plain PyTorch on whatever device and dtype it is given: float64 for the
comparison that decides a run's ``correct``, bfloat16 for the control that
has to fail it.  It multiplies no matrices, so TF32 cannot enter; the flags
that would allow it are turned off all the same.

The lattice: ``nx ny nz`` vertices, vertex ``(i, j, k)`` at index
``(i ny + j) nz + k`` and at ``origin + spacing (i, j, k)``.  Each of the
``(nx - 1)(ny - 1)(nz - 1)`` cells is split into five tets: at each of its four corners
whose offset ``(di, dj, dk)`` has the parity of ``i + j + k``, the corner
and its three neighbours along the axes; and the tet of the other four
corners.  A tet whose signed volume is negative at rest has its last two
corners swapped.  The springs are the unique edges of the tets, with their
rest lengths at rest; the rest volumes are the tets' at rest.  The surface
is the faces ``k = 0`` and ``k = nz - 1``, two triangles a square, as the
program's builder emits them: two of the six faces, both wound to face the
inside.

One substep of ``dt``, every vertex free (``w = 1 / mass``):

1. springs: for the edge ``(a, b)`` with ``d = x_b - x_a``,
   ``n = d / max(|d|, 1e-12)``, the force
   ``f = (k (|d| - rest) + damping ((v_b - v_a) . n)) n`` is added at ``a``
   and taken from ``b``;
2. ``v = (v + dt (g + w f)) (1 - global_damping dt)``, then ``x += dt v``;
3. one Jacobi PBD volume pass at those positions: for the tet
   ``(p0, p1, p2, p3)`` with ``e_m = p_m - p0``, the gradients
   ``g1 = e2 x e3 / 6``, ``g2 = e3 x e1 / 6``, ``g3 = e1 x e2 / 6``,
   ``g0 = -(g1 + g2 + g3)``, the volume ``V = (e1 x e2) . e3 / 6``,
   ``C = V - V0`` and ``s = -C / max(sum_m w_m |g_m|^2, 1e-12)``; corner
   ``m`` takes ``s w_m g_m``.  Each vertex's sum is divided by its count of
   tets (at least 1) and scaled by ``volume_stiffness`` into ``dx``; then
   ``x += dx`` and ``v += dx / dt``;
4. the ground plane at ``plane_height``: a vertex below it moves onto it,
   loses its downward velocity (times ``restitution``) and keeps
   ``1 - friction`` of its tangential velocity.

Vertex normals are the sums of the surface triangles' ``(p1 - p0) x
(p2 - p0)`` at their corners (area weighted), divided by their length
clamped at 1e-12 below: zero at a vertex on no triangle.

Departures from the program's banded form (``solver/banded.py``, the
lattice kernels), none of them a change of the equations: the program
evaluates each spring and tet from its lowest vertex and an index delta per
group, and sums a vertex's terms group by group, where this sums edges and
tet corners by ``index_add_`` in its own order, so the sums round
differently; it holds each group's rest length and rest volume in float32,
where these are float64; and it skips the volume pass when
``volume_stiffness`` is 0, where this adds a zero correction.

Each episode starts from the rest shape with a seeded smooth velocity
field and a seeded rigid spin (:func:`start_velocity`).
"""

from __future__ import annotations

import math

import torch

# no matrix product runs here; a float32 one on the H100 may otherwise run
# in TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_CORNERS = [(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]


def _cell_tets(parity: int):
    """The five tets of a cell whose ``i + j + k`` has ``parity``, as
    corner offsets ``[5][4] (di, dj, dk)``."""
    apex = [c for c in _CORNERS if sum(c) % 2 == parity]
    rest = [c for c in _CORNERS if sum(c) % 2 != parity]
    tets = []
    for c in apex:
        tets.append([c] + [tuple(c[m] ^ (m == axis) for m in range(3))
                           for axis in range(3)])
    tets.append(rest)
    return tets


def shape(scene: dict):
    """``(nx, ny, nz)``: the lattice's vertices along each axis."""
    return scene["nx"], scene["ny"], scene["nz"]


def rest_positions(scene: dict) -> torch.Tensor:
    """``[nx ny nz, 3]`` float64 rest positions, vertex
    ``(i ny + j) nz + k``."""
    h = scene["spacing"]
    axes = [torch.arange(m, dtype=torch.float64) for m in shape(scene)]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    return (grid.reshape(-1, 3) * h
            + torch.tensor(scene["origin"], dtype=torch.float64))


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise cross product of ``[..., 3]`` tensors."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                       dim=-1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(dim=-1)


def signed_volumes(x: torch.Tensor, tets: torch.Tensor) -> torch.Tensor:
    """``[T]`` signed volumes of ``tets`` at ``x``."""
    p0 = x[tets[:, 0]]
    e1, e2, e3 = (x[tets[:, m]] - p0 for m in (1, 2, 3))
    return _dot(_cross(e1, e2), e3) / 6.0


def lattice(scene: dict) -> dict:
    """The cube's tables, float64 and int64 on the CPU: ``x0`` [N, 3],
    ``tets`` [T, 4] (positive volume at rest), ``rest_volume`` [T],
    ``edges`` [E, 2] (``a < b``, sorted), ``rest_length`` [E] and
    ``triangles`` [F, 3]."""
    nx, ny, nz = shape(scene)
    nv = nx * ny * nz
    x0 = rest_positions(scene)
    ci, cj, ck = (a.reshape(-1) for a in torch.meshgrid(
        torch.arange(nx - 1), torch.arange(ny - 1), torch.arange(nz - 1),
        indexing="ij"))
    offs = torch.tensor([_cell_tets(0), _cell_tets(1)])   # [2, 5, 4, 3]
    o = offs[(ci + cj + ck) % 2]                         # [C, 5, 4, 3]
    tets = (((ci[:, None, None] + o[..., 0]) * ny
             + cj[:, None, None] + o[..., 1]) * nz
            + ck[:, None, None] + o[..., 2]).reshape(-1, 4)
    flip = signed_volumes(x0, tets) < 0.0
    tets[flip] = tets[flip][:, [0, 1, 3, 2]]
    pairs = tets[:, [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]]]
    pairs = torch.sort(pairs.reshape(-1, 2), dim=1).values
    edges = torch.unique(pairs[:, 0] * nv + pairs[:, 1])
    edges = torch.stack([edges // nv, edges % nv], dim=1)
    d = x0[edges[:, 1]] - x0[edges[:, 0]]
    fi, fj = (t.reshape(-1) for t in torch.meshgrid(
        torch.arange(nx - 1), torch.arange(ny - 1), indexing="ij"))

    def face(corners, kk):
        return torch.stack([((fi + di) * ny + fj + dj) * nz + kk
                            for di, dj in corners], dim=1)

    # a square's two triangles on k = 0, then its two on k = nz - 1,
    # wound as the program's builder winds them: both face the inside
    tris = [face(((0, 0), (1, 0), (0, 1)), 0),
            face(((1, 0), (1, 1), (0, 1)), 0),
            face(((0, 0), (0, 1), (1, 0)), nz - 1),
            face(((1, 0), (0, 1), (1, 1)), nz - 1)]
    triangles = torch.stack(tris, dim=1).reshape(-1, 3)
    return {"x0": x0, "tets": tets,
            "rest_volume": signed_volumes(x0, tets), "edges": edges,
            "rest_length": torch.sqrt(_dot(d, d)), "triangles": triangles}


def start_velocity(config: dict, generator: torch.Generator,
                   device) -> torch.Tensor:
    """An episode's start velocity, ``[N, 3]`` float32 on ``device``: a sum
    of ``start.modes`` smooth modes ``a sin(pi p i / nx + phi)
    sin(pi q j / ny + psi) sin(pi r k / nz + chi)``, each with wave numbers ``p, q, r`` in ``1..start.max_wavenumber``,
    phases in ``[0, 2 pi)`` and a random direction ``a`` in ``[-1, 1]^3``,
    scaled so that the fastest vertex moves at ``start.max_speed`` m/s;
    plus a rigid spin ``omega x (x - c)`` about the rest shape's centre
    ``c``, ``omega`` of a uniform random direction and a rate uniform in
    ``[start.max_spin / 2, start.max_spin]`` rad/s.  The few numbers come
    from ``generator`` (on the CPU), so every device makes the same field;
    it is formed on the device in float64 and rounded once to float32."""
    start, scene = config["start"], config["scene"]
    m = start["modes"]
    waves = torch.randint(1, start["max_wavenumber"] + 1, (m, 3),
                          generator=generator)
    phases = (torch.rand(m, 3, generator=generator, dtype=torch.float64)
              * 2 * math.pi)
    amp = torch.rand(m, 3, generator=generator, dtype=torch.float64) * 2 - 1
    axis = torch.randn(3, generator=generator, dtype=torch.float64)
    rate = start["max_spin"] * (
        0.5 + 0.5 * torch.rand(1, generator=generator, dtype=torch.float64))
    params = torch.cat([waves.double(), phases, amp], dim=1).to(device)
    s = [torch.sin(math.pi * params[:, a:a + 1]
                   * torch.arange(size, dtype=torch.float64, device=device)
                   / size + params[:, 3 + a:4 + a])
         for a, size in enumerate(shape(scene))]
    v = torch.einsum("mc,mi,mj,mk->ijkc", params[:, 6:9], *s).reshape(-1, 3)
    v = v * (start["max_speed"] / torch.sqrt(_dot(v, v)).amax())
    x = rest_positions(scene).to(device)
    omega = (axis / torch.sqrt(_dot(axis, axis)) * rate).to(device)
    v = v + _cross(omega.expand_as(x), x - x.mean(dim=0))
    return v.float()


class TetCube:
    """The reference of one configuration, on ``device`` in ``dtype``."""

    def __init__(self, config: dict, dtype=torch.float64, device="cpu"):
        scene, sim = config["scene"], config["sim"]
        if sim["solver"] != "euler":
            raise ValueError(f"solver {sim['solver']!r}: the reference runs "
                             "semi-implicit Euler only")
        self.dtype, self.device = dtype, torch.device(device)
        tables = lattice(scene)
        self.n = tables["x0"].shape[0]
        to = dict(dtype=dtype, device=self.device)
        self.edges = tables["edges"].to(self.device)
        self.rest_length = tables["rest_length"].to(**to)
        self.tets = tables["tets"].to(self.device)
        self.rest_volume = tables["rest_volume"].to(**to)
        self.triangles = tables["triangles"].to(self.device)
        count = torch.bincount(self.tets.reshape(-1), minlength=self.n)
        self.tet_count = torch.clamp_min(count, 1).to(**to)[:, None]
        self.w = 1.0 / scene["mass"]
        self.k = sim["springs"]["k_structural"]
        self.damping = sim["springs"]["damping"]
        self.dt = sim["dt"]
        self.n_substeps = sim["n_substeps"]
        self.decay = 1.0 - sim["global_damping"] * self.dt
        self.gravity = torch.tensor(sim["gravity"], **to)
        self.volume_stiffness = sim["volume_stiffness"]
        col = sim["collision"]
        self.plane = scene["plane_height"] if col["enable_plane"] else None
        self.friction = col["friction"]
        self.restitution = col["restitution"]

    def spring_forces(self, x, v):
        a, b = self.edges[:, 0], self.edges[:, 1]
        d = x[b] - x[a]
        length = torch.sqrt(_dot(d, d))
        nrm = d / torch.clamp_min(length, 1e-12)[:, None]
        rel_v = _dot(v[b] - v[a], nrm)
        fn = (self.k * (length - self.rest_length)
              + self.damping * rel_v)[:, None] * nrm
        f = torch.zeros_like(x)
        f.index_add_(0, a, fn)
        f.index_add_(0, b, -fn)
        return f

    def volume_correction(self, x):
        t = self.tets
        p0 = x[t[:, 0]]
        e1, e2, e3 = (x[t[:, m]] - p0 for m in (1, 2, 3))
        g1 = _cross(e2, e3) / 6.0
        g2 = _cross(e3, e1) / 6.0
        g3 = _cross(e1, e2) / 6.0
        g0 = -(g1 + g2 + g3)
        c = _dot(_cross(e1, e2), e3) / 6.0 - self.rest_volume
        denom = self.w * (_dot(g0, g0) + _dot(g1, g1) + _dot(g2, g2)
                          + _dot(g3, g3))
        s = (-c / torch.clamp_min(denom, 1e-12) * self.w)[:, None]
        dx = torch.zeros_like(x)
        for m, g in enumerate((g0, g1, g2, g3)):
            dx.index_add_(0, t[:, m], s * g)
        return self.volume_stiffness * dx / self.tet_count

    def substep(self, x, v):
        f = self.spring_forces(x, v)
        v = (v + self.dt * (self.gravity + self.w * f)) * self.decay
        x = x + self.dt * v
        dx = self.volume_correction(x)
        x = x + dx
        v = v + dx / self.dt
        if self.plane is not None:
            hit = x[:, 1] < self.plane
            y = torch.where(hit, torch.full_like(x[:, 1], self.plane),
                            x[:, 1])
            x = torch.stack([x[:, 0], y, x[:, 2]], dim=1)
            vy = torch.where(hit & (v[:, 1] < 0.0),
                             -self.restitution * v[:, 1], v[:, 1])
            keep = 1.0 - self.friction
            v = torch.stack([torch.where(hit, v[:, 0] * keep, v[:, 0]), vy,
                             torch.where(hit, v[:, 2] * keep, v[:, 2])],
                            dim=1)
        return x, v

    def frame(self, x: torch.Tensor, v: torch.Tensor):
        """One frame (``n_substeps`` substeps) from ``[N, 3]`` positions and
        velocities; returns them after it, ``[N, 3]`` in this dtype."""
        x = x.to(self.device, self.dtype)
        v = v.to(self.device, self.dtype)
        for _ in range(self.n_substeps):
            x, v = self.substep(x, v)
        return x, v

    def normals(self, x: torch.Tensor) -> torch.Tensor:
        """``[N, 3]`` unit area-weighted vertex normals at ``x`` [N, 3]."""
        x = x.to(self.device, self.dtype)
        tri = self.triangles
        p0 = x[tri[:, 0]]
        fn = _cross(x[tri[:, 1]] - p0, x[tri[:, 2]] - p0)
        acc = torch.zeros_like(x)
        for m in range(3):
            acc.index_add_(0, tri[:, m], fn)
        length = torch.sqrt(_dot(acc, acc))
        return acc / torch.clamp_min(length, 1e-12)[:, None]


Reference = TetCube
