"""Plain reference of a grid cloth under semi-implicit Euler, written from
the configuration file alone (the reference module of the configurations
whose ``builder`` is ``cloth_grid``).

It reads the scene's sizes and coefficients from the benchmark's
configuration (``configs/<name>.json``) and nothing else: it imports neither
the program under test nor the JAX package, and takes no table, weight or
plane that the program built.  Every operation is plain PyTorch on whatever
device and dtype it is given: float64 for the comparison that decides a
run's ``correct``, bfloat16 for the control that has to fail it.

One substep, on ``[3, ny, nx]`` planes of positions and velocities:

1. spring forces: each spring class is a grid offset ``(di, dj)`` (structural
   ``(0, 1), (1, 0)``, shear ``(1, 1), (1, -1)``, bend ``(0, 2), (2, 0)``);
   the vertex at ``(i, j)`` pulls toward ``(i + di, j + dj)`` with
   ``k (|d| - rest) + damping ((v_b - v_a) . n)`` along ``n = d / |d|``
   (``|d|`` clamped at 1e-12 below), and its neighbour takes the opposite;
2. self-collision, when the configuration turns it on: every pair of
   vertices closer than ``radius`` pushes apart with
   ``stiffness (radius - d) / d * (x_i - x_j)``, where
   ``d = sqrt(max(|x_i - x_j|^2, (1e-3 radius)^2))`` (the block method's
   rule; the dense rule and the block method agree wherever the block
   method drops no pair), evaluated at the substep's start;
3. ``v = (v + dt (g + f / m)) (1 - global_damping dt)``, zero at pins, then
   ``x += dt v``;
4. the ground plane: a free vertex below it moves onto it, loses its
   downward normal velocity (times ``restitution``) and keeps
   ``1 - friction`` of its tangential velocity.

Vertex normals are the area-weighted sums of the two triangles of each
grid cell, ``(p00, p10, p01)`` and ``(p01, p10, p11)``, divided by their
length clamped at 1e-12 below.

Each episode starts from the rest shape with a seeded smooth velocity
field (:func:`start_velocity`).
"""

from __future__ import annotations

import math

import torch

_PIN_NAMES = ("top", "bottom", "left", "right", "tl", "tr", "bl", "br",
              "corners")


def offsets(scene: dict, springs: dict):
    """``(di, dj, stiffness, rest length)`` of each spring class present."""
    h = scene["spacing"]
    out = [(0, 1, springs["k_structural"], h),
           (1, 0, springs["k_structural"], h)]
    if scene["shear"]:
        out += [(1, 1, springs["k_shear"], h * math.sqrt(2.0)),
                (1, -1, springs["k_shear"], h * math.sqrt(2.0))]
    if scene["bend"]:
        out += [(0, 2, springs["k_bend"], 2.0 * h),
                (2, 0, springs["k_bend"], 2.0 * h)]
    return out


def pin_mask(scene: dict, device) -> torch.Tensor:
    """``[ny, nx]`` bool, True at the pinned vertices."""
    ny, nx = scene["ny"], scene["nx"]
    pin = torch.zeros((ny, nx), dtype=torch.bool, device=device)
    for p in scene["pinned"]:
        if p not in _PIN_NAMES:
            raise ValueError(f"unknown pin name {p!r}")
        if p == "top":
            pin[0, :] = True
        elif p == "bottom":
            pin[-1, :] = True
        elif p == "left":
            pin[:, 0] = True
        elif p == "right":
            pin[:, -1] = True
        else:
            for name, (i, j) in (("tl", (0, 0)), ("tr", (0, -1)),
                                 ("bl", (-1, 0)), ("br", (-1, -1))):
                if p in (name, "corners"):
                    pin[i, j] = True
    return pin


def rest_positions(scene: dict) -> torch.Tensor:
    """``[N, 3]`` float64 rest positions, row-major ``i * nx + j``."""
    ny, nx, h = scene["ny"], scene["nx"], scene["spacing"]
    ii, jj = torch.meshgrid(torch.arange(ny, dtype=torch.float64),
                            torch.arange(nx, dtype=torch.float64),
                            indexing="ij")
    x = torch.zeros((ny, nx, 3), dtype=torch.float64)
    if scene["orientation"] == "xy":
        x[..., 0], x[..., 1] = jj * h, -ii * h
    elif scene["orientation"] == "xz":
        x[..., 0], x[..., 2] = jj * h, ii * h
    else:
        raise ValueError(f"unknown orientation {scene['orientation']!r}")
    x += torch.tensor(scene["origin"], dtype=torch.float64)
    return x.reshape(-1, 3)


def start_velocity(config: dict, generator: torch.Generator,
                   device) -> torch.Tensor:
    """An episode's start velocity, ``[N, 3]`` float32 on ``device``: a sum
    of ``start.modes`` smooth modes
    ``a * sin(pi k i / ny + phi) * sin(pi l j / nx + psi)``, each with wave
    numbers ``k, l`` in ``1..start.max_wavenumber``, phases in ``[0, 2 pi)``
    and a random direction ``a`` in ``[-1, 1]^3``, scaled so that the
    fastest free vertex moves at ``start.max_speed`` m/s; zero at the
    pinned vertices.  The few numbers of the modes come from ``generator``
    (on the CPU), so every device makes the same field; the field is formed
    on the device in float64 and rounded once to float32."""
    start = config["start"]
    ny, nx = config["scene"]["ny"], config["scene"]["nx"]
    m = start["modes"]
    waves = torch.randint(1, start["max_wavenumber"] + 1, (m, 2),
                          generator=generator)
    phases = (torch.rand(m, 2, generator=generator, dtype=torch.float64)
              * 2 * math.pi)
    amp = torch.rand(m, 3, generator=generator, dtype=torch.float64) * 2 - 1
    params = torch.cat([waves.double(), phases, amp], dim=1).to(device)
    i = torch.arange(ny, dtype=torch.float64, device=device)
    j = torch.arange(nx, dtype=torch.float64, device=device)
    rows = torch.sin(math.pi * params[:, 0:1] * i / ny + params[:, 2:3])
    cols = torch.sin(math.pi * params[:, 1:2] * j / nx + params[:, 3:4])
    v = torch.einsum("mc,mi,mj->ijc", params[:, 4:7], rows, cols)
    v = v * ~pin_mask(config["scene"], device)[..., None]
    speed = torch.sqrt((v * v).sum(dim=-1)).amax()
    return (v * (start["max_speed"] / speed)).reshape(-1, 3).float()


def pair_forces(x: torch.Tensor, radius: float,
                stiffness: float) -> torch.Tensor:
    """``[N, 3]`` repulsion of every pair of vertices of ``x`` [N, 3] closer
    than ``radius``, found through a uniform grid of cells of edge
    ``radius``: each vertex meets the vertices of the 27 cells around its
    own.  A vertex meets itself too, and adds exactly 0 (its difference is
    0, its weight finite)."""
    n = x.shape[0]
    f = torch.zeros_like(x)
    if not bool(torch.isfinite(x).all()):
        return torch.full_like(x, math.nan)
    eps2 = (1e-3 * radius) ** 2
    cell = torch.floor(x.double() / radius).long()
    cell = cell - cell.amin(dim=0) + 1
    dims = (cell.amax(dim=0) + 2).tolist()
    key = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    order = torch.argsort(key)
    skey = key[order]
    steps = torch.tensor([(a * dims[1] + b) * dims[2] + c
                          for a in (-1, 0, 1) for b in (-1, 0, 1)
                          for c in (-1, 0, 1)], device=x.device)
    near = key[None, :] + steps[:, None]                        # [27, N]
    lo = torch.searchsorted(skey, near.reshape(-1), right=False)
    hi = torch.searchsorted(skey, near.reshape(-1), right=True)
    counts = hi - lo
    total = int(counts.sum())
    owner = torch.arange(n, device=x.device).repeat(27)
    i = torch.repeat_interleave(owner, counts, output_size=total)
    first = torch.cumsum(counts, 0) - counts
    pos = (torch.arange(total, device=x.device)
           - torch.repeat_interleave(first - lo, counts, output_size=total))
    j = order[pos]
    diff = x[i] - x[j]
    d = torch.sqrt(torch.clamp_min((diff * diff).sum(dim=1), eps2))
    w = torch.where(d < radius, stiffness * (radius - d) / d,
                    torch.zeros_like(d))
    return f.index_add_(0, i, w[:, None] * diff)


class GridCloth:
    """The reference of one configuration, on ``device`` in ``dtype``."""

    def __init__(self, config: dict, dtype=torch.float64, device="cpu"):
        scene, sim = config["scene"], config["sim"]
        if sim["solver"] != "euler":
            raise ValueError(f"solver {sim['solver']!r}: the reference runs "
                             "semi-implicit Euler only")
        self.dtype, self.device = dtype, torch.device(device)
        self.ny, self.nx = scene["ny"], scene["nx"]
        self.offsets = offsets(scene, sim["springs"])
        self.damping = sim["springs"]["damping"]
        self.dt = sim["dt"]
        self.n_substeps = sim["n_substeps"]
        self.decay = 1.0 - sim["global_damping"] * self.dt
        self.gravity = torch.tensor(sim["gravity"], dtype=dtype,
                                    device=self.device).reshape(3, 1, 1)
        pinned = pin_mask(scene, self.device)
        self.free = ~pinned
        self.inv_mass = torch.where(pinned, 0.0, 1.0 / scene["mass"]).to(
            dtype)
        col = sim["collision"]
        self.plane = (scene["plane_height"] if col["enable_plane"] else None)
        self.friction = col["friction"]
        self.restitution = col["restitution"]
        sc = sim.get("self_collision") or {}
        self.self_collision = ((sc["radius"], sc["stiffness"])
                               if sc.get("enabled") else None)

    def planes(self, x: torch.Tensor) -> torch.Tensor:
        """``[N, 3]`` -> ``[3, ny, nx]`` in this reference's dtype."""
        return x.to(self.device, self.dtype).t().reshape(3, self.ny, self.nx)

    @staticmethod
    def rows(x3: torch.Tensor) -> torch.Tensor:
        """``[3, ny, nx]`` -> ``[N, 3]``."""
        return x3.reshape(3, -1).t()

    def spring_forces(self, x3, v3):
        f = torch.zeros_like(x3)
        ny, nx = self.ny, self.nx
        for di, dj, k, rest in self.offsets:
            # the owner (i, j) and its neighbour (i + di, j + dj) over the
            # cells where both exist
            a = (slice(None), slice(0, ny - di),
                 slice(max(0, -dj), nx - max(0, dj)))
            b = (slice(None), slice(di, ny),
                 slice(max(0, dj), nx - max(0, -dj)))
            d = x3[b] - x3[a]
            length = torch.sqrt((d * d).sum(dim=0))
            n = d / torch.clamp_min(length, 1e-12)
            rel_v = ((v3[b] - v3[a]) * n).sum(dim=0)
            fn = (k * (length - rest) + self.damping * rel_v) * n
            f[a] += fn
            f[b] -= fn
        return f

    def substep(self, x3, v3):
        f = self.spring_forces(x3, v3)
        if self.self_collision:
            f = f + self.planes(pair_forces(self.rows(x3),
                                            *self.self_collision))
        v3 = (v3 + self.dt * (self.gravity + f * self.inv_mass)) * self.decay
        v3 = torch.where(self.free, v3, torch.zeros_like(v3))
        x3 = x3 + self.dt * v3
        if self.plane is not None:
            hit = (x3[1] < self.plane) & self.free
            x3 = torch.stack([x3[0], torch.where(
                hit, torch.full_like(x3[1], self.plane), x3[1]), x3[2]])
            vy = torch.where(hit & (v3[1] < 0.0),
                             -self.restitution * v3[1], v3[1])
            keep = 1.0 - self.friction
            v3 = torch.stack([torch.where(hit, v3[0] * keep, v3[0]), vy,
                              torch.where(hit, v3[2] * keep, v3[2])])
        return x3, v3

    def frame(self, x: torch.Tensor, v: torch.Tensor):
        """One frame (``n_substeps`` substeps) from ``[N, 3]`` positions and
        velocities; returns them after it, ``[N, 3]`` in this dtype."""
        x3, v3 = self.planes(x), self.planes(v)
        for _ in range(self.n_substeps):
            x3, v3 = self.substep(x3, v3)
        return self.rows(x3), self.rows(v3)

    def normals(self, x: torch.Tensor) -> torch.Tensor:
        """``[N, 3]`` unit area-weighted vertex normals at ``x`` [N, 3]."""
        p = self.planes(x)
        p00, p10 = p[:, :-1, :-1], p[:, 1:, :-1]
        p01, p11 = p[:, :-1, 1:], p[:, 1:, 1:]
        f1 = torch.linalg.cross(p10 - p00, p01 - p00, dim=0)
        f2 = torch.linalg.cross(p10 - p01, p11 - p01, dim=0)
        acc = torch.zeros_like(p)
        acc[:, :-1, :-1] += f1
        acc[:, 1:, :-1] += f1 + f2
        acc[:, :-1, 1:] += f1 + f2
        acc[:, 1:, 1:] += f2
        length = torch.sqrt((acc * acc).sum(dim=0))
        return self.rows(acc / torch.clamp_min(length, 1e-12))


Reference = GridCloth
