"""Plain reference of a grid cloth under XPBD, written from the
configuration file alone (the reference module of the configurations whose
``builder`` is ``cloth_grid`` and whose ``sim.solver`` is ``xpbd``).

It reads the scene's sizes, compliances and coefficients from the
benchmark's configuration (``configs/<name>.json``) and nothing else: it
imports neither the program under test nor the JAX package, and takes no
table, weight or plane that the program built.  The rest shape, the
seeded start velocity, the pins and the vertex normals are those of
``grid_cloth.py``, loaded from its file beside this one as the harness
loads a module.  Every operation is plain PyTorch on whatever device and
dtype it is given: float64 for the comparison that decides a run's
``correct``, bfloat16 for the control that has to fail it.

Each grid offset ``(di, dj)`` is a class of distance constraints between
the vertex at ``(i, j)`` and the one at ``(i + di, j + dj)``: structural
``(0, 1), (1, 0)`` and shear ``(1, 1), (1, -1)`` with
``xpbd.compliance_distance``, bend ``(0, 2), (2, 0)`` with
``xpbd.compliance_bend``, each at its rest length (``spacing``,
``spacing sqrt 2``, ``2 spacing``).  One substep, on ``[3, ny, nx]`` planes
of positions ``x`` and velocities ``v``:

1. predict: ``v <- (v + dt g)(1 - global_damping dt)``, zero at the pins;
   ``delta = dt v``, the substep's position change;
2. ``xpbd.n_iterations`` global Jacobi sweeps, each from the evaluation
   point ``x + delta`` of the sweep's start: every constraint, with its own
   ``lambda`` (zero at the substep's start), takes
   ``dlam = -(C + at lambda) / (w_a + w_b + at)``, ``C = |d| - rest``,
   ``d = x_b - x_a``, ``at = compliance / dt^2``, ``w`` the inverse masses
   (zero at the pins), and ``lambda += dlam``; ``a`` moves by
   ``-w_a dlam n`` and ``b`` by ``+w_b dlam n``, ``n = d / |d|``.  The
   moves of a vertex are summed over its constraints and scaled by
   ``relaxation / max(count, 1)``, ``count`` the constraints that touch
   it, into ``delta``; then the ground plane: a free vertex whose
   ``x + delta`` lies below it gets ``delta_y = plane - x_y``, and is
   marked in contact for the rest of the substep;
3. friction once after the loop: a marked vertex keeps ``1 - friction`` of
   its tangential (x and z) change;
4. the pins' change is zero, ``x <- x + delta`` and ``v <- delta / dt``.

Departures from the order that ``kernels/stencil.py::xpbd_substep_grid``
documents, none of which changes a result beyond rounding:

- the velocity is ``delta / dt``, which is ``(x_new - x_start) / dt``
  without the rounding of the subtraction; the program forms it so too;
- each constraint class is taken over the cells where both of its ends
  exist, in place of masked planes over the whole grid; a vertex's moves
  are summed class by class, its owned constraint and the one that owns it
  in one step each, where the program adds them in its own order;
- the ground is at rest: the program's moving plane
  (``plane_velocity``) has no key in the configuration, and friction
  pulls the tangential change toward zero;
- the denominator is not clamped below: ``at > 0`` for every class the
  configurations run (the program clamps it at 1e-12);
- the predict takes gravity alone: wind and external forces are off in
  every configuration that names this reference, and a configuration that
  asks for them, for self-collision or for the strain limit is refused.

Each episode starts from the rest shape with ``grid_cloth``'s seeded
smooth velocity field.
"""

from __future__ import annotations

import importlib.util
import math
import os

import torch


def _grid_cloth():
    """``grid_cloth.py`` beside this file, found by its file as the harness
    finds a module, so that a copy of the folder holds both."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "grid_cloth.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.reference.grid_cloth", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_cloth = _grid_cloth()
rest_positions = _cloth.rest_positions
start_velocity = _cloth.start_velocity
pin_mask = _cloth.pin_mask


def constraints(scene: dict, xpbd: dict):
    """``(di, dj, compliance, rest length)`` of each constraint class
    present, in the program's offset order."""
    h = scene["spacing"]
    a, b = xpbd["compliance_distance"], xpbd["compliance_bend"]
    out = [(0, 1, a, h), (1, 0, a, h)]
    if scene["shear"]:
        out += [(1, 1, a, h * math.sqrt(2.0)), (1, -1, a, h * math.sqrt(2.0))]
    if scene["bend"]:
        out += [(0, 2, b, 2.0 * h), (2, 0, b, 2.0 * h)]
    return out


def ends(ny: int, nx: int, di: int, dj: int):
    """The plane slices of the first end ``(i, j)`` and the second
    ``(i + di, j + dj)`` over the cells where both exist."""
    a = (slice(0, ny - di), slice(max(0, -dj), nx - max(0, dj)))
    b = (slice(di, ny), slice(max(0, dj), nx - max(0, -dj)))
    return a, b


class GridXpbd(_cloth.GridCloth):
    """The reference of one configuration, on ``device`` in ``dtype``: the
    planes, frame and normals of ``grid_cloth.GridCloth``, its own
    substep."""

    def __init__(self, config: dict, dtype=torch.float64, device="cpu"):
        scene, sim = config["scene"], config["sim"]
        if sim["solver"] != "xpbd":
            raise ValueError(f"solver {sim['solver']!r}: this reference runs "
                             "XPBD only")
        for off in ("self_collision", "wind", "strain_limit", "tear",
                    "plasticity"):
            if (sim.get(off) or {}).get("enabled"):
                raise ValueError(f"{off}: not in this reference")
        self.dtype, self.device = dtype, torch.device(device)
        self.ny, self.nx = scene["ny"], scene["nx"]
        xp = sim["xpbd"]
        self.constraints = constraints(scene, xp)
        self.n_iterations = xp["n_iterations"]
        self.relaxation = xp["relaxation"]
        self.dt = sim["dt"]
        self.n_substeps = sim["n_substeps"]
        self.decay = 1.0 - sim["global_damping"] * self.dt
        self.gravity = torch.tensor(sim["gravity"], dtype=dtype,
                                    device=self.device).reshape(3, 1, 1)
        pinned = pin_mask(scene, self.device)
        self.free = ~pinned
        self.inv_mass = torch.where(pinned, 0.0, 1.0 / scene["mass"]).to(
            dtype)
        count = torch.zeros((self.ny, self.nx), dtype=torch.float64,
                            device=self.device)
        for di, dj, _, _ in self.constraints:
            a, b = ends(self.ny, self.nx, di, dj)
            count[a] += 1.0
            count[b] += 1.0
        self.scale = (self.relaxation / torch.clamp_min(count, 1.0)).to(dtype)
        col = sim["collision"]
        self.plane = (scene["plane_height"] if col["enable_plane"] else None)
        self.friction = col["friction"]

    def zero_lambdas(self):
        """A substep's start lambdas: a zero plane a constraint class, over
        its cells."""
        return [torch.zeros_like(self.inv_mass[ends(self.ny, self.nx, di,
                                                    dj)[0]])
                for di, dj, _, _ in self.constraints]

    def sweep(self, x3, delta, lams, contact):
        """One Jacobi sweep from ``x3 + delta``; ``lams`` (one plane a
        constraint class, over its cells) are updated in place.  Returns
        ``(delta, contact)``."""
        xe = x3 + delta
        dx = torch.zeros_like(xe)
        w = self.inv_mass
        for k, (di, dj, alpha, rest) in enumerate(self.constraints):
            a, b = ends(self.ny, self.nx, di, dj)
            d = xe[(slice(None), *b)] - xe[(slice(None), *a)]
            length = torch.sqrt((d * d).sum(dim=0))
            n = d / torch.clamp_min(length, 1e-12)
            at = alpha / (self.dt * self.dt)
            wa, wb = w[a], w[b]
            dlam = -((length - rest) + at * lams[k]) / (wa + wb + at)
            lams[k] += dlam
            dx[(slice(None), *a)] -= (wa * dlam) * n
            dx[(slice(None), *b)] += (wb * dlam) * n
        delta = delta + dx * self.scale
        if self.plane is not None:
            hit = ((x3[1] + delta[1]) < self.plane) & self.free
            delta = torch.stack([delta[0], torch.where(
                hit, self.plane - x3[1], delta[1]), delta[2]])
            contact = contact | hit
        return delta, contact

    def substep(self, x3, v3):
        v3 = (v3 + self.dt * self.gravity) * self.decay
        v3 = torch.where(self.free, v3, torch.zeros_like(v3))
        delta = self.dt * v3
        lams = self.zero_lambdas()
        contact = torch.zeros_like(self.free)
        for _ in range(self.n_iterations):
            delta, contact = self.sweep(x3, delta, lams, contact)
        keep = 1.0 - self.friction
        delta = torch.stack([torch.where(contact, delta[0] * keep, delta[0]),
                             delta[1],
                             torch.where(contact, delta[2] * keep, delta[2])])
        delta = torch.where(self.free, delta, torch.zeros_like(delta))
        return x3 + delta, delta / self.dt


Reference = GridXpbd
