"""Substeps of the banded (tet-lattice) path in plain PyTorch.

Counterpart of ``softbodyunity_tpu/solver/step.py`` for its banded branches:
Euler (``euler_integrate`` + the velocity-level resolve), Verlet
(``verlet_integrate`` + ``verlet_contact_project``) and XPBD (the banded
Jacobi loop of ``substep_xpbd``, in delta form), with the same operations in
the same order, the wind's drag and the capsule and box contact included.
These are the plain versions of the tet-lattice CUDA kernels
(``kernels/csrc/lattice_euler.cu``,
``lattice_verlet.cu``, ``lattice_xpbd.cu``):
:mod:`softbodyunity_torch.kernels.dispatch` takes
:func:`make_plain_step` for tensors on the CPU, and ``chip_smoke.py`` holds
each kernel to it on the card.  They run in float32 or float64.

Only scenes whose springs and tets are all banded run here (no residual
elements, :func:`softbodyunity_torch.kernels.lattice.lattice_gate`); the
general edge-list path is not ported yet (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import torch

from ..core.config import SimConfig, Solver
from ..core.state import State
from ..core.topology import Topology, check_same_scene
from . import banded, collide


def _volume_on(top: Topology, cfg: SimConfig) -> bool:
    return top.n_tets > 0 and cfg.volume_stiffness != 0.0


def _volume_projection(top: Topology, x: torch.Tensor,
                       stiffness: float) -> torch.Tensor:
    return banded.banded_volume_projection(top.tet_groups, x.t(),
                                           top.inv_mass, stiffness).t()


def wind_drag(cfg: SimConfig, v, wvel):
    """The wind's drag ``drag * (velocity - v)`` on ``[N, 3]`` velocities
    (the oracle's ``wind_forces`` without lift, which the lattice path
    refuses); ``wvel`` is the wind velocity row ``[1, 3]``."""
    return cfg.wind.drag * (wvel - v)


def euler_integrate(top: Topology, cfg: SimConfig, x, v, dt: float, g,
                    wvel=None):
    """The Euler substep before contact: banded spring forces plus the
    wind's drag when ``wvel`` (its velocity row ``[1, 3]``) is given, the
    semi-implicit velocity and position update, pinning, and the banded
    volume projection.  ``g`` is the gravity row ``[1, 3]``.  Returns
    ``(x, v, movable)``."""
    w = top.inv_mass[:, None]
    movable = top.inv_mass > 0.0
    f = banded.banded_spring_forces(top.offset_groups, x.t(), v.t(),
                                    cfg.springs.damping).t()
    if wvel is not None:
        f = f + wind_drag(cfg, v, wvel)
    v = (v + dt * (g + f * w)) * (1.0 - cfg.global_damping * dt)
    v = torch.where(movable[:, None], v, 0.0)
    x = x + dt * v
    if _volume_on(top, cfg):
        dx = _volume_projection(top, x, cfg.volume_stiffness)
        x = x + dx
        v = v + dx / dt
    return x, v, movable


def substep_euler(top: Topology, cfg: SimConfig, x, v, dt: float, g,
                  wvel=None):
    x, v, movable = euler_integrate(top, cfg, x, v, dt, g, wvel)
    return collide.resolve_velocity_level(top, cfg, x, v, movable)


def verlet_integrate(top: Topology, cfg: SimConfig, x, x_prev, dt: float,
                     g, wvel=None):
    """The Verlet substep before contact: spring forces (and the wind's
    drag) at the velocity estimate, the damped position update, pinning,
    and the banded volume projection.  Returns ``(x_new, movable)``."""
    w = top.inv_mass[:, None]
    movable = top.inv_mass > 0.0
    v_est = (x - x_prev) / dt
    f = banded.banded_spring_forces(top.offset_groups, x.t(), v_est.t(),
                                    cfg.springs.damping).t()
    if wvel is not None:
        f = f + wind_drag(cfg, v_est, wvel)
    accel = g + f * w
    x_new = x + (x - x_prev) * (1.0 - cfg.global_damping * dt) + accel * dt * dt
    x_new = torch.where(movable[:, None], x_new, x)
    if _volume_on(top, cfg):
        x_new = x_new + _volume_projection(top, x_new, cfg.volume_stiffness)
    return x_new, movable


def verlet_contact_project(top: Topology, cfg: SimConfig, x_new, x_old,
                           dt: float, movable):
    """The Verlet substep's position-level contact chain: the pre-clamp
    contact record, the projection, then plane, sphere and capsule/box
    friction."""
    contact = collide.plane_contact_preclamp(top, cfg, x_new, movable)
    x_new = collide.project_positions_only(top, cfg, x_new, movable)
    x_new = collide.plane_friction_positions(top, cfg, x_new, x_old, dt,
                                             contact)
    x_new = collide.sphere_friction_positions(top, cfg, x_new, x_old, dt,
                                              movable)
    return collide.rest_friction_positions(top, cfg, x_new, x_old, dt,
                                           movable)


def substep_verlet(top: Topology, cfg: SimConfig, x, x_prev, dt: float, g,
                   wvel=None):
    """Returns ``(x_new, x)``: the new position and the new history."""
    x_new, movable = verlet_integrate(top, cfg, x, x_prev, dt, g, wvel)
    return verlet_contact_project(top, cfg, x_new, x, dt, movable), x


def substep_xpbd(top: Topology, cfg: SimConfig, x, v, dt: float, g, cnt,
                 wvel=None):
    """One XPBD substep, banded: predict (the wind's drag, when ``wvel`` is
    given, entering as ``g + drag * (velocity - v) * w``, as
    ``pallas_lattice.py`` takes it), ``n_iterations`` Jacobi sweeps
    over the distance and volume constraints with contact projected inside
    the loop, plane friction once from the OR of the sweeps' pre-clamp
    contact masks, sphere and capsule/box friction, and ``v = delta / dt``.  ``cnt`` is
    :func:`.banded.xpbd_constraint_count`.  Returns ``(x, v)``.

    Delta form: the loop carries the substep's position change ``delta``
    and never a rounded ``x``; only the evaluation point ``x_prev + delta``
    rounds large plus small, and it is never stored."""
    movable = top.inv_mass > 0.0
    acc = (g if wvel is None
           else g + wind_drag(cfg, v, wvel) * top.inv_mass[:, None])
    v = (v + dt * acc) * (1.0 - cfg.global_damping * dt)
    v = torch.where(movable[:, None], v, 0.0)
    x_prev = x
    n = x.shape[0]
    lams = tuple(torch.zeros_like(top.inv_mass)
                 for _ in top.offset_groups.deltas)
    lamv = tuple(torch.zeros_like(top.inv_mass)
                 for _ in top.tet_groups.deltas)
    x_prevT = x_prev.t()
    deltaT = (dt * v).t()
    contact = torch.zeros(n, dtype=torch.bool, device=x.device)
    for _ in range(cfg.xpbd.n_iterations):
        dxT, lams, lamv = banded.xpbd_iteration_banded(
            top, cfg, x_prevT + deltaT, lams, lamv, cnt, dt)
        deltaT = deltaT + dxT
        delta, pc = collide.project_positions_delta(top, cfg, x_prev,
                                                    deltaT.t(), movable)
        deltaT = delta.t()
        contact = contact | pc
    delta = deltaT.t()
    delta = collide.plane_friction_delta(top, cfg, delta, dt, contact)
    xe = x_prev + delta
    xf = collide.sphere_friction_positions(top, cfg, xe, x_prev, dt, movable)
    xf = collide.rest_friction_positions(top, cfg, xf, x_prev, dt, movable)
    delta = delta + (xf - xe)
    delta = torch.where(movable[:, None], delta, 0.0)
    return x_prev + delta, delta / dt


def make_plain_step(top: Topology, cfg: SimConfig):
    """Build ``fn(state, dt, n_substeps) -> state`` that runs the banded
    substeps of ``cfg.solver`` in plain PyTorch on whatever device and
    dtype ``top`` has.  Euler and XPBD return ``x_prev = x - dt * v``, as the
    JAX package's fused lattice paths do; Verlet returns its history.

    Everything a substep reads besides the state and the collider rows is
    built here, once, on the device, so a frame makes no host-to-device
    copy.  The collider rows are read from the call's ``top`` where one is
    passed (:func:`softbodyunity_torch.api.move_colliders`)."""
    from ..kernels.lattice import lattice_gate

    lattice_gate(top, cfg)
    g = torch.tensor(cfg.gravity, dtype=top.dtype, device=top.device)[None, :]
    # the wind's drag (lift is refused on lattices: lattice_gate)
    wvel = (torch.tensor(cfg.wind.velocity, dtype=top.dtype,
                         device=top.device)[None, :]
            if cfg.wind.enabled else None)
    if cfg.solver == Solver.XPBD:
        cnt = banded.xpbd_constraint_count(top)

    built = top

    def fn(state: State, dt: float, n_substeps: int, top=None) -> State:
        # the call's topology (api.move_colliders) carries the colliders
        if top is None:
            top = built
        check_same_scene(built, top)
        dt = float(dt)
        x = state.x
        if cfg.solver == Solver.VERLET:
            xp = state.x_prev
            for _ in range(n_substeps):
                x, xp = substep_verlet(top, cfg, x, xp, dt, g, wvel)
            return State(x=x, v=(x - xp) / dt, x_prev=xp)
        v = state.v
        for _ in range(n_substeps):
            if cfg.solver == Solver.XPBD:
                x, v = substep_xpbd(top, cfg, x, v, dt, g, cnt, wvel)
            else:
                x, v = substep_euler(top, cfg, x, v, dt, g, wvel)
        return State(x=x, v=v, x_prev=x - dt * v)

    return fn
