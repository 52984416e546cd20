"""Public API: ``init`` / ``step`` / ``rollout`` / ``move_colliders`` /
``normals``.

Counterpart of ``softbodyunity_tpu/api.py`` for the grid-cloth and
tet-lattice slices (Euler, Verlet, XPBD; the solver is ``cfg.solver``).
``init`` builds the device topology and rest state once; ``step`` advances one
frame of ``n_substeps`` substeps; ``move_colliders`` animates the colliders
between frames.  PyTorch runs eagerly, so where the JAX package compiles one
executable per config, this module builds one step function per scene and
``SimConfig`` and keeps it; the scene's collider rows are read from the
topology of each call.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .core.config import SimConfig
from .core.state import State, make_state
from .core.topology import HostTopology, SceneKey, Topology
from .solver.normals import incident_faces
from .solver.normals import vertex_normals as _vertex_normals


def suggest_dt(host: HostTopology, cfg: SimConfig, *,
               safety: float = 0.35) -> float:
    """Largest stable substep dt for explicit integration on this scene.

    Explicit integration is stable for ``dt < 2 / omega_max``; the bound uses
    the Gershgorin estimate of the spring Jacobian's largest eigenvalue,
    ``omega_max^2 <= 2 * max_i (w_i * sum_{e at i} k_e)``, times ``safety``
    for headroom (spring damping, contact kicks).  Host-side NumPy, the same
    function as ``softbodyunity_tpu.api.suggest_dt``."""
    k = np.asarray(host.edge_stiffness, np.float64)
    if host.edges.shape[0] == 0 or float(k.max(initial=0.0)) <= 0.0:
        return float(cfg.dt)
    w = np.asarray(host.inv_mass, np.float64)
    k_sum = np.zeros_like(w)
    np.add.at(k_sum, host.edges[:, 0], k)
    np.add.at(k_sum, host.edges[:, 1], k)
    omega_max = float(np.sqrt(2.0 * (w * k_sum).max()))
    if omega_max <= 0.0:
        return float(cfg.dt)
    return float(safety * 2.0 / omega_max)


def device_topology(host: HostTopology, device,
                    dtype=torch.float32) -> Topology:
    """Cast the float64 host topology's fields that the grid and lattice
    paths read to tensors on ``device`` (float32 for the kernel path; the
    tests also pass float64 to hold the port to the NumPy oracle).

    The banded spring and tet groups (:mod:`.solver.banded`) are built where
    the JAX package builds them, for every non-grid scene and for grids of
    at most 65,536 vertices, and moved to the device once, here."""
    from .solver.banded import build_offset_groups, build_tet_groups

    device = torch.device(device)
    n = host.positions0.shape[0]
    groups = tgroups = None
    if host.grid_shape is None or n <= 65536:
        groups = build_offset_groups(
            n, np.asarray(host.edges), np.asarray(host.rest_length),
            np.asarray(host.edge_stiffness),
            np.asarray(host.edge_compliance)).to(device, dtype)
        tgroups = build_tet_groups(
            n, np.asarray(host.tets),
            np.asarray(host.rest_volume)).to(device, dtype)

    def f(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    def i(a):
        return torch.tensor(np.asarray(a), dtype=torch.int64, device=device)

    def rows(a, shape):
        """A collider field as ``shape`` rows; zero rows where it is None."""
        return f(np.zeros(shape) if a is None
                 else np.asarray(a).reshape((-1,) + shape[1:]))

    def velocities(a, n_rows):
        return rows(np.zeros((n_rows, 3)) if a is None else a, (n_rows, 3))

    n_spheres = np.asarray(host.sphere_radii).shape[0]
    n_caps = 0 if host.capsule_radii is None else len(host.capsule_radii)
    n_boxes = 0 if host.box_centers is None else len(host.box_centers)
    return Topology(
        inv_mass=f(host.inv_mass),
        plane_height=f(host.plane_height),
        plane_velocity=f(host.plane_velocity if host.plane_velocity is not None
                         else np.zeros(3)),
        sphere_centers=f(np.asarray(host.sphere_centers).reshape(-1, 3)),
        sphere_radii=f(host.sphere_radii),
        sphere_velocities=velocities(host.sphere_velocities, n_spheres),
        capsule_p0=rows(host.capsule_p0, (n_caps, 3)),
        capsule_p1=rows(host.capsule_p1, (n_caps, 3)),
        capsule_radii=rows(host.capsule_radii, (n_caps,)),
        capsule_velocities=velocities(host.capsule_velocities, n_caps),
        box_centers=rows(host.box_centers, (n_boxes, 3)),
        box_half_extents=rows(host.box_half_extents, (n_boxes, 3)),
        box_rotations=rows(host.box_rotations, (n_boxes, 3, 3)),
        box_velocities=velocities(host.box_velocities, n_boxes),
        triangles=i(host.triangles),
        edges=i(host.edges),
        rest_length=f(host.rest_length),
        n_vertices=n,
        grid_shape=host.grid_shape,
        grid_spacing=host.grid_spacing,
        edge_classes_present=host.edge_classes_present,
        offset_groups=groups,
        tet_groups=tgroups,
        n_tets=int(np.asarray(host.tets).shape[0]),
    )


def init(host: HostTopology, device="cuda",
         dtype=torch.float32) -> Tuple[Topology, State]:
    """Build the device topology and rest state on ``device``, the one
    host-to-device boundary.  Raises when a CUDA device is asked for and
    none is available: pass ``device="cpu"`` for the plain PyTorch path."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"init(device={str(device)!r}) needs a CUDA device and "
            "torch.cuda.is_available() is False")
    return (device_topology(host, device, dtype),
            make_state(host.positions0, device, dtype))


@functools.lru_cache(maxsize=16)
def _build_step(key: SceneKey, cfg: SimConfig):
    """One built step function per (scene, config): the offset table, the
    plane index and the ownership words are built once, not every frame.
    ``key`` leaves out the collider rows, so a topology from
    :func:`move_colliders` reuses the function (``cache_info().misses``
    counts the builds)."""
    from .kernels import dispatch

    return dispatch.maybe_fast_step(key.top, cfg)


def _dispatch_step(top, cfg, state, dt, n_substeps):
    # the call's topology carries the collider rows the frame reads
    return _build_step(SceneKey(top), cfg)(state, dt, n_substeps, top=top)


def move_colliders(
    top: Topology,
    sphere_centers=None,
    sphere_radii=None,
    plane_height=None,
    capsule_p0=None,
    capsule_p1=None,
    capsule_radii=None,
    box_centers=None,
    box_half_extents=None,
    box_rotations=None,
    plane_velocity=None,
    sphere_velocities=None,
    capsule_velocities=None,
    box_velocities=None,
) -> Topology:
    """Animated colliders (the Unity moving-Collider analogue): a topology
    with the given collider geometry and kinematic velocities replaced and
    every other field shared with ``top``.  ``step`` reuses the step
    function built for ``top`` and reads the new rows (a few hundred bytes)
    in the next frame; a new collider count builds a new one.  Port of
    ``softbodyunity_tpu.api.move_colliders`` without its SDF arguments (SDF
    colliders are not ported).

    The ``*_velocities`` rows are the colliders' kinematic velocities: the
    velocity-level (Euler) contact responds relative to them, and the
    position-level friction of Verlet and XPBD damps the tangential
    displacement relative to them.  When animating geometry between frames,
    also set the matching velocity (``(new - old) / frame_dt``)."""
    kw = {}
    for name, val in (
        ("sphere_centers", sphere_centers),
        ("sphere_radii", sphere_radii),
        ("plane_height", plane_height),
        ("capsule_p0", capsule_p0),
        ("capsule_p1", capsule_p1),
        ("capsule_radii", capsule_radii),
        ("box_centers", box_centers),
        ("box_half_extents", box_half_extents),
        ("box_rotations", box_rotations),
        ("plane_velocity", plane_velocity),
        ("sphere_velocities", sphere_velocities),
        ("capsule_velocities", capsule_velocities),
        ("box_velocities", box_velocities),
    ):
        if val is not None:
            old = getattr(top, name)
            shape = (old.shape if name.startswith("plane_")
                     else (-1,) + tuple(old.shape[1:]))
            kw[name] = torch.as_tensor(
                np.asarray(val) if not torch.is_tensor(val) else val,
                dtype=top.dtype, device=top.device).reshape(shape)
    return dataclasses.replace(top, **kw)


def ensure_tear_state(top: Topology, cfg: SimConfig, state: State) -> State:
    """Populate ``State.edge_alive`` (every edge live) when a tearing config
    meets a state without it; no-op otherwise."""
    if cfg.tear.enabled and state.edge_alive is None:
        state = state.replace(edge_alive=torch.ones(
            int(top.edges.shape[0]), dtype=state.x.dtype,
            device=state.x.device))
    return state


def ensure_plastic_state(top: Topology, cfg: SimConfig,
                         state: State) -> State:
    """Populate ``State.rest_scale`` (all ones) when a plasticity config
    meets a state without it; no-op otherwise."""
    if cfg.plasticity.enabled and state.rest_scale is None:
        state = state.replace(rest_scale=torch.ones(
            int(top.edges.shape[0]), dtype=state.x.dtype,
            device=state.x.device))
    return state


def step(
    top: Topology,
    cfg: SimConfig,
    state: State,
    dt: Optional[float] = None,
    n_substeps: Optional[int] = None,
) -> State:
    """Advance one frame: ``n_substeps`` substeps of size ``dt``.  Verlet
    reads ``state.x_prev`` as its history (so a state handed over from a
    running scene keeps its motion); Euler and XPBD read ``state.v``.
    Under tearing or plasticity a state without ``edge_alive`` or
    ``rest_scale`` starts with every edge live and unscaled."""
    dt = cfg.dt if dt is None else float(dt)
    n = cfg.n_substeps if n_substeps is None else int(n_substeps)
    state = ensure_plastic_state(top, cfg, ensure_tear_state(top, cfg, state))
    return _dispatch_step(top, cfg, state, dt, n)


def rollout(
    top: Topology,
    cfg: SimConfig,
    state: State,
    n_steps: int,
    dt: Optional[float] = None,
    n_substeps: Optional[int] = None,
):
    """Run ``n_steps`` frames; returns ``(final_state, xs[n_steps, N, 3])``."""
    dt = cfg.dt if dt is None else float(dt)
    n = cfg.n_substeps if n_substeps is None else int(n_substeps)
    state = ensure_plastic_state(top, cfg, ensure_tear_state(top, cfg, state))
    xs = torch.empty((int(n_steps),) + tuple(state.x.shape),
                     dtype=state.x.dtype, device=state.x.device)
    for t in range(int(n_steps)):
        state = _dispatch_step(top, cfg, state, dt, n)
        xs[t] = state.x
    return state, xs


@functools.lru_cache(maxsize=16)
def _normal_table(key: SceneKey) -> torch.Tensor:
    """The incident-face table of the scene's triangles, built once per
    scene (a topology from :func:`move_colliders` shares it) and kept, as
    :func:`_build_step` keeps its step functions, for the 16 scenes last
    used."""
    return incident_faces(key.top.triangles, key.top.n_vertices)


def normals(top: Topology, state: State) -> torch.Tensor:
    """Vertex normals for rendering (Unity RecalculateNormals analogue),
    summed in a fixed order: the same bits on every run."""
    return _vertex_normals(top.triangles, state.x,
                           _normal_table(SceneKey(top)))
