"""Public API: ``init`` / ``step`` / ``rollout`` / ``normals``.

Counterpart of ``softbodyunity_tpu/api.py`` for the grid-cloth Euler slice.
``init`` builds the device topology and rest state once; ``step`` advances one
frame of ``n_substeps`` substeps.  PyTorch runs eagerly, so where the JAX
package compiles one executable per config, this module builds one step
function per ``(Topology, SimConfig)`` and keeps it.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .core.config import SimConfig
from .core.state import State, make_state
from .core.topology import HostTopology, Topology
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
    """Cast the float64 host topology's fields that the grid path reads to
    tensors on ``device`` (float32 for the kernel path; the tests also pass
    float64 to hold the port to the NumPy oracle)."""
    device = torch.device(device)

    def f(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    def i(a):
        return torch.tensor(np.asarray(a), dtype=torch.int64, device=device)

    n_spheres = np.asarray(host.sphere_radii).shape[0]
    return Topology(
        inv_mass=f(host.inv_mass),
        plane_height=f(host.plane_height),
        plane_velocity=f(host.plane_velocity if host.plane_velocity is not None
                         else np.zeros(3)),
        sphere_centers=f(np.asarray(host.sphere_centers).reshape(-1, 3)),
        sphere_radii=f(host.sphere_radii),
        sphere_velocities=f(host.sphere_velocities
                            if host.sphere_velocities is not None
                            else np.zeros((n_spheres, 3))),
        triangles=i(host.triangles),
        edges=i(host.edges),
        rest_length=f(host.rest_length),
        n_vertices=host.positions0.shape[0],
        grid_shape=host.grid_shape,
        grid_spacing=host.grid_spacing,
        edge_classes_present=host.edge_classes_present,
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
def _step_fn(top: Topology, cfg: SimConfig):
    """One built step function per (topology, config): packing the collider
    rows and the offset table happens once, not every frame."""
    from .kernels import dispatch

    return dispatch.maybe_fast_step(top, cfg)


def _dispatch_step(top, cfg, state, dt, n_substeps):
    return _step_fn(top, cfg)(state, dt, n_substeps)


def step(
    top: Topology,
    cfg: SimConfig,
    state: State,
    dt: Optional[float] = None,
    n_substeps: Optional[int] = None,
) -> State:
    """Advance one frame: ``n_substeps`` substeps of size ``dt``."""
    dt = cfg.dt if dt is None else float(dt)
    n = cfg.n_substeps if n_substeps is None else int(n_substeps)
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
    xs = torch.empty((int(n_steps),) + tuple(state.x.shape),
                     dtype=state.x.dtype, device=state.x.device)
    for t in range(int(n_steps)):
        state = _dispatch_step(top, cfg, state, dt, n)
        xs[t] = state.x
    return state, xs


def normals(top: Topology, state: State) -> torch.Tensor:
    """Vertex normals for rendering (Unity RecalculateNormals analogue)."""
    return _vertex_normals(top.triangles, state.x)
