"""Tear liveness and plastic rest-scale planes in the launch-start form the
grid kernels run.

Counterpart of ``softbodyunity_tpu/kernels/pallas_tiled.py``'s
``_feature_plane_maps`` and of the first-flag scan bodies of its row-tiled
kernels (TPU kernels #4-6).  A substep is one kernel launch with no
grid-wide barrier, so the feature update that needs the neighbours' new
positions cannot run at the end of the launch that computes them.  It runs
at the start of the next one instead, from that launch's input positions:

- the planes go in once per frame (:meth:`FeaturePlanes.to_planes`);
- every launch after the first of the frame updates them at its start
  (plastic flow, then the tear check against the flowed rest) and computes
  its substep with the updated planes; the first launch carries the planes
  of the frame's state, which the previous frame's end already updated;
- one more update after the last substep (the frame-end launch, ``finish``)
  gives the state's ``edge_alive``/``rest_scale``.

That is exactly the end-of-substep update of
:func:`.stencil.make_stencil_step` and of the oracle, reordered.
:func:`make_launch_start_step` is the plain PyTorch form of it, built from
:mod:`.stencil`'s functions in the kernels' order, so the CPU tests can hold
the reformulation itself to the end-of-substep form.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.config import SimConfig, Solver
from ..core.state import State
from ..core.topology import EDGE_BEND, EDGE_SHEAR, Topology
from .build import check_launch
from .grid_scene import check_input
from .stencil import (_offsets, _valid_mask, _xpbd_offsets, check_ported,
                      edge_values, euler_substep_grid, from_planes,
                      jacobi_count, tear_plane_maps, to_planes,
                      update_features, verlet_substep_grid,
                      xpbd_substep_grid)


def features_on(cfg: SimConfig) -> bool:
    """Whether ``cfg`` carries feature planes (tearing or plasticity)."""
    return cfg.tear.enabled or cfg.plasticity.enabled


def launches_per_frame(cfg: SimConfig, n_substeps: int,
                       per_substep: int = 1) -> int:
    """A grid kernel's launches in a frame of ``n_substeps``: each
    substep's, plus the frame-end feature update."""
    return n_substeps * per_substep + int(features_on(cfg) and n_substeps > 0)


class FeaturePlanes:
    """The flat ``[E]`` <-> ``[n_off, ny, nx]`` conversion of a grid scene's
    feature fields, built once per step function (the index is computed on
    the host from the edge list and kept on the topology's device)."""

    def __init__(self, top: Topology, cfg: SimConfig, offsets):
        ny, nx = top.grid_shape
        self.cfg = cfg
        self.offsets = offsets
        self.tearing = cfg.tear.enabled
        self.plastic = cfg.plasticity.enabled
        self.n_edges = int(top.edges.shape[0])
        self.edge_to_planes, self.planes_to_edge, _ = tear_plane_maps(
            top, offsets, ny, nx)

    def to_planes(self, state: State):
        """``(alive, scale)`` planes of ``state`` (None for a feature that is
        off; all ones for a field the state does not carry yet)."""
        alive = scale = None
        if self.tearing:
            alive = self.edge_to_planes(edge_values(
                state.edge_alive, self.n_edges, state.x))
        if self.plastic:
            scale = self.edge_to_planes(edge_values(
                state.rest_scale, self.n_edges, state.x))
        return alive, scale

    def to_edges(self, alive, scale, state: State):
        """``(edge_alive, rest_scale)`` of the next state: the planes
        gathered at the edges' owners (valid grid positions only), the
        state's own field for a feature that is off."""
        return ((self.planes_to_edge(alive) if self.tearing
                 else state.edge_alive),
                (self.planes_to_edge(scale) if self.plastic
                 else state.rest_scale))

    def start(self, x3, alive, scale, first: bool):
        """The update at a launch's start, from its input positions ``x3``;
        the first launch of a frame carries its planes unchanged."""
        if first:
            return alive, scale
        return update_features(x3, self.offsets, alive, scale, self.cfg)

    def finish(self, x3, alive, scale, state: State):
        """The frame-end update over the final positions, gathered to the
        edges: ``(edge_alive, rest_scale)``."""
        alive, scale = update_features(x3, self.offsets, alive, scale,
                                       self.cfg)
        return self.to_edges(alive, scale, state)


# ctypes argument types of each grid library's frame-end update,
# grid_<kernel>_features (csrc/grid_common.cuh::launch_feature_finish)
FINISH_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # x, alive in, out
    ctypes.c_void_p, ctypes.c_void_p,                    # scale in, out
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,      # table, limits, n_off
    *[ctypes.c_float] * 5,                               # FeatParams
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,         # ny, nx, stream
]


class FeatParamsStruct(ctypes.Structure):
    """``csrc/grid_common.cuh::FeatParams``: the feature update's scalars
    (:attr:`CudaFeatures.scalars`), for the structs of the substep entries."""

    _fields_ = [(name, ctypes.c_float) for name in (
        "strain1", "yield_strain", "creep", "min_scale", "max_scale")]


def _ptr(t):
    return None if t is None else t.data_ptr()


class CudaFeatures:
    """A grid kernel's feature planes on the card: the tear thresholds and
    update scalars packed once, the planes of a frame in ping-pong buffers
    (a launch reads one and writes the other: an edge's entry is read by two
    threads), and the frame-end launch.  ``finish`` is the library's
    ``grid_<kernel>_features``."""

    def __init__(self, top: Topology, cfg: SimConfig, offsets, finish,
                 error_string, name: str):
        self.planes = FeaturePlanes(top, cfg, offsets)
        self.n_off = len(offsets)
        self.ny, self.nx = top.grid_shape
        sl = cfg.tear.strain_limit
        # rest * (1 + strain_limit) in double, rounded once, as the plain
        # tear check's threshold without plasticity
        self.limits = torch.tensor([off[3] * (1.0 + sl) for off in offsets],
                                   dtype=torch.float32, device=top.device)
        pp = cfg.plasticity
        self.scalars = (1.0 + sl, pp.yield_strain, pp.creep, pp.min_scale,
                        pp.max_scale)
        self._finish, self._error_string, self._name = (finish, error_string,
                                                        name)
        self.alive = self.alive_out = self.scale = self.scale_out = None

    def begin(self, state: State) -> None:
        """Load the frame's planes from ``state`` into the read buffers."""
        for name, on in (("edge_alive", self.planes.tearing),
                         ("rest_scale", self.planes.plastic)):
            t = getattr(state, name)
            if on and t is not None:
                check_input(f"state.{name}", t, (self.planes.n_edges,),
                            self.limits.device)
        self.alive, self.scale = self.planes.to_planes(state)
        self.alive_out = (None if self.alive is None
                          else torch.empty_like(self.alive))
        self.scale_out = (None if self.scale is None
                          else torch.empty_like(self.scale))

    def swap(self) -> None:
        """After a launch: its output planes are the next one's input."""
        self.alive, self.alive_out = self.alive_out, self.alive
        self.scale, self.scale_out = self.scale_out, self.scale

    def launch_finish(self, x3: torch.Tensor, table: torch.Tensor,
                      stream) -> None:
        """The frame-end update over the final positions ``x3``, then
        :meth:`swap`."""
        check_launch(self._finish(
            x3.data_ptr(), _ptr(self.alive), _ptr(self.alive_out),
            _ptr(self.scale), _ptr(self.scale_out), table.data_ptr(),
            self.limits.data_ptr(), self.n_off, *self.scalars, self.ny,
            self.nx, stream), f"{self._name} features", self._error_string)
        self.swap()

    def end(self, state: State):
        """``(edge_alive, rest_scale)`` of the next state, gathered from the
        read buffers."""
        return self.planes.to_edges(self.alive, self.scale, state)

    def update(self, x3, alive, scale, table):
        """One frame-end launch on the given planes (either may be None),
        outside any frame: the new ``(alive, scale)`` planes.  The card
        tests and ``chip_smoke.py`` hold it to
        :func:`.stencil.update_features` on the same inputs."""
        self.alive, self.scale = alive, scale
        self.alive_out = None if alive is None else torch.empty_like(alive)
        self.scale_out = None if scale is None else torch.empty_like(scale)
        with torch.cuda.device(x3.device):
            self.launch_finish(x3.contiguous(), table,
                               torch.cuda.current_stream().cuda_stream)
        return self.alive, self.scale


def make_launch_start_step(top: Topology, cfg: SimConfig):
    """Build ``fn(state, dt, n_substeps) -> state`` that runs a grid scene
    with feature planes in the kernels' launch-start form, in plain
    PyTorch: per substep :meth:`FeaturePlanes.start` (first-launch flag),
    then the substep on the updated planes (XPBD: its Jacobi count from
    them), and :meth:`FeaturePlanes.finish` after the last.  Self-collision
    is not taken: this is the reformulation's own check."""
    check_ported(cfg)
    if not features_on(cfg):
        raise ValueError("make_launch_start_step needs tearing or plasticity")
    if cfg.self_collision.enabled:
        raise ValueError("make_launch_start_step takes no self-collision")
    ny, nx = top.grid_shape
    has_shear = EDGE_SHEAR in top.edge_classes_present
    has_bend = EDGE_BEND in top.edge_classes_present
    offsets = _offsets(cfg, top.grid_spacing, has_shear, has_bend)
    xoffsets = _xpbd_offsets(cfg, top.grid_spacing, has_shear, has_bend)
    valid = [_valid_mask(ny, nx, di, dj, top.device, top.dtype)
             for di, dj, _, _ in offsets]
    gravity = torch.tensor(cfg.gravity, dtype=top.dtype,
                           device=top.device).reshape(3, 1, 1)
    inv_mass2 = top.inv_mass.reshape(1, ny, nx)
    planes = FeaturePlanes(top, cfg, offsets)

    def fn(state: State, dt: float, n_substeps: int) -> State:
        x3 = to_planes(state.x, ny, nx)
        xp3 = to_planes(state.x_prev, ny, nx)
        v3 = to_planes(state.v, ny, nx)
        alive, scale = planes.to_planes(state)
        for k in range(n_substeps):
            alive, scale = planes.start(x3, alive, scale, first=k == 0)
            m = valid if alive is None else alive
            if cfg.solver == Solver.VERLET:
                x3, xp3 = verlet_substep_grid(x3, xp3, inv_mass2, offsets, m,
                                              gravity, cfg, dt, top,
                                              scale=scale)
            elif cfg.solver == Solver.XPBD:
                x3, v3 = xpbd_substep_grid(x3, v3, inv_mass2, xoffsets, m,
                                           jacobi_count(xoffsets, m),
                                           gravity, cfg, dt, top,
                                           scale=scale)
            else:
                x3, v3 = euler_substep_grid(x3, v3, inv_mass2, offsets, m,
                                            gravity, cfg, dt, top,
                                            scale=scale)
        if n_substeps > 0:
            edge_alive, rest_scale = planes.finish(x3, alive, scale, state)
        else:
            edge_alive, rest_scale = planes.to_edges(alive, scale, state)
        if cfg.solver == Solver.VERLET:
            v3 = (x3 - xp3) / dt
        else:
            xp3 = x3 - dt * v3
        return State(x=from_planes(x3), v=from_planes(v3),
                     x_prev=from_planes(xp3), edge_alive=edge_alive,
                     rest_scale=rest_scale, cluster_quat=state.cluster_quat)

    return fn
