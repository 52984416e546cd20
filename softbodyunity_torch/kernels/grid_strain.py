"""The strain limit's sweeps on the card, shared by the three grid kernel
wrappers (:mod:`.grid_euler`, :mod:`.grid_verlet`, :mod:`.grid_xpbd`).

Counterpart of ``softbodyunity_tpu/kernels/pallas_substep.py::
_strain_limit_planes``, which the TPU's fused Euler, Verlet and XPBD grid
kernels run inside their substep.  Here a Jacobi sweep needs every
neighbour's result of the sweep before, so each sweep is one launch of
``csrc/grid_common.cuh::grid_strain_sweep_kernel`` (each grid library
exports it as ``grid_<solver>_strain``, with that solver's epilogue), after
the substep's integrate launch (Euler, Verlet) or Jacobi sweeps (XPBD); the
last sweep runs the rest of the substep.  Its plain version is
:func:`.stencil.strain_limit_planes`.

Each sweep launch counts once here and once in its solver wrapper's count.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.config import SimConfig
from .grid_scene import check_launch

_launches = 0


def launch_count() -> int:
    """Strain sweep launches, of every grid solver, since the last
    :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def sweeps(cfg: SimConfig) -> int:
    """Sweep launches per substep: ``iterations``, at least one (with none,
    one launch runs the epilogue alone), and 0 without the strain limit."""
    sl = cfg.strain_limit
    return max(sl.iterations, 1) if sl.enabled else 0


# ctypes argument types that every grid_<solver>_strain starts with: the
# sweep's positions (base, add, xs_out), inv_mass, the offset table, the
# bands, n_off, the tear and plastic planes, StrainParams, project, last
SWEEP_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_float, ctypes.c_float, ctypes.c_int,
    ctypes.c_int, ctypes.c_int,
]


def _ptr(t):
    return None if t is None else t.data_ptr()


class CudaStrain:
    """A grid scene's strain limit on the card: the per-offset bands
    ``(rest * (1 + max_stretch), rest * (1 - max_compress) or 0)`` rounded
    once from double, as the plain version's Python floats are, the sweep
    scalars, and two scratch position planes for the sweeps' ping-pong."""

    def __init__(self, cfg: SimConfig, offsets, inv_mass: torch.Tensor,
                 launch, error_string, name: str):
        sl = cfg.strain_limit
        compress = sl.max_compress >= 0.0
        self.n_sweeps = sweeps(cfg)
        self.project = int(sl.iterations > 0)
        self.n_off = len(offsets)
        self.limits = torch.tensor(
            [(off[3] * (1.0 + sl.max_stretch),
              off[3] * (1.0 - sl.max_compress) if compress else 0.0)
             for off in offsets], dtype=torch.float32,
            device=inv_mass.device)
        self.scalars = (1.0 + sl.max_stretch, 1.0 - sl.max_compress,
                        int(compress))
        self.inv_mass = inv_mass
        self._launch, self._error_string, self._name = (launch, error_string,
                                                        name)
        self.scratch = ()

    def begin(self, like: torch.Tensor) -> None:
        """Allocate the sweeps' scratch planes for a call's frames."""
        if self.n_sweeps > 1:
            self.scratch = (torch.empty_like(like), torch.empty_like(like))

    def launch(self, base, add, table, alive, scale, epilogue) -> int:
        """Launch one substep's sweeps; the first reads ``base`` (plus
        ``add`` where it is not None), each later one its predecessor's
        output, and the last runs the solver's epilogue, whose arguments
        (after :data:`SWEEP_ARGTYPES`) are ``epilogue``.  ``alive`` and
        ``scale`` are the substep's feature planes or None.  Returns the
        number of launches."""
        global _launches
        for k in range(self.n_sweeps):
            last = k == self.n_sweeps - 1
            out = None if last else self.scratch[k % 2]
            check_launch(self._launch(
                _ptr(base), _ptr(add), _ptr(out), self.inv_mass.data_ptr(),
                table.data_ptr(), self.limits.data_ptr(), self.n_off,
                _ptr(alive), _ptr(scale), *self.scalars, self.project,
                int(last), *epilogue), f"{self._name} strain sweep",
                self._error_string)
            _launches += 1
            base, add = out, None
        return self.n_sweeps
