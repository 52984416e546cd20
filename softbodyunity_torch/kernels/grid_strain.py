"""The strain limit's sweeps on the card, shared by the three grid kernel
wrappers (:mod:`.grid_euler`, :mod:`.grid_verlet`, :mod:`.grid_xpbd`).

Counterpart of ``softbodyunity_tpu/kernels/pallas_substep.py::
_strain_limit_planes``, which the TPU's fused Euler, Verlet and XPBD grid
kernels run inside their substep.  Here a substep's sweeps are one
cooperative launch of ``csrc/grid_common.cuh::grid_strain_sweep_kernel``
with each solver's epilogue (launched from the frame entries
``grid_euler_substeps`` and ``grid_verlet_substeps``, and from the
``grid_euler_strain`` and ``grid_xpbd_strain`` entries), after the
substep's integrate launch (Euler, Verlet) or Jacobi sweeps (XPBD): a grid
barrier separates the sweeps, and the last runs the rest of the substep.
Its plain version is :func:`.stencil.strain_limit_planes`.

Each launch counts once here and once in its solver wrapper's count.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.config import SimConfig
from ..utils import profiling
from .build import check_launch
from .grid_scene import sweep_pattern


def launch_count() -> int:
    """Strain launches, of every grid solver, since the last
    :func:`reset_launch_count`."""
    return profiling.count("grid_strain")


def reset_launch_count() -> None:
    profiling.reset_count("grid_strain")


def add_launches(n: int) -> None:
    """Count ``n`` strain launches that a solver's C entry made itself
    (``grid_euler_substeps`` and ``grid_verlet_substeps`` launch a
    substep's sweeps)."""
    profiling.add("grid_strain", n)


def sweeps(cfg: SimConfig) -> int:
    """Strain launches per substep: one, which runs every sweep (with
    ``iterations = 0``, the epilogue alone), and 0 without the strain
    limit."""
    return int(cfg.strain_limit.enabled)


def n_sweeps(cfg: SimConfig) -> int:
    """The sweeps that one launch runs: ``iterations``, at least one."""
    return max(cfg.strain_limit.iterations, 1)


class StrainParamsStruct(ctypes.Structure):
    _fields_ = [("stretch1", ctypes.c_float), ("compress1", ctypes.c_float),
                ("compress_on", ctypes.c_int)]


class SweepsStruct(ctypes.Structure):
    """``csrc/grid_common.cuh::StrainSweeps`` field by field."""

    _fields_ = [
        *[(name, ctypes.c_void_p) for name in ("inv_mass", "table",
                                               "limits")],
        ("scratch", ctypes.c_void_p * 2),
        ("inv_cnt", ctypes.c_void_p),
        *[(name, ctypes.c_int) for name in (
            "pattern", "n_sweeps", "project", "ny", "nx")],
        ("sp", StrainParamsStruct),
    ]


def _ptr(t):
    return None if t is None else t.data_ptr()


class CudaStrain:
    """A grid scene's strain limit on the card: the per-offset bands
    ``(rest * (1 + max_stretch), rest * (1 - max_compress) or 0)`` rounded
    once from double, as the plain version's Python floats are, the sweep
    scalars, the offsets' pattern, and per call the scratch planes of the
    sweeps' ping-pong and Jacobi weights.  ``launch`` is the library's
    ``grid_<solver>_strain`` (None where a frame entry launches the sweeps
    itself); ``size`` its ``grid_<solver>_strain_size``, which must be the
    ctypes mirror's."""

    def __init__(self, cfg: SimConfig, offsets, inv_mass: torch.Tensor,
                 launch, size, error_string, name: str):
        if size() != ctypes.sizeof(SweepsStruct):
            raise RuntimeError(
                f"{name}: the C StrainSweeps struct has {size()} bytes, its "
                f"ctypes mirror {ctypes.sizeof(SweepsStruct)}")
        sl = cfg.strain_limit
        compress = sl.max_compress >= 0.0
        self.n_sweeps = n_sweeps(cfg)
        self.project = int(sl.iterations > 0)
        self.pattern = sweep_pattern(offsets)
        self.limits = torch.tensor(
            [(off[3] * (1.0 + sl.max_stretch),
              off[3] * (1.0 - sl.max_compress) if compress else 0.0)
             for off in offsets], dtype=torch.float32,
            device=inv_mass.device)
        self.scalars = StrainParamsStruct(1.0 + sl.max_stretch,
                                     1.0 - sl.max_compress, int(compress))
        self.inv_mass = inv_mass
        self._launch, self._error_string, self._name = (launch, error_string,
                                                        name)
        self.args = None

    def begin(self, like: torch.Tensor, table: torch.Tensor) -> SweepsStruct:
        """Allocate a call's scratch planes (like the ``[3, ny, nx]``
        ``like``), pack the struct of its launches (``table``: the offsets
        table on the card) and return it."""
        ny, nx = self.inv_mass.shape
        scratch = [None, None]
        inv_cnt = None
        if self.n_sweeps > 1:
            scratch = [torch.empty_like(like), torch.empty_like(like)]
            inv_cnt = torch.empty_like(self.inv_mass)
        # the planes stay referenced while the call's launches may read them
        self.planes = (scratch, inv_cnt, table)
        self.args = SweepsStruct(
            self.inv_mass.data_ptr(), table.data_ptr(),
            self.limits.data_ptr(),
            (ctypes.c_void_p * 2)(*map(_ptr, scratch)), _ptr(inv_cnt),
            self.pattern, self.n_sweeps, self.project, ny, nx, self.scalars)
        return self.args

    def launch(self, alive, scale, *epilogue) -> int:
        """Launch one substep's sweeps, one C call: ``alive`` and ``scale``
        are the substep's feature planes or None, ``epilogue`` the rest of
        the solver's arguments.  Returns the number of launches."""
        check_launch(self._launch(ctypes.byref(self.args), _ptr(alive),
                                  _ptr(scale), *epilogue),
                     f"{self._name} strain sweeps", self._error_string)
        add_launches(1)
        return 1
