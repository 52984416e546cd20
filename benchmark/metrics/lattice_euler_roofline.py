"""``csrc/lattice_euler.cu``'s share of its roofline, in %: the least time
one substep's work could take on the card (``roofline/lattice_euler.py``,
against the H100's published peaks at 700 W) over the device time a
substep of its kernels (``lattice_euler_integrate_kernel``,
``lattice_tet_kernel``, ``lattice_euler_gather_kernel``) in the profiled
frames.  Nothing to read where no such kernel ran."""

import importlib

KERNELS = ("lattice_euler", "lattice_tet")


def read(run):
    rec = run.device
    if rec is None:
        return None
    t = sum(s for name, s in rec.op_s.items()
            if any(k in name for k in KERNELS))
    if t <= 0.0:
        return None
    roofline = importlib.import_module("benchmark.roofline.lattice_euler")
    bound, _ = roofline.bound_per_substep(run.cell.config)
    return 100.0 * bound * rec.substeps / t
