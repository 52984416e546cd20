"""``csrc/grid_xpbd.cu``'s share of its roofline, in %: the least time one
substep's work could take on the card (``roofline/grid_xpbd.py``, against
the H100's published peaks at 700 W) over the device time of the kernels
named ``grid_xpbd*`` (the predict and the Jacobi sweeps) a substep in the
profiled frames.  Nothing to read where no such kernel ran."""

import importlib

GRID_XPBD = "grid_xpbd"


def read(run):
    rec = run.device
    if rec is None:
        return None
    t = sum(s for name, s in rec.op_s.items() if GRID_XPBD in name)
    if t <= 0.0:
        return None
    roofline = importlib.import_module("benchmark.roofline.grid_xpbd")
    bound, _ = roofline.bound_per_substep(run.cell.config)
    return 100.0 * bound * rec.substeps / t
