"""``csrc/grid_euler.cu``'s share of its roofline, in %: the least time one
substep's work could take on the card (``roofline/grid_euler.py``, against
the H100's published peaks at 700 W) over the device time of
``grid_euler.cu``'s kernels a substep in the profiled frames.  Nothing to
read where no such kernel ran."""

import importlib

GRID_EULER = "grid_euler"


def read(run):
    rec = run.device
    if rec is None:
        return None
    t = sum(s for name, s in rec.op_s.items() if GRID_EULER in name)
    if t <= 0.0:
        return None
    roofline = importlib.import_module("benchmark.roofline.grid_euler")
    bound, _ = roofline.bound_per_substep(run.cell.config)
    return 100.0 * bound * rec.substeps / t
