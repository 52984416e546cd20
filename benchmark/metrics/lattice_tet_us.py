"""Device time of the tet volume term's pass, ``lattice_tet_kernel``
(``csrc/lattice_common.cuh``: each tet's volume constraint once, its
corners' terms to scratch planes), in us a substep over the profiled
frames.  Nothing to read where no such kernel ran."""

TET_KERNEL = "lattice_tet_kernel"


def read(run):
    rec = run.device
    if rec is None:
        return None
    t = sum(s for name, s in rec.op_s.items() if TET_KERNEL in name)
    if t <= 0.0:
        return None
    return t / rec.substeps * 1e6
