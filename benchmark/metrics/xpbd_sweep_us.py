"""Device time of the XPBD Jacobi sweeps, ``grid_xpbd_sweep_kernel``
(``csrc/grid_xpbd.cu``: ``n_iterations`` launches a substep, each
constraint once a sweep, the last running the epilogue), in us a substep
over the profiled frames.  Nothing to read where no such kernel ran."""

SWEEP_KERNEL = "grid_xpbd_sweep_kernel"


def read(run):
    rec = run.device
    if rec is None:
        return None
    t = sum(s for name, s in rec.op_s.items() if SWEEP_KERNEL in name)
    if t <= 0.0:
        return None
    return t / rec.substeps * 1e6
