"""Kernels, memcpys and memsets on the device in the profiled frames, over
their substeps (the benchmark's marker kernels left out)."""


def read(run):
    rec = run.device
    if rec is None or rec.n_ops == 0:
        return None
    return rec.n_ops / rec.substeps
