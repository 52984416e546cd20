"""The device's idle share in the profiled frames, in %: one less the union
of its kernels, memcpys and memsets over the profiled span."""


def read(run):
    rec = run.device
    if rec is None or rec.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)
