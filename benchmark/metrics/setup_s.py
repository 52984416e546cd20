"""Seconds from the process's start to the window's start: imports, the
kernels' build or load, the scene, ``init`` and the warm-up frames."""


def read(run):
    return run.setup_s
