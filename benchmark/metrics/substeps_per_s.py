"""Simulated substeps completed in the window over its wall seconds (host
clock): every frame's substeps, the episode resets' time included."""


def read(run):
    if run.window_s <= 0.0 or run.substeps == 0:
        return None
    return run.substeps / run.window_s
