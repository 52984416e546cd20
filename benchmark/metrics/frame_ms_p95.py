"""The 95th percentile of the frame times of the whole window, in ms (host
clock from before ``step`` until the frame's positions and normals are in
the host buffers)."""

import numpy as np


def read(run):
    if not run.frame_s:
        return None
    return float(np.percentile(np.asarray(run.frame_s), 95.0)) * 1e3
