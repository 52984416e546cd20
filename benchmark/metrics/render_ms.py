"""Mean host time from the ``normals`` call until the positions and the
normals are in the host buffers, in ms a frame, over the frames that the
profiler did not cover."""


def read(run):
    normals = run.spans.get("normals", [])
    readback = run.spans.get("readback", [])
    if not normals or len(normals) != len(readback):
        return None
    return (sum(normals) + sum(readback)) / len(normals) * 1e3
