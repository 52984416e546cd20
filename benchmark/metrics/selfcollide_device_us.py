"""Device time a substep of the self-collision force plane: every kernel,
memcpy and memset that ``step`` issued in the profiled frames except
``grid_euler.cu``'s (so the sort, the partner search, ``block_pairs`` and
the step wrapper's few plane copies), in us a substep.  Nothing to read in
a scene without self-collision."""

GRID_EULER = "grid_euler"


def read(run):
    rec = run.device
    sc = run.cell.config["sim"].get("self_collision") or {}
    if rec is None or not sc.get("enabled"):
        return None
    ops = rec.span_op_s.get("step", {})
    total = sum(t for name, t in ops.items() if GRID_EULER not in name)
    if total <= 0.0:
        return None
    return total / rec.substeps * 1e6
