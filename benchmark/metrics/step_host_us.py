"""Mean host time of one ``step`` call (the API, the dispatcher and the
step wrapper, without a synchronise), in us a frame, over the frames that
the profiler did not cover."""


def read(run):
    spans = run.spans.get("step", [])
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e6
