"""Hold two runs of ``chip_smoke.py`` to each other, field by field.

    python tools/compare_smoke.py A.out B.out

A.out and B.out are the standard outputs of two runs (two checkouts on one
card, or one checkout twice).  Every JSON line of the phases that check
results (compare, main_path and its sub-phases, sphere, golden, fidelity
and their sub-phases) is taken in order, and its numbers, strings and
booleans are flattened to key paths; fields that depend on the host's
clock or the allocator (seconds, rates, milli- and microseconds, peak
memory) are left out.  Prints one JSON object: the count of fields
compared and the fields that differ, with both values.
"""

import json
import sys

CHECKED = ("compare", "main_path", "sphere", "golden", "fidelity")
CLOCK = ("seconds", "per_s", "_ms", "ms_", "us_per", "peak_mem",
         "host_build")


def _lines(path):
    out = {}
    for line in open(path):
        if not line.startswith("{"):
            continue
        try:
            d = json.loads(line)
        except json.JSONDecodeError:
            continue
        phase = d.get("phase", "")
        if not phase.startswith(CHECKED):
            continue
        out.setdefault(phase, []).append(d)
    return out


def _flatten(d, prefix=""):
    if isinstance(d, dict):
        for k, v in d.items():
            if any(c in k for c in CLOCK):
                continue
            yield from _flatten(v, f"{prefix}.{k}" if prefix else k)
    elif isinstance(d, list):
        for i, v in enumerate(d):
            yield from _flatten(v, f"{prefix}[{i}]")
    else:
        yield prefix, d


def compare(a, b):
    la, lb = _lines(a), _lines(b)
    n, differ = 0, []
    for phase in sorted(set(la) | set(lb)):
        ra, rb = la.get(phase, []), lb.get(phase, [])
        if len(ra) != len(rb):
            differ.append({"field": f"{phase}: lines", "a": len(ra),
                           "b": len(rb)})
        for k, (da, db) in enumerate(zip(ra, rb)):
            fa, fb = dict(_flatten(da)), dict(_flatten(db))
            for key in sorted(set(fa) | set(fb)):
                n += 1
                if fa.get(key) != fb.get(key):
                    label = da.get("kernel") or da.get("path") or ""
                    differ.append({"field": f"{phase}[{k}] {label} {key}",
                                   "a": fa.get(key), "b": fb.get(key)})
    return {"compared": n, "differ": len(differ), "fields": differ}


if __name__ == "__main__":
    print(json.dumps(compare(sys.argv[1], sys.argv[2]), indent=1))
