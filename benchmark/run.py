"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload cloth64k.render --seed 7 \
        --seconds 10 --trace 0

From the root of a checkout that holds the program (``softbodyunity_torch``)
beside this folder.  The last line on standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``check``: each number compared
beside its limit); the numbers compared are also the last lines on standard
error.  A run that cannot measure (no CUDA device, too few devices, a module
of the JAX side loaded, the program missing) prints no result and exits
non-zero.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def process_age_s() -> float:
    """Seconds since this process started, from ``/proc`` (0 where it
    cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE0 = process_age_s()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    # Python's bytecode too: where the environment forbids writing it
    # beside the installed sources, every run would compile torch's anew
    # (some 7 s of a 10 s set-up on the H100's host, and its most variable
    # part); written once here, later runs load it
    sys.dont_write_bytecode = False
    sys.pycache_prefix = os.path.join(ROOT, "build", "pycache")
    sys.path.insert(0, ROOT)
    try:
        from benchmark import harness

        result, numbers, limits = harness.run_cell(
            args.workload, args.seed, args.seconds, bool(args.trace),
            setup_from=_T0, age=_AGE0)
        found = harness.forbidden_modules()
        if found:
            raise harness.Refused("modules of the JAX side loaded: "
                                  + ", ".join(found))
    except ModuleNotFoundError as e:
        print(f"run.py: {e}", file=sys.stderr)
        return 3
    except Exception as e:  # noqa: BLE001 - the boundary of one run
        if type(e).__name__ != "Refused":
            import traceback

            traceback.print_exc()
        print(f"run.py: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    for name, limit in limits.items():
        print(f"check {name} {numbers.get(name)} limit {limit}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
