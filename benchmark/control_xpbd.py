"""The XPBD curtain's planted fault, for the limits of its comparison; the
benchmark's own runs do not run this.

``sweeps_half``: the program stepped with half its Jacobi sweeps a substep
(``xpbd.n_iterations`` 4 in place of 8), through the episodes and frames
that a run of the cell would keep (``control.episodes_of``), judged by the
run's comparison against the reference with every sweep.  It prints one
JSON line a seed, as ``control.py`` does for its sides; ``control.py``
gives the ``program``, ``bfloat16`` and ``frozen`` readings of the same
cell.

    python3 benchmark/control_xpbd.py --workload cloth64k_xpbd.render \
        --seeds 1,2,3
"""

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import check as checks
    from benchmark import control, harness

    cell = harness.find_cell(args.workload)
    prog = harness.Program(cell, args.device)
    sweeps = prog.cfg.xpbd.n_iterations
    if sweeps < 2:
        raise SystemExit(f"{args.workload}: {sweeps} sweep(s), none to halve")
    prog.cfg = dataclasses.replace(prog.cfg, xpbd=dataclasses.replace(
        prog.cfg.xpbd, n_iterations=sweeps // 2))
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        kept = control.episodes_of(prog, cell, seed)

        def start_state(episode):
            s = prog.start(seed, episode)
            return s.x, s.v

        detail = {}
        numbers = checks.compare(cell.config, prog.reference, kept,
                                 start_state, prog.device, detail=detail)
        spread = {name: {q: max(f[q] for f in frames) for q in frames[0]}
                  for name, frames in detail.items()}
        print(json.dumps({"cell": args.workload, "seed": seed,
                          "side": "sweeps_half", **numbers, "spread": spread,
                          "seed_s": time.perf_counter() - t}), flush=True)


if __name__ == "__main__":
    main()
