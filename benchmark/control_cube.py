"""The tet cube's planted fault, for the limits of its comparison; the
benchmark's own runs do not run this.

``volume_off``: the program stepped with ``volume_stiffness`` 0, the tet
volume term left out, through the episodes and frames that a run of the
cell would keep (``control.episodes_of``), judged by the run's comparison
against the reference with the term on.  It prints one JSON line a seed,
as ``control.py`` does for its sides; ``control.py`` gives the
``program``, ``bfloat16`` and ``frozen`` readings of the same cell.

    python3 benchmark/control_cube.py --workload cube64k.render \
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
    if prog.cfg.volume_stiffness == 0.0:
        raise SystemExit(f"{args.workload}: its volume term is off already")
    prog.cfg = dataclasses.replace(prog.cfg, volume_stiffness=0.0)
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
                          "side": "volume_off", **numbers, "spread": spread,
                          "seed_s": time.perf_counter() - t}), flush=True)


if __name__ == "__main__":
    main()
