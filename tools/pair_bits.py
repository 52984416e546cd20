"""Hold the self-collision pair kernel of two checkouts to each other, bit
for bit, on saved states of the 64k pile.

    python3 tools/pair_bits.py states --out DIR [--seed N]
    python3 tools/pair_bits.py forces --states DIR/states.pt --out F \\
        [--root CHECKOUT]
    python3 tools/pair_bits.py compare A B

``states`` saves the positions of cloth_selfcollide_64k after 40 and 100
frames from rest, and of the benchmark's ``selfcollide64k.render`` after
110 frames of the first episode of run ``--seed`` (a crushed pile), into
``DIR/states.pt``.  ``forces`` imports the program from ``--root`` (this
checkout by default) and saves, for each state, the force planes of one
``make_block_pairs`` call and of ``make_block_pairs_dual`` on each of 4 row
shards, each with the recorder off and on, and the counters of the counting
calls.  ``compare`` prints one JSON line: the fields compared (every force
plane, as int32 bits, and every counter both sides have), those that
differ, and each side's counters and pair hit share.  Needs a CUDA device
for ``states`` and ``forces``; run from the root of a checkout.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4


def states(out, seed):
    sys.path.insert(0, ROOT)
    import torch

    import softbodyunity_torch as sb
    from benchmark import harness

    host, cfg = sb.presets.build("cloth_selfcollide_64k")
    top, state = sb.init(host, device="cuda")
    saved = {}
    for frame in range(1, 101):
        state = sb.step(top, cfg, state)
        if frame in (40, 100):
            saved[f"rest+{frame}"] = state.x.clone()
    prog = harness.Program(harness.find_cell("selfcollide64k.render"),
                           "cuda")
    state = prog.start(seed, 0)
    for _ in range(110):
        state = prog.sb.step(prog.top, prog.cfg, state)
    saved[f"seed {seed}, episode 0 + 110"] = state.x.clone()
    os.makedirs(out, exist_ok=True)
    torch.save({k: v.cpu() for k, v in saved.items()},
               os.path.join(out, "states.pt"))
    print(json.dumps({"states": list(saved), "card":
                      torch.cuda.get_device_name(0)}))


def forces(path, out, root):
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import softbodyunity_torch as sb
    from softbodyunity_torch.kernels import blocks
    from softbodyunity_torch.utils import profiling

    if not sb.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {sb.__file__}, not the program of "
                           f"{root}")
    p = sb.presets.build("cloth_selfcollide_64k")[1].self_collision
    result = {}
    for name, x in torch.load(path).items():
        x = x.cuda()
        n = x.shape[0]
        ni = n // RANKS
        calls = [("single", blocks.make_block_pairs(p, n, x.device), (x,))]
        calls += [(f"dual {r}",
                   blocks.make_block_pairs_dual(p, ni, n, x.device),
                   (x[r * ni:(r + 1) * ni], x)) for r in range(RANKS)]
        for form, fn, args in calls:
            profiling.disable()
            plain = fn(*args)
            profiling.enable()
            counted = fn(*args)
            counters = profiling.read().counters
            profiling.disable()
            result[f"{name}: {form}"] = {
                "forces": plain.cpu(), "forces counting": counted.cpu(),
                "counters": {k.split(".", 1)[1]: v
                             for k, v in counters.items()
                             if k.split(".")[0] in blocks.FORMS
                             and "." in k and not k.endswith(".tiles")}}
    torch.save(result, out)
    print(json.dumps({"root": root, "calls": len(result),
                      "card": torch.cuda.get_device_name(0)}))


def compare(a, b):
    import torch

    ra, rb = torch.load(a), torch.load(b)
    compared, differ, counts = 0, [], {}
    for key in sorted(set(ra) | set(rb)):
        if key not in ra or key not in rb:
            differ.append(f"{key}: on one side only")
            continue
        for field in ("forces", "forces counting"):
            fa, fb = ra[key][field], rb[key][field]
            compared += 1
            if fa.shape != fb.shape or not torch.equal(
                    fa.contiguous().view(torch.int32),
                    fb.contiguous().view(torch.int32)):
                n = (fa.view(torch.int32) != fb.view(torch.int32)).sum()
                differ.append(f"{key}: {field}, {int(n)} of {fa.numel()}")
        ca, cb = ra[key]["counters"], rb[key]["counters"]
        for name in sorted(set(ca) & set(cb)):
            if name == "pairs_swept":       # what each sweep swept
                continue
            compared += 1
            if ca[name] != cb[name]:
                differ.append(f"{key}: {name}, {ca[name]} / {cb[name]}")
        counts[key] = {
            side: {**c, "pair_hit_pct": 100.0 * c.get("pairs_in_reach", 0)
                   / max(c.get("pairs_swept", 0), 1)}
            for side, c in (("a", ca), ("b", cb))}
    print(json.dumps({"compared": compared, "differ": len(differ),
                      "fields_differing": differ, "counters": counts}))
    return 1 if differ else 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    s = sub.add_parser("states")
    s.add_argument("--out", required=True)
    s.add_argument("--seed", type=int, default=2_900_000_013)
    f = sub.add_parser("forces")
    f.add_argument("--states", required=True)
    f.add_argument("--out", required=True)
    f.add_argument("--root", default=ROOT)
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = ap.parse_args(argv)
    if args.what == "states":
        states(args.out, args.seed)
    elif args.what == "forces":
        forces(args.states, args.out, args.root)
    else:
        return compare(args.a, args.b)
    return 0


if __name__ == "__main__":
    sys.exit(main())
