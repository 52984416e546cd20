"""Readings that the limits of the comparison are set from; the benchmark's
own runs do not run this.

For each seed it runs the program, untimed, through the episodes and frames
that a run of the cell would keep (``check.frames_for``), and prints one
JSON line for each side judged by the run's comparison:

- ``program``: the program itself (the lower readings);
- ``bfloat16``: the control, the plain reference in bfloat16 in the
  program's place (the upper readings; it has to fail);
- ``frozen``: a step that returns its state unchanged (a fault);
- in a configuration with self-collision, faults planted in the program's
  self-collision force plane: ``pairs_zero`` (the pair forces computed and
  dropped), ``pairs_half`` (halved) and ``partner_dropped`` (each tile's
  last partner tile left out of the pair sweep).

Beside each number, ``spread`` gives the largest over the frames judged of
each quantile of the per-vertex distances (``check.quantiles``).

    python3 benchmark/control.py --workload selfcollide64k.render \
        --seeds 1,2,3 --control-seeds 1,2,3
"""

import argparse
import contextlib
import json
import os
import random
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Frozen:
    """A step that returns the state it was given."""

    def __init__(self, ref):
        self.ref = ref

    def frame(self, x, v):
        return x, v

    def normals(self, x):
        return self.ref.normals(x)


def _scaled(make, scale):
    """A maker of self-collision force planes whose planes are scaled."""
    def maker(*args, **kw):
        planes = make(*args, **kw)
        if planes is None:
            return None
        return lambda x3: planes(x3) * scale
    return maker


def _one_partner_less(find):
    """A partner search that leaves out each tile's last partner tile (the
    interacting tiles come first)."""
    import torch

    def partners(*args, **kw):
        idx, pvalid, overflow = find(*args, **kw)
        last = pvalid.sum(dim=1, keepdim=True) - 1
        column = torch.arange(pvalid.shape[1], device=pvalid.device)
        return idx, pvalid & (column != last), overflow
    return partners


@contextlib.contextmanager
def planted(fault):
    """The program with ``fault`` planted in its self-collision force plane
    (the card's wrapper and the plain path alike); its step functions are
    built anew inside and out."""
    from softbodyunity_torch import api
    from softbodyunity_torch.kernels import blocks, grid_euler, stencil
    from softbodyunity_torch.solver import blocksparse

    if fault in ("pairs_zero", "pairs_half"):
        scale = 0.0 if fault == "pairs_zero" else 0.5
        targets = [(grid_euler, "self_collision_planes_cuda"),
                   (stencil, "self_collision_planes")]
        wrap = lambda f: _scaled(f, scale)  # noqa: E731
    else:
        targets = [(blocks, "_tile_partners"),
                   (blocksparse, "_tile_partners")]
        wrap = _one_partner_less
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]
    api._build_step.cache_clear()
    try:
        for mod, name, f in saved:
            setattr(mod, name, wrap(f))
        yield
    finally:
        for mod, name, f in saved:
            setattr(mod, name, f)
        api._build_step.cache_clear()


PLANTED = ("pairs_zero", "pairs_half", "partner_dropped")


def episodes_of(prog, cell, seed):
    """The kept episodes of one seed, as ``check.compare`` takes them: the
    first ``check.episodes`` episodes, each with the frames a run draws."""
    from benchmark import check as checks

    rng = random.Random(f"check:{seed}")
    out = []
    for episode in range(cell.config["check"]["episodes"]):
        frames = checks.frames_for(rng, cell.config,
                                   cell.traffic["episode_frames"])
        state = prog.start(seed, episode)
        kept = []
        for k in range(1, max(frames) + 1):
            new = prog.sb.step(prog.top, prog.cfg, state)
            if k in frames:
                kept.append(checks.Kept(k, state, new.x,
                                        prog.sb.normals(prog.top, new)))
            state = new
        out.append((episode, kept))
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import check as checks
    from benchmark import harness

    cell = harness.find_cell(args.workload)
    prog = harness.Program(cell, args.device)
    ref = prog.reference
    sc = cell.config["sim"].get("self_collision") or {}
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        kept = episodes_of(prog, cell, seed)

        def start_state(episode):
            s = prog.start(seed, episode)
            return s.x, s.v

        sides = [("program", None, None)]
        if seed in controls:
            sides += [("bfloat16", None, ref.Reference(
                          cell.config, torch.bfloat16, prog.device)),
                      ("frozen", None, Frozen(ref.Reference(
                          cell.config, device=prog.device)))]
            if sc.get("enabled"):
                sides += [(fault, fault, None) for fault in PLANTED]
        for side, fault, program in sides:
            t0 = time.perf_counter()
            judged = kept
            if fault:
                with planted(fault):
                    judged = episodes_of(prog, cell, seed)
            detail = {}
            numbers = checks.compare(cell.config, ref, judged, start_state,
                                     prog.device, program=program,
                                     detail=detail)
            spread = {name: {q: max(f[q] for f in frames) for q in frames[0]}
                      for name, frames in detail.items()}
            print(json.dumps({"cell": args.workload, "seed": seed,
                              "side": side, **numbers, "spread": spread,
                              "check_s": time.perf_counter() - t0,
                              "seed_s": time.perf_counter() - t}),
                  flush=True)


if __name__ == "__main__":
    main()
