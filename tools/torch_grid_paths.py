"""Run the grid Euler, Verlet, XPBD and strain-limit paths and the
self-collision pair forces of one checkout of the PyTorch port on one
NVIDIA GPU, save their states to hold two checkouts to each other bit for
bit, and time them.

    python tools/torch_grid_paths.py ROOT OUT.pt [--time] [--only P1,P2]
    python tools/torch_grid_paths.py --compare A.pt B.pt

ROOT is a checkout; --only runs the paths whose names start with one of
the comma-separated prefixes (e.g. ``pairs_`` for the pair forces alone).

The paths: cloth_bench_64k (Euler) and the same 256 x 256 cloth with each
other offset pattern (structural, with shear, with bend), cloth_bench_262k,
cloth_bench_1m, cloth_tearing_262k, cloth_plastic_262k, cloth_tearing_64k,
cloth_plastic_64k, cloth_wind_64k, chip_smoke.py's cloth_colliders_64k,
cloth_selfcollide_64k (the force plane) and cloth_strain_64k under the three
solvers; under Verlet cloth_bench_64k_verlet, and cloth_wind_64k,
cloth_colliders_64k, cloth_tearing_262k and cloth_selfcollide_64k with
``solver`` replaced; under XPBD cloth_bench_64k_xpbd, and cloth_wind_64k,
cloth_tearing_64k, cloth_plastic_64k, cloth_colliders_64k,
cloth_selfcollide_64k and cloth_tearing_262k with ``solver`` replaced; each
from rest through its wrapper's make_cuda_step, the state saved (x, v,
x_prev and the feature fields).  The XPBD curtain also from a seeded start
velocity, x and v saved after frames 1, 10 and 30, with the program's
recorder off and on (its counting sweep).  Then the strain
sweeps alone on cloth_strain_64k stretched 15 %, with its 4 iterations and
with 1, 2 and 8 (what one more sweep costs); and the pair forces alone
(block_pairs) on cloth_selfcollide_64k after 24 substeps (the pile, saved
too), in the single form and the dual form on 1 and 4 row shards.  With
--time, per path the kernel path's
ms a substep from CUDA events (three times) and each grid kernel's device
µs a launch from torch.profiler, both read through the checkout's
chip_smoke.py (``events_ms``, ``profile_device``: its yardstick, which
holds the headline device times), so --time needs a checkout whose
chip_smoke.py has them.  A checkout's kernels build at first use into its
own build/kernels/, so checkouts run one after the other on one card can be
held to each other.
"""

import dataclasses
import importlib.util
import json
import sys

# the kernels --time reads from the trace
KERNELS = ("grid_euler_substep_kernel", "grid_euler_wide_kernel",
           "grid_feature_finish_kernel", "grid_strain_sweep_kernel",
           "grid_verlet_substep_kernel", "grid_xpbd_predict_kernel",
           "grid_xpbd_sweep_kernel", "block_pairs_kernel")
# the XPBD curtain's seeded start, and the frames whose states are saved
XPBD_SEED, XPBD_FRAMES = 2**31 + 21, (1, 10, 30)


def _cases(sb, smoke):
    """(name, solver module, host, cfg, frames) of every path."""
    from softbodyunity_torch.kernels import grid_euler, grid_verlet, grid_xpbd

    out = []
    host, cfg = sb.presets.build("cloth_bench_64k")
    out.append(("cloth_bench_64k", grid_euler, host, cfg, 20))
    ny, nx = host.grid_shape
    for shear, bend in ((False, False), (True, False), (False, True)):
        grid = sb.cloth_grid(nx, ny, spacing=host.grid_spacing, shear=shear,
                             bend=bend, pinned=("top",), springs=cfg.springs,
                             xpbd=cfg.xpbd, plane_height=host.plane_height,
                             orientation="xy")
        out.append((f"cloth_256_shear{int(shear)}_bend{int(bend)}",
                    grid_euler, grid, cfg, 20))
    for preset, frames in (("cloth_bench_262k", 4), ("cloth_bench_1m", 2),
                           ("cloth_tearing_262k", 4),
                           ("cloth_plastic_262k", 4),
                           ("cloth_tearing_64k", 10),
                           ("cloth_plastic_64k", 10),
                           ("cloth_wind_64k", 20),
                           ("cloth_selfcollide_64k", 2)):
        host, cfg = sb.presets.build(preset)
        out.append((preset, grid_euler, host, cfg, frames))
    host, cfg = smoke.cloth_colliders_64k(sb, sb.Solver.SEMI_IMPLICIT_EULER)
    out.append(("cloth_colliders_64k", grid_euler, host, cfg, 45))
    host, cfg = sb.presets.build("cloth_strain_64k")
    for solver, module in ((sb.Solver.SEMI_IMPLICIT_EULER, grid_euler),
                           (sb.Solver.VERLET, grid_verlet),
                           (sb.Solver.XPBD, grid_xpbd)):
        out.append((f"cloth_strain_64k_{solver.value}", module, host,
                    cfg.replace(solver=solver), 10))
    verlet = sb.Solver.VERLET
    host, cfg = sb.presets.build("cloth_bench_64k_verlet")
    out.append(("cloth_bench_64k_verlet", grid_verlet, host, cfg, 20))
    for preset, frames in (("cloth_wind_64k", 20), ("cloth_tearing_262k", 4),
                           ("cloth_selfcollide_64k", 2)):
        host, cfg = sb.presets.build(preset)
        out.append((f"{preset}_verlet", grid_verlet, host,
                    cfg.replace(solver=verlet), frames))
    host, cfg = smoke.cloth_colliders_64k(sb, verlet)
    out.append(("cloth_colliders_64k_verlet", grid_verlet, host, cfg, 45))
    xpbd = sb.Solver.XPBD
    host, cfg = sb.presets.build("cloth_bench_64k_xpbd")
    out.append(("cloth_bench_64k_xpbd", grid_xpbd, host, cfg, 20))
    for preset, frames in (("cloth_wind_64k", 20), ("cloth_tearing_64k", 10),
                           ("cloth_plastic_64k", 10),
                           ("cloth_selfcollide_64k", 2),
                           ("cloth_tearing_262k", 4)):
        host, cfg = sb.presets.build(preset)
        out.append((f"{preset}_xpbd", grid_xpbd, host,
                    cfg.replace(solver=xpbd), frames))
    host, cfg = smoke.cloth_colliders_64k(sb, xpbd)
    out.append(("cloth_colliders_64k_xpbd", grid_xpbd, host, cfg, 45))
    return out


def _xpbd_frames(sb, profiling, record):
    """x and v of the XPBD curtain after each of XPBD_FRAMES frames from a
    seeded start velocity, with the recorder off or on."""
    import torch

    host, cfg = sb.presets.build("cloth_bench_64k_xpbd")
    top, s = sb.init(host, device="cuda")
    g = torch.Generator().manual_seed(XPBD_SEED)
    v = 0.5 * torch.rand(tuple(s.x.shape), generator=g) - 0.25
    v = torch.where(top.inv_mass[:, None].cpu() > 0, v, 0.0).to(s.x.device)
    s = s.replace(v=v, x_prev=s.x - cfg.dt * v)
    if record:
        profiling.enable()
    out = {}
    for f in range(1, max(XPBD_FRAMES) + 1):
        s = sb.step(top, cfg, s)
        if f in XPBD_FRAMES:
            out[f"x{f}"], out[f"v{f}"] = s.x.cpu(), s.v.cpu()
    profiling.disable()
    return out


def _pair_forces(sb, blocks):
    """(name, fn, args) of the pair forces alone on cloth_selfcollide_64k
    after 24 substeps: the single form, and the dual form on 1 and 4 row
    shards; and that state."""
    host, cfg = sb.presets.build("cloth_selfcollide_64k")
    top, s0 = sb.init(host, device="cuda")
    x = sb.step(top, cfg, s0, n_substeps=24).x
    p, n = cfg.self_collision, x.shape[0]
    out = [("pairs_64k_single", blocks.make_block_pairs(p, n, x.device),
            (x,))]
    for ranks in (1, 4):
        ni = n // ranks
        for r in range(ranks):
            out.append((f"pairs_64k_dual{ranks}_rank{r}",
                        blocks.make_block_pairs_dual(p, ni, n, x.device),
                        (x[r * ni:(r + 1) * ni], x)))
    return out, x


def run(root: str, out: str, timing: bool, only=None) -> None:
    sys.path.insert(0, root)
    import torch

    import softbodyunity_torch as sb
    from softbodyunity_torch.kernels import grid_euler
    from softbodyunity_torch.kernels.stencil import to_planes

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    spec = importlib.util.spec_from_file_location("smoke",
                                                  root + "/chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    print(torch.cuda.get_device_name(0), flush=True)
    if timing:
        events_ms = smoke.events_ms

        def device_us(body):
            """Device µs a launch of each grid kernel of ``body()``, and
            launches."""
            return smoke.profile_device(body, KERNELS)[0]

    def wanted(name):
        return only is None or name.startswith(only)

    states, times = {}, {}
    for name, module, host, cfg, frames in _cases(sb, smoke):
        if not wanted(name):
            continue
        top, s0 = sb.init(host, device="cuda")
        if cfg.tear.enabled or cfg.plasticity.enabled:
            s0 = sb.api.ensure_plastic_state(
                top, cfg, sb.api.ensure_tear_state(top, cfg, s0))
        fn = module.make_cuda_step(top, cfg)
        s = s0
        for _ in range(frames):
            s = fn(s, cfg.dt, cfg.n_substeps)
        torch.cuda.synchronize()
        states[name] = {k: getattr(s, k).cpu() for k in (
            "x", "v", "x_prev", "edge_alive", "rest_scale")
            if getattr(s, k) is not None}
        if timing:
            n_f = 2 if name.startswith("cloth_selfcollide_64k") else 10

            def body(fn=fn, s0=s0, cfg=cfg, n_f=n_f):
                s = s0
                for _ in range(n_f):
                    s = fn(s, cfg.dt, cfg.n_substeps)
            body()
            ms = [events_ms(body, n_f * cfg.n_substeps) for _ in range(3)]
            dev = device_us(lambda: [fn(s0, cfg.dt, cfg.n_substeps)
                                     for _ in range(3)])
            times[name] = {"ms_per_substep": ms, "device_us_per_launch": dev,
                           "substeps": 3 * cfg.n_substeps}
            print(json.dumps({"path": name, **times[name]}), flush=True)
        del top, fn
    from softbodyunity_torch.utils import profiling

    for record in (False, True):
        name = f"xpbd_64k_frames_recorder{int(record)}"
        if wanted(name):
            states[name] = _xpbd_frames(sb, profiling, record)
    # the sweeps alone, from the 64k banner stretched 15 % after a frame
    host, cfg = sb.presets.build("cloth_strain_64k")
    top, s0 = sb.init(host, device="cuda")
    s1 = sb.step(top, cfg, s0)
    x3 = to_planes(1.15 * s1.x, *top.grid_shape).contiguous()
    for it in (cfg.strain_limit.iterations, 1, 2, 8):
        name = ("strain_sweeps_alone" if it == cfg.strain_limit.iterations
                else f"strain_sweeps_alone_{it}")
        if not wanted(name):
            continue
        sweep = grid_euler.make_strain_correction(top, cfg.replace(
            strain_limit=dataclasses.replace(cfg.strain_limit,
                                             iterations=it)))
        states[name] = {"x": sweep(x3).cpu()}
        if timing:
            body = lambda: [sweep(x3) for _ in range(50)]   # noqa: E731
            body()
            times[name] = {
                "ms_per_call": [events_ms(body, 50) for _ in range(3)],
                "device_us_per_launch": device_us(body)}
            print(json.dumps({"path": name, **times[name]}), flush=True)
    from softbodyunity_torch.kernels import blocks

    pairs, x24 = _pair_forces(sb, blocks)
    states["pairs_64k_state"] = {"x": x24.cpu()}
    for name, fn, args in pairs:
        if not wanted(name):
            continue
        states[name] = {"f": fn(*args).cpu()}
        if timing:
            body = lambda: [fn(*args) for _ in range(20)]   # noqa: E731
            body()
            times[name] = {
                "ms_per_call": [events_ms(body, 20) for _ in range(3)],
                "device_us_per_launch": device_us(body)}
            print(json.dumps({"path": name, **times[name]}), flush=True)
    torch.save({"states": states, "times": times}, out)


def compare(a: str, b: str) -> None:
    import torch

    sa, sb_ = torch.load(a)["states"], torch.load(b)["states"]
    differ, values = [], {}
    n = 0
    for name in sorted(set(sa) & set(sb_)):
        count = [0, 0]   # the values compared, and those that differ
        for field in sorted(set(sa[name]) & set(sb_[name])):
            n += 1
            x, y = sa[name][field], sb_[name][field]
            count[0] += x.numel()
            if not torch.equal(x, y):
                count[1] += int((x != y).sum()) if x.shape == y.shape \
                    else x.numel()
                differ.append((name, field,
                               float((x.double() - y.double()).abs().max())))
        values[name] = count
    print(json.dumps({"compared": n, "differ": differ,
                      "values_compared_differ": values,
                      "only_in_one": sorted(set(sa) ^ set(sb_))}))


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        compare(sys.argv[2], sys.argv[3])
    else:
        flags = sys.argv[3:]
        only = (tuple(flags[flags.index("--only") + 1].split(","))
                if "--only" in flags else None)
        run(sys.argv[1], sys.argv[2], "--time" in flags, only)
