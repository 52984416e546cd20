"""Time the 64k tet-cube lattice paths of one checkout of the PyTorch port on
one NVIDIA GPU, and save their states to compare two checkouts bit for bit.

    python tools/torch_lattice_cubes.py ROOT OUT.pt    # ROOT: a checkout
    python tools/torch_lattice_cubes.py --compare A.pt B.pt

For each of softbody_cube_64k (Euler), softbody_cube_64k_verlet and, for
both, the same with the wind's drag, with chip_smoke.py's capsule and box
and with no volume constraint, and softbody_cube_64k_xpbd: 40 frames from
rest (XPBD 4) through the lattice wrapper's make_cuda_step, the state saved;
then per substep the kernel path's ms from CUDA events (20 frames, three
times) and each kernel's device µs a launch from torch.profiler (5 frames).
A checkout's kernels build at first use into its own build/kernels/, so two
checkouts of one card, run one after the other, can be held to each other.
"""

import importlib.util
import sys


def run(root: str, out: str) -> None:
    sys.path.insert(0, root)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import softbodyunity_torch as sb
    from softbodyunity_torch.kernels import (lattice_euler, lattice_verlet,
                                             lattice_xpbd)

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    spec = importlib.util.spec_from_file_location("smoke",
                                                  root + "/chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    wind = sb.WindParams(velocity=(3.0, 0.0, 1.0), drag=0.3)
    cases = []
    for preset, module in (("softbody_cube_64k", lattice_euler),
                           ("softbody_cube_64k_verlet", lattice_verlet),
                           ("softbody_cube_64k_xpbd", lattice_xpbd)):
        host, cfg = sb.presets.build(preset)
        cases.append((preset, module, host, cfg))
        if module is lattice_xpbd:
            continue
        cases.append((preset + "_drag", module, host, cfg.replace(wind=wind)))
        cases.append((preset + "_colliders", module,
                      *smoke.add_cube_colliders(sb, host, cfg)))
        cases.append((preset + "_novolume", module, host,
                      cfg.replace(volume_stiffness=0.0)))
    print(torch.cuda.get_device_name(0), flush=True)
    states = {}
    for name, module, host, cfg in cases:
        top, s0 = sb.init(host, device="cuda")
        fn = module.make_cuda_step(top, cfg)
        s = s0
        for _ in range(4 if module is lattice_xpbd else 40):
            s = fn(s, cfg.dt, cfg.n_substeps)
        torch.cuda.synchronize()
        states[name] = [s.x.cpu(), s.v.cpu(), s.x_prev.cpu()]
        ms = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            s = s0
            for _ in range(20):
                s = fn(s, cfg.dt, cfg.n_substeps)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end) / (20 * cfg.n_substeps))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            s = s0
            for _ in range(5):
                s = fn(s, cfg.dt, cfg.n_substeps)
            torch.cuda.synchronize()
        per_launch, busy = {}, 0.0
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CPU:
                continue
            total = getattr(ev, "device_time_total", None)
            if total is None:
                total = getattr(ev, "cuda_time_total", 0.0)
            busy += total
            if "lattice" in ev.key and ev.count:
                kernel = ev.key.split("(")[1] if ev.key.startswith("void") \
                    else ev.key
                per_launch[kernel.split("::")[-1][:40]] = (
                    round(total / ev.count, 2), ev.count)
        print(name, "path us/substep", [round(1e3 * m, 2) for m in ms],
              "device us/substep", round(busy / (5 * cfg.n_substeps), 2),
              per_launch, flush=True)
    torch.save(states, out)


def compare(a_path: str, b_path: str) -> int:
    import torch

    a, b = torch.load(a_path), torch.load(b_path)
    same = True
    for name in a:
        equal = [torch.equal(x, y) for x, y in zip(a[name], b[name])]
        same &= all(equal)
        print("bit-equal", name, equal)
    return 0 if same else 1


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    run(sys.argv[1], sys.argv[2])
