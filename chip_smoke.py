#!/usr/bin/env python3
"""Drive softbodyunity_torch's main paths once on an NVIDIA GPU and check them.

Run from a checkout, with one card:  python3 chip_smoke.py

The port's grid-cloth paths, one hand-written CUDA kernel each:

    Euler   cloth_bench_64k          grid_euler   1 launch per substep
    Verlet  cloth_bench_64k_verlet   grid_verlet  1 launch per substep
    XPBD    cloth_bench_64k_xpbd     grid_xpbd    1 + n_iterations per substep

Phases, each printed as one JSON line; any failure raises and exits nonzero:

1. device     the card's name and power limit (nvidia-smi) and torch's view;
2. build      nvcc builds the three kernels from kernels/csrc at first use,
              one nvcc per source, all started together;
3. compare    each kernel against its plain PyTorch version, both float32 on
              the card: 16x8 cloths (the scenes of tests/test_pallas.py)
              and one frame of its 64k preset;
4. main_path  each 64k preset through init(device="cuda") and 300 frames of
              step(), every launch count set to 0 just before and read just
              after: the path's kernel launched frames x substeps x launches
              per substep times and no other kernel launched; x finite,
              pinned rows bit-equal to the initial state, nothing below the
              plane, unit normals, peak device memory;
5. sphere     cloth_hanging_sphere (Euler), 120 frames: the pins hold, no
              vertex inside the sphere;
6. golden     the float64 oracle trajectories of tests/golden replayed
              through step() at tests/test_golden.py's tolerances;
7. fidelity   each kernel in float32 against its plain version in float64
              on its 64k preset: Euler and Verlet over 1000 frames, XPBD over
              200 (its float64 plain version runs ~1,600 eager ops per
              substep);
8. timing     per 64k preset, ms per substep of the kernel path and of the
              plain version with CUDA events, in turns plain/kernel/kernel/
              plain; then, after all of them (a profiler session slows the
              launches that follow it), each kernel's device time per
              launch from torch.profiler.

Then a JSON line of the kernels (launches on the main path, error against
the plain version, times, bound), the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.  Without a CUDA device, or without the
package beside it, it exits nonzero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# device memory bandwidth and float32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

# Operations each kernel's function needs, counted from its plain version
# (kernels/stencil.py), each add, multiply, divide, sqrt and max as one:
# - a spring edge (Euler, Verlet): d 3, |d|^2 5, sqrt 1, max 1, reciprocal 1,
#   n 3, dv 3, rel_v 5, fmag 4, force 3, added at both ends 6 = 35;
# - an XPBD edge in one sweep: d 3, |d|^2 5, sqrt 1, max 1, n 3, C 1,
#   dlam 7, lambda 1, the two corrections 8, added at both ends 6 = 36.
# Per vertex: Euler v and x update and the plane test 22; Verlet velocity
# estimate, damped update and the plane test 31; XPBD predict 12 and
# epilogue 6 once, evaluation point, averaged update and plane test 12 per
# sweep.  Contact and friction work is data-dependent and the 64k presets
# make none (their plane lies below the cloth's reach), so it counts 0.
OPS_SPRING_EDGE = 35
OPS_XPBD_EDGE = 36
OPS_EULER_VERTEX = 22
OPS_VERLET_VERTEX = 31
OPS_XPBD_VERTEX_ONCE = 18
OPS_XPBD_VERTEX_SWEEP = 12


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound_per_substep(name, top, cfg):
    """(least ms the card could take for one substep of ``name`` on this
    scene, "bytes" or "operations"): each input read once and each output
    written once over the memory rate, against the operations over the
    float32 rate."""
    n = top.n_vertices
    e = int(top.edges.shape[0])
    n_off = len(top.edge_classes_present) * 2
    consts = 16 * n_off + 16 + 28 * top.n_spheres   # table, plane, spheres
    if name == "grid_euler":      # x, v, inv_mass in; x, v out
        nbytes = 4 * n * (3 + 3 + 1 + 3 + 3)
        ops = OPS_SPRING_EDGE * e + OPS_EULER_VERTEX * n
    elif name == "grid_verlet":   # x, x_prev, inv_mass in; x out
        nbytes = 4 * n * (3 + 3 + 1 + 3)
        ops = OPS_SPRING_EDGE * e + OPS_VERLET_VERTEX * n
    else:                         # x, v, inv_mass, inv_cnt in; x, v out
        it = cfg.xpbd.n_iterations
        nbytes = 4 * n * (3 + 3 + 1 + 1 + 3 + 3)
        ops = (it * (OPS_XPBD_EDGE * e + OPS_XPBD_VERTEX_SWEEP * n)
               + OPS_XPBD_VERTEX_ONCE * n)
    t_bytes = (nbytes + consts) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1

    import numpy as np

    import softbodyunity_torch as sb
    from softbodyunity_torch.kernels import (build, grid_euler, grid_verlet,
                                            grid_xpbd)
    from softbodyunity_torch.kernels.stencil import make_stencil_step

    cuda = torch.device("cuda")
    t_start = time.perf_counter()
    t_phase = time.perf_counter()

    def phase_seconds():
        nonlocal t_phase
        now = time.perf_counter()
        s, t_phase = now - t_phase, now
        return s

    kernels = {
        "grid_euler": dict(
            module=grid_euler, preset="cloth_bench_64k",
            replaces="softbodyunity_tpu/kernels/pallas_substep.py:534",
            device_names=("grid_euler_substep_kernel",)),
        "grid_verlet": dict(
            module=grid_verlet, preset="cloth_bench_64k_verlet",
            replaces="softbodyunity_tpu/kernels/pallas_substep.py:801",
            device_names=("grid_verlet_substep_kernel",)),
        "grid_xpbd": dict(
            module=grid_xpbd, preset="cloth_bench_64k_xpbd",
            replaces="softbodyunity_tpu/kernels/pallas_xpbd.py:334",
            device_names=("grid_xpbd_predict_kernel",
                          "grid_xpbd_sweep_kernel")),
    }
    for name, k in kernels.items():
        k["host"], k["cfg"] = sb.presets.build(k["preset"])
        k["source"] = f"softbodyunity_torch/kernels/csrc/{name}.cu"

    def launches_per_substep(name, cfg):
        return (grid_xpbd.launches_per_substep(cfg) if name == "grid_xpbd"
                else 1)

    def reset_counts():
        for k in kernels.values():
            k["module"].reset_launch_count()

    def counts():
        return {n: k["module"].launch_count() for n, k in kernels.items()}

    # 1. device -------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], seconds=phase_seconds())

    # 2. build --------------------------------------------------------------
    fresh = {n: not build.library_path(n).exists() for n in kernels}
    t = time.perf_counter()
    build.load_libraries(list(kernels))
    build_s = time.perf_counter() - t
    for name in kernels:
        lib = build.library_path(name)
        log = lib.with_suffix(".log")
        ptxas = ([ln.strip() for ln in log.read_text().splitlines()
                  if "ptxas" in ln] if log.exists() else [])
        emit("build", kernel=name, fresh_build=fresh[name],
             library=os.path.relpath(lib, ROOT), ptxas=ptxas)
    emit("build", kernels=list(kernels), seconds=build_s)
    phase_seconds()

    # 3. kernel vs plain version on the card ----------------------------------
    def scene16(solver=sb.Solver.SEMI_IMPLICIT_EULER, shear=True, bend=True,
                sphere=None, verlet_sphere=False):
        """tests/test_pallas.py's 16x8 scenes."""
        cfg = sb.SimConfig(
            solver=solver,
            springs=sb.SpringParams(k_structural=500.0, k_shear=250.0,
                                    k_bend=100.0,
                                    damping=0.1 if verlet_sphere else 0.6),
            xpbd=sb.XPBDParams(compliance_distance=1e-6,
                               compliance_bend=5e-4, n_iterations=6,
                               relaxation=1.0),
            collision=sb.CollisionParams(enable_plane=True,
                                         enable_spheres=sphere is not None,
                                         friction=0.2),
            global_damping=0.3,
        )
        host = sb.cloth_grid(
            16, 8, spacing=0.05, shear=shear, bend=bend, pinned=("tl", "tr"),
            springs=cfg.springs, xpbd=cfg.xpbd,
            plane_height=-2.5 if verlet_sphere else -0.25, orientation="xy",
            sphere_centers=np.array([sphere]) if sphere else None,
            sphere_radii=np.array([0.15]) if sphere else None,
        )
        return host, cfg

    def compare(name, scene, host, cfg, n_sub, atol_x, atol_v, why):
        top, s0 = sb.init(host, device=cuda)
        plain = make_stencil_step(top, cfg)(s0, cfg.dt, n_sub)
        kern = kernels[name]["module"].make_cuda_step(top, cfg)(
            s0, cfg.dt, n_sub)
        torch.cuda.synchronize()
        dx = float((kern.x - plain.x).abs().max())
        dv = float((kern.v - plain.v).abs().max())
        finite = bool(torch.isfinite(kern.x).all() and torch.isfinite(kern.v).all())
        pinned = torch.from_numpy(host.inv_mass == 0.0).to(cuda)
        pins_frozen = torch.equal(kern.x[pinned], s0.x[pinned])
        emit("compare", kernel=name, scene=scene, substeps=n_sub,
             max_abs_dx=dx, max_abs_dv=dv, atol_x=atol_x, atol_v=atol_v,
             pins_frozen=pins_frozen, why=why)
        require(finite, f"{name} {scene}: kernel output not finite")
        require(pins_frozen, f"{name} {scene}: pinned vertices moved")
        require(dx <= atol_x and dv <= atol_v,
                f"{name} {scene}: kernel vs plain |dx| {dx:.3e} "
                f"(<= {atol_x}), |dv| {dv:.3e} (<= {atol_v})")
        return max(dx, dv)

    twin = ("tests/test_pallas.py kernel-vs-twin bound; FMA contraction here "
            "as rsqrt there")
    V = sb.Solver.VERLET
    X = sb.Solver.XPBD
    compare("grid_euler", "16x8 structural", *scene16(shear=False, bend=False),
            64, 5e-4, 5e-2,
            twin + ", floppy cloth amplifies it through plane contact")
    compare("grid_euler", "16x8 shear+bend", *scene16(), 64, 5e-6, 5e-4, twin)
    compare("grid_euler", "16x8 sphere", *scene16(sphere=(0.35, -0.4, 0.0)),
            96, 2e-5, 5e-2, twin + "; sphere contact")
    compare("grid_verlet", "16x8 plane drape", *scene16(V), 64, 1e-3, 5e-2,
            twin + "; plane-friction mask flips on a few vertices")
    compare("grid_verlet", "16x8 sphere",
            *scene16(V, sphere=(0.375, -0.45, 0.0), verlet_sphere=True), 240,
            2e-5, 5e-2, twin + "; v = (x - x_prev)/dt carries x rounding")
    compare("grid_xpbd", "16x8", *scene16(X), 64, 1e-5, 1e-3, twin)
    compare("grid_xpbd", "16x8 sphere", *scene16(X, sphere=(0.375, -0.3, 0.0)),
            96, 2e-5, 5e-2, twin + "; v = delta/dt carries x rounding")
    host, cfg = scene16(X)
    compare("grid_xpbd", "16x8 no sweeps", host,
            cfg.replace(xpbd=dataclasses.replace(cfg.xpbd, n_iterations=0)),
            32, 1e-5, 1e-3, twin + "; n_iterations = 0: the epilogue alone")
    for name, k in kernels.items():
        k["err64"] = compare(name, k["preset"], k["host"], k["cfg"],
                             k["cfg"].n_substeps, 1e-5, 1e-3,
                             "one smooth frame: rounding only")
    emit("compare", seconds=phase_seconds())

    # 4. the main paths -----------------------------------------------------
    frames = 300
    for name, k in kernels.items():
        host, cfg = k["host"], k["cfg"]
        top, state0 = sb.init(host, device="cuda")
        pinned = torch.from_numpy(host.inv_mass == 0.0).to(cuda)
        expected = frames * cfg.n_substeps * launches_per_substep(name, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t = time.perf_counter()
        state = state0
        for _ in range(frames):
            state = sb.step(top, cfg, state)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t
        launched = counts()
        k["launches"] = launched[name]
        x = state.x
        nrm = sb.normals(top, state)
        unit_err = float((torch.linalg.vector_norm(nrm, dim=1) - 1.0).abs().max())
        emit("main_path", kernel=name, preset=k["preset"],
             solver=cfg.solver.value, vertices=x.shape[0], frames=frames,
             substeps=frames * cfg.n_substeps, launches=launched,
             expected_launches=expected, seconds=main_s,
             y_min=float(x[:, 1].min()), plane_height=float(top.plane_height),
             normal_unit_err=unit_err,
             peak_mem_bytes=torch.cuda.max_memory_allocated())
        require(launched[name] == expected,
                f"{name} launched {launched[name]} times, expected {expected}")
        require(sum(launched.values()) == expected,
                f"{k['preset']}: other kernels launched: {launched}")
        require(bool(torch.isfinite(x).all()), f"{name} main path: x not finite")
        require(int(pinned.sum()) == 256, f"{name} main path: expected 256 pins")
        require(torch.equal(x[pinned], state0.x[pinned]),
                f"{name} main path: pinned rows moved")
        require(bool((x[:, 1] >= top.plane_height).all()),
                f"{name} main path: vertex below the plane")
        require(unit_err <= 1e-5,
                f"{name}: normals off unit length by {unit_err:.3e}")
    emit("main_path", seconds=phase_seconds())

    # 5. hanging cloth on a sphere ------------------------------------------
    host, cfg = sb.presets.build("cloth_hanging_sphere")
    top, s0 = sb.init(host, device="cuda")
    s = s0
    for _ in range(120):
        s = sb.step(top, cfg, s)
    center = torch.tensor([0.8, -1.0, 0.15], device=cuda)
    dmin = float(torch.linalg.vector_norm(s.x - center, dim=1).min())
    pins = torch.from_numpy(host.inv_mass == 0.0).to(cuda)
    # 1e-5: the push-out lands a vertex on the radius to f32 rounding of
    # |x| ~ 1 values (measured 0.34999995 on the plain path)
    emit("sphere", preset="cloth_hanging_sphere", frames=120,
         min_sphere_dist=dmin, radius=0.35, tol=1e-5,
         y_min=float(s.x[:, 1].min()), seconds=phase_seconds())
    require(bool(torch.isfinite(s.x).all()), "sphere: x not finite")
    require(torch.equal(s.x[pins], s0.x[pins]), "sphere: pins moved")
    require(dmin >= 0.35 - 1e-5, f"sphere: vertex inside, dist {dmin}")

    # 6. golden replay ------------------------------------------------------
    # tests/test_golden.py's tolerances; the sphere scene's first recorded
    # frame is also held to 2e-3 (CPU plain path 8.4e-4, JAX f32 1.3e-3)
    for name, tol, first_tol in (("cloth_32_euler", 1e-4, 1e-4),
                                 ("cloth_hanging_sphere", 5e-2, 2e-3),
                                 ("cloth_xpbd", 2e-3, 2e-3)):
        data = np.load(os.path.join(ROOT, "tests", "golden", f"{name}.npz"))
        golden = data["positions"]
        every = int(data["record_every"])
        host, cfg = sb.presets.build(name)
        top, s = sb.init(host, device="cuda")
        drifts = []
        for r in range(golden.shape[0]):
            for _ in range(every):
                s = sb.step(top, cfg, s)
            drifts.append(float(np.max(np.abs(
                s.x.double().cpu().numpy() - golden[r]))))
        emit("golden", preset=name, solver=cfg.solver.value,
             frames=golden.shape[0] * every, drift_per_record=drifts, tol=tol,
             first_tol=first_tol)
        require(drifts[0] < first_tol and max(drifts) < tol,
                f"golden {name}: drifts {drifts}")
    emit("golden", seconds=phase_seconds())

    # 7. fidelity bound -----------------------------------------------------
    # BASELINE.json:5's 1e-3 over 1000 steps.  Verlet: on this scene the JAX
    # package's own float32 stencil drifts from its float64 run by the
    # series below, every 50 frames, worst 1.823590e-2 (CPU; python
    # tests/test_torch_xpbd_verlet.py cloth_bench_64k_verlet 1000 50):
    # float32 position Verlet keeps moving where float64 settles.  The port
    # is held to that worst drift plus 1e-5, the rounding allowance of the
    # one-frame 64k compare above (two float32 implementations of the same
    # arithmetic), and its difference from the series is printed.
    jax_verlet_drift = [
        4.697062e-04, 9.317698e-04, 1.234884e-03, 2.049689e-03, 4.189502e-03,
        7.977036e-03, 1.264167e-02, 4.539067e-03, 1.230327e-02, 1.823590e-02,
        1.263966e-02, 3.930316e-03, 1.707734e-02, 1.797614e-02, 5.664898e-03,
        1.088965e-02, 1.764441e-02, 1.316370e-02, 2.158719e-03, 1.467907e-02]
    fidelity = {"grid_euler": (1000, 250, 1e-3, "BASELINE.json:5", None),
                "grid_verlet": (1000, 50, max(jax_verlet_drift) + 1e-5,
                                "JAX stencil f32-vs-f64 drift on this scene "
                                "+ 1e-5 rounding", jax_verlet_drift),
                "grid_xpbd": (200, 50, 1e-3, "BASELINE.json:5", None)}
    for name, (n_frames, every, bound, why, ref) in fidelity.items():
        k = kernels[name]
        cfg = k["cfg"]
        t = time.perf_counter()
        top32, s32 = sb.init(k["host"], device="cuda")
        top64, s64 = sb.init(k["host"], device="cuda", dtype=torch.float64)
        plain64 = make_stencil_step(top64, cfg)
        checkpoints = []
        for i in range(n_frames):
            s32 = sb.step(top32, cfg, s32)
            s64 = plain64(s64, cfg.dt, cfg.n_substeps)
            if (i + 1) % every == 0:
                checkpoints.append(float((s32.x.double() - s64.x).abs().max()))
        torch.cuda.synchronize()
        worst = max(checkpoints)
        emit("fidelity", kernel=name, preset=k["preset"], frames=n_frames,
             every=every, drift=checkpoints, worst_drift=worst, bound=bound,
             bound_source=why,
             minus_reference=(None if ref is None else
                              [a - b for a, b in zip(checkpoints, ref)]),
             seconds=time.perf_counter() - t)
        require(worst <= bound, f"fidelity {name}: drift {worst:.3e} > {bound}")
    emit("fidelity", seconds=phase_seconds())

    # 8. timing -------------------------------------------------------------
    def device_us_per_launch(fn, s0, cfg, n_frames, names):
        """Device time per launch of each named kernel over n_frames, from
        torch.profiler; None where the trace shows no device time."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            s = s0
            for _ in range(n_frames):
                s = fn(s, cfg.dt, cfg.n_substeps)
            torch.cuda.synchronize()
        out = {}
        for ev in prof.key_averages():
            for kname in names:
                if kname in ev.key:
                    total = getattr(ev, "device_time_total", None)
                    if total is None:
                        total = getattr(ev, "cuda_time_total", 0.0)
                    if total > 0 and ev.count > 0:
                        out[kname] = (total / ev.count, ev.count)
        return out

    # every CUDA-event timing first: a torch.profiler session slows the
    # launches that follow it, so the device times are taken after
    for name, k in kernels.items():
        cfg = k["cfg"]
        top, s0 = sb.init(k["host"], device="cuda")
        runs = {"kernel": (k["module"].make_cuda_step(top, cfg), 100),
                "plain": (make_stencil_step(top, cfg), 5)}
        k["timing_runs"], k["timing_s0"] = runs, s0
        for fn, _ in runs.values():          # warm-up
            for _ in range(2):
                fn(s0, cfg.dt, cfg.n_substeps)
        torch.cuda.synchronize()

        def timed(which):
            fn, n_frames = runs[which]
            s = s0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n_frames):
                s = fn(s, cfg.dt, cfg.n_substeps)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / (n_frames * cfg.n_substeps)

        ms = {"kernel": [], "plain": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            ms[which].append(timed(which))
        k["ms"] = min(ms["kernel"])
        k["plain_ms"] = min(ms["plain"])
        k["bound_ms"], k["bound_by"] = bound_per_substep(name, top, cfg)
        emit("timing", kernel=name, preset=k["preset"], card=smi,
             ms_per_substep=ms,
             kernel_substeps_per_s=1e3 / k["ms"],
             plain_substeps_per_s=1e3 / k["plain_ms"],
             bound_us_per_substep=k["bound_ms"] * 1e3, bound_by=k["bound_by"])
    for name, k in kernels.items():
        cfg, s0 = k["cfg"], k["timing_s0"]
        dev = device_us_per_launch(k["timing_runs"]["kernel"][0], s0, cfg, 5,
                                   k["device_names"])
        per_sub = (sum(us * count for us, count in dev.values())
                   / (5 * cfg.n_substeps)
                   if len(dev) == len(k["device_names"]) else None)
        emit("timing", kernel=name, profiler_frames=5,
             device_us_per_launch={n: us for n, (us, _) in dev.items()},
             device_us_per_substep=per_sub)
    emit("timing", seconds=phase_seconds())

    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": k["source"],
        "replaces": k["replaces"], "launches": k["launches"],
        "max_abs_err": k["err64"], "ms": k["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        "library_ms": None,   # no single PyTorch call computes a stencil substep
    } for name, k in kernels.items()]}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
