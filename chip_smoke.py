#!/usr/bin/env python3
"""Drive softbodyunity_torch's main path once on an NVIDIA GPU and check it.

Run from a checkout, with one card:  python3 chip_smoke.py

Phases, each printed as one JSON line; any failure raises and exits nonzero:

1. device     the card's name and power limit (nvidia-smi) and torch's view;
2. build      nvcc builds the grid_euler kernel from kernels/csrc at first use;
3. compare    the kernel against its plain PyTorch version, both float32 on
              the card: a 16x8 cloth structural-only and with shear + bend
              (64 substeps), the same with a sphere in contact (96), and
              cloth_bench_64k (one frame);
4. main_path  cloth_bench_64k through init(device="cuda") and 300 frames of
              step(): every substep launched the kernel, x finite, pinned
              rows bit-equal to the initial state, nothing below the plane,
              unit normals;
5. sphere     cloth_hanging_sphere, 120 frames: the pins hold, no vertex
              inside the sphere;
6. golden     the float64 oracle trajectories of tests/golden replayed
              through step() at tests/test_golden.py's tolerances;
7. fidelity   cloth_bench_64k for 1000 frames, the kernel in float32 against
              the plain version in float64: drift <= 1e-3 (BASELINE.json:5);
8. timing     substeps/s of the kernel path and the plain version on
              cloth_bench_64k, CUDA events, in turns plain/kernel/kernel/plain.

Then a JSON line of the kernels (launches on the main path, error against
the plain version, times), the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.  Without a CUDA device, or without the
package beside it, it exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1

    import numpy as np

    import softbodyunity_torch as sb
    from softbodyunity_torch.kernels import build, grid_euler
    from softbodyunity_torch.kernels.grid_euler import make_cuda_step
    from softbodyunity_torch.kernels.stencil import make_stencil_step

    cuda = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. device -------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    # 2. build --------------------------------------------------------------
    lib = build.library_path("grid_euler")
    fresh = not lib.exists()
    t = time.perf_counter()
    build.load_library("grid_euler")
    build_s = time.perf_counter() - t
    log = lib.with_suffix(".log")
    ptxas = ([ln.strip() for ln in log.read_text().splitlines()
              if "ptxas" in ln] if log.exists() else [])
    emit("build", kernel="grid_euler", seconds=build_s, fresh_build=fresh,
         library=os.path.relpath(lib, ROOT), ptxas=ptxas)

    # 3. kernel vs plain version on the card ----------------------------------
    def scene16(shear, bend, sphere):
        cfg = sb.SimConfig(
            springs=sb.SpringParams(k_structural=500.0, k_shear=250.0,
                                    k_bend=100.0, damping=0.6),
            collision=sb.CollisionParams(enable_plane=True,
                                         enable_spheres=sphere, friction=0.2),
            global_damping=0.3,
        )
        host = sb.cloth_grid(
            16, 8, spacing=0.05, shear=shear, bend=bend, pinned=("tl", "tr"),
            springs=cfg.springs, xpbd=cfg.xpbd, plane_height=-0.25,
            orientation="xy",
            sphere_centers=np.array([[0.35, -0.4, 0.0]]) if sphere else None,
            sphere_radii=np.array([0.15]) if sphere else None,
        )
        return host, cfg

    def compare(name, host, cfg, n_sub, atol_x, atol_v, why):
        top, s0 = sb.init(host, device=cuda)
        plain = make_stencil_step(top, cfg)(s0, cfg.dt, n_sub)
        kern = make_cuda_step(top, cfg)(s0, cfg.dt, n_sub)
        torch.cuda.synchronize()
        dx = float((kern.x - plain.x).abs().max())
        dv = float((kern.v - plain.v).abs().max())
        finite = bool(torch.isfinite(kern.x).all() and torch.isfinite(kern.v).all())
        emit("compare", scene=name, substeps=n_sub, max_abs_dx=dx,
             max_abs_dv=dv, atol_x=atol_x, atol_v=atol_v, why=why)
        require(finite, f"{name}: kernel output not finite")
        require(dx <= atol_x and dv <= atol_v,
                f"{name}: kernel vs plain |dx| {dx:.3e} (<= {atol_x}), "
                f"|dv| {dv:.3e} (<= {atol_v})")
        return max(dx, dv)

    twin = ("tests/test_pallas.py kernel-vs-twin bound; FMA contraction here "
            "as rsqrt there")
    compare("16x8 structural", *scene16(False, False, False), 64, 5e-4, 5e-2,
            twin + ", floppy cloth amplifies it through plane contact")
    compare("16x8 shear+bend", *scene16(True, True, False), 64, 5e-6, 5e-4,
            twin)
    compare("16x8 sphere", *scene16(True, True, True), 96, 2e-5, 5e-2,
            twin + "; sphere contact")
    host64, cfg64 = sb.presets.build("cloth_bench_64k")
    err64 = compare("cloth_bench_64k", host64, cfg64, cfg64.n_substeps,
                    1e-5, 1e-3, "one smooth frame: rounding only")

    # 4. the main path ------------------------------------------------------
    top, state0 = sb.init(host64, device="cuda")
    pinned = torch.from_numpy(host64.inv_mass == 0.0).to(cuda)
    frames = 300
    torch.cuda.reset_peak_memory_stats()
    grid_euler.reset_launch_count()
    t = time.perf_counter()
    state = state0
    for _ in range(frames):
        state = sb.step(top, cfg64, state)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t
    launches = grid_euler.launch_count()
    x = state.x
    nrm = sb.normals(top, state)
    unit_err = float((torch.linalg.vector_norm(nrm, dim=1) - 1.0).abs().max())
    emit("main_path", preset="cloth_bench_64k", vertices=x.shape[0],
         frames=frames, substeps=frames * cfg64.n_substeps,
         kernel_launches=launches, seconds=main_s,
         y_min=float(x[:, 1].min()), plane_height=float(top.plane_height),
         normal_unit_err=unit_err,
         peak_mem_bytes=torch.cuda.max_memory_allocated())
    require(launches == frames * cfg64.n_substeps,
            f"kernel launched {launches} times, expected "
            f"{frames * cfg64.n_substeps}")
    require(bool(torch.isfinite(x).all()), "main path: x not finite")
    require(int(pinned.sum()) == 256, "main path: expected 256 pins")
    require(torch.equal(x[pinned], state0.x[pinned]),
            "main path: pinned rows moved")
    require(bool((x[:, 1] >= top.plane_height).all()),
            "main path: vertex below the plane")
    require(unit_err <= 1e-5, f"normals off unit length by {unit_err:.3e}")

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
         y_min=float(s.x[:, 1].min()))
    require(bool(torch.isfinite(s.x).all()), "sphere: x not finite")
    require(torch.equal(s.x[pins], s0.x[pins]), "sphere: pins moved")
    require(dmin >= 0.35 - 1e-5, f"sphere: vertex inside, dist {dmin}")

    # 6. golden replay ------------------------------------------------------
    # tests/test_golden.py's tolerances; the sphere scene's first recorded
    # frame is also held to 2e-3 (CPU plain path 8.4e-4, JAX f32 1.3e-3)
    for name, tol, first_tol in (("cloth_32_euler", 1e-4, 1e-4),
                                 ("cloth_hanging_sphere", 5e-2, 2e-3)):
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
        emit("golden", preset=name, frames=golden.shape[0] * every,
             drift_per_record=drifts, tol=tol, first_tol=first_tol)
        require(drifts[0] < first_tol and max(drifts) < tol,
                f"golden {name}: drifts {drifts}")

    # 7. fidelity bound -----------------------------------------------------
    t = time.perf_counter()
    top32, s32 = sb.init(host64, device="cuda")
    top64, s64 = sb.init(host64, device="cuda", dtype=torch.float64)
    plain64 = make_stencil_step(top64, cfg64)
    worst = 0.0
    checkpoints = []
    for i in range(1000):
        s32 = sb.step(top32, cfg64, s32)
        s64 = plain64(s64, cfg64.dt, cfg64.n_substeps)
        if (i + 1) % 250 == 0:
            d = float((s32.x.double() - s64.x).abs().max())
            checkpoints.append(d)
            worst = max(worst, d)
    torch.cuda.synchronize()
    emit("fidelity", preset="cloth_bench_64k", frames=1000,
         drift_every_250=checkpoints, worst_drift=worst, bound=1e-3,
         seconds=time.perf_counter() - t)
    require(worst <= 1e-3, f"fidelity: drift {worst:.3e} > 1e-3")

    # 8. timing -------------------------------------------------------------
    top, s0 = sb.init(host64, device="cuda")
    runs = {"kernel": (make_cuda_step(top, cfg64), 200),
            "plain": (make_stencil_step(top, cfg64), 10)}
    for fn, _ in runs.values():          # warm-up
        for _ in range(3):
            fn(s0, cfg64.dt, cfg64.n_substeps)
    torch.cuda.synchronize()

    def timed(which):
        fn, n_frames = runs[which]
        s = s0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_frames):
            s = fn(s, cfg64.dt, cfg64.n_substeps)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (n_frames * cfg64.n_substeps)

    ms = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        ms[which].append(timed(which))
    per_sub = {k: min(v) for k, v in ms.items()}
    emit("timing", preset="cloth_bench_64k", card=smi,
         ms_per_substep=ms,
         kernel_substeps_per_s=1e3 / per_sub["kernel"],
         plain_substeps_per_s=1e3 / per_sub["plain"])

    print(json.dumps({"kernels": [{
        "name": "grid_euler", "route": "cuda",
        "source": "softbodyunity_torch/kernels/csrc/grid_euler.cu",
        "replaces": "softbodyunity_tpu/kernels/pallas_substep.py:534",
        "launches": launches, "max_abs_err": err64,
        "ms": per_sub["kernel"], "plain_ms": per_sub["plain"],
    }]}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
