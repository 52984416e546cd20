#!/usr/bin/env python3
"""Drive softbodyunity_torch's main paths once on an NVIDIA GPU and check them.

Run from a checkout, with one card:  python3 chip_smoke.py

The port's paths, one hand-written CUDA kernel each:

    Euler   cloth_bench_64k           grid_euler      1 launch per substep (a
                                                      32 x 8 tile a CTA, each
                                                      edge once)
    Verlet  cloth_bench_64k_verlet    grid_verlet     1 launch per substep
                                                      (the same tile)
    XPBD    cloth_bench_64k_xpbd      grid_xpbd       1 (resident: the
                                                      predict, the sweeps
                                                      and the epilogue; past
                                                      the card's resident
                                                      tiles 1 + n_iterations)
    Euler   softbody_cube_64k         lattice_euler   3 (integrate, tet, gather)
    Verlet  softbody_cube_64k_verlet  lattice_verlet  3, + 1 a call (the
                                                      velocity estimate)
    XPBD    softbody_cube_64k_xpbd    lattice_xpbd    1 + 2 n_iterations
    Euler   cloth_selfcollide_64k     block_pairs     1, then grid_euler 1

The grid Euler and Verlet wrappers launch a frame from one ctypes call into
C (with self-collision, a substep); both XPBD wrappers and both lattice
Euler and Verlet wrappers launch a substep from one; a lattice XPBD sweep is a
constraint pass (each edge and tet once) and a gather pass, a lattice Euler
or Verlet volume projection a tet pass (each tet once) and a gather pass.

The seventh path is self-collision on grid cloth: each substep one
ctypes call builds the Morton tiles and their partners on the card (CUDA
kernels and CUB's radix sort) and launches block_pairs, which writes the
repulsion force plane (each warp skipping the 32 x 32 sub-blocks out of
reach, exactly), and one grid_euler launch adds it to the spring forces.

Then the grids past the TPU's whole-VMEM cap (its row-tiled kernels) and the
tear and plastic planes, on the same three grid kernels (their feature
instantiations, with one frame-end update launch a frame):

    Euler   cloth_bench_262k, cloth_bench_1m        grid_euler   1
    Euler   cloth_tearing_262k, cloth_plastic_262k,
            cloth_tearing_64k, cloth_plastic_64k    grid_euler   1, + 1 a frame
    Verlet  cloth_tearing_262k (solver replaced)    grid_verlet  1, + 1 a frame
    XPBD    cloth_tearing_262k (solver replaced)    grid_xpbd    1 + n_iterations,
                                                                 + 1 a frame

Then the wind and strain-limit branches: wind (drag and lift) in the three
grid kernels, the strain limit's sweeps (grid_strain_sweep_kernel, one
cooperative launch a substep for all its sweeps, a grid barrier between
them, the last running the solver's epilogue), and the wind's drag in the
three lattice kernels:

    Euler   cloth_wind_64k (Verlet, XPBD: solver replaced)   grid_*    as above
    Euler   cloth_strain_64k (Verlet, XPBD: solver replaced) grid_*    + 1
            (the sweeps; XPBD: 1 + n_iterations + 1)
    Euler   softbody_cube_64k, _verlet, _xpbd with drag      lattice_* as above
            (wind velocity (3, 0, 1), drag 0.3)

Then the capsule and box branch of the six kernels, on two scenes built
here from the presets with the public add_colliders (cloth_colliders_64k,
add_cube_colliders): a 64k cloth dropped onto a rolling capsule and a
turned box, and the 64k cubes dropped onto a turned box and a capsule:

    Euler   cloth_colliders_64k (Verlet, XPBD: solver replaced)  grid_*     as above
    Euler   softbody_cube_64k, _verlet, _xpbd with colliders      lattice_*  as above

Then the row-sharded grid cloth of parallel/halo.py, the multi-device path:
each rank steps its rows of the cloth in plain PyTorch with a two-row halo
from its neighbours, all-gathers the cloth's positions, and launches the
dual form of block_pairs (TPU kernel #11) for its rows' self-collision, on
a ring of one NCCL rank (torch.distributed) and on four ranks of one
process (LocalRing, which runs them in turns on the one card):

    Euler   cloth_selfcollide_64k (Verlet, XPBD: solver replaced)
            block_pairs_dual   1 a substep and rank

Phases, each printed as one JSON line; any failure raises and exits nonzero:

1. device     the card's name and power limit (nvidia-smi) and torch's view;
              then the host build time of each preset (tet_cube(40) is
              seconds of Python loops);
2. build      nvcc builds the seven kernels and the vertex normals' kernel
              (csrc/normals.cu) from kernels/csrc at first use,
              one nvcc per source, all started together at the script's
              start, beside the host's preset builds of phase 1; the phase
              waits for them;
3. compare    each kernel against its plain PyTorch version, both float32 on
              the card: 16x8 cloths (the scenes of tests/test_pallas.py),
              6^3 and 7^3 tet cubes (tests/test_pallas_lattice.py), and one
              frame of its 64k preset; block_pairs on random clouds, the
              folded sheets of tests/test_blocksparse.py (and against the
              dense rule) and the 64k self-collision preset after 24
              substeps, where no tile pair may be dropped, each with its
              cull's kept shares of sub-block pairs and of their partner
              vertices, its dense and culled bounds and its dense
              instantiation's forces (to the bit), and the frame
              that follows; then one frame of the 64k curtain shrunk to
              60 % and of each grid solver with self-collision; each
              feature instantiation on the small tearing and plastic
              scenes of tests/test_torch_features.py, one frame-end update
              launch from identical inputs against the plain update (masks
              and scales to the bit), one frame of each 262k feature preset
              under the three solvers (masks equal), and one frame of the
              262k and 1m curtains; then the wind with lift under the three
              grid solvers (10x10 and a contact-free 16x24, tests/test_wind.py's
              scenes), the strain limit under the three (tests/
              test_strainlimit.py's 16x16 banner, without planes, tearing,
              tearing and plasticity: masks equal), the sweeps alone from
              identical positions, the drag on 6^3 cubes, and one frame of
              each wind, strain and drag path at 64k; then the six kernels
              on tests/test_torch_colliders.py's cloth and cube in contact
              with a moving capsule and box (the grid kernels also under
              the strain limit and with tear and plastic planes), and one
              frame of each 64k collider path from rest and one from its
              state in contact; then block_pairs_dual on the 64k
              self-collision preset after 24 substeps, cut into 1 and 4 row
              shards, each launch against the plain dual form (with one
              rank, against block_pairs to the bit: required), with its µs
              a launch from CUDA events, kept share, both bounds and dropped
              pairs;
4. main_path  each 64k preset through init(device="cuda") and 300 frames of
              step() (the self-collision preset 60), every launch count set
              to 0 just before and read just after: the path's kernels
              launched frames x substeps x launches per substep times and
              no other kernel launched; x finite, pinned rows bit-equal to
              the initial state, nothing below the plane (and the cubes
              resting on it), unit normals, the path's own peak device
              memory from init on; the normals of every main path's last
              state (sb.normals) one launch of the normals kernel, within
              1e-5 of the plain version on the same card tensors; then the
              eight paths past the cap or
              with feature planes (phase main_path_large), each checked the
              same way, the tear masks non-increasing with edges torn, the
              rest scales inside their clip with some above 1, max |v| per
              frame finite; then the nine wind, strain and drag paths
              (phase main_path_branches), the strain sweeps' own count too;
              then the six collider paths (phase main_path_colliders), the
              capsule raised by 0.05 m halfway through move_colliders with
              no step function built, and no vertex inside a capsule or a
              box by more than 1e-4 at the end; then the halo paths (phase
              main_path_halo): per solver and ring, the first 4 substeps
              held to the single-device kernel path at 1e-5 (from rest
              under Euler and Verlet; from the curtain shrunk to 70 %
              under all three), then
              2 frames with the counts set to 0 just before (block_pairs_dual
              once a substep and rank, no other kernel), finite, the pins
              held, nothing below the plane, and the rate (four ranks in
              turns on one card: not a scaling number);
5. sphere     cloth_hanging_sphere (Euler), 120 frames: the pins hold, no
              vertex inside the sphere;
6. golden     the float64 oracle trajectories of tests/golden replayed
              through step() at tests/test_golden.py's tolerances
              (cloth_batch_rl with self-collision methods block and dense;
              cloth_strain_limited);
7. fidelity   each kernel in float32 against its plain version in float64
              (replayed from a CUDA graph of one frame, held bit-equal to
              a call of it on the first frame):
              grid Euler and Verlet over 500 frames of their 64k presets,
              grid XPBD over 100; softbody_cube over 1000 frames; the 64k
              cubes over 200 frames (Euler, Verlet) and 60 (XPBD);
              cloth_batch_rl with method block over 100 frames; the 262k
              and 1m curtains over 200 and 100 frames; the feature presets
              over 60 (64k) or 30 (262k) frames, the masks and scales of
              float32 kernel, float32 plain and float64 plain compared at
              each frame (printed, not bounded); cloth_wind_64k and
              cloth_strain_64k over 200 frames, held to 1e-3 while the JAX
              package's own float32 drift on them stays inside it, and to
              twice its worst after, where the flutter and the strain clamp
              have made both chaotic; the collider scenes the same way (the
              cloth over 100 frames, the cubes over 40);
8. timing     per 64k preset, ms per substep of the kernel path and of the
              plain version with CUDA events, in turns plain/kernel/kernel/
              plain; then, after all of them (a profiler session slows the
              launches that follow it), each kernel's device time per
              launch from torch.profiler, each line naming the kernel
              instances (template symbols) that ran.  The lattice kernels
              are timed from rest (the cube in free fall, the work
              bound_per_substep counts) and again from the main path's last
              state (the cube
              deformed and resting on the plane).  The self-collision
              path and its pair function alone are timed from the 64k
              preset's state after 24 substeps.  The paths past the cap and
              with feature planes, and the wind, strain and drag paths, are
              timed from rest, and the strain sweeps alone; the collider
              paths from their state in contact.  Each XPBD path prints
              its launches a substep.  The normals of the 64k curtain
              perturbed: a call of sb.normals (the kernel) against the
              plain version with CUDA events, then the kernel's device
              time a launch from torch.profiler, against its byte bound.

Then a JSON line of the kernels (launches on the main path, error against
the plain version, times, bound), the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.  Without a CUDA device, or without the
package beside it, it exits nonzero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
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
#
# The lattice kernels' functions, counted from their plain versions
# (solver/banded.py, solver/step.py) the same way:
# - a banded spring edge: as a grid edge, with a divide for each of the 3
#   components of n in place of a reciprocal and 3 multiplies: 34;
# - a tet of the PBD volume projection: edges 9, three cross products 27
#   (e1 x e2 counted once, though the plain version forms it twice), /6 on
#   the 9 gradient components 9, g0 9, volume dot 5 and /6 1, C 1, the
#   denominator (4 squared norms 20, times w 4, summed 3) 27, max 1, scale
#   -C/max 2, the 4 corners' w s 4 and times g 12, added into dx 12 = 119;
# - an XPBD volume constraint in one sweep: the same plus alpha lambda 1,
#   C + 1, denominator + alpha 1 and the lambda update 1 = 123.
# Per vertex: Euler's volume step stiffness dx / count, x + dx, v + dx/dt 15;
# Verlet's 9; per XPBD sweep evaluation point 3, relaxation dx / count 6,
# delta + 3 and the plane test 2 = 14.  Plane and sphere contact work is
# data-dependent; the timed windows start from rest and end before the
# cubes reach the plane (20 frames of a 1 m drop), so they count 0.
OPS_SPRING_EDGE = 35
OPS_XPBD_EDGE = 36
OPS_EULER_VERTEX = 22
OPS_VERLET_VERTEX = 31
OPS_XPBD_VERTEX_ONCE = 18
OPS_XPBD_VERTEX_SWEEP = 12
OPS_BANDED_EDGE = 34
OPS_TET = 119
OPS_XPBD_TET = 123
OPS_EULER_VOLUME_VERTEX = 15
OPS_VERLET_VOLUME_VERTEX = 9
OPS_LATTICE_XPBD_VERTEX_SWEEP = 14
# A vertex pair of the block-sparse self-collision, counted from the plain
# version (solver/blocksparse.py) the same way: diff 3, squared norm 5, max 1,
# sqrt 1, k (r - d) / d 3, w diff 3, summed into the force 3 = 19 (the
# compare and select of the radius test are not counted).  The kernel's cull
# (csrc/block_pairs.cu, "The cull") adds, per 32-vertex slice box, the min
# and max of 3 coordinates over 5 shuffle steps, 30, per sub-block pair's
# box test two differences and two maxima an axis and the squares summed,
# 17, and per partner vertex of a kept sub-block pair its point test against
# the warp's box, the same 17; then it takes the squared distance of each
# pair of a kept vertex, diff 3 and squared norm 5, 8, and the full pair
# only for those within reach (~1 % of them on the 64k pile, not counted).
OPS_PAIR = 19
OPS_SLICE_BOX = 30
OPS_SLICE_TEST = 17
OPS_POINT_TEST = 17
OPS_PAIR_TEST = 8
# The feature update of one edge, counted from its plain version
# (kernels/stencil.py::update_features) the same way: the length (d 3,
# |d|^2 5, sqrt 1) 9; plastic flow (rest scale 1, max 1, strain 2, abs 1,
# yield 1, max 1, sign 1 and its multiply 1, creep 1, + 1 1, times scale 1,
# clip 2) 14; the tear check (threshold 1 multiply without plasticity, 2
# with, compare 1, alive * ok 1).  A plastic edge's force or constraint
# takes one more multiply (rest * scale); under tearing the XPBD Jacobi
# count adds 2 per edge and a max and a divide per vertex.
OPS_FEATURE_LENGTH = 9
OPS_PLASTIC = 14
OPS_TEAR = 3
OPS_XPBD_COUNT_EDGE = 2
OPS_XPBD_COUNT_VERTEX = 2
# The wind, counted from its plain version (kernels/stencil.py::
# wind_forces_grid) the same way, per vertex: v_rel 3, drag 3, added to the
# force 3 = 9 for drag alone; with lift the two face normals of a cell (2
# differences 6 and a cross product 9 each) 30, the six faces summed 15,
# the norm (squares 5, sqrt, max, divides 3) 10, v_rel . n 5, lift * 1,
# times n 3 and added 3: 76.  The lattice kernels run the drag alone.
OPS_WIND_VERTEX = 76
OPS_DRAG_VERTEX = 9
# A strain-limit edge in one sweep (kernels/stencil.py::strain_limit_planes):
# d 3, |d|^2 5, sqrt 1, max 1, n 3, clip 2, C 1 and its mask 1, w + wn 1,
# max 1, divide 1, the two shares 2, times n 6, added at both ends 6 = 34;
# per vertex and sweep the averaged update 6; once per substep the count, 2
# per edge and 2 per vertex.
OPS_STRAIN_EDGE = 34
OPS_STRAIN_VERTEX = 6
# Capsule and box contact (solver/collide.py's primitives), the same way,
# per vertex and collider: a capsule's test (axis 3, |axis|^2 5, x - p0 3,
# the dot 5, max 1, divide 1, clip 2, closest point 6, d 3, |d|^2 5, sqrt 1,
# max 1, reciprocal 1, normal 3, penetration 1) 41; a box's (d 3, local
# coordinates 15, abs 3, penetrations 3, normal 3) 27, and its friction
# shell 3 more (the largest half extent 2, times the shell 1).  Every
# vertex runs the tests, so they count for every vertex; the response runs
# where a vertex is in contact, which depends on the data: it counts for
# the vertices in contact in the timed state (within 1e-3 of a surface or
# inside), per contact the push-out 6, the velocity response 35 (Euler), the
# friction 23 (Verlet, XPBD; its test again as above).
OPS_CAPSULE_TEST = 41
OPS_BOX_TEST = 27
OPS_BOX_SHELL = 3
OPS_PUSH = 6
OPS_VELOCITY_RESPONSE = 35
OPS_FRICTION = 23


def rot_z(deg):
    """The rotation by ``deg`` degrees about z (a box's world-from-local
    matrix, its columns the box's axes)."""
    import numpy as np

    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def cloth_colliders_64k(pkg, solver):
    """``cloth_colliders_64k``: a 256x256 cloth (spacing 0.01, 2.55 m,
    horizontal, no pins) dropped from y = 1.15 onto a capsule rolling at
    (0.3, 0, 0) and a box turned 30 degrees about z, the layout of
    tests/test_colliders.py::_scene scaled by 4.6 about the origin but for
    the capsule's end p1, moved from x = 0.23 to -0.6 (scaled as it is, the
    capsule overlaps the box, and in that crease the capsule-then-box
    projection leaves vertices up to 2.7e-4 inside the capsule, in the JAX
    package too: tests/test_torch_colliders.py crease), with
    cloth_bench_64k's springs, mass, damping, dt and 16 substeps; the plane
    at -9.2.  ``pkg`` is softbodyunity_torch (or the JAX package, whose
    names are the same: tests/test_torch_colliders.py measures its own
    float32 drift on this scene).  Verlet and XPBD replace the solver (XPBD
    with cloth_bench_64k_xpbd's iterations and compliances)."""
    _, base = pkg.presets.build("cloth_bench_64k")
    cfg = base.replace(
        solver=solver,
        collision=pkg.CollisionParams(
            enable_plane=True, enable_capsules=True, enable_boxes=True,
            restitution=0.1, friction=0.3))
    if solver == pkg.Solver.XPBD:
        cfg = cfg.replace(xpbd=pkg.presets.build(
            "cloth_bench_64k_xpbd")[1].xpbd)
    host = pkg.cloth_grid(
        256, 256, spacing=0.01, mass=0.01, shear=True, bend=True, pinned=(),
        springs=cfg.springs, xpbd=cfg.xpbd, plane_height=-9.2,
        origin=(-1.29, 1.15, -1.29), orientation="xz")
    host = pkg.add_colliders(
        host, capsule_p0=[[-1.38, 0.0, 0.0]], capsule_p1=[[-0.6, 0.0, 0.0]],
        capsule_radii=[0.55], capsule_velocities=[[0.3, 0.0, 0.0]],
        box_centers=[[0.83, -0.23, 0.46]],
        box_half_extents=[[0.69, 0.46, 0.55]], box_rotations=[rot_z(30.0)])
    return host, cfg


def add_cube_colliders(pkg, host, cfg):
    """``softbody_cube_64k_colliders``: a 64k cube preset's scene (40^3 tets,
    0.78 m, dropped from y = 1) with a box at (0.25, 0.2, 0.39), half
    extents (0.3, 0.2, 0.6), turned 20 degrees about z, and a capsule from
    (0.7, 0.15, -0.2) to (0.7, 0.15, 1.0) of radius 0.15, both under it.
    Attaches them to a copy of ``host``."""
    import copy

    host = pkg.add_colliders(
        copy.deepcopy(host), capsule_p0=[[0.7, 0.15, -0.2]],
        capsule_p1=[[0.7, 0.15, 1.0]], capsule_radii=[0.15],
        box_centers=[[0.25, 0.2, 0.39]], box_half_extents=[[0.3, 0.2, 0.6]],
        box_rotations=[rot_z(20.0)])
    return host, cfg.replace(collision=dataclasses.replace(
        cfg.collision, enable_capsules=True, enable_boxes=True))


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# the numbered phase main() is in, which a failure names
_phase = {"name": "start"}


def begin(phase: str) -> None:
    _phase["name"] = phase


def events_ms(body, n):
    """ms per unit of ``body()``, which does ``n`` units, from CUDA
    events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    body()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def profile_device(body, names, symbols=None):
    """Run ``body()`` under torch.profiler: {name: (device µs a launch,
    launches)} of each of ``names`` that the trace shows running (a name
    matches every kernel whose symbol holds it), and the device µs of every
    kernel, memcpy and memset in the trace.  ``symbols``, a dict, receives
    {name: the full symbols it matched} (a template kernel's instances)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        body()
        torch.cuda.synchronize()
    total_of, busy = {}, 0.0
    for ev in prof.key_averages():
        total = getattr(ev, "device_time_total", None)
        if total is None:
            total = getattr(ev, "cuda_time_total", 0.0)
        # the device's own events; a host event's device time counts the
        # kernels it launched a second time
        if ev.device_type == DeviceType.CPU:
            continue
        busy += total
        for kname in names:
            if kname in ev.key and total > 0 and ev.count > 0:
                t, c = total_of.get(kname, (0.0, 0))
                total_of[kname] = (t + total, c + ev.count)
                if symbols is not None:
                    symbols.setdefault(kname, []).append(ev.key)
    return {k: (t / c, c) for k, (t, c) in total_of.items()}, busy


def collider_counts(top, cfg):
    """The capsules and boxes a kernel loops over (0 for one that is off)."""
    col = cfg.collision
    return (top.n_capsules if col.enable_capsules else 0,
            top.n_boxes if col.enable_boxes else 0)


def collider_ops(name, top, cfg, contacts):
    """Operations of one substep's capsule and box contact (OPS_CAPSULE_TEST
    and the rest above): the tests of every vertex, once per projection
    (XPBD: once per Jacobi sweep, and once more after the strain sweeps)
    and once more for the friction, and the response of the ``contacts``
    vertices in contact."""
    n_caps, n_boxes = collider_counts(top, cfg)
    if n_caps + n_boxes == 0:
        return 0
    n = top.n_vertices
    test = OPS_CAPSULE_TEST * n_caps + OPS_BOX_TEST * n_boxes
    if name.endswith("euler"):
        return n * test + contacts * (OPS_PUSH + OPS_VELOCITY_RESPONSE)
    passes = 1
    if name.endswith("xpbd"):
        passes = cfg.xpbd.n_iterations + int(cfg.strain_limit.enabled)
    friction = 0
    if cfg.collision.friction != 0.0:
        friction = (n * (test + OPS_BOX_SHELL * n_boxes)
                    + contacts * OPS_FRICTION)
    return passes * (n * test + contacts * OPS_PUSH) + friction


def bound_per_substep(name, top, cfg, contacts=0):
    """(least ms the card could take for one substep of ``name`` on this
    scene, "bytes" or "operations"): each input read once and each output
    written once over the memory rate, against the operations over the
    float32 rate.  ``contacts``: the vertices in capsule or box contact
    (collider_ops)."""
    n = top.n_vertices
    e = int(top.edges.shape[0])
    if name.startswith("lattice_"):
        return _lattice_bound(name, top, cfg, n, e, contacts)
    n_off = len(top.edge_classes_present) * 2
    n_caps, n_boxes = collider_counts(top, cfg)
    # table, plane, spheres, capsules, boxes
    consts = (16 * n_off + 16 + 28 * top.n_spheres + 40 * n_caps
              + 72 * n_boxes)
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
    tear, plastic = cfg.tear.enabled, cfg.plasticity.enabled
    if tear or plastic:
        # the planes of the enabled features read and written once per
        # substep, and per frame one more update over the final x (read
        # once), spread over the frame's substeps; the update's operations
        # per edge and substep, as many again at the frame's end
        planes = n_off * (int(tear) + int(plastic))
        sub = cfg.n_substeps
        nbytes += 4 * n * planes * 2 * (sub + 1) / sub + 4 * n * 3 / sub
        update = (OPS_FEATURE_LENGTH + OPS_PLASTIC * int(plastic)
                  + (OPS_TEAR + int(plastic)) * int(tear))
        ops += e * update * (sub + 1) / sub
        if plastic:
            ops += e * (cfg.xpbd.n_iterations if name == "grid_xpbd" else 1)
        if tear and name == "grid_xpbd":
            ops += OPS_XPBD_COUNT_EDGE * e + OPS_XPBD_COUNT_VERTEX * n
    if cfg.wind.enabled:
        ops += (OPS_WIND_VERTEX if cfg.wind.lift != 0.0
                else OPS_DRAG_VERTEX) * n
    if cfg.strain_limit.enabled:
        # the sweeps' positions stay inside the substep: no input or output
        # bytes of their own, the operations of every sweep
        ops += _strain_ops(cfg, n, e)
    ops += collider_ops(name, top, cfg, contacts)
    return _bound(nbytes + consts, ops)


def _strain_ops(cfg, n, e):
    it = cfg.strain_limit.iterations
    return (it * (OPS_STRAIN_EDGE * e + OPS_STRAIN_VERTEX * n)
            + OPS_XPBD_COUNT_EDGE * e + OPS_XPBD_COUNT_VERTEX * n)


def strain_bound(top, cfg):
    """(least ms the card could take for one substep's strain-limit sweeps
    on this scene, "bytes" or "operations"): the positions and inverse
    masses read once and the positions written once, against every sweep's
    operations."""
    n = top.n_vertices
    e = int(top.edges.shape[0])
    return _bound(4 * n * (3 + 1 + 3), _strain_ops(cfg, n, e))


def _bound(nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def block_pairs_bound(n, blk, n_tiles, sum_nvalid, n_tiles_j=0, kept=None,
                      kept_vertices=None):
    """(least ms the card could take for the pair forces of one state,
    "bytes" or "operations"): the kernel's inputs (tiles, partner counts, the
    interacting partner ids, the sort order) read once and the [3, N] force
    planes written once, against OPS_PAIR per vertex pair of the interacting
    tile pairs this state has (the dense sweep, the TPU kernel's work) or,
    given the ``kept`` 32 x 32 sub-block pairs and the ``kept_vertices``
    partner vertices the cull keeps in them, OPS_PAIR_TEST per pair of
    those vertices, 32 each, with the slice boxes, the box tests and the
    point tests.  The
    dual form reads ``n_tiles_j`` partner tiles besides the ``n_tiles``
    i-tiles of its ``n`` vertices."""
    nbytes = (4 * 3 * (n_tiles + n_tiles_j) * blk + 8 * n_tiles
              + 8 * sum_nvalid + 8 * n + 4 * 3 * n)
    if kept is None:
        return _bound(nbytes, OPS_PAIR * blk * blk * sum_nvalid)
    slices = blk // 32
    return _bound(nbytes, OPS_PAIR_TEST * 32 * kept_vertices
                  + OPS_POINT_TEST * 32 * kept + sum_nvalid * (
                      OPS_SLICE_TEST * slices * slices
                      + OPS_SLICE_BOX * slices))


def _lattice_bound(name, top, cfg, n, e, contacts):
    """bound_per_substep of a tet-lattice kernel: the ownership word and the
    count plane (4 B each) stand for the edge and tet masks."""
    from softbodyunity_torch.kernels.lattice import use_volume

    volume = use_volume(top, cfg)
    t = top.n_tets if volume else 0
    n_groups = len(top.offset_groups.deltas)
    t_groups = len(top.tet_groups.deltas) if volume else 0
    n_caps, n_boxes = collider_counts(top, cfg)
    consts = (12 * n_groups + 16 * t_groups + 16 + 28 * top.n_spheres
              + 40 * n_caps + 72 * n_boxes)
    per_vertex = 4 * (1 + 1 + int(volume or name == "lattice_xpbd"))
    if name == "lattice_euler":     # x, v in; x, v out
        nbytes = n * (4 * 12 + per_vertex)
        ops = (OPS_BANDED_EDGE * e + OPS_TET * t + OPS_EULER_VERTEX * n
               + (OPS_EULER_VOLUME_VERTEX * n if volume else 0))
    elif name == "lattice_verlet":  # x, x_prev in; x out
        nbytes = n * (4 * 9 + per_vertex)
        ops = (OPS_BANDED_EDGE * e + OPS_TET * t + OPS_VERLET_VERTEX * n
               + (OPS_VERLET_VOLUME_VERTEX * n if volume else 0))
    else:                           # x, v in; x, v out
        it = cfg.xpbd.n_iterations
        nbytes = n * (4 * 12 + per_vertex)
        ops = (it * (OPS_XPBD_EDGE * e + OPS_XPBD_TET * t
                     + OPS_LATTICE_XPBD_VERTEX_SWEEP * n)
               + OPS_XPBD_VERTEX_ONCE * n)
    if cfg.wind.enabled:
        ops += OPS_DRAG_VERTEX * n
    ops += collider_ops(name, top, cfg, contacts)
    return _bound(nbytes + consts, ops)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1

    import numpy as np

    import softbodyunity_torch as sb
    from softbodyunity_torch import api
    from softbodyunity_torch.core.topology import (EDGE_BEND, EDGE_SHEAR,
                                                   SceneKey)
    from softbodyunity_torch.kernels import (blocks, build, grid_euler,
                                            grid_strain, grid_verlet,
                                            grid_xpbd, lattice_euler,
                                            lattice_verlet, lattice_xpbd)
    from softbodyunity_torch.kernels import normals as normals_kernel
    from softbodyunity_torch.kernels.stencil import (_offsets, _valid_mask,
                                                    from_planes,
                                                    make_stencil_step,
                                                    strain_limit_planes,
                                                    to_planes,
                                                    update_features)
    from softbodyunity_torch.parallel import DistRing, LocalRing, halo
    from softbodyunity_torch.solver import blocksparse
    from softbodyunity_torch.solver.forces import self_collision_forces_dense
    from softbodyunity_torch.solver.normals import vertex_normals
    from softbodyunity_torch.solver.step import make_plain_step

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
        "lattice_euler": dict(
            module=lattice_euler, preset="softbody_cube_64k",
            replaces="softbodyunity_tpu/kernels/pallas_lattice.py:363",
            device_names=("lattice_euler_integrate_kernel",
                          "lattice_tet_kernel",
                          "lattice_euler_gather_kernel")),
        "lattice_verlet": dict(
            module=lattice_verlet, preset="softbody_cube_64k_verlet",
            replaces="softbodyunity_tpu/kernels/pallas_lattice.py:901",
            device_names=("lattice_verlet_velocity_kernel",
                          "lattice_verlet_integrate_kernel",
                          "lattice_tet_kernel",
                          "lattice_verlet_gather_kernel")),
        "lattice_xpbd": dict(
            module=lattice_xpbd, preset="softbody_cube_64k_xpbd",
            replaces="softbodyunity_tpu/kernels/pallas_lattice.py:699",
            device_names=("lattice_xpbd_predict_kernel",
                          "lattice_xpbd_constraint_kernel",
                          "lattice_xpbd_gather_kernel")),
        "block_pairs": dict(
            module=blocks, preset="cloth_selfcollide_64k",
            replaces="softbodyunity_tpu/kernels/pallas_blocks.py:151",
            device_names=("block_pairs_kernel",)),
    }
    for name, k in kernels.items():
        k["source"] = f"softbodyunity_torch/kernels/csrc/{name}.cu"
        k["lattice"] = name.startswith("lattice_")
        k["plain"] = make_plain_step if k["lattice"] else make_stencil_step
    # the six solver kernels, each the whole substep of its own path
    steps = {n: k for n, k in kernels.items() if n != "block_pairs"}
    # the vertex normals' kernel: no substep's, so not in ``kernels``; each
    # main path's sb.normals call is one launch of it, held against the
    # plain version on the same card tensors (rendered below)
    normals_line = dict(
        name="normals",
        source="softbodyunity_torch/kernels/csrc/normals.cu",
        replaces="none: softbodyunity_tpu/solver/normals.py leaves the "
                 "normals to XLA (a segment sum)",
        launches=0, err_of={})
    libraries = [*kernels, normals_line["name"]]

    def launches_per_call(name, top, cfg, n_sub):
        """Launches of one call of kernel ``name``'s step function."""
        if kernels[name]["lattice"]:
            return kernels[name]["module"].launches_per_call(top, cfg, n_sub)
        return n_sub * (grid_xpbd.launches_per_substep(cfg, top.grid_shape)
                        if name == "grid_xpbd" else 1)

    def grid_launches_per_frame(module, top, cfg):
        """A grid kernel's launches a frame of ``cfg.n_substeps``; grid
        XPBD's follow its plan on the grid's shape (one resident launch a
        substep where the tiles fit the card)."""
        if module is grid_xpbd:
            return grid_xpbd.launches_per_frame(cfg, cfg.n_substeps,
                                                top.grid_shape)
        return module.launches_per_frame(cfg, cfg.n_substeps)

    # the grids past the TPU's whole-VMEM cap and the tear and plastic
    # planes: each path's preset (its solver replaced where named), the
    # kernel it launches and its main-path frames (the 1m curtain at least
    # 12: its JAX preset once NaN'd by frame 12)
    large = {}
    for label, preset, solver, kernel, frames_ in (
            ("cloth_bench_262k", "cloth_bench_262k", None, "grid_euler", 30),
            ("cloth_bench_1m", "cloth_bench_1m", None, "grid_euler", 24),
            ("cloth_tearing_262k", "cloth_tearing_262k", None, "grid_euler",
             30),
            ("cloth_tearing_262k_verlet", "cloth_tearing_262k",
             sb.Solver.VERLET, "grid_verlet", 20),
            ("cloth_tearing_262k_xpbd", "cloth_tearing_262k", sb.Solver.XPBD,
             "grid_xpbd", 10),
            ("cloth_plastic_262k", "cloth_plastic_262k", None, "grid_euler",
             30),
            ("cloth_tearing_64k", "cloth_tearing_64k", None, "grid_euler", 60),
            ("cloth_plastic_64k", "cloth_plastic_64k", None, "grid_euler",
             60)):
        large[label] = dict(preset=preset, solver=solver, kernel=kernel,
                            frames=frames_)
    # the kernels line's entries for the row-tiled TPU kernels #4-6: the
    # feature instantiations, and the plain one past the cap
    variants = {
        "grid_euler_features": dict(
            base="grid_euler", path="cloth_tearing_262k",
            replaces="softbodyunity_tpu/kernels/pallas_tiled.py:380, and the "
                     "tear/plastic branch of pallas_substep.py:534"),
        "grid_verlet_features": dict(
            base="grid_verlet", path="cloth_tearing_262k_verlet",
            replaces="softbodyunity_tpu/kernels/pallas_tiled.py:738, and the "
                     "tear/plastic branch of pallas_substep.py:801"),
        "grid_xpbd_features": dict(
            base="grid_xpbd", path="cloth_tearing_262k_xpbd",
            replaces="softbodyunity_tpu/kernels/pallas_tiled.py:1155, and "
                     "the tear/plastic branch of pallas_xpbd.py:334"),
        "grid_euler_1m": dict(
            base="grid_euler", path="cloth_bench_1m",
            replaces="softbodyunity_tpu/kernels/pallas_tiled.py:380, without "
                     "feature planes"),
    }

    # the wind and strain-limit branches of the grid kernels and the drag
    # of the lattice kernels: each path's preset (its solver replaced where
    # named; the 64k cubes blown by a wind of drag only), the kernel it
    # launches and its main-path frames
    cube_wind = sb.WindParams(velocity=(3.0, 0.0, 1.0), drag=0.3)
    branches = {}
    for label, preset, solver, kernel, frames_ in (
            ("cloth_wind_64k", "cloth_wind_64k", None, "grid_euler", 300),
            ("cloth_wind_64k_verlet", "cloth_wind_64k", sb.Solver.VERLET,
             "grid_verlet", 60),
            ("cloth_wind_64k_xpbd", "cloth_wind_64k", sb.Solver.XPBD,
             "grid_xpbd", 30),
            ("cloth_strain_64k", "cloth_strain_64k", None, "grid_euler", 300),
            ("cloth_strain_64k_verlet", "cloth_strain_64k", sb.Solver.VERLET,
             "grid_verlet", 60),
            ("cloth_strain_64k_xpbd", "cloth_strain_64k", sb.Solver.XPBD,
             "grid_xpbd", 30),
            ("softbody_cube_64k_wind", "softbody_cube_64k", None,
             "lattice_euler", 60),
            ("softbody_cube_64k_verlet_wind", "softbody_cube_64k_verlet", None,
             "lattice_verlet", 60),
            ("softbody_cube_64k_xpbd_wind", "softbody_cube_64k_xpbd", None,
             "lattice_xpbd", 20)):
        branches[label] = dict(preset=preset, solver=solver, kernel=kernel,
                               frames=frames_)
    # the kernels line's entries for the branches: each grid kernel's wind
    # (lift) and lattice kernel's drag, and the strain sweep
    branch_lines = {
        "grid_euler_wind": dict(
            path="cloth_wind_64k",
            replaces="softbodyunity_tpu/kernels/pallas_substep.py:404-408, "
                     "the wind branch of :534 (and pallas_tiled.py:273-281 "
                     "of :380)"),
        "grid_verlet_wind": dict(
            path="cloth_wind_64k_verlet",
            replaces="softbodyunity_tpu/kernels/pallas_substep.py:669-673, "
                     "the wind branch of :801 (and pallas_tiled.py:623-628 "
                     "of :738)"),
        "grid_xpbd_wind": dict(
            path="cloth_wind_64k_xpbd",
            replaces="softbodyunity_tpu/kernels/pallas_xpbd.py:103-111, the "
                     "wind branch of :334 (and pallas_tiled.py:993-1000 of "
                     ":1155)"),
        "lattice_euler_drag": dict(
            path="softbody_cube_64k_wind",
            replaces="softbodyunity_tpu/kernels/pallas_lattice.py:293-294, "
                     "the wind drag of :363"),
        "lattice_verlet_drag": dict(
            path="softbody_cube_64k_verlet_wind",
            replaces="softbodyunity_tpu/kernels/pallas_lattice.py:818-819, "
                     "the wind drag of :901"),
        "lattice_xpbd_drag": dict(
            path="softbody_cube_64k_xpbd_wind",
            replaces="softbodyunity_tpu/kernels/pallas_lattice.py:521, the "
                     "wind drag of :699"),
    }
    # the capsule and box branch of the six kernels: chip_smoke's two 64k
    # collider scenes under the three solvers (the cubes: the three cube
    # presets), the kernel each launches, its main-path frames, the frames
    # from rest after which the scene is in contact (the compare and timing
    # start there), and the kernels line's entry
    S = sb.Solver
    collider_paths = {}
    for label, solver, kernel, contact_frames, replaces in (
            ("cloth_colliders_64k", S.SEMI_IMPLICIT_EULER, "grid_euler", 40,
             "softbodyunity_tpu/kernels/pallas_substep.py:442, the capsule/box "
             "branch of :534 (and pallas_tiled.py:307 of :380)"),
            ("cloth_colliders_64k_verlet", S.VERLET, "grid_verlet", 40,
             "softbodyunity_tpu/kernels/pallas_substep.py:693 and :711, the "
             "capsule/box branch of :801 (and pallas_tiled.py:644 and :663 "
             "of :738)"),
            ("cloth_colliders_64k_xpbd", S.XPBD, "grid_xpbd", 40,
             "softbodyunity_tpu/kernels/pallas_xpbd.py:167, :213 and :238, "
             "the capsule/box branch of :334 (and pallas_tiled.py:1048 and "
             ":1083 of :1155)"),
            ("softbody_cube_64k_colliders", None, "lattice_euler", 30,
             "softbodyunity_tpu/kernels/pallas_lattice.py:324, the "
             "capsule/box branch of :363"),
            ("softbody_cube_64k_verlet_colliders", None, "lattice_verlet", 30,
             "softbodyunity_tpu/kernels/pallas_lattice.py:840 and :861, the "
             "capsule/box branch of :901"),
            ("softbody_cube_64k_xpbd_colliders", None, "lattice_xpbd", 30,
             "softbodyunity_tpu/kernels/pallas_lattice.py:619 and :657, the "
             "capsule/box branch of :699")):
        collider_paths[label] = dict(
            solver=solver, kernel=kernel, frames=300,
            contact_frames=contact_frames, line=f"{kernel}_colliders",
            replaces=replaces)
    strain_line = dict(
        name="grid_strain_sweep", path="cloth_strain_64k",
        source="softbodyunity_torch/kernels/csrc/grid_common.cuh",
        replaces="softbodyunity_tpu/kernels/pallas_substep.py:301 "
                 "_strain_limit_planes, the strain branch of "
                 "pallas_substep.py:534 (414-422), :801 (679-686) and "
                 "pallas_xpbd.py:334 (186-225)")

    # TPU kernel #11, the dual form of block_pairs (csrc/block_pairs.cu), on
    # the row-sharded halo paths of parallel/halo.py: the 64k self-collision
    # preset under each solver, on a ring of one NCCL rank and on four
    # ranks of one process (LocalRing, run in turns on the one card)
    dual = dict(
        name="block_pairs_dual",
        source="softbodyunity_torch/kernels/csrc/block_pairs.cu",
        replaces="softbodyunity_tpu/kernels/pallas_blocks.py:180 "
                 "_block_pairs_dual_pallas",
        ranks=4, launches=0)

    def reset_counts():
        for k in kernels.values():
            k["module"].reset_launch_count()
        grid_strain.reset_launch_count()
        normals_kernel.reset_launch_count()

    def rendered(label, top, state):
        """``sb.normals(top, state)`` at the end of main path ``label``: one
        launch of the normals kernel since the path's ``reset_counts``, and
        within 1e-5 a component of the plain version on the same card
        tensors (the card-vs-CPU tolerance: the plain cross product may
        contract into FMAs, and a vertex whose faces nearly cancel
        magnifies a few ulps)."""
        n = sb.normals(top, state)
        launched = normals_kernel.launch_count()
        want = vertex_normals(top.triangles, state.x)
        err = float((n - want).abs().max())
        normals_line["launches"] += launched
        normals_line["err_of"][label] = err
        require(launched == 1,
                f"{label}: sb.normals launched the normals kernel {launched} "
                "times, expected 1")
        require(err <= 1e-5, f"{label}: normals kernel vs plain {err:.3e}")
        return n

    def counts():
        c = {n: k["module"].launch_count() for n, k in kernels.items()}
        c["block_pairs_dual"] = blocks.launch_count("block_pairs_dual")
        return c

    # nvcc builds the kernels in the background (one process a source) while
    # the host builds the presets below; phase 2 waits for it
    fresh = {n: not build.library_path(n).exists() for n in libraries}
    nvcc_pool = concurrent.futures.ThreadPoolExecutor(1)

    def build_all():
        t = time.perf_counter()
        build.load_libraries(libraries)
        return time.perf_counter() - t

    building = nvcc_pool.submit(build_all)

    # 1. device -------------------------------------------------------------
    begin("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], seconds=phase_seconds())
    for name, k in kernels.items():
        t = time.perf_counter()
        k["host"], k["cfg"] = sb.presets.build(k["preset"])
        emit("host_build", preset=k["preset"],
             vertices=k["host"].positions0.shape[0],
             tets=k["host"].tets.shape[0], edges=k["host"].edges.shape[0],
             seconds=time.perf_counter() - t)
    built = {}
    for p in large.values():
        if p["preset"] not in built:
            t = time.perf_counter()
            built[p["preset"]] = sb.presets.build(p["preset"])
            emit("host_build", preset=p["preset"],
                 vertices=built[p["preset"]][0].positions0.shape[0],
                 edges=built[p["preset"]][0].edges.shape[0],
                 seconds=time.perf_counter() - t)
        p["host"], cfg = built[p["preset"]]
        p["cfg"] = cfg if p["solver"] is None else cfg.replace(
            solver=p["solver"])
    for p in branches.values():
        if p["kernel"].startswith("lattice_"):
            k = kernels[p["kernel"]]
            p["host"], p["cfg"] = k["host"], k["cfg"].replace(wind=cube_wind)
            continue
        if p["preset"] not in built:
            t = time.perf_counter()
            built[p["preset"]] = sb.presets.build(p["preset"])
            emit("host_build", preset=p["preset"],
                 vertices=built[p["preset"]][0].positions0.shape[0],
                 edges=built[p["preset"]][0].edges.shape[0],
                 seconds=time.perf_counter() - t)
        p["host"], cfg = built[p["preset"]]
        p["cfg"] = cfg if p["solver"] is None else cfg.replace(
            solver=p["solver"])
    for label, p in collider_paths.items():
        t = time.perf_counter()
        if p["kernel"].startswith("lattice_"):
            k = kernels[p["kernel"]]
            p["preset"] = k["preset"]
            p["host"], p["cfg"] = add_cube_colliders(sb, k["host"], k["cfg"])
        else:
            p["preset"] = "cloth_bench_64k"
            p["host"], p["cfg"] = cloth_colliders_64k(sb, p["solver"])
        h = p["host"]
        emit("host_build", path=label, preset=p["preset"],
             solver=p["cfg"].solver.value,
             vertices=h.positions0.shape[0], edges=h.edges.shape[0],
             tets=h.tets.shape[0],
             y_range=[float(h.positions0[:, 1].min()),
                      float(h.positions0[:, 1].max())],
             capsule_p0=h.capsule_p0.tolist(),
             capsule_p1=h.capsule_p1.tolist(),
             capsule_radii=h.capsule_radii.tolist(),
             capsule_velocities=(None if h.capsule_velocities is None
                                 else h.capsule_velocities.tolist()),
             box_centers=h.box_centers.tolist(),
             box_half_extents=h.box_half_extents.tolist(),
             box_rotations=h.box_rotations.tolist(),
             plane_height=h.plane_height, seconds=time.perf_counter() - t)
    phase_seconds()

    # 2. build --------------------------------------------------------------
    begin("build")
    t = time.perf_counter()
    build_s = building.result()   # raises the build's error, if any
    nvcc_pool.shutdown()
    wait_s = time.perf_counter() - t
    for name in libraries:
        lib = build.library_path(name)
        log = lib.with_suffix(".log")
        ptxas = ([ln.strip() for ln in log.read_text().splitlines()
                  if "ptxas" in ln] if log.exists() else [])
        emit("build", kernel=name, fresh_build=fresh[name],
             library=os.path.relpath(lib, ROOT), ptxas=ptxas)
    emit("build", kernels=libraries, nvcc_seconds=build_s,
         waited_seconds=wait_s)
    phase_seconds()

    # --- the self-collision path: block_pairs, then grid_euler ----------------
    sc = kernels["block_pairs"]
    pair_tol = (5e-4, 1e-3)   # tests/test_blocksparse.py:158, atol and rtol

    def sc_params(**kw):
        """tests/test_blocksparse.py's parameters."""
        base = dict(enabled=True, method="block", radius=0.05, stiffness=10.0,
                    cell_size=0.05, block_partners=16)
        base.update(kw)
        return sb.SelfCollisionParams(**base)

    def folded(n_side, span, gap):
        """tests/test_blocksparse.py's folded sheets: n_side^2 vertices at
        spacing 0.01, folded back over itself every ``span`` in y, the
        layers ``gap`` apart."""
        xs, ys = np.meshgrid(np.arange(n_side), np.arange(n_side),
                             indexing="ij")
        layer = (ys.ravel() * 0.01 // span).astype(int)
        yy = np.where(layer % 2 == 0, ys.ravel() * 0.01 % span,
                      span - ys.ravel() * 0.01 % span)
        x = np.stack([xs.ravel() * 0.01, yy, layer * gap],
                     axis=1).astype(np.float32)
        return torch.tensor(x, device=cuda)

    def diagnostics(x, p):
        d = blocksparse.self_collision_block_diagnostics(x, p)
        dropped = int(d["dropped_pairs"])
        return dropped, int(d["candidate_pairs"]) - dropped

    def cull(p, x, xall=None):
        """block_pairs' cull on ``x`` (against ``xall``: the dual form):
        the 32 x 32 sub-block pairs it keeps (blocks.kept_sub_blocks, plain
        PyTorch), of how many, the partner vertices it keeps in them
        (blocks.kept_partner_vertices), and the interacting tile pairs;
        with the dense and the culled bound (block_pairs_bound) in ms."""
        inputs = blocks.pair_inputs(p, x, xall)
        kept = int(blocks.kept_sub_blocks(*inputs[:4], p.radius).sum())
        kept_v = int(blocks.kept_partner_vertices(*inputs[:4],
                                                  p.radius).sum())
        sum_nvalid = int(inputs[2].sum())
        slices = p.block_size // 32
        blk = p.block_size
        n_j = 0 if xall is None else -(-xall.shape[0] // blk)
        args = (x.shape[0], blk, -(-x.shape[0] // blk), sum_nvalid, n_j)
        return dict(kept_sub_blocks=kept,
                    sub_block_pairs=sum_nvalid * slices * slices,
                    kept_share=kept / max(sum_nvalid * slices * slices, 1),
                    kept_vertex_share=kept_v / max(32 * kept, 1),
                    sum_nvalid=sum_nvalid,
                    dense_bound=block_pairs_bound(*args),
                    culled_bound=block_pairs_bound(
                        *args, kept=kept, kept_vertices=kept_v))

    def compare_pairs(x, p, scene, want=None, tol=pair_tol,
                      why="kernel vs plain: rsqrt and another sum order"):
        """block_pairs against its plain version (or ``want``) on ``x``,
        with its cull's kept shares and both bounds, and against its dense
        instantiation over the plain build to the bit."""
        fn = blocks.make_block_pairs(p, x.shape[0], cuda)
        got = fn(x).t()
        dense = fn.sweep(blocks.pair_inputs(p, x), dense=True).t()
        equal_dense = bool(torch.equal(got.view(torch.int32),
                                       dense.view(torch.int32)))
        if want is None:
            want = blocksparse.self_collision_forces_block(x, p)
        torch.cuda.synchronize()
        err = (got - want).abs()
        ok = bool(torch.isfinite(got).all()
                  and (err <= tol[0] + tol[1] * want.abs()).all())
        dropped, tile_pairs = diagnostics(x, p)
        c = cull(p, x)
        emit("compare", kernel="block_pairs", scene=scene,
             vertices=x.shape[0], block=p.block_size,
             tile_pairs=tile_pairs, dropped_pairs=dropped,
             kept_sub_blocks=c["kept_sub_blocks"],
             sub_block_pairs=c["sub_block_pairs"],
             kept_share=c["kept_share"],
             kept_vertex_share=c["kept_vertex_share"],
             dense_bound_us=c["dense_bound"][0] * 1e3,
             culled_bound_us=c["culled_bound"][0] * 1e3,
             max_abs_err=float(err.max()),
             max_abs_force=float(want.abs().max()), atol=tol[0],
             rtol=tol[1], equal_to_dense=equal_dense, why=why)
        require(ok, f"block_pairs {scene}: |err| {float(err.max()):.3e}")
        require(equal_dense, f"block_pairs {scene}: the culled forces are "
                "not the dense sweep's to the bit")
        require(float(want.abs().max()) > 0.0,
                f"block_pairs {scene}: no pair interacts")
        return float(err.max())

    def batch_rl(solver, method):
        """cloth_batch_rl with its self-collision method replaced (the
        shipping dense_mxu is not ported), as tests/test_golden.py does."""
        host, cfg = sb.presets.build("cloth_batch_rl")
        return host, cfg.replace(
            solver=solver, self_collision=dataclasses.replace(
                cfg.self_collision, method=method))

    def compare_self_collision():
        for n in (500, 1000, 2048):
            for blk in (256, 128):
                rng = np.random.default_rng(n)
                x = torch.tensor(rng.uniform(0, 0.5, (n, 3)),
                                 dtype=torch.float32, device=cuda)
                compare_pairs(x, sc_params(block_size=blk,
                                           block_partners=-(-n // blk)),
                              f"cloud {n}")
        compare_pairs(folded(48, 0.16, 0.004),
                      sc_params(radius=0.006, cell_size=0.012),
                      "folded 48x48 sheet")
        # the dense rule (which takes its 16,384 rows in chunks)
        p16 = sb.presets.build("cloth_selfcollide_16k")[1].self_collision
        x128 = folded(128, 0.32, 0.75 * p16.radius)
        require(diagnostics(x128, p16)[0] == 0, "folded 128x128: dropped")
        compare_pairs(x128, p16, "folded 128x128 sheet against dense",
                      want=self_collision_forces_dense(
                          x128, p16.radius, p16.stiffness),
                      tol=(1e-3, 1e-3),
                      why="block against the dense rule, "
                          "tests/test_blocksparse.py:118-142's 1e-3")
        # the 64k preset after 24 substeps (bench.py:366-378)
        host, cfg = sc["host"], sc["cfg"]
        top, s0 = sb.init(host, device=cuda)
        s24 = sb.step(top, cfg, s0, n_substeps=24)
        sc["err64"] = compare_pairs(s24.x, cfg.self_collision,
                                    "cloth_selfcollide_64k after 24 substeps")
        dropped, tile_pairs = diagnostics(s24.x, cfg.self_collision)
        require(dropped == 0, f"64k after 24 substeps: {dropped} tile pairs "
                "dropped (bench.py asserts 0)")
        # one frame from that state, substep by substep: the kernel path
        # against the plain path, and (printed) the plain path in float32
        # against float64.  The bottom rows start below the plane and are
        # crushed into a pile, where a pair at d ~ 1e-5 has a spring rate
        # k r / d near 5e4 and explicit steps amplify any rounding: within
        # the frame plain float32 leaves float64 by x 1.4e-2 and v 3.4.  So
        # the first 4 substeps are held to the bounds of a rounding-only
        # compare, and the frame to fixed bounds 7x and 4.5x over the
        # readings of two runs (x 1.42e-4, v 5.64e-2, the same to the bit);
        # the shrunk curtain below holds a whole frame at the rounding bounds
        kern_fn = grid_euler.make_cuda_step(top, cfg)
        plain_fn = make_stencil_step(top, cfg)
        top64, _ = sb.init(host, device=cuda, dtype=torch.float64)
        plain64_fn = make_stencil_step(top64, cfg)
        kern, plain = s24, s24
        ref = sb.State(x=s24.x.double(), v=s24.v.double(),
                       x_prev=s24.x_prev.double())
        series = []
        for _ in range(cfg.n_substeps):
            kern = kern_fn(kern, cfg.dt, 1)
            plain = plain_fn(plain, cfg.dt, 1)
            ref = plain64_fn(ref, cfg.dt, 1)
            series.append((float((kern.x - plain.x).abs().max()),
                           float((kern.v - plain.v).abs().max()),
                           float((plain.x.double() - ref.x).abs().max()),
                           float((plain.v.double() - ref.v).abs().max())))
        torch.cuda.synchronize()
        held, frame_x, frame_v = 4, 1e-3, 0.25
        dx_held = max(a for a, _, _, _ in series[:held])
        dv_held = max(b for _, b, _, _ in series[:held])
        dx = max(a for a, _, _, _ in series)
        dv = max(b for _, b, _, _ in series)
        pinned = torch.from_numpy(host.inv_mass == 0.0).to(cuda)
        emit("compare", kernel="block_pairs+grid_euler",
             scene="cloth_selfcollide_64k, frame after 24 substeps",
             substeps=cfg.n_substeps, tile_pairs=tile_pairs,
             kernel_vs_plain_dx=[a for a, _, _, _ in series],
             kernel_vs_plain_dv=[b for _, b, _, _ in series],
             plain32_vs_plain64_dx=[c for _, _, c, _ in series],
             plain32_vs_plain64_dv=[d for _, _, _, d in series],
             held_substeps=held, held_atol_x=1e-5, held_atol_v=2e-3,
             frame_atol_x=frame_x, frame_atol_v=frame_v,
             why="FMA contraction and rsqrt, amplified by the crushed pile")
        require(bool(torch.isfinite(kern.x).all()), "64k frame: not finite")
        require(torch.equal(kern.x[pinned], s0.x[pinned]), "64k: pins moved")
        require(dx_held <= 1e-5 and dv_held <= 2e-3,
                f"64k self-collision, first {held} substeps: |dx| "
                f"{dx_held:.3e}, |dv| {dv_held:.3e}")
        require(dx <= frame_x and dv <= frame_v,
                f"64k self-collision frame: |dx| {dx:.3e} (<= {frame_x}), "
                f"|dv| {dv:.3e} (<= {frame_v})")
        del top64, plain64_fn, ref

        # the sheet shrunk to 60 % about its pinned top row: every
        # structural neighbour inside the radius, and no vertex near the
        # plane, so no pile
        def shrink(s):
            return s.replace(x=0.6 * s.x, x_prev=0.6 * s.x_prev)

        dropped, tile_pairs = diagnostics(shrink(s0).x, cfg.self_collision)
        require(tile_pairs > 0, "64k shrunk: no tile pair interacts")
        compare("grid_euler", f"cloth_selfcollide_64k shrunk to 60% "
                f"({tile_pairs} tile pairs, {dropped} dropped)", host, cfg,
                cfg.n_substeps, 1e-5, 2e-3, "FMA contraction and rsqrt only",
                start=shrink)
        # one frame of each grid solver on cloth_batch_rl shrunk the same
        # way: every neighbour at 0.024, inside the 0.03 radius
        for solver, name in ((sb.Solver.SEMI_IMPLICIT_EULER, "grid_euler"),
                             (sb.Solver.VERLET, "grid_verlet"),
                             (sb.Solver.XPBD, "grid_xpbd")):
            host_b, cfg_b = batch_rl(solver, "block")
            compare(name, "cloth_batch_rl shrunk, self-collision block",
                    host_b, cfg_b, cfg_b.n_substeps, 1e-5, 2e-3,
                    "FMA contraction and rsqrt only", start=shrink)
        return top, s24

    def main_path_self_collision():
        host, cfg = sc["host"], sc["cfg"]
        frames_sc = 60
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        top, state0 = sb.init(host, device="cuda")
        pinned = torch.from_numpy(host.inv_mass == 0.0).to(cuda)
        expected = frames_sc * cfg.n_substeps
        reset_counts()
        t = time.perf_counter()
        state = state0
        for _ in range(frames_sc):
            state = sb.step(top, cfg, state)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t
        launched = counts()
        sc["launches"] = launched["block_pairs"]
        x = state.x
        # the bottom rows start below the plane and are pressed flat onto
        # it, a column's vertices onto one point: a vertex all of whose
        # triangles collapsed has no normal (length 0); every other is unit
        length = torch.linalg.vector_norm(
            rendered(sc["preset"], top, state), dim=1)
        flat = length == 0.0
        unit_err = float((length[~flat] - 1.0).abs().max())
        dropped, tile_pairs = diagnostics(x, cfg.self_collision)
        emit("main_path", kernel="block_pairs+grid_euler",
             preset=sc["preset"], solver=cfg.solver.value,
             vertices=x.shape[0], frames=frames_sc, substeps=expected,
             launches=launched, expected_launches={
                 "block_pairs": expected, "grid_euler": expected},
             seconds=main_s, y_min=float(x[:, 1].min()),
             plane_height=float(top.plane_height), normal_unit_err=unit_err,
             collapsed_normals=int(flat.sum()),
             sum_nvalid=tile_pairs, dropped_pairs=dropped,
             peak_mem_bytes=torch.cuda.max_memory_allocated() - held)
        require(launched["block_pairs"] == expected
                and launched["grid_euler"] == expected
                and sum(launched.values()) == 2 * expected,
                f"self-collision main path launches {launched}, expected "
                f"{expected} block_pairs and {expected} grid_euler")
        require(bool(torch.isfinite(x).all()), "self-collision: x not finite")
        require(int(pinned.sum()) == 256, "self-collision: pins")
        require(torch.equal(x[pinned], state0.x[pinned]),
                "self-collision main path: pinned rows moved")
        require(bool((x[:, 1] >= top.plane_height).all()),
                "self-collision main path: vertex below the plane")
        require(bool(torch.isfinite(length).all())
                and int(flat.sum()) < x.shape[0] // 2,
                f"self-collision normals: {int(flat.sum())} collapsed")
        require(unit_err <= 1e-5, f"self-collision normals {unit_err:.3e}")

    def compare_halo(sc_state):
        """The dual pair form (TPU kernel #11) on the row shards of the 64k
        self-collision preset after 24 substeps: one rank (the whole cloth:
        the single form's tiles, so its output to the bit) and four ranks
        (64 x 256 = 16,384 vertices each against the 65,536 gathered), each
        launch held to the plain dual form, with its µs a launch (CUDA
        events), its bound and its dropped pairs."""
        _, s24 = sc_state
        p = sc["cfg"].self_collision
        x = s24.x
        n, blk = x.shape[0], p.block_size
        single = blocks.make_block_pairs(p, n, cuda)(x)
        for n_ranks in (1, dual["ranks"]):
            ni = n // n_ranks
            rows = []
            for r in range(n_ranks):
                xi = x[r * ni:(r + 1) * ni]
                fn = blocks.make_block_pairs_dual(p, ni, n, cuda)
                got = fn(xi, x)
                want = blocksparse.self_collision_forces_block_dual(
                    xi, x, p).t()
                torch.cuda.synchronize()
                err = (got - want).abs()
                ok = bool(torch.isfinite(got).all() and (
                    err <= pair_tol[0] + pair_tol[1] * want.abs()).all())
                d = blocksparse.self_collision_block_dual_diagnostics(xi, x,
                                                                      p)
                dropped, sum_nvalid = (int(d["dropped_pairs"]),
                                       int(d["sum_nvalid"]))
                ms = min(events_ms(lambda: [fn(xi, x) for _ in range(20)],
                                   20) for _ in range(2))
                plain_ms = events_ms(
                    lambda: [blocksparse.self_collision_forces_block_dual(
                        xi, x, p) for _ in range(2)], 2)
                c = cull(p, xi, x)
                require(c["sum_nvalid"] == sum_nvalid,
                        "block_pairs_dual: pair_inputs' partners are not "
                        "the diagnostics'")
                (bound_ms, bound_by), dense_ms = (c["culled_bound"],
                                                  c["dense_bound"][0])
                equal = bool(torch.equal(got, single)) if n_ranks == 1 else None
                emit("compare", kernel="block_pairs_dual",
                     scene="cloth_selfcollide_64k after 24 substeps",
                     ranks=n_ranks, rank=r, vertices=ni, gathered=n,
                     sum_nvalid=sum_nvalid, dropped_pairs=dropped,
                     kept_sub_blocks=c["kept_sub_blocks"],
                     sub_block_pairs=c["sub_block_pairs"],
                     kept_share=c["kept_share"],
                     kept_vertex_share=c["kept_vertex_share"],
                     max_abs_err=float(err.max()),
                     max_abs_force=float(want.abs().max()),
                     atol=pair_tol[0], rtol=pair_tol[1], card=smi,
                     us_per_launch=ms * 1e3, plain_ms=plain_ms,
                     bound_us=bound_ms * 1e3, bound_by=bound_by,
                     dense_bound_us=dense_ms * 1e3,
                     equal_to_block_pairs=equal,
                     why="rsqrt and another sum order")
                require(ok, f"block_pairs_dual, rank {r} of {n_ranks}: "
                        f"|err| {float(err.max()):.3e}")
                if n_ranks == 1:
                    require(equal, "block_pairs_dual on one rank is not "
                            "block_pairs to the bit")
                rows.append((float(err.max()), ms, plain_ms, bound_ms,
                             bound_by, float(want.abs().max()), dense_ms))
            # the rows by the pins touch nothing; the pile's rows do
            require(max(row[5] for row in rows) > 0.0,
                    f"block_pairs_dual, {n_ranks} ranks: no pair interacts")
            if n_ranks == dual["ranks"]:
                # the kernels line: per launch, averaged over the shards
                dual["err"] = max(e for e, *_ in rows)
                dual["ms"] = sum(r[1] for r in rows) / n_ranks
                dual["plain_ms"] = sum(r[2] for r in rows) / n_ranks
                dual["bound_ms"] = sum(r[3] for r in rows) / n_ranks
                dual["bound_by"] = rows[0][4]
                dual["dense_bound_ms"] = sum(r[6] for r in rows) / n_ranks

    def halo_maker(solver):
        return {sb.Solver.SEMI_IMPLICIT_EULER: halo.make_halo_step,
                sb.Solver.VERLET: halo.make_halo_verlet_step,
                sb.Solver.XPBD: halo.make_halo_xpbd_step}[solver]

    def main_path_halo():
        """The row-sharded grid cloth (parallel/halo.py): the 64k
        self-collision preset under each solver through make_halo_step and
        its Verlet and XPBD twins, on a ring of one NCCL rank (DistRing,
        torch.distributed through a FileStore) and on LocalRing(4) (four
        ranks in turns on the one card).  The first 4 substeps are held to
        the single-device kernel path at 1e-5 (PERF.md's rule for this
        crushed pile) from rest under Euler and Verlet, and under all three
        from the curtain shrunk to 70 % (every neighbour in range, no pile;
        at 60 % the whole cloth's tiles drop 19 tile pairs, the row shards'
        none, so the two pair sets differ), where no tiling drops a pair.
        XPBD from rest is printed, not held: deep contact makes its Jacobi
        sweeps amplify any difference in operation order (the single-device
        plain version leaves the kernel by as much, printed beside it).
        Then two frames from rest with every count set to 0 just before and
        read just after: block_pairs_dual launched once a substep and rank,
        and no other kernel (the rest of the substep is plain PyTorch, as
        the JAX halo path is plain XLA)."""
        import torch.distributed as dist

        store = os.path.join(ROOT, "build", "halo_filestore")
        os.makedirs(os.path.dirname(store), exist_ok=True)
        if os.path.exists(store):
            os.remove(store)
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method="file://" + store,
                                rank=0, world_size=1)
        held, frames_h = 4, 2
        try:
            rings = {"nccl, world size 1": DistRing(),
                     f"LocalRing({dual['ranks']}), serialised ranks on one "
                     "card": LocalRing(dual["ranks"])}
            for solver, module in ((sb.Solver.SEMI_IMPLICIT_EULER,
                                    grid_euler),
                                   (sb.Solver.VERLET, grid_verlet),
                                   (sb.Solver.XPBD, grid_xpbd)):
                host, cfg = sc["host"], sc["cfg"].replace(solver=solver)
                top, s0 = sb.init(host, device=cuda)
                ny, nx = top.grid_shape
                starts = {"rest": s0, "shrunk to 70 %": s0.replace(
                    x=0.7 * s0.x, x_prev=0.7 * s0.x_prev)}
                kern_fn = module.make_cuda_step(top, cfg)
                plain_fn = make_stencil_step(top, cfg)
                ref, plain_dx = {}, {}
                for name, st0 in starts.items():
                    ref[name] = to_planes(kern_fn(st0, cfg.dt, held).x, ny,
                                          nx)
                    plain_dx[name] = float((to_planes(plain_fn(
                        st0, cfg.dt, held).x, ny, nx) - ref[name]).abs().max())
                held_on = (("shrunk to 70 %",) if solver == sb.Solver.XPBD
                           else tuple(starts))
                # the pair sets are exact (no tile pair dropped) in the
                # whole cloth's tiling and in each rank's
                p_sc, dropped = cfg.self_collision, {}
                for name, st0 in starts.items():
                    xs = st0.x
                    dropped[name] = [int(blocksparse.
                                         self_collision_block_diagnostics(
                                             xs, p_sc)["dropped_pairs"])]
                    ni = xs.shape[0] // dual["ranks"]
                    dropped[name] += [int(
                        blocksparse.self_collision_block_dual_diagnostics(
                            xs[r * ni:(r + 1) * ni], xs, p_sc)[
                                "dropped_pairs"])
                        for r in range(dual["ranks"])]
                pinned = torch.from_numpy(host.inv_mass == 0.0).to(cuda)
                for label, ring in rings.items():
                    fn = halo_maker(solver)(top, cfg, ring)

                    def rank_main(n_sub, st0):
                        x3, v3, im3, ph = halo.shard_grid_state(top, st0,
                                                                ring)
                        xp3 = halo.shard_grid_state(
                            top, st0.replace(x=st0.x_prev), ring)[0]
                        out = fn(x3, xp3 if solver == sb.Solver.VERLET
                                 else v3, im3, ph, cfg.dt, n_sub)
                        return ring.gather_rows(out[0]), ring.gather_rows(
                            out[1])

                    def on_ring(n_sub, st0):
                        if isinstance(ring, LocalRing):
                            return ring.run(lambda: rank_main(n_sub, st0))[0]
                        return rank_main(n_sub, st0)

                    dx = {}
                    for name, st0 in starts.items():
                        x4, _ = on_ring(held, st0)
                        torch.cuda.synchronize()
                        dx[name] = float((x4 - ref[name]).abs().max())
                    n_sub = frames_h * cfg.n_substeps
                    reset_counts()
                    t = time.perf_counter()
                    x3, v3 = on_ring(n_sub, s0)
                    torch.cuda.synchronize()
                    secs = time.perf_counter() - t
                    launched = counts()
                    expected = n_sub * ring.size
                    dual["launches"] += launched["block_pairs_dual"]
                    x = from_planes(x3)
                    emit("main_path_halo", kernel="block_pairs_dual",
                         preset=sc["preset"], solver=cfg.solver.value,
                         ring=label, ranks=ring.size, vertices=x.shape[0],
                         held_substeps=held, halo_vs_kernel_path_dx=dx,
                         plain_vs_kernel_path_dx=plain_dx,
                         dropped_pairs_whole_then_ranks=dropped,
                         held_atol_x=1e-5, held_on=held_on,
                         frames=frames_h, substeps=n_sub, launches=launched,
                         expected_launches={"block_pairs_dual": expected},
                         seconds=secs, substeps_per_s=n_sub / secs,
                         rate_is=("four ranks run in turns on one card, not "
                                  "a scaling number" if ring.size > 1
                                  else "one rank"),
                         y_min=float(x[:, 1].min()),
                         max_abs_v=float(v3.abs().max()), card=smi)
                    for name in held_on:
                        require(not any(dropped[name]),
                                f"halo {cfg.solver.value} from {name}: "
                                f"dropped tile pairs {dropped[name]}")
                        require(dx[name] <= 1e-5,
                                f"halo {cfg.solver.value} on {label} from "
                                f"{name}: first {held} substeps |dx| "
                                f"{dx[name]:.3e} against the kernel path")
                    require(launched["block_pairs_dual"] == expected
                            and sum(launched.values()) == expected,
                            f"halo {cfg.solver.value} on {label}: launches "
                            f"{launched}, expected {expected} block_pairs_dual")
                    require(bool(torch.isfinite(x3).all()
                                 and torch.isfinite(v3).all()),
                            f"halo {cfg.solver.value} on {label}: not finite")
                    require(torch.equal(x[pinned], s0.x[pinned]),
                            f"halo {cfg.solver.value} on {label}: pins moved")
                    require(bool((x[:, 1] >= top.plane_height).all()),
                            f"halo {cfg.solver.value} on {label}: vertex "
                            "below the plane")
        finally:
            dist.destroy_process_group()

    def golden_self_collision():
        # tests/test_golden.py's 5e-2 for self-collision chaos; the first
        # record (frame 10) also at 1e-5, before the chaos (the JAX
        # package's own f32 path is 2.0e-7 from f64 there)
        data = np.load(os.path.join(ROOT, "tests", "golden",
                                    "cloth_batch_rl.npz"))
        golden = data["positions"]
        every = int(data["record_every"])
        for method in ("block", "dense"):
            host, cfg = batch_rl(sb.Solver.SEMI_IMPLICIT_EULER, method)
            top, s = sb.init(host, device="cuda")
            drifts = []
            for r in range(golden.shape[0]):
                for _ in range(every):
                    s = sb.step(top, cfg, s)
                drifts.append(float(np.max(np.abs(
                    s.x.double().cpu().numpy() - golden[r]))))
            emit("golden", preset="cloth_batch_rl", method=method,
                 solver=cfg.solver.value, frames=golden.shape[0] * every,
                 drift_per_record=drifts, tol=5e-2, first_tol=1e-5)
            require(drifts[0] < 1e-5 and max(drifts) < 5e-2,
                    f"golden cloth_batch_rl {method}: drifts {drifts}")

    def fidelity_self_collision():
        # the f32 kernel path against the f64 plain path: 1e-5 over frames
        # 1-20, where the JAX package's own f32 stays within 4.2e-7 of f64,
        # so a wrong force cannot hide behind contact chaos; then the
        # golden's 5e-2 (the JAX package: 1.94e-2 at frame 50)
        host, cfg = batch_rl(sb.Solver.SEMI_IMPLICIT_EULER, "block")
        t = time.perf_counter()
        top32, s32 = sb.init(host, device="cuda")
        top64, s64 = sb.init(host, device="cuda", dtype=torch.float64)
        plain64 = make_stencil_step(top64, cfg)
        drift = []
        for _ in range(100):
            s32 = sb.step(top32, cfg, s32)
            s64 = plain64(s64, cfg.dt, cfg.n_substeps)
            drift.append(float((s32.x.double() - s64.x).abs().max()))
        early, late = max(drift[:20]), max(drift[20:])
        emit("fidelity", kernel="block_pairs+grid_euler",
             preset="cloth_batch_rl", method="block", frames=100, every=10,
             drift=drift[9::10], worst_frames_1_20=early,
             worst_frames_21_100=late, bound_frames_1_20=1e-5,
             bound_frames_21_100=5e-2, seconds=time.perf_counter() - t)
        require(early <= 1e-5, f"fidelity cloth_batch_rl: {early:.3e} by 20")
        require(late <= 5e-2, f"fidelity cloth_batch_rl: {late:.3e}")

    # --- the grids past the cap and the tear and plastic planes -------------
    def feature_scene(solver, feature):
        """tests/test_torch_features.py's hanging cloth (8 wide, 24 rows; 32
        for XPBD): "tear" rips at 3 % strain, "plastic" creeps past 2 %,
        "both" does both, creeping slower."""
        cfg = sb.SimConfig(
            solver=solver,
            springs=sb.SpringParams(k_structural=300.0, k_shear=150.0,
                                    k_bend=60.0, damping=0.3),
            xpbd=sb.XPBDParams(compliance_distance=3e-4, compliance_bend=1e-3,
                               n_iterations=4),
            tear=sb.TearParams(enabled=feature in ("tear", "both"),
                               strain_limit=0.03),
            plasticity=sb.PlasticityParams(
                enabled=feature in ("plastic", "both"), yield_strain=0.02,
                creep=0.05 if feature == "both" else 0.25),
            collision=sb.CollisionParams(enable_plane=True),
            global_damping=0.1)
        host = sb.cloth_grid(8, 32 if solver == sb.Solver.XPBD else 24,
                             spacing=0.05, shear=True, bend=True,
                             pinned=("top",), springs=cfg.springs,
                             xpbd=cfg.xpbd, plane_height=-5.0,
                             orientation="xy")
        return host, cfg

    def with_features(top, cfg, s):
        return api.ensure_plastic_state(top, cfg,
                                        api.ensure_tear_state(top, cfg, s))

    def feature_diff(a, b):
        """(edges whose liveness differs, max |rest scale difference|)
        between two states (None for a feature that is off)."""
        m = (None if a.edge_alive is None else
             int((a.edge_alive != b.edge_alive.to(a.edge_alive.dtype)).sum()))
        d = (None if a.rest_scale is None else float(
            (a.rest_scale.double() - b.rest_scale.double()).abs().max()))
        return m, d

    def compare_features(name, scene, host, cfg, n_sub, atol_x, atol_v,
                         atol_s, why):
        """Kernel ``name`` with its tear and plastic planes against the plain
        version, float32 on the card, from rest: the masks must be equal.
        Returns (max error, topology, kernel state)."""
        top, s0 = sb.init(host, device=cuda)
        s0 = with_features(top, cfg, s0)
        plain = make_stencil_step(top, cfg)(s0, cfg.dt, n_sub)
        kern = kernels[name]["module"].make_cuda_step(top, cfg)(
            s0, cfg.dt, n_sub)
        torch.cuda.synchronize()
        dx = float((kern.x - plain.x).abs().max())
        dv = float((kern.v - plain.v).abs().max())
        mask_diff, ds = feature_diff(kern, plain)
        torn = (None if plain.edge_alive is None
                else int((plain.edge_alive == 0).sum()))
        smax = (None if plain.rest_scale is None
                else float(plain.rest_scale.max()))
        pinned = torch.from_numpy(host.inv_mass == 0.0).to(cuda)
        emit("compare", kernel=name, scene=scene, substeps=n_sub,
             tear=cfg.tear.enabled, plastic=cfg.plasticity.enabled,
             max_abs_dx=dx, max_abs_dv=dv, mask_diff_edges=mask_diff,
             torn_edges=torn, max_abs_scale_err=ds, max_scale=smax,
             atol_x=atol_x, atol_v=atol_v, atol_scale=atol_s, why=why)
        require(bool(torch.isfinite(kern.x).all()
                     and torch.isfinite(kern.v).all()),
                f"{name} {scene}: kernel output not finite")
        require(torch.equal(kern.x[pinned], s0.x[pinned]),
                f"{name} {scene}: pinned vertices moved")
        require(not mask_diff, f"{name} {scene}: {mask_diff} masks differ")
        require(dx <= atol_x and dv <= atol_v and (ds is None or ds <= atol_s),
                f"{name} {scene}: kernel vs plain |dx| {dx:.3e}, |dv| "
                f"{dv:.3e}, |dscale| {ds}")
        return max(dx, dv), top, kern

    def update_bit_equal(name, scene, top, cfg, state):
        """One frame-end update launch of kernel ``name`` on ``state``
        against the plain update on the same inputs: masks and scales of
        every edge to the bit."""
        fn = kernels[name]["module"].make_cuda_step(top, cfg)
        planes = fn.features.planes
        alive, scale = planes.to_planes(state)
        x3 = to_planes(state.x, *top.grid_shape).contiguous()
        table = torch.tensor(planes.offsets, dtype=torch.float32, device=cuda)
        got = planes.to_edges(*fn.features.update(x3, alive, scale, table),
                              state)
        want = planes.to_edges(*update_features(x3, planes.offsets, alive,
                                                scale, cfg), state)
        torch.cuda.synchronize()
        tore = (None if want[0] is None else
                int(((state.edge_alive != 0) & (want[0] == 0)).sum()))
        same = [torch.equal(g, w) for g, w in zip(got, want) if w is not None]
        emit("compare", kernel=name, scene=scene + ", one frame-end launch",
             edges=planes.n_edges, torn_by_the_update=tore,
             bit_equal=all(same))
        require(all(same), f"{name} {scene}: the update launch differs from "
                "the plain update")

    def compare_large():
        fma = "FMA contraction only"
        for solver, name in ((sb.Solver.SEMI_IMPLICIT_EULER, "grid_euler"),
                             (sb.Solver.VERLET, "grid_verlet"),
                             (sb.Solver.XPBD, "grid_xpbd")):
            for feature in ("tear", "plastic", "both"):
                host, cfg = feature_scene(solver, feature)
                _, top, kern = compare_features(
                    name, f"8-wide hanging cloth, {feature}", host, cfg, 64,
                    5e-5, 5e-2, 1e-5,
                    fma + "; tests/test_tearing.py's 5e-5 on x over 64 "
                    "substeps of a tearing cloth")
                if cfg.tear.enabled:
                    require(float(kern.edge_alive.min()) == 0.0,
                            f"{name} {feature}: nothing tore")
                if cfg.plasticity.enabled:
                    require(float(kern.rest_scale.max()) > 1.001,
                            f"{name} {feature}: no plastic flow")
                # a stretched cloth: strains around the limits
                rng = np.random.default_rng(7)
                _, s0 = sb.init(host, device=cuda)
                e = host.edges.shape[0]
                state = s0.replace(
                    x=s0.x + torch.tensor(
                        0.003 * rng.standard_normal(tuple(s0.x.shape)),
                        dtype=torch.float32, device=cuda),
                    edge_alive=torch.tensor(rng.uniform(size=e) < 0.8,
                                            dtype=torch.float32, device=cuda),
                    rest_scale=torch.tensor(rng.uniform(0.9, 1.2, e),
                                            dtype=torch.float32,
                                            device=cuda))
                update_bit_equal(name, f"8-wide cloth stretched, {feature}",
                                 top, cfg, state)
        # one frame of each 262k feature preset under the three solvers,
        # and of the curtains past the cap
        for label, p in large.items():
            host, cfg = p["host"], p["cfg"]
            if cfg.tear.enabled or cfg.plasticity.enabled:
                err, top, kern = compare_features(
                    p["kernel"], label, host, cfg, cfg.n_substeps, 1e-5, 1e-3,
                    1e-5, "one frame from rest: " + fma)
                update_bit_equal(p["kernel"], label + " after one frame", top,
                                 cfg, kern)
                del top, kern
            else:
                err = compare(p["kernel"], label, host, cfg, cfg.n_substeps,
                              1e-5, 1e-3, "one smooth frame: rounding only")
            p["err"] = err
        if "cloth_plastic_262k" in large:
            for solver, name in ((sb.Solver.VERLET, "grid_verlet"),
                                 (sb.Solver.XPBD, "grid_xpbd")):
                p = large["cloth_plastic_262k"]
                compare_features(name, "cloth_plastic_262k, " + solver.value,
                                 p["host"], p["cfg"].replace(solver=solver),
                                 p["cfg"].n_substeps, 1e-5, 1e-3, 1e-5,
                                 "one frame from rest: " + fma)

    def main_path_large():
        for label, p in large.items():
            host, cfg = p["host"], p["cfg"]
            frames_ = p["frames"]
            module = kernels[p["kernel"]]["module"]
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            top, state0 = sb.init(host, device="cuda")
            pinned = torch.from_numpy(host.inv_mass == 0.0).to(cuda)
            expected = frames_ * grid_launches_per_frame(module, top, cfg)
            reset_counts()
            t = time.perf_counter()
            state, vmax, alive_sum = state0, [], []
            for _ in range(frames_):
                state = sb.step(top, cfg, state)
                vmax.append(torch.linalg.vector_norm(state.v, dim=1).max())
                if cfg.tear.enabled:
                    alive_sum.append(state.edge_alive.sum())
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t
            launched = counts()
            p["launches"] = launched[p["kernel"]]
            x = state.x
            vmax = torch.stack(vmax).tolist()
            alive_sum = (torch.stack(alive_sum).tolist() if alive_sum
                         else None)
            length = torch.linalg.vector_norm(rendered(label, top, state),
                                              dim=1)
            flat = length == 0.0
            unit_err = float((length[~flat] - 1.0).abs().max())
            e = host.edges.shape[0]
            scale = state.rest_scale
            emit("main_path_large", kernel=p["kernel"], path=label,
                 preset=p["preset"], solver=cfg.solver.value,
                 vertices=x.shape[0], edges=e, frames=frames_,
                 substeps=frames_ * cfg.n_substeps, launches=launched,
                 expected_launches=expected, seconds=main_s,
                 vmax_per_frame=vmax[::max(1, frames_ // 12)],
                 vmax_last=vmax[-1], alive_edges_per_frame=(
                     None if alive_sum is None
                     else alive_sum[::max(1, frames_ // 12)]),
                 torn_edges=(None if alive_sum is None
                             else e - int(alive_sum[-1])),
                 rest_scale_min=None if scale is None else float(scale.min()),
                 rest_scale_max=None if scale is None else float(scale.max()),
                 y_min=float(x[:, 1].min()),
                 plane_height=float(top.plane_height),
                 normal_unit_err=unit_err, collapsed_normals=int(flat.sum()),
                 peak_mem_bytes=torch.cuda.max_memory_allocated() - held)
            require(launched[p["kernel"]] == expected,
                    f"{label}: {launched[p['kernel']]} launches, expected "
                    f"{expected}")
            require(sum(launched.values()) == expected,
                    f"{label}: other kernels launched: {launched}")
            require(bool(torch.isfinite(x).all()), f"{label}: x not finite")
            require(int(pinned.sum()) == host.grid_shape[1],
                    f"{label}: {int(pinned.sum())} pins")
            require(torch.equal(x[pinned], state0.x[pinned]),
                    f"{label}: pinned row moved")
            require(bool((x[:, 1] >= top.plane_height).all()),
                    f"{label}: vertex below the plane")
            require(all(np.isfinite(vmax)) and max(vmax) < 100.0,
                    f"{label}: max |v| per frame {vmax}")
            require(bool(torch.isfinite(length).all()) and unit_err <= 1e-5,
                    f"{label}: normals off unit length by {unit_err:.3e}")
            if alive_sum is not None:
                require(all(b <= a for a, b in zip(alive_sum, alive_sum[1:])),
                        f"{label}: a torn edge came back")
                require(alive_sum[-1] < e, f"{label}: nothing tore")
            if scale is not None:
                pp = cfg.plasticity
                require(float(scale.min()) >= pp.min_scale
                        and float(scale.max()) <= pp.max_scale
                        and float(scale.max()) > 1.0,
                        f"{label}: rest scales in [{float(scale.min())}, "
                        f"{float(scale.max())}]")
            del top, state0, state, x, pinned, length, flat

    # --- the wind and strain-limit branches, and the lattices' drag ---------
    def wind_scene(solver, nx=10, ny=10, plane_height=-1.0):
        """tests/test_wind.py's cloth in a cross-wind with drag and lift
        (10x10; 16x24 contact-free, past an 8-row tile)."""
        cfg = sb.SimConfig(
            solver=solver,
            wind=sb.WindParams(velocity=(2.0, 0.5, 1.0), drag=0.3, lift=0.8),
            xpbd=sb.XPBDParams(n_iterations=3),
            collision=sb.CollisionParams(enable_plane=True),
            global_damping=0.2)
        host = sb.cloth_grid(nx, ny, spacing=0.05, shear=True, bend=True,
                             pinned=("tl", "tr"), springs=cfg.springs,
                             xpbd=cfg.xpbd, plane_height=plane_height,
                             orientation="xy")
        return host, cfg

    def strain_scene(solver, feature="none"):
        """tests/test_strainlimit.py's soft 16x16 banner on a plane, 8 %
        stretch bound; "tear" tears at 20 %, "both" also creeps."""
        cfg = sb.SimConfig(
            solver=solver,
            strain_limit=sb.StrainLimitParams(enabled=True, max_stretch=0.08),
            springs=sb.SpringParams(k_structural=30.0, k_shear=15.0,
                                    k_bend=6.0, damping=0.5),
            xpbd=sb.XPBDParams(compliance_distance=5e-3, compliance_bend=5e-2),
            tear=sb.TearParams(enabled=feature != "none", strain_limit=0.2),
            plasticity=sb.PlasticityParams(enabled=feature == "both",
                                           yield_strain=0.02, creep=0.1),
            global_damping=0.4)
        host = sb.cloth_grid(16, 16, spacing=0.08, mass=0.04,
                             pinned=("top",), shear=True, bend=True,
                             springs=cfg.springs, xpbd=cfg.xpbd,
                             plane_height=-0.9, orientation="xy")
        return host, cfg

    def grid_offsets(top, cfg):
        return _offsets(cfg, top.grid_spacing,
                        EDGE_SHEAR in top.edge_classes_present,
                        EDGE_BEND in top.edge_classes_present)

    def compare_sweeps(scene, host, cfg, x, alive=None, scale=None):
        """The strain sweeps alone (grid_euler.make_strain_correction) from
        positions ``x`` against x + strain_limit_planes: FMA contraction
        only.  Returns the error."""
        top, _ = sb.init(host, device=cuda)
        ny, nx = top.grid_shape
        x3 = to_planes(x, ny, nx).contiguous()
        offsets = grid_offsets(top, cfg)
        masks = [_valid_mask(ny, nx, di, dj, cuda, torch.float32)
                 for di, dj, _, _ in offsets]
        want = x3 + strain_limit_planes(
            x3, offsets, masks if alive is None else list(alive),
            top.inv_mass.reshape(1, ny, nx), cfg.strain_limit, scales=scale)
        got = grid_euler.make_strain_correction(top, cfg)(x3, alive, scale)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        moved = float((want - x3).abs().max())
        pinned = (top.inv_mass == 0.0).reshape(ny, nx)
        frozen = torch.equal(got[:, pinned], x3[:, pinned])
        emit("compare", kernel="grid_strain_sweep", scene=scene,
             sweeps=cfg.strain_limit.iterations, tear=alive is not None,
             plastic=scale is not None, max_abs_dx=err, max_moved=moved,
             pins_frozen=frozen, atol_x=1e-6, why="FMA contraction only")
        require(err <= 1e-6 and moved > 1e-4 and frozen,
                f"strain sweeps {scene}: |dx| {err:.3e}, moved {moved:.3e}, "
                f"pins frozen {frozen}")
        return err

    def compare_branches():
        fma = "FMA contraction only"
        for solver, name in ((sb.Solver.SEMI_IMPLICIT_EULER, "grid_euler"),
                             (sb.Solver.VERLET, "grid_verlet"),
                             (sb.Solver.XPBD, "grid_xpbd")):
            compare(name, "10x10 wind with lift", *wind_scene(solver), 64,
                    5e-5, 5e-2, fma + "; tests/test_wind.py's 5e-5 on x")
            compare(name, "16x24 wind with lift, contact-free",
                    *wind_scene(solver, 16, 24, -3.0), 64, 5e-5, 5e-2,
                    fma + "; tests/test_wind.py's 5e-5 on x")
            host, cfg = strain_scene(solver)
            compare(name, "16x16 strain limit", host, cfg, 64, 3e-5, 5e-2,
                    fma + "; tests/test_strainlimit.py's 3e-5 on x")
            for feature in ("tear", "both"):
                host, cfg = strain_scene(solver, feature)
                compare_features(
                    name, f"16x16 strain limit, {feature}", host, cfg, 64,
                    2e-4, 5e-2, 1e-3,
                    fma + "; tests/test_strainlimit.py's 2e-4 on x with "
                    "tearing; scales: x's rounding over rest 0.08, creep 0.1")
        # the sweeps alone, the banner stretched 15 % with noise
        rng = np.random.default_rng(5)
        for feature in ("none", "tear", "both"):
            host, cfg = strain_scene(sb.Solver.SEMI_IMPLICIT_EULER, feature)
            x0 = torch.tensor(host.positions0, dtype=torch.float32,
                              device=cuda)
            x = 1.15 * x0 + torch.tensor(
                0.01 * rng.standard_normal(tuple(x0.shape)),
                dtype=torch.float32, device=cuda)
            ny, nx = host.grid_shape
            alive = scale = None
            if cfg.tear.enabled:
                alive = torch.stack([
                    _valid_mask(ny, nx, di, dj, cuda, torch.float32)
                    for di, dj in ((0, 1), (1, 0), (1, 1), (1, -1), (0, 2),
                                   (2, 0))]) * torch.tensor(
                    rng.uniform(size=(6, ny, nx)) < 0.8, dtype=torch.float32,
                    device=cuda)
            if cfg.plasticity.enabled:
                scale = torch.tensor(rng.uniform(0.9, 1.2, (6, ny, nx)),
                                     dtype=torch.float32, device=cuda)
            compare_sweeps(f"16x16 banner stretched 15 %, {feature}", host,
                           cfg, x, alive, scale)
        # the drag on tests/test_pallas_lattice.py's 6^3 cube
        for solver, name in ((sb.Solver.SEMI_IMPLICIT_EULER, "lattice_euler"),
                             (sb.Solver.VERLET, "lattice_verlet"),
                             (sb.Solver.XPBD, "lattice_xpbd")):
            host, cfg = cube(solver)
            compare(name, "6^3 drag", host,
                    cfg.replace(wind=sb.WindParams(velocity=(3.0, 0.0, 1.0),
                                                   drag=0.5)),
                    48, 1e-5, 2e-3, fma)
        # one frame of each path at 64k, and the sweeps alone from the
        # strain preset's state after a frame
        for label, p in branches.items():
            host, cfg = p["host"], p["cfg"]
            p["err"] = compare(p["kernel"], label, host, cfg, cfg.n_substeps,
                               1e-5, 1e-3, "one frame from rest: " + fma)
        p = branches[strain_line["path"]]
        top, s0 = sb.init(p["host"], device=cuda)
        s1 = sb.step(top, p["cfg"], s0)
        strain_line["err"] = compare_sweeps(
            "cloth_strain_64k after a frame, stretched 15 %", p["host"],
            p["cfg"], 1.15 * s1.x)
        del top, s0, s1

    def main_path_branches():
        for label, p in branches.items():
            host, cfg = p["host"], p["cfg"]
            frames_ = p["frames"]
            kernel = p["kernel"]
            lattice = kernel.startswith("lattice_")
            module = kernels[kernel]["module"]
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            top, state0 = sb.init(host, device="cuda")
            pinned = torch.from_numpy(host.inv_mass == 0.0).to(cuda)
            expected = frames_ * (
                grid_launches_per_frame(module, top, cfg) if not lattice
                else module.launches_per_call(top, cfg, cfg.n_substeps))
            sweeps = frames_ * cfg.n_substeps * grid_strain.sweeps(cfg)
            reset_counts()
            t = time.perf_counter()
            state, vmax = state0, []
            for _ in range(frames_):
                state = sb.step(top, cfg, state)
                vmax.append(torch.linalg.vector_norm(state.v, dim=1).max())
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t
            launched = counts()
            swept = grid_strain.launch_count()
            p["launches"] = launched[kernel]
            p["sweeps"] = swept
            x = state.x
            vmax = torch.stack(vmax).tolist()
            if lattice:   # the normals of the surface the triangles cover
                on = torch.zeros(x.shape[0], dtype=torch.bool, device=cuda)
                on[top.triangles.reshape(-1)] = True
                length = torch.linalg.vector_norm(
                    rendered(label, top, state)[on], dim=1)
            else:
                length = torch.linalg.vector_norm(rendered(label, top, state),
                                                  dim=1)
            unit_err = float((length - 1.0).abs().max())
            e = host.edges.shape[0]
            strain = None
            if cfg.strain_limit.enabled:
                a, b = top.edges[:, 0], top.edges[:, 1]
                strain = float((torch.linalg.vector_norm(x[b] - x[a], dim=1)
                                / top.rest_length - 1.0).max())
            x0 = state0.x
            emit("main_path_branches", kernel=kernel, path=label,
                 preset=p["preset"], solver=cfg.solver.value,
                 vertices=x.shape[0], edges=e, frames=frames_,
                 substeps=frames_ * cfg.n_substeps, launches=launched,
                 expected_launches=expected, strain_sweeps=swept,
                 expected_strain_sweeps=sweeps, seconds=main_s,
                 vmax_per_frame=vmax[::max(1, frames_ // 12)],
                 vmax_last=vmax[-1], max_strain=strain,
                 max_stretch=(cfg.strain_limit.max_stretch
                              if cfg.strain_limit.enabled else None),
                 mean_dx=float((x[:, 0] - x0[:, 0]).mean()),
                 mean_dz=float((x[:, 2] - x0[:, 2]).mean()),
                 y_min=float(x[:, 1].min()),
                 plane_height=float(top.plane_height),
                 normal_unit_err=unit_err,
                 peak_mem_bytes=torch.cuda.max_memory_allocated() - held)
            require(launched[kernel] == expected,
                    f"{label}: {launched[kernel]} launches, expected "
                    f"{expected}")
            require(sum(launched.values()) == expected,
                    f"{label}: other kernels launched: {launched}")
            require(swept == sweeps,
                    f"{label}: {swept} strain sweeps, expected {sweeps}")
            require(bool(torch.isfinite(x).all()), f"{label}: x not finite")
            require(int(pinned.sum()) == (0 if lattice
                                          else host.grid_shape[1]),
                    f"{label}: {int(pinned.sum())} pins")
            require(torch.equal(x[pinned], x0[pinned]),
                    f"{label}: pinned row moved")
            require(bool((x[:, 1] >= top.plane_height).all()),
                    f"{label}: vertex below the plane")
            require(all(np.isfinite(vmax)) and max(vmax) < 100.0,
                    f"{label}: max |v| per frame {vmax}")
            require(bool(torch.isfinite(length).all()) and unit_err <= 1e-5,
                    f"{label}: normals off unit length by {unit_err:.3e}")
            if cfg.wind.enabled:   # blown downwind, along +x and +z
                require(float((x[:, 0] - x0[:, 0]).mean()) > 0.0
                        and float((x[:, 2] - x0[:, 2]).mean()) > 0.0,
                        f"{label}: not blown downwind")
            del top, state0, state, x, pinned, length

    # --- the capsule and box branch of the six grid and lattice kernels -------
    def collider_scene(solver, kind="grid"):
        """tests/test_torch_colliders.py's scenes in contact from the start:
        the 12x12 cloth in the band of a capsule and a box turned 30 degrees
        (one corner pinned), or the 5^3 cube straddling a capsule and a box
        turned 20 degrees (three vertices pinned); every collider with a
        kinematic velocity."""
        cfg = sb.SimConfig(
            solver=solver,
            collision=sb.CollisionParams(
                enable_plane=True, enable_capsules=True, enable_boxes=True,
                restitution=0.1, friction=0.3),
            volume_stiffness=0.5, global_damping=0.3)
        if kind == "grid":
            host = sb.cloth_grid(
                12, 12, spacing=0.05, shear=True, bend=True, pinned=("tl",),
                springs=cfg.springs, xpbd=cfg.xpbd, plane_height=-2.0,
                origin=(-0.28, 0.05, -0.28), orientation="xz")
            geometry = dict(
                capsule_p0=[[-0.3, 0.0, 0.0]], capsule_p1=[[0.05, 0.0, 0.0]],
                capsule_radii=[0.12], box_centers=[[0.18, -0.05, 0.1]],
                box_half_extents=[[0.15, 0.1, 0.12]],
                box_rotations=[rot_z(30.0)])
        else:
            host = sb.tet_cube(5, spacing=0.05, springs=cfg.springs,
                               xpbd=cfg.xpbd, plane_height=-0.5,
                               origin=(-0.1, -0.02, -0.1))
            host.inv_mass[:3] = 0.0
            geometry = dict(
                capsule_p0=[[-0.15, 0.0, 0.1]], capsule_p1=[[0.25, 0.0, 0.1]],
                capsule_radii=[0.06], box_centers=[[0.05, -0.06, -0.05]],
                box_half_extents=[[0.12, 0.05, 0.1]],
                box_rotations=[rot_z(20.0)])
        return sb.add_colliders(host, capsule_velocities=[[0.3, 0.0, 0.1]],
                                box_velocities=[[0.0, 0.1, -0.2]],
                                **geometry), cfg

    def collider_depth(top, x):
        """(deepest vertex inside a capsule, inside a box, vertices within
        1e-3 of a surface or inside), in float64 from the rows of ``top``:
        a straightforward reference, not the port's primitives."""
        x = x.double()
        cap = box = torch.tensor(-float("inf"), dtype=torch.float64,
                                 device=x.device)
        near = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
        for c in range(top.n_capsules):
            p0 = top.capsule_p0[c].double()
            ax = top.capsule_p1[c].double() - p0
            t = ((x - p0) @ ax / (ax @ ax)).clamp(0.0, 1.0)
            depth = (top.capsule_radii[c].double()
                     - torch.linalg.vector_norm(x - p0 - t[:, None] * ax,
                                                dim=1))
            cap = torch.maximum(cap, depth.max())
            near |= depth > -1e-3
        for b in range(top.n_boxes):
            q = (x - top.box_centers[b].double()) @ top.box_rotations[b].double()
            depth = (top.box_half_extents[b].double() - q.abs()).min(dim=1)[0]
            box = torch.maximum(box, depth.max())
            near |= depth > -1e-3
        return float(cap), float(box), int(near.sum())

    def advanced(p, frames_, top):
        """The kernel path's state after ``frames_`` frames of path ``p``
        from rest on its topology ``top``: the scene in contact."""
        s = sb.make_state(p["host"].positions0, cuda)
        for _ in range(frames_):
            s = sb.step(top, p["cfg"], s)
        torch.cuda.synchronize()
        return s

    def compare_colliders():
        fma = "FMA contraction only"
        # the six kernels on the small scenes, 48 substeps in contact; x at
        # tests/test_colliders.py's kernel-vs-twin 5e-5 (rounding amplified
        # by contact), v 5e-2 (x's rounding over dt)
        for solver, grid, lat in (
                (sb.Solver.SEMI_IMPLICIT_EULER, "grid_euler", "lattice_euler"),
                (sb.Solver.VERLET, "grid_verlet", "lattice_verlet"),
                (sb.Solver.XPBD, "grid_xpbd", "lattice_xpbd")):
            compare(grid, "12x12 capsule and box, moving",
                    *collider_scene(solver), 48, 5e-5, 5e-2,
                    fma + ", amplified by contact; tests/test_colliders.py's "
                    "5e-5 on x")
            compare(lat, "5^3 capsule and box, moving",
                    *collider_scene(solver, "lattice"), 48, 5e-5, 5e-2,
                    fma + ", amplified by contact")
            host, cfg = collider_scene(solver)
            compare(grid, "12x12 capsule and box, strain limit", host,
                    cfg.replace(strain_limit=sb.StrainLimitParams(
                        enabled=True, max_stretch=0.05, iterations=4)),
                    32, 5e-5, 5e-2, fma + ", amplified by contact")
            compare_features(
                grid, "12x12 capsule and box, tear and plastic", host,
                cfg.replace(tear=sb.TearParams(enabled=True,
                                               strain_limit=0.3),
                            plasticity=sb.PlasticityParams(
                                enabled=True, yield_strain=0.02, creep=0.2)),
                32, 5e-5, 5e-2, 1e-4,
                fma + ", amplified by contact; scales: x's rounding over "
                "rest 0.05, creep 0.2")
        # one frame of each 64k path from rest, every vertex running the
        # capsule and box tests with none in contact yet, at x 1e-5; and one
        # from its state in contact, where a vertex ends a substep within
        # ulps of a friction shell (the shells' knife edge): one ulp of x
        # apart, kernel and plain version decide it apart and the friction
        # moves it by mu times its tangential step, ~1e-4 (on an H100:
        # 9.2e-5 under Verlet, x 1.5e-6 under Euler), so that frame is held
        # at the fixed x 1e-3 / v 0.25 of a chaotic contact frame (the
        # self-collision pile's above); the small scenes above hold the
        # branch's arithmetic at 5e-5
        for label, p in collider_paths.items():
            host, cfg = p["host"], p["cfg"]
            top, _ = sb.init(host, device=cuda)
            rest = compare(p["kernel"], f"{label} from rest", host, cfg,
                           cfg.n_substeps, 1e-5, 1e-3,
                           "one frame from rest: " + fma, top=top)
            s_in = advanced(p, p["contact_frames"], top)
            p["err"] = max(rest, compare(
                p["kernel"], f"{label} after {p['contact_frames']} frames",
                host, cfg, cfg.n_substeps, 1e-3, 0.25,
                "one frame in contact: friction-shell decisions part on an "
                "ulp of x", start=lambda s0: s_in, top=top))
            del top, s_in

    def main_path_colliders():
        for label, p in collider_paths.items():
            host, cfg = p["host"], p["cfg"]
            frames_ = p["frames"]
            kernel = p["kernel"]
            lattice = kernel.startswith("lattice_")
            module = kernels[kernel]["module"]
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            top, state0 = sb.init(host, device="cuda")
            pinned = torch.from_numpy(host.inv_mass == 0.0).to(cuda)
            expected = frames_ * (
                grid_launches_per_frame(module, top, cfg) if not lattice
                else module.launches_per_call(top, cfg, cfg.n_substeps))
            frame_dt = cfg.dt * cfg.n_substeps
            lift = torch.tensor([0.0, 0.05, 0.0], device=cuda)
            w = top.capsule_velocities
            reset_counts()
            t = time.perf_counter()
            state, vmax, built, near_seen = state0, [], None, []
            for i in range(frames_):
                if i % 30 == 29:   # contact, every 30 frames
                    near_seen.append(collider_depth(top, state.x)[2])
                if i == frames_ // 2:
                    near_at_move = collider_depth(top, state.x)[2]
                    # raise the capsule by 0.05 m over this frame, at the
                    # matching velocity; the next frame it rolls on at w
                    top = sb.move_colliders(
                        top, capsule_p0=top.capsule_p0 + lift,
                        capsule_p1=top.capsule_p1 + lift,
                        capsule_velocities=w + lift / frame_dt)
                elif i == frames_ // 2 + 1:
                    top = sb.move_colliders(top, capsule_velocities=w)
                state = sb.step(top, cfg, state)
                if i == 0:
                    built = api._build_step.cache_info().misses
                vmax.append(torch.linalg.vector_norm(state.v, dim=1).max())
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t
            launched = counts()
            rebuilt = api._build_step.cache_info().misses - built
            p["launches"] = launched[kernel]
            x = state.x
            vmax = torch.stack(vmax).tolist()
            cap, box, near = collider_depth(top, x)
            if lattice:   # the normals of the surface the triangles cover
                on = torch.zeros(x.shape[0], dtype=torch.bool, device=cuda)
                on[top.triangles.reshape(-1)] = True
                length = torch.linalg.vector_norm(
                    rendered(label, top, state)[on], dim=1)
            else:
                length = torch.linalg.vector_norm(rendered(label, top, state),
                                                  dim=1)
            unit_err = float((length - 1.0).abs().max())
            x0 = state0.x
            emit("main_path_colliders", kernel=kernel, path=label,
                 solver=cfg.solver.value, vertices=x.shape[0],
                 edges=host.edges.shape[0], tets=host.tets.shape[0],
                 frames=frames_, substeps=frames_ * cfg.n_substeps,
                 launches=launched, expected_launches=expected,
                 moved_at_frame=frames_ // 2 + 1,
                 step_functions_built_after_frame_1=rebuilt,
                 seconds=main_s, vmax_per_frame=vmax[::max(1, frames_ // 12)],
                 vmax_last=vmax[-1], max_depth_in_capsule=cap,
                 max_depth_in_box=box, vertices_near_colliders=near,
                 vertices_near_colliders_at_move=near_at_move,
                 vertices_near_colliders_every_30_frames=near_seen,
                 pins=int(pinned.sum()),
                 mean_dx=float((x[:, 0] - x0[:, 0]).mean()),
                 y_min=float(x[:, 1].min()), y_max=float(x[:, 1].max()),
                 plane_height=float(top.plane_height),
                 normal_unit_err=unit_err,
                 peak_mem_bytes=torch.cuda.max_memory_allocated() - held)
            require(launched[kernel] == expected,
                    f"{label}: {launched[kernel]} launches, expected "
                    f"{expected}")
            require(sum(launched.values()) == expected,
                    f"{label}: other kernels launched: {launched}")
            require(rebuilt == 0,
                    f"{label}: {rebuilt} step functions built by "
                    "move_colliders")
            require(bool(torch.isfinite(x).all()), f"{label}: x not finite")
            require(torch.equal(x[pinned], x0[pinned]),
                    f"{label}: pinned vertices moved")
            require(cap <= 1e-4 and box <= 1e-4,
                    f"{label}: a vertex {cap:.3e} inside the capsule, "
                    f"{box:.3e} inside the box")
            require(max(near_seen) > 0,
                    f"{label}: no vertex ever near the colliders")
            require(bool((x[:, 1] >= top.plane_height).all()),
                    f"{label}: vertex below the plane")
            require(all(np.isfinite(vmax)) and max(vmax) < 100.0,
                    f"{label}: max |v| per frame {vmax}")
            require(bool(torch.isfinite(length).all()) and unit_err <= 1e-5,
                    f"{label}: normals off unit length by {unit_err:.3e}")
            del top, state0, state, x, pinned, length

    # The 64k collider scenes: the JAX package's own float32 path leaves its
    # float64 run by the series below, every 10 frames (CPU: PYTHONPATH=.
    # python tests/test_torch_colliders.py cloth|cube euler|verlet|xpbd
    # <frames> 10): the landing on the capsule and the box (near frame 25)
    # is chaotic in float32, the drift growing some tenfold every 10 frames
    # from it.  So the port is held to BASELINE.json:5's 1e-3 over the
    # frames where the reference's float32 stays within half of it (a
    # second float32 implementation of a chaotic contact needs that margin),
    # and to twice the reference's worst after, as the wind and strain
    # presets are.  The cloth over 100 frames, the cubes over 40 (the impact
    # near frame 20; later they slide off the colliders onto the plane), to
    # keep the script near half its time limit.
    jax_collider_drift = {
        "cloth_colliders_64k": (30, [
            5.722046e-08, 9.655915e-07, 4.664968e-04, 4.570672e-03,
            3.070750e-02, 1.079005e-02, 2.458915e-02, 2.890808e-02,
            5.160730e-02, 3.828656e-02]),
        "cloth_colliders_64k_verlet": (10, [
            3.918111e-04, 8.930292e-04, 5.322735e-03, 1.680905e-02,
            3.910712e-02, 2.716449e-02, 3.380739e-02, 3.405518e-02,
            3.345585e-02, 4.680162e-02]),
        "cloth_colliders_64k_xpbd": (20, [
            2.813339e-07, 1.382824e-06, 5.616872e-04, 2.612597e-02,
            3.964238e-02, 4.633709e-02, 4.489777e-02, 4.489428e-02,
            4.894184e-02, 5.645786e-02]),
        "softbody_cube_64k_colliders": (20, [
            3.140061e-07, 6.754022e-07, 1.374811e-02, 2.964455e-02]),
        "softbody_cube_64k_verlet_colliders": (10, [
            3.009297e-04, 9.553039e-04, 5.532259e-02, 7.498270e-02]),
        "softbody_cube_64k_xpbd_colliders": (20, [
            2.608806e-07, 2.796307e-07, 2.737625e-02, 6.265632e-02]),
    }

    def fidelity_colliders():
        for label, (held, ref) in jax_collider_drift.items():
            p = collider_paths[label]
            host, cfg = p["host"], p["cfg"]
            n_frames = 10 * len(ref)
            late_bound = 2.0 * max(ref)
            plain = kernels[p["kernel"]]["plain"]
            t = time.perf_counter()
            top32, s32 = sb.init(host, device="cuda")
            top64, s64 = sb.init(host, device="cuda", dtype=torch.float64)
            plain64 = plain(top64, cfg)
            frame64 = graphed(plain64, s64, cfg)
            want, got = plain64(s64, cfg.dt, cfg.n_substeps), frame64(s64)
            require(all(torch.equal(a, b) for a, b in (
                (want.x, got.x), (want.v, got.v),
                (want.x_prev, got.x_prev))),
                f"fidelity {label}: the graph's frame differs from a call's")
            del want, got
            checkpoints = []
            for i in range(n_frames):
                s32 = sb.step(top32, cfg, s32)
                s64 = frame64(s64)
                if (i + 1) % 10 == 0:
                    checkpoints.append(float(
                        (s32.x.double() - s64.x).abs().max()))
            torch.cuda.synchronize()
            early = max(checkpoints[:held // 10])
            late = max(checkpoints[held // 10:])
            emit("fidelity", kernel=p["kernel"], path=label,
                 frames=n_frames, every=10, drift=checkpoints,
                 held_frames=held, worst_drift_held=early, bound_held=1e-3,
                 worst_drift_after=late, bound_after=late_bound,
                 bound_source="BASELINE.json:5 while the JAX package's own "
                              "f32 drift stays inside it; then twice its "
                              "worst",
                 minus_reference=[a - b for a, b in zip(checkpoints, ref)],
                 seconds=time.perf_counter() - t)
            require(early <= 1e-3,
                    f"fidelity {label}: drift {early:.3e} by frame {held}")
            require(late <= late_bound,
                    f"fidelity {label}: drift {late:.3e} > {late_bound}")
            del top32, s32, top64, s64, plain64, frame64

    # 3. kernel vs plain version on the card ----------------------------------
    begin("compare")
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

    def cube(solver=sb.Solver.SEMI_IMPLICIT_EULER, n=6, volume_stiffness=0.5,
             sphere=False, pins=0):
        """tests/test_pallas_lattice.py's tet-cube scenes: on the plane, or
        (sphere) dropped onto a sphere with the plane out of reach."""
        cfg = sb.SimConfig(
            solver=solver,
            springs=sb.SpringParams(k_structural=1200.0, damping=1.5),
            xpbd=sb.XPBDParams(compliance_distance=1e-6,
                               compliance_volume=1e-7, n_iterations=4,
                               relaxation=1.0),
            collision=sb.CollisionParams(enable_plane=True,
                                         enable_spheres=sphere, friction=0.4),
            global_damping=0.5,
            volume_stiffness=volume_stiffness,
        )
        host = sb.tet_cube(n, spacing=0.08, springs=cfg.springs,
                           xpbd=cfg.xpbd, plane_height=-5.0 if sphere else 0.0,
                           origin=(0.0, 0.25 if sphere else 0.01, 0.0))
        if sphere:
            host.sphere_centers = np.array([[0.2, -0.02, 0.2]])
            host.sphere_radii = np.array([0.3])
        host.inv_mass[:pins] = 0.0
        return host, cfg

    def compare(name, scene, host, cfg, n_sub, atol_x, atol_v, why,
                start=None, top=None):
        """Kernel ``name`` against its plain version over ``n_sub``
        substeps from rest (or from ``start(rest)``), on ``top`` where
        given (a 64k cube's topology takes seconds of host work to build),
        else on a topology built from ``host``."""
        if top is None:
            top, s0 = sb.init(host, device=cuda)
        else:
            s0 = sb.make_state(host.positions0, cuda)
        if start is not None:
            s0 = start(s0)
        plain = kernels[name]["plain"](top, cfg)(s0, cfg.dt, n_sub)
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
    # tests/test_torch_cuda.py's lattice bounds: x 1e-5 (FMA contraction
    # only; tests/test_pallas_lattice.py allows its rsqrt kernel 2e-5), v
    # 2e-3 (v carries x's rounding over dt)
    fma = "kernel vs plain, FMA contraction only"
    for name, solver, label, kw, n_sub in (
            ("lattice_euler", None, "6^3 on the plane", dict(n=6), 48),
            ("lattice_euler", None, "7^3 on the plane", dict(n=7), 48),
            ("lattice_euler", None, "6^3 no volume",
             dict(volume_stiffness=0.0), 48),
            ("lattice_euler", None, "6^3 pinned corner", dict(pins=8), 64),
            ("lattice_euler", None, "6^3 sphere", dict(sphere=True), 96),
            ("lattice_verlet", V, "6^3 on the plane", dict(n=6), 48),
            ("lattice_verlet", V, "6^3 sphere, pins",
             dict(sphere=True, pins=4), 96),
            ("lattice_xpbd", X, "6^3 on the plane", dict(n=6), 64),
            ("lattice_xpbd", X, "7^3 pinned corner", dict(n=7, pins=8), 64),
            ("lattice_xpbd", X, "6^3 sphere", dict(sphere=True), 64)):
        compare(name, label,
                *cube(solver or sb.Solver.SEMI_IMPLICIT_EULER, **kw), n_sub,
                1e-5, 2e-3, fma)
    host, cfg = cube(X)
    compare("lattice_xpbd", "6^3 no sweeps", host,
            cfg.replace(xpbd=dataclasses.replace(cfg.xpbd, n_iterations=0)),
            32, 1e-5, 2e-3, fma + "; n_iterations = 0: the epilogue alone")
    for name, k in steps.items():
        k["err64"] = compare(name, k["preset"], k["host"], k["cfg"],
                             k["cfg"].n_substeps, 1e-5, 1e-3,
                             "one smooth frame: rounding only")
    sc_state = compare_self_collision()
    compare_halo(sc_state)
    compare_large()
    compare_branches()
    compare_colliders()
    emit("compare", seconds=phase_seconds())

    # 4. the main paths -----------------------------------------------------
    begin("main_path")
    frames = 300
    for name, k in steps.items():
        host, cfg = k["host"], k["cfg"]
        # the path's own peak: what it allocates from init on, over what
        # earlier phases still hold (api.step caches the step functions,
        # and with them the topologies, of the presets before it)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        top, state0 = sb.init(host, device="cuda")
        pinned = torch.from_numpy(host.inv_mass == 0.0).to(cuda)
        expected = frames * launches_per_call(name, top, cfg, cfg.n_substeps)
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
        # the cubes' surface triangles cover two faces: normals of the
        # vertices they touch
        on_surface = torch.zeros(x.shape[0], dtype=torch.bool, device=cuda)
        on_surface[top.triangles.reshape(-1)] = True
        nrm = rendered(k["preset"], top, state)[on_surface]
        unit_err = float((torch.linalg.vector_norm(nrm, dim=1) - 1.0).abs().max())
        y_min = float(x[:, 1].min())
        emit("main_path", kernel=name, preset=k["preset"],
             solver=cfg.solver.value, vertices=x.shape[0], frames=frames,
             substeps=frames * cfg.n_substeps, launches=launched,
             expected_launches=expected, seconds=main_s,
             y_min=y_min, plane_height=float(top.plane_height),
             normal_unit_err=unit_err,
             peak_mem_bytes=torch.cuda.max_memory_allocated() - held)
        require(launched[name] == expected,
                f"{name} launched {launched[name]} times, expected {expected}")
        require(sum(launched.values()) == expected,
                f"{k['preset']}: other kernels launched: {launched}")
        require(bool(torch.isfinite(x).all()), f"{name} main path: x not finite")
        require(int(pinned.sum()) == (0 if k["lattice"] else 256),
                f"{name} main path: {int(pinned.sum())} pins")
        require(torch.equal(x[pinned], state0.x[pinned]),
                f"{name} main path: pinned rows moved")
        require(bool((x[:, 1] >= top.plane_height).all()),
                f"{name} main path: vertex below the plane")
        # the cube dropped from 1 m rests on the plane after 5 s
        require(not k["lattice"] or y_min <= float(top.plane_height) + 1e-4,
                f"{name} main path: the cube never reached the plane "
                f"(y_min {y_min})")
        require(unit_err <= 1e-5,
                f"{name}: normals off unit length by {unit_err:.3e}")
        if k["lattice"]:
            k["settled"] = state
        del top, state0, state, x, pinned, on_surface, nrm
    main_path_self_collision()
    main_path_large()
    main_path_branches()
    main_path_colliders()
    main_path_halo()
    emit("main_path", kernel="normals", launches=normals_line["launches"],
         max_abs_err_vs_plain=normals_line["err_of"])
    emit("main_path", seconds=phase_seconds())

    # 5. hanging cloth on a sphere ------------------------------------------
    begin("sphere")
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
    begin("golden")
    # tests/test_golden.py's tolerances; the sphere scene's first recorded
    # frame is also held to 2e-3 (CPU plain path 8.4e-4, JAX f32 1.3e-3)
    for name, tol, first_tol in (("cloth_32_euler", 1e-4, 1e-4),
                                 ("cloth_hanging_sphere", 5e-2, 2e-3),
                                 ("cloth_xpbd", 2e-3, 2e-3),
                                 ("softbody_cube", 1e-4, 1e-4),
                                 ("cloth_strain_limited", 5e-3, 5e-3)):
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
    golden_self_collision()
    emit("golden", seconds=phase_seconds())

    # 7. fidelity bound -----------------------------------------------------
    begin("fidelity")
    # BASELINE.json:5's 1e-3.  The grid presets run 500 frames (Euler,
    # Verlet) and 100 (XPBD), the first checkpoints of the 1000 and 200 that
    # earlier versions of this script ran, so that the six paths fit the
    # time limit.  Verlet: on this scene the JAX package's own float32
    # stencil drifts from its float64 run by the series below, every 50
    # frames, worst 1.823590e-2 at frame 500 (CPU; python
    # tests/test_torch_xpbd_verlet.py cloth_bench_64k_verlet 1000 50):
    # float32 position Verlet keeps moving where float64 settles.  The port
    # is held to that worst drift plus 1e-5, the rounding allowance of the
    # one-frame 64k compare above (two float32 implementations of the same
    # arithmetic), and its difference from the series is printed.
    jax_verlet_drift = [
        4.697062e-04, 9.317698e-04, 1.234884e-03, 2.049689e-03, 4.189502e-03,
        7.977036e-03, 1.264167e-02, 4.539067e-03, 1.230327e-02, 1.823590e-02]
    # The cubes: softbody_cube (BASELINE.json:10) over the BASELINE's 1000
    # frames at 1e-3 (tests/test_oracle_parity.py holds the JAX package's
    # f32 path to it there).  The 64k cubes drop 1 m and hit the plane near
    # frame 35; the impact is chaotic in float32, and the JAX package's own
    # banded f32 path leaves its f64 run by the series below, every 10
    # frames (CPU; PYTHONPATH=. python tests/test_torch_lattice.py <preset>
    # <frames> 10): worst 1.951600e-1 (Euler), 2.038528e-1 (Verlet),
    # 9.033996e-2 (XPBD, 60 frames), against 3e-7 to 3e-4 before impact.
    # 1e-3 cannot hold there for any float32 implementation; the port is
    # held to the reference's worst plus the 1e-5 rounding allowance, and
    # its difference from the series is printed.
    jax_cube_drift = {
        "lattice_euler": [
            3.140061e-07, 6.754022e-07, 3.065103e-05, 6.519001e-02,
            1.845364e-01, 1.951600e-01, 1.070300e-01, 9.029354e-02,
            1.066816e-01, 9.386550e-02, 6.355496e-02, 5.988397e-02,
            7.763131e-02, 7.504255e-02, 8.175739e-02, 8.130445e-02,
            7.199581e-02, 7.113218e-02, 6.059273e-02, 6.338075e-02],
        "lattice_verlet": [
            3.009297e-04, 9.553039e-04, 1.658833e-03, 9.587694e-02,
            2.038528e-01, 1.039482e-01, 8.655242e-02, 6.008203e-02,
            8.741652e-02, 1.064603e-01, 9.248460e-02, 8.695215e-02,
            1.088908e-01, 1.037462e-01, 8.466016e-02, 6.511108e-02,
            6.505714e-02, 5.596025e-02, 5.942246e-02, 5.366196e-02],
        "lattice_xpbd": [
            2.608806e-07, 2.796307e-07, 2.539572e-02, 5.443324e-02,
            9.033996e-02, 7.973840e-02]}
    cube_host, cube_cfg = sb.presets.build("softbody_cube")
    cube_why = ("JAX banded f32-vs-f64 drift on this scene + 1e-5 rounding")
    fidelity = [
        ("grid_euler", None, 500, 250, 1e-3, "BASELINE.json:5", None),
        ("grid_verlet", None, 500, 50, max(jax_verlet_drift) + 1e-5,
         "JAX stencil f32-vs-f64 drift on this scene + 1e-5 rounding",
         jax_verlet_drift),
        ("grid_xpbd", None, 100, 50, 1e-3, "BASELINE.json:5", None),
        ("lattice_euler", "softbody_cube", 1000, 250, 1e-3,
         "BASELINE.json:5", None)]
    fidelity += [(name, None, 10 * len(ref), 10, max(ref) + 1e-5, cube_why,
                  ref) for name, ref in jax_cube_drift.items()]

    def graphed(fn, s0, cfg):
        """``fn(s, cfg.dt, cfg.n_substeps)`` captured from ``s0`` in one CUDA
        graph: a replay runs the same kernels on the same inputs as a call,
        without the host's cost of the thousands of small eager ops a frame
        of a float64 plain version launches.  The state it returns is the
        graph's output buffers, which the next replay overwrites.  The tear
        and plastic fields ride along where ``s0`` has them."""
        fields = [f for f in ("x", "v", "x_prev", "edge_alive", "rest_scale")
                  if getattr(s0, f) is not None]
        inp = s0.replace(**{f: getattr(s0, f).clone() for f in fields})
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(inp, cfg.dt, cfg.n_substeps)     # warm-up, outside the graph
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn(inp, cfg.dt, cfg.n_substeps)

        def frame(s):
            for f in fields:
                getattr(inp, f).copy_(getattr(s, f))
            graph.replay()
            return out

        # the graph reads the tensors ``fn`` built once (masks, tables) by
        # address: keep them alive as long as the graph (unreferenced, their
        # memory is reused and replays read garbage)
        frame.fn = fn
        return frame

    for name, preset, n_frames, every, bound, why, ref in fidelity:
        k = kernels[name]
        host, cfg = ((cube_host, cube_cfg) if preset == "softbody_cube"
                     else (k["host"], k["cfg"]))
        t = time.perf_counter()
        top32, s32 = sb.init(host, device="cuda")
        top64, s64 = sb.init(host, device="cuda", dtype=torch.float64)
        plain64 = k["plain"](top64, cfg)
        frame64 = graphed(plain64, s64, cfg)
        # the replay against a call, once: the same kernels, the same bits
        want, got = plain64(s64, cfg.dt, cfg.n_substeps), frame64(s64)
        require(all(torch.equal(a, b) for a, b in (
            (want.x, got.x), (want.v, got.v), (want.x_prev, got.x_prev))),
            f"fidelity {name}: the graph's frame differs from a call's")
        del want, got
        checkpoints = []
        for i in range(n_frames):
            s32 = sb.step(top32, cfg, s32)
            s64 = frame64(s64)
            if (i + 1) % every == 0:
                checkpoints.append(float((s32.x.double() - s64.x).abs().max()))
        torch.cuda.synchronize()
        worst = max(checkpoints)
        emit("fidelity", kernel=name, preset=preset or k["preset"],
             frames=n_frames,
             every=every, drift=checkpoints, worst_drift=worst, bound=bound,
             bound_source=why,
             minus_reference=(None if ref is None else
                              [a - b for a, b in zip(checkpoints, ref)]),
             seconds=time.perf_counter() - t)
        require(worst <= bound, f"fidelity {name}: drift {worst:.3e} > {bound}")
    fidelity_self_collision()

    def fidelity_large():
        # the curtains past the cap: BASELINE.json:5's 1e-3 over 200 (262k)
        # and 100 (1m) frames.  The float64 references of this phase run
        # eagerly: at these sizes the device, not the host, bounds them
        for label, n_frames, every in (("cloth_bench_262k", 200, 50),
                                       ("cloth_bench_1m", 100, 25)):
            p = large[label]
            host, cfg = p["host"], p["cfg"]
            t = time.perf_counter()
            top32, s32 = sb.init(host, device="cuda")
            top64, s64 = sb.init(host, device="cuda", dtype=torch.float64)
            plain64 = make_stencil_step(top64, cfg)
            checkpoints = []
            for i in range(n_frames):
                s32 = sb.step(top32, cfg, s32)
                s64 = plain64(s64, cfg.dt, cfg.n_substeps)
                if (i + 1) % every == 0:
                    checkpoints.append(float(
                        (s32.x.double() - s64.x).abs().max()))
            torch.cuda.synchronize()
            worst = max(checkpoints)
            emit("fidelity", kernel=p["kernel"], preset=label,
                 frames=n_frames, every=every, drift=checkpoints,
                 worst_drift=worst, bound=1e-3,
                 bound_source="BASELINE.json:5",
                 seconds=time.perf_counter() - t)
            require(worst <= 1e-3, f"fidelity {label}: drift {worst:.3e}")
            del top32, s32, top64, s64, plain64
        # the feature presets: the float32 kernel path against the float32
        # and the float64 plain versions, frame by frame: the first frame in
        # which the tear masks part, the edges that differ and the largest
        # rest-scale gap at each checkpoint, and the position drift.
        # Printed, not bounded: a mask decision at the threshold turns on one
        # ulp of an edge length
        for label, n_frames, every in (("cloth_tearing_64k", 60, 10),
                                       ("cloth_plastic_64k", 60, 10),
                                       ("cloth_tearing_262k", 30, 5),
                                       ("cloth_plastic_262k", 30, 5)):
            p = large[label]
            host, cfg = p["host"], p["cfg"]
            t = time.perf_counter()
            top32, s32 = sb.init(host, device="cuda")
            s32 = with_features(top32, cfg, s32)
            top64, s64 = sb.init(host, device="cuda", dtype=torch.float64)
            s64 = with_features(top64, cfg, s64)
            plain32 = make_stencil_step(top32, cfg)
            plain64 = make_stencil_step(top64, cfg)
            p32, p64 = s32, s64
            first = {"plain32": None, "plain64": None}
            rows = []
            for i in range(n_frames):
                s32 = sb.step(top32, cfg, s32)
                p32 = plain32(p32, cfg.dt, cfg.n_substeps)
                p64 = plain64(p64, cfg.dt, cfg.n_substeps)
                d32, d64 = feature_diff(s32, p32), feature_diff(s32, p64)
                for key, d in (("plain32", d32), ("plain64", d64)):
                    if first[key] is None and (d[0] or 0) > 0:
                        first[key] = i + 1
                if (i + 1) % every == 0:
                    rows.append(dict(
                        frame=i + 1,
                        mask_diff_vs_plain32=d32[0],
                        mask_diff_vs_plain64=d64[0],
                        scale_gap_vs_plain32=d32[1],
                        scale_gap_vs_plain64=d64[1],
                        torn_edges=(None if s32.edge_alive is None else
                                    int((s32.edge_alive == 0).sum())),
                        x_drift_vs_plain64=float(
                            (s32.x.double() - p64.x).abs().max())))
            torch.cuda.synchronize()
            emit("fidelity", kernel=p["kernel"], preset=label,
                 frames=n_frames, every=every,
                 first_frame_masks_part=first, checkpoints=rows,
                 seconds=time.perf_counter() - t)
            require(bool(torch.isfinite(s32.x).all()),
                    f"fidelity {label}: not finite")
            del top32, s32, top64, s64, plain32, plain64, p32, p64

    fidelity_large()

    # The wind and strain presets: the JAX package's own float32 path
    # leaves its float64 run by the series below, every 10 frames (CPU;
    # api.step in float32 and float64 on the preset, 200 frames): the
    # flutter in the cross-wind and the strain clamp on the soft banner
    # amplify rounding exponentially, past 1e-3 by frame 90 (wind) and 30
    # (strain), and then saturate at the motion's own amplitude.  So the
    # port is held to BASELINE.json:5's 1e-3 over the frames where the
    # reference's float32 stays inside it (wind 1-80, strain 1-20).  Past
    # them a float32 run lands anywhere in that amplitude (run 3, PR 6: the
    # kernel followed the wind series to 2.2e-4 up to frame 100, then ended
    # at 5.03e-2 against the reference's 4.58e-2): it is held to twice the
    # reference's worst, which a wrong force (the compares above hold every
    # branch at 1e-5 for a frame) would leave by far, and its difference
    # from the series is printed.
    jax_branch_drift = {
        "cloth_wind_64k": (80, [
            1.845229e-06, 2.495283e-06, 2.457427e-06, 4.267878e-06,
            2.078255e-05, 5.530978e-05, 1.095842e-04, 3.116132e-04,
            1.551024e-03, 4.335685e-03, 1.657185e-02, 2.038094e-02,
            2.250000e-02, 2.559366e-02, 3.078683e-02, 3.458134e-02,
            4.349818e-02, 4.087440e-02, 4.462330e-02, 4.576919e-02]),
        "cloth_strain_64k": (20, [
            9.169401e-05, 4.226400e-04, 1.259543e-03, 2.958249e-03,
            7.118472e-03, 9.049879e-03, 5.317054e-02, 7.168111e-02,
            7.599411e-02, 8.004781e-02, 4.095386e-02, 3.385353e-02,
            4.321141e-02, 4.532942e-02, 4.745200e-02, 4.912903e-02,
            2.979982e-02, 7.483560e-02, 4.881768e-02, 4.702367e-02])}
    for label, (held, ref) in jax_branch_drift.items():
        p = branches[label]
        host, cfg = p["host"], p["cfg"]
        late_bound = 2.0 * max(ref)
        t = time.perf_counter()
        top32, s32 = sb.init(host, device="cuda")
        top64, s64 = sb.init(host, device="cuda", dtype=torch.float64)
        plain64 = make_stencil_step(top64, cfg)
        frame64 = graphed(plain64, s64, cfg)
        want, got = plain64(s64, cfg.dt, cfg.n_substeps), frame64(s64)
        require(all(torch.equal(a, b) for a, b in (
            (want.x, got.x), (want.v, got.v), (want.x_prev, got.x_prev))),
            f"fidelity {label}: the graph's frame differs from a call's")
        del want, got
        checkpoints = []
        for i in range(200):
            s32 = sb.step(top32, cfg, s32)
            s64 = frame64(s64)
            if (i + 1) % 10 == 0:
                checkpoints.append(float((s32.x.double() - s64.x).abs().max()))
        torch.cuda.synchronize()
        early = max(checkpoints[:held // 10])
        late = max(checkpoints[held // 10:])
        emit("fidelity", kernel=p["kernel"], preset=label, frames=200,
             every=10, drift=checkpoints, held_frames=held,
             worst_drift_held=early, bound_held=1e-3,
             worst_drift_after=late, bound_after=late_bound,
             bound_source="BASELINE.json:5 while the JAX package's own f32 "
                          "drift stays inside it; then twice its worst",
             minus_reference=[a - b for a, b in zip(checkpoints, ref)],
             seconds=time.perf_counter() - t)
        require(early <= 1e-3,
                f"fidelity {label}: drift {early:.3e} by frame {held}")
        require(late <= late_bound,
                f"fidelity {label}: drift {late:.3e} > {late_bound}")
        del top32, s32, top64, s64, plain64, frame64
    fidelity_colliders()
    emit("fidelity", seconds=phase_seconds())

    # 8. timing -------------------------------------------------------------
    begin("timing")

    def substep_ms(fn, s0, cfg, n_frames, n_sub):
        """ms per substep of ``n_frames`` calls ``fn(s, dt, n_sub)`` from
        ``s0``."""
        def body():
            s = s0
            for _ in range(n_frames):
                s = fn(s, cfg.dt, n_sub)
        return events_ms(body, n_frames * n_sub)

    def in_turns(runs):
        """Each of ``runs`` {"kernel": body, "plain": body} (bodies return
        ms) after a warm-up call, in turns plain/kernel/kernel/plain."""
        for body in runs.values():
            body()
        torch.cuda.synchronize()
        ms = {"kernel": [], "plain": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            ms[which].append(runs[which]())
        return ms

    def pass_launches(dev, kernel, top, cfg, n_frames, what):
        """A path's launches a substep in a profiler window of ``n_frames``
        calls, from the per-kernel counts ``dev`` (a lattice Verlet call's
        velocity-estimate launch and a frame's feature update included);
        they must be the launches that ``kernel``'s wrapper makes, so a
        kernel the trace does not name fails the run."""
        module = kernels[kernel]["module"]
        per_call = (module.launches_per_call(top, cfg, cfg.n_substeps)
                    if kernels[kernel]["lattice"]
                    else grid_launches_per_frame(module, top, cfg))
        n = sum(c for _, c in dev.values())
        require(n == n_frames * per_call,
                f"timing {what}: the trace names {n} launches of "
                f"{kernel}'s kernels, its wrapper makes {n_frames * per_call}")
        return {"launches_per_substep": n / (n_frames * cfg.n_substeps)}

    def device_us_per_launch(fn, s0, cfg, n_frames, names):
        """Device time per launch of each named kernel over n_frames, from
        torch.profiler (absent where the trace shows no device time), and
        the device time of every kernel, memcpy and memset in the trace, in
        µs per substep; and {name: the distinct symbols it matched}, which
        each device line prints, so it names the kernel instances that
        ran."""
        def body():
            s = s0
            for _ in range(n_frames):
                s = fn(s, cfg.dt, cfg.n_substeps)
        symbols = {}
        out, busy = profile_device(body, names, symbols)
        return (out, busy / (n_frames * cfg.n_substeps),
                {k: sorted(set(v)) for k, v in symbols.items()})

    # every CUDA-event timing first: a torch.profiler session slows the
    # launches that follow it, so the device times are taken after.
    # The normals of the 64k curtain perturbed (the card tests' scene): a
    # call of the kernel's path against the plain version's
    top, s0 = sb.init(kernels["grid_euler"]["host"], device="cuda")
    x = s0.x + torch.tensor(
        0.01 * np.random.default_rng(3).standard_normal(tuple(s0.x.shape)),
        dtype=torch.float32, device=cuda)
    s_nrm = s0.replace(x=x)
    ms = in_turns({
        "kernel": lambda: events_ms(
            lambda: [sb.normals(top, s_nrm) for _ in range(200)], 200),
        "plain": lambda: events_ms(
            lambda: [vertex_normals(top.triangles, x) for _ in range(20)],
            20)})
    scene = api._normals_of(SceneKey(top))
    # x read and the normals written once, the int32 triangles and table
    # read once
    nbytes = (2 * x.numel() * x.element_size() + 4 * scene.tris.numel()
              + 4 * scene.table.numel())
    normals_line.update(
        ms=min(ms["kernel"]), plain_ms=min(ms["plain"]),
        bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes",
        timing=(top, s_nrm))
    emit("timing", kernel="normals", preset=kernels["grid_euler"]["preset"],
         card=smi, ms_per_call=ms, bytes=nbytes,
         bound_us_per_call=normals_line["bound_ms"] * 1e3, bound_by="bytes")
    for name, k in steps.items():
        cfg = k["cfg"]
        top, s0 = sb.init(k["host"], device="cuda")
        # lattices: 20 frames from rest end before the cube reaches the
        # plane, so the timed work is the one bound_per_substep counts
        kern_fn = k["module"].make_cuda_step(top, cfg)
        plain_fn = k["plain"](top, cfg)
        frames_k, frames_p = (20, 1) if k["lattice"] else (100, 5)
        k["timing_fn"], k["timing_s0"] = kern_fn, s0
        k["timing_top"] = top
        ms = in_turns({
            "kernel": lambda: substep_ms(kern_fn, s0, cfg, frames_k,
                                         cfg.n_substeps),
            "plain": lambda: substep_ms(plain_fn, s0, cfg, frames_p,
                                        cfg.n_substeps)})
        if k["lattice"]:
            # the same kernels from the main path's last state, the cube
            # deformed and resting on the plane
            ms["kernel_settled"] = [
                substep_ms(kern_fn, k["settled"], cfg, frames_k,
                           cfg.n_substeps) for _ in range(2)]
        k["ms"] = min(ms["kernel"])
        k["plain_ms"] = min(ms["plain"])
        k["bound_ms"], k["bound_by"] = bound_per_substep(name, top, cfg)
        emit("timing", kernel=name, preset=k["preset"], card=smi,
             ms_per_substep=ms,
             kernel_substeps_per_s=1e3 / k["ms"],
             plain_substeps_per_s=1e3 / k["plain_ms"],
             bound_us_per_substep=k["bound_ms"] * 1e3, bound_by=k["bound_by"])
    # the self-collision path, and its pair function alone, from the 64k
    # preset's state after 24 substeps
    top, s24 = sc_state
    cfg = sc["cfg"]
    p, x = cfg.self_collision, s24.x
    # its own name: the profiler below traces this step function (PR 5's
    # script traced whichever step a later loop left in kern_fn)
    sc_fn = grid_euler.make_cuda_step(top, cfg)
    plain_fn = make_stencil_step(top, cfg)
    pair_fn = blocks.make_block_pairs(p, x.shape[0], cuda)
    path_ms = in_turns({
        "kernel": lambda: substep_ms(sc_fn, s24, cfg, 10, cfg.n_substeps),
        "plain": lambda: substep_ms(plain_fn, s24, cfg, 1, 2)})
    pair_ms = in_turns({
        "kernel": lambda: events_ms(lambda: [pair_fn(x) for _ in range(50)],
                                    50),
        "plain": lambda: events_ms(
            lambda: [blocksparse.self_collision_forces_block(x, p)
                     for _ in range(2)], 2)})
    dropped, tile_pairs = diagnostics(x, p)
    sc["ms"] = min(pair_ms["kernel"])
    sc["plain_ms"] = min(pair_ms["plain"])
    c = cull(p, x)
    sc["bound_ms"], sc["bound_by"] = c["culled_bound"]
    sc["dense_bound_ms"] = c["dense_bound"][0]
    emit("timing", kernel="block_pairs", preset=sc["preset"], card=smi,
         start="24 substeps", ms_per_substep=path_ms,
         kernel_substeps_per_s=1e3 / min(path_ms["kernel"]),
         plain_substeps_per_s=1e3 / min(path_ms["plain"]),
         ms_per_pair_call=pair_ms, sum_nvalid=tile_pairs,
         dropped_pairs=dropped, kept_share=c["kept_share"],
         kept_vertex_share=c["kept_vertex_share"],
         bound_us_per_call=sc["bound_ms"] * 1e3, bound_by=sc["bound_by"],
         dense_bound_us_per_call=sc["dense_bound_ms"] * 1e3)
    # the paths past the cap and with feature planes, from rest
    for label, p in large.items():
        host, cfg = p["host"], p["cfg"]
        top, s0 = sb.init(host, device="cuda")
        s0 = with_features(top, cfg, s0)
        kern_fn = kernels[p["kernel"]]["module"].make_cuda_step(top, cfg)
        plain_fn = make_stencil_step(top, cfg)
        p["timing_fn"], p["timing_s0"] = kern_fn, s0
        p["timing_top"] = top
        ms = in_turns({
            "kernel": lambda: substep_ms(kern_fn, s0, cfg, 10,
                                         cfg.n_substeps),
            "plain": lambda: substep_ms(plain_fn, s0, cfg, 1,
                                        cfg.n_substeps)})
        p["ms"], p["plain_ms"] = min(ms["kernel"]), min(ms["plain"])
        p["bound_ms"], p["bound_by"] = bound_per_substep(p["kernel"], top,
                                                         cfg)
        emit("timing", kernel=p["kernel"], path=label, preset=p["preset"],
             card=smi, ms_per_substep=ms,
             kernel_substeps_per_s=1e3 / p["ms"],
             plain_substeps_per_s=1e3 / p["plain_ms"],
             bound_us_per_substep=p["bound_ms"] * 1e3,
             bound_by=p["bound_by"])
        del top, plain_fn
    # the wind, strain and drag paths, from rest
    for label, p in branches.items():
        host, cfg = p["host"], p["cfg"]
        k = kernels[p["kernel"]]
        top, s0 = sb.init(host, device="cuda")
        kern_fn = k["module"].make_cuda_step(top, cfg)
        plain_fn = k["plain"](top, cfg)
        frames_k, frames_p = (20, 1) if k["lattice"] else (100, 3)
        p["timing_fn"], p["timing_s0"] = kern_fn, s0
        p["timing_top"] = top
        ms = in_turns({
            "kernel": lambda: substep_ms(kern_fn, s0, cfg, frames_k,
                                         cfg.n_substeps),
            "plain": lambda: substep_ms(plain_fn, s0, cfg, frames_p,
                                        cfg.n_substeps)})
        p["ms"], p["plain_ms"] = min(ms["kernel"]), min(ms["plain"])
        p["bound_ms"], p["bound_by"] = bound_per_substep(p["kernel"], top,
                                                         cfg)
        emit("timing", kernel=p["kernel"], path=label, preset=p["preset"],
             card=smi, ms_per_substep=ms,
             kernel_substeps_per_s=1e3 / p["ms"],
             plain_substeps_per_s=1e3 / p["plain_ms"],
             bound_us_per_substep=p["bound_ms"] * 1e3,
             bound_by=p["bound_by"])
        del top, plain_fn
    # the strain sweeps of one substep alone, from the 64k banner at rest
    # stretched 15 %, every edge past its 10 % bound
    p = branches[strain_line["path"]]
    cfg = p["cfg"]
    top, s0 = sb.init(p["host"], device="cuda")
    ny, nx = top.grid_shape
    x3 = to_planes(1.15 * s0.x, ny, nx).contiguous()
    offsets = grid_offsets(top, cfg)
    masks = [_valid_mask(ny, nx, di, dj, cuda, torch.float32)
             for di, dj, _, _ in offsets]
    w2 = top.inv_mass.reshape(1, ny, nx)
    sweep_fn = grid_euler.make_strain_correction(top, cfg)
    ms = in_turns({
        "kernel": lambda: events_ms(
            lambda: [sweep_fn(x3) for _ in range(50)], 50),
        "plain": lambda: events_ms(
            lambda: [x3 + strain_limit_planes(x3, offsets, masks, w2,
                                              cfg.strain_limit)
                     for _ in range(3)], 3)})
    strain_line["ms"], strain_line["plain_ms"] = (min(ms["kernel"]),
                                                  min(ms["plain"]))
    strain_line["bound_ms"], strain_line["bound_by"] = strain_bound(top, cfg)
    emit("timing", kernel="grid_strain_sweep", path=strain_line["path"],
         card=smi, sweeps=cfg.strain_limit.iterations,
         ms_per_substep_sweeps=ms,
         bound_us_per_substep_sweeps=strain_line["bound_ms"] * 1e3,
         bound_by=strain_line["bound_by"])
    del top, s0
    # the collider paths, from their state in contact
    for label, p in collider_paths.items():
        host, cfg = p["host"], p["cfg"]
        k = kernels[p["kernel"]]
        top, _ = sb.init(host, device="cuda")
        s0 = advanced(p, p["contact_frames"], top)
        kern_fn = k["module"].make_cuda_step(top, cfg)
        plain_fn = k["plain"](top, cfg)
        frames_k = 20 if k["lattice"] else 100
        p["timing_fn"], p["timing_s0"] = kern_fn, s0
        p["timing_top"] = top
        # the plain version over 4 substeps: ms per substep alike, and the
        # float32 plain XPBD cube takes 0.15 s a substep
        ms = in_turns({
            "kernel": lambda: substep_ms(kern_fn, s0, cfg, frames_k,
                                         cfg.n_substeps),
            "plain": lambda: substep_ms(plain_fn, s0, cfg, 1, 4)})
        contacts = collider_depth(top, s0.x)[2]
        p["ms"], p["plain_ms"] = min(ms["kernel"]), min(ms["plain"])
        p["bound_ms"], p["bound_by"] = bound_per_substep(
            p["kernel"], top, cfg, contacts)
        emit("timing", kernel=p["kernel"], path=label,
             start=f"{p['contact_frames']} frames", card=smi,
             ms_per_substep=ms, kernel_substeps_per_s=1e3 / p["ms"],
             plain_substeps_per_s=1e3 / p["plain_ms"],
             vertices_in_contact=contacts,
             bound_us_per_substep=p["bound_ms"] * 1e3,
             bound_by=p["bound_by"])
        del top, plain_fn
    for name, k in steps.items():
        cfg = k["cfg"]
        starts = {"": k["timing_s0"]}
        if k["lattice"]:
            starts["settled"] = k["settled"]
        for label, s0 in starts.items():
            dev, _, sym = device_us_per_launch(k["timing_fn"], s0, cfg, 5,
                                               k["device_names"])
            per_sub = (sum(us * count for us, count in dev.values())
                       / (5 * cfg.n_substeps)
                       if len(dev) == len(k["device_names"]) else None)
            emit("timing", kernel=name, profiler_frames=5,
                 start=label or "rest",
                 device_us_per_launch={n: us for n, (us, _) in dev.items()},
                 launches={n: c for n, (_, c) in dev.items()},
                 kernel_symbols=sym, device_us_per_substep=per_sub,
                 **pass_launches(dev, name, k["timing_top"], cfg, 5,
                                 f"{name} {label or 'rest'}"))
    # the self-collision substep: block_pairs, grid_euler, and the sort and
    # partner search (every other kernel of the trace)
    cfg = sc["cfg"]
    names = sc["device_names"] + kernels["grid_euler"]["device_names"]
    dev, busy, sym = device_us_per_launch(sc_fn, s24, cfg, 5, names)
    named = (sum(us * count for us, count in dev.values())
             / (5 * cfg.n_substeps))
    emit("timing", kernel="block_pairs", profiler_frames=5,
         start="24 substeps",
         device_us_per_launch={n: us for n, (us, _) in dev.items()},
         launches={n: c for n, (_, c) in dev.items()},
         kernel_symbols=sym, other_device_us_per_substep=busy - named,
         device_us_per_substep=busy)
    # the dual form alone on the row shards (block_pairs_kernel is its
    # kernel too): device µs a launch, and of the sort and partner search
    # around it
    p_sc, x24 = sc["cfg"].self_collision, sc_state[1].x
    for n_ranks in (1, dual["ranks"]):
        ni = x24.shape[0] // n_ranks
        per_rank = []
        for r in range(n_ranks):
            xi = x24[r * ni:(r + 1) * ni]
            fn = blocks.make_block_pairs_dual(p_sc, ni, x24.shape[0], cuda)
            fn(xi, x24)
            torch.cuda.synchronize()
            dev, busy = profile_device(
                lambda: [fn(xi, x24) for _ in range(10)],
                ("block_pairs_kernel",))
            per_rank.append({
                "kernel_us": dev.get("block_pairs_kernel", (None,))[0],
                "all_device_us": busy / 10})
        emit("timing", kernel="block_pairs_dual", profiler_calls=10,
             start="24 substeps", ranks=n_ranks, card=smi,
             device_us_per_call=per_rank)
    for label, p in large.items():
        cfg = p["cfg"]
        names = kernels[p["kernel"]]["device_names"]
        if p["kernel"] == "grid_euler":
            # plain substeps on more tiles than the card holds CTAs at once
            names = names + ("grid_euler_wide_kernel",)
        if cfg.tear.enabled or cfg.plasticity.enabled:
            names = names + ("grid_feature_finish_kernel",)
        dev, busy, sym = device_us_per_launch(
            p["timing_fn"], p["timing_s0"], cfg, 3, names)
        emit("timing", kernel=p["kernel"], path=label, profiler_frames=3,
             start="rest",
             device_us_per_launch={n: us for n, (us, _) in dev.items()},
             launches={n: c for n, (_, c) in dev.items()},
             kernel_symbols=sym, device_us_per_substep=busy,
             **pass_launches(dev, p["kernel"], p["timing_top"], cfg, 3,
                             label))
    for label, p in branches.items():
        cfg = p["cfg"]
        names = kernels[p["kernel"]]["device_names"]
        if cfg.strain_limit.enabled:
            names = names + ("grid_strain_sweep_kernel",)
        dev, busy, sym = device_us_per_launch(
            p["timing_fn"], p["timing_s0"], cfg, 3, names)
        emit("timing", kernel=p["kernel"], path=label, profiler_frames=3,
             start="rest",
             device_us_per_launch={n: us for n, (us, _) in dev.items()},
             launches={n: c for n, (_, c) in dev.items()},
             kernel_symbols=sym, device_us_per_substep=busy,
             **pass_launches(dev, p["kernel"], p["timing_top"], cfg, 3,
                             label))
    for label, p in collider_paths.items():
        cfg = p["cfg"]
        dev, busy, sym = device_us_per_launch(
            p["timing_fn"], p["timing_s0"], cfg, 3,
            kernels[p["kernel"]]["device_names"])
        emit("timing", kernel=p["kernel"], path=label, profiler_frames=3,
             start=f"{p['contact_frames']} frames",
             device_us_per_launch={n: us for n, (us, _) in dev.items()},
             launches={n: c for n, (_, c) in dev.items()},
             kernel_symbols=sym, device_us_per_substep=busy,
             **pass_launches(dev, p["kernel"], p["timing_top"], cfg, 3,
                             label))
    top, s_nrm = normals_line.pop("timing")
    dev, busy = profile_device(
        lambda: [sb.normals(top, s_nrm) for _ in range(10)],
        ("vertex_normals_kernel",))
    us, launched = dev["vertex_normals_kernel"]
    normals_line["device_us"] = us
    emit("timing", kernel="normals", preset=kernels["grid_euler"]["preset"],
         profiler_calls=10, device_us_per_launch=us, launches=launched,
         device_us_per_call=busy / 10)
    require(launched == 10, f"timing normals: the trace names {launched} "
            "launches of vertex_normals_kernel, the calls made 10")
    del top, s_nrm
    emit("timing", seconds=phase_seconds())

    # block_pairs' bound_ms is the culled work's; dense_bound_ms the dense
    # sweep's (the TPU kernel's work)
    line = [{
        "name": name, "route": "cuda", "source": k["source"],
        "replaces": k["replaces"], "launches": k["launches"],
        "max_abs_err": k["err64"], "ms": k["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        "library_ms": None,   # no single PyTorch call computes a substep
        **({"dense_bound_ms": k["dense_bound_ms"]} if "dense_bound_ms" in k
           else {}),
    } for name, k in kernels.items()]
    for name, vv in variants.items():
        p = large[vv["path"]]
        line.append({
            "name": name, "route": "cuda",
            "source": kernels[vv["base"]]["source"],
            "replaces": vv["replaces"], "launches": p["launches"],
            "max_abs_err": p["err"], "ms": p["ms"], "plain_ms": p["plain_ms"],
            "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
            "library_ms": None})
    for name, vv in branch_lines.items():
        p = branches[vv["path"]]
        line.append({
            "name": name, "route": "cuda",
            "source": kernels[p["kernel"]]["source"],
            "replaces": vv["replaces"], "launches": p["launches"],
            "max_abs_err": p["err"], "ms": p["ms"], "plain_ms": p["plain_ms"],
            "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
            "library_ms": None})
    line.append({
        "name": strain_line["name"], "route": "cuda",
        "source": strain_line["source"], "replaces": strain_line["replaces"],
        "launches": branches[strain_line["path"]]["sweeps"],
        "max_abs_err": strain_line["err"], "ms": strain_line["ms"],
        "plain_ms": strain_line["plain_ms"],
        "bound_ms": strain_line["bound_ms"],
        "bound_by": strain_line["bound_by"], "library_ms": None})
    for label, p in collider_paths.items():
        line.append({
            "name": p["line"], "route": "cuda",
            "source": kernels[p["kernel"]]["source"],
            "replaces": p["replaces"], "launches": p["launches"],
            "max_abs_err": p["err"], "ms": p["ms"], "plain_ms": p["plain_ms"],
            "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
            "library_ms": None})
    line.append({
        "name": dual["name"], "route": "cuda", "source": dual["source"],
        "replaces": dual["replaces"], "launches": dual["launches"],
        "max_abs_err": dual["err"], "ms": dual["ms"],
        "plain_ms": dual["plain_ms"], "bound_ms": dual["bound_ms"],
        "bound_by": dual["bound_by"], "library_ms": None,
        "dense_bound_ms": dual["dense_bound_ms"]})
    line.append({
        "name": normals_line["name"], "route": "cuda",
        "source": normals_line["source"],
        "replaces": normals_line["replaces"],
        "launches": normals_line["launches"],
        "max_abs_err": max(normals_line["err_of"].values()),
        "ms": normals_line["ms"], "plain_ms": normals_line["plain_ms"],
        "device_us": normals_line["device_us"],
        "bound_ms": normals_line["bound_ms"],
        "bound_by": normals_line["bound_by"],
        "library_ms": None})   # no single PyTorch call computes the normals
    print(json.dumps({"kernels": line}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception as e:
        # name the phase, then fail with the traceback: nothing is swallowed
        print(json.dumps({"phase": "failed", "in": _phase["name"],
                          "error": repr(e)}), flush=True)
        print(f"chip_smoke: failed in phase {_phase['name']}",
              file=sys.stderr, flush=True)
        raise
    sys.exit(code)
