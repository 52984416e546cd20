"""The grid XPBD substep's two schedules (``csrc/grid_xpbd.cu``): one
resident launch a substep, where every 32 x 8 tile of the grid fits on the
card at once, and the predict launch and one launch per Jacobi sweep
elsewhere.  On the CPU: the plan as a function of the grid's tiles and the
card's resident CTAs, the launch counts that follow it, the counters'
names.  On the card: the resident launch bit for bit against the per-sweep
launches on the 64k curtain under every instantiation that fits there,
with the recorder off and on, its counts, NaN-poisoned scratch and flags,
repeats, and a 262k grid on the per-sweep launches.  The card tests skip
without a CUDA device; the file imports no jax, so on the card:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_xpbd_resident.py
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import softbodyunity_torch as tsb
from softbodyunity_torch.core.config import (CollisionParams,
                                             PlasticityParams,
                                             SelfCollisionParams, Solver,
                                             StrainLimitParams, TearParams,
                                             WindParams)
from softbodyunity_torch.kernels import grid_xpbd
from softbodyunity_torch.utils import profiling

CSRC = Path(grid_xpbd.__file__).resolve().parent / "csrc"
# the H100's SMs, and the CTAs an SM that the resident kernel's launch
# bounds promise
H100_SLOTS = 132 * 2


def _cfg(n_iter=8, strain=False, feature=False):
    return tsb.SimConfig(
        solver=Solver.XPBD,
        xpbd=tsb.XPBDParams(n_iterations=n_iter),
        strain_limit=StrainLimitParams(enabled=strain, iterations=4),
        tear=TearParams(enabled=feature))


# --- on the CPU: the plan and the counts ------------------------------------

@pytest.mark.parametrize("shape,want", [
    ((256, 256), 256), ((512, 512), 1024), ((1024, 1024), 4096),
    ((53, 37), 7 * 2), ((130, 19), 17), ((8, 32), 1), ((9, 33), 4),
    ((1, 1), 1)])
def test_tiles_of_a_grid(shape, want):
    """One CTA a 32 x 8 tile, the ragged last tile in each direction
    included."""
    assert grid_xpbd.tiles(shape) == want


def test_the_tile_is_the_sweeps():
    m = re.search(r"constexpr int kTileX = (\d+), kTileY = (\d+);",
                  (CSRC / "grid_common.cuh").read_text())
    assert grid_xpbd.TILE == (int(m.group(2)), int(m.group(1)))


@pytest.mark.parametrize("shape,slots,n_iter,want", [
    ((256, 256), H100_SLOTS, 8, True),    # the 64k curtain: 256 of 264
    ((256, 256), 256, 8, True),           # exactly full
    ((256, 256), 255, 8, False),          # one tile short
    ((256, 256), 0, 8, False),            # no occupancy: per sweep
    ((256, 256), H100_SLOTS, 1, True),
    ((256, 256), H100_SLOTS, 0, False),   # no sweep: the epilogue launch
    ((512, 512), H100_SLOTS, 8, False),   # 262k: 1024 tiles
    ((512, 512), 3 * 132, 8, False),
    ((1024, 1024), H100_SLOTS, 8, False),
    ((53, 37), H100_SLOTS, 8, True),
    ((53, 37), 13, 8, False)])
def test_plan_is_a_function_of_tiles_and_occupancy(shape, slots, n_iter,
                                                   want):
    """Resident exactly where the grid has Jacobi sweeps and its tiles fit
    the card's resident CTAs."""
    assert grid_xpbd.plan(_cfg(n_iter), shape, slots) is want
    assert grid_xpbd.plan(_cfg(n_iter), shape, slots) == (
        n_iter > 0 and grid_xpbd.tiles(shape) <= slots)


@pytest.mark.parametrize("slots", [0, H100_SLOTS], ids=["sweeps",
                                                        "resident"])
@pytest.mark.parametrize("shape", [(256, 256), (512, 512)],
                         ids=["64k", "262k"])
@pytest.mark.parametrize("n_iter,strain", [(0, False), (1, False),
                                           (8, False), (0, True),
                                           (8, True)])
def test_launches_per_substep_follow_the_plan(n_iter, strain, shape, slots):
    """A resident substep is one launch (and the strain launch after it);
    a per-sweep substep the predict and max(n_iterations, 1) sweeps (with
    the strain limit n_iterations, then the strain launch)."""
    cfg = _cfg(n_iter, strain)
    sweeps = n_iter if strain else max(n_iter, 1)
    resident = grid_xpbd.plan(cfg, shape, slots)
    want = 1 + int(strain) + (0 if resident else sweeps)
    assert grid_xpbd.launches_per_substep(cfg, shape, slots) == want
    assert resident == (shape == (256, 256) and slots > 0 and n_iter > 0)


@pytest.mark.parametrize("feature", [False, True])
@pytest.mark.parametrize("slots", [0, H100_SLOTS], ids=["sweeps",
                                                        "resident"])
def test_launches_per_frame_follow_the_plan(slots, feature):
    """A frame: each substep's launches, plus the frame-end feature
    update; none without substeps."""
    cfg = _cfg(8, feature=feature)
    per_sub = 1 if slots else 9
    assert grid_xpbd.launches_per_frame(cfg, 16, (256, 256), slots) == (
        16 * per_sub + int(feature))
    assert grid_xpbd.launches_per_frame(cfg, 0, (256, 256), slots) == 0


def test_the_resident_kernel_keeps_the_readers_names():
    """The benchmark's sweep reader matches ``grid_xpbd_sweep_kernel`` and
    its roofline ``grid_xpbd``: the resident kernel's name starts with
    both; its launch bounds promise two CTAs an SM."""
    src = (CSRC / "grid_xpbd.cu").read_text()
    assert re.search(r"__launch_bounds__\(kTileX \* kTileY, 2\)\s+"
                     r"grid_xpbd_sweep_kernel_resident\(", src)
    assert "cudaLaunchCooperativeKernel" in src


def test_counter_names_follow_the_kernel():
    """COUNTERS in the order of csrc/grid_xpbd.cu's Counter enum."""
    body = re.search(r"enum Counter \{(.*?)\};",
                     (CSRC / "grid_xpbd.cu").read_text(), re.S).group(1)
    names = re.findall(r"^\s*k(\w+)", body, re.M)
    snake = [re.sub(r"(?<!^)([A-Z])", r"_\1", n).lower() for n in names]
    assert tuple(snake[:-1]) == grid_xpbd.COUNTERS
    assert snake[-1] == "counters"


def test_reset_zeroes_the_resident_count():
    profiling.add(grid_xpbd.RESIDENT, 5)
    profiling.add("grid_xpbd", 7)
    assert grid_xpbd.resident_substep_count() >= 5
    grid_xpbd.reset_launch_count()
    assert grid_xpbd.resident_substep_count() == 0
    assert grid_xpbd.launch_count() == 0


def test_the_cpu_path_runs_no_resident_substep():
    """On the CPU (the plain path) no substep is resident."""
    host, cfg = tsb.presets.build("cloth_xpbd")
    top, s0 = tsb.init(host, device="cpu")
    grid_xpbd.reset_launch_count()
    tsb.step(top, cfg, s0)
    assert grid_xpbd.resident_substep_count() == 0
    assert grid_xpbd.launch_count() == 0


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the "
                    "card")
    return torch.device("cuda")


@pytest.fixture
def recorder():
    profiling.disable()
    yield profiling
    profiling.disable()


def _rot_z(deg):
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


BRANCHES = ("plain", "tear", "plastic", "wind", "strain", "colliders",
            "force")


def _curtain(branch, n_iter, device, preset="cloth_bench_64k_xpbd"):
    """The preset (its solver XPBD) with ``n_iter`` sweeps and the branch's
    feature, from a seeded start velocity: ``(top, cfg, state)``."""
    host, cfg = tsb.presets.build(preset)
    cfg = cfg.replace(solver=Solver.XPBD, xpbd=dataclasses.replace(
        cfg.xpbd, n_iterations=n_iter))
    if branch == "tear":
        cfg = cfg.replace(tear=TearParams(enabled=True, strain_limit=0.01))
    elif branch == "plastic":
        cfg = cfg.replace(plasticity=PlasticityParams(
            enabled=True, yield_strain=0.002, creep=0.3))
    elif branch == "wind":
        cfg = cfg.replace(wind=WindParams(velocity=(2.0, 0.5, 1.0), drag=0.3,
                                          lift=0.8))
    elif branch == "strain":
        cfg = cfg.replace(strain_limit=StrainLimitParams(
            enabled=True, max_stretch=0.01, iterations=4))
    elif branch == "colliders":
        # a capsule through the curtain's middle and a box turned 30
        # degrees through its lower left: in contact from the first frame
        cfg = cfg.replace(collision=CollisionParams(
            enable_plane=True, enable_capsules=True, enable_boxes=True,
            friction=0.3))
        host = tsb.add_colliders(
            host, capsule_p0=[[1.28, -1.2, -0.3]],
            capsule_p1=[[1.28, -1.2, 0.3]], capsule_radii=[0.1],
            box_centers=[[0.6, -2.0, 0.0]], box_half_extents=[[0.15, 0.1,
                                                                0.05]],
            box_rotations=[_rot_z(30.0)],
            capsule_velocities=[[0.3, 0.0, 0.1]],
            box_velocities=[[0.0, 0.1, -0.2]])
    elif branch == "force":
        cfg = cfg.replace(self_collision=SelfCollisionParams(
            enabled=True, method="block", radius=0.008, stiffness=60.0,
            cell_size=0.32, block_partners=96))
    top, state = tsb.init(host, device=device)
    if branch in ("tear", "plastic"):
        state = tsb.api.ensure_plastic_state(
            top, cfg, tsb.api.ensure_tear_state(top, cfg, state))
    g = torch.Generator().manual_seed(2**31 + 21)
    n = state.x.shape[0]
    v = 0.5 * torch.rand((n, 3), generator=g) - 0.25
    v = torch.where(top.inv_mass[:, None].cpu() > 0, v, 0.0).to(device)
    return top, cfg, state.replace(v=v, x_prev=state.x - cfg.dt * v)


def _build(top, cfg, monkeypatch, resident):
    """The step function on the resident launch or, forced through its
    plan (no resident CTA), on the per-sweep launches."""
    with monkeypatch.context() as m:
        if not resident:
            m.setattr(grid_xpbd, "resident_slots", lambda: 0)
        fn = grid_xpbd.make_cuda_step(top, cfg)
    assert fn.resident is resident
    return fn


def _run(fn, cfg, state, frames, record, keep=(1, 10, 30)):
    """``frames`` frames; the states after the frames in ``keep``, the
    counters, and the launches and resident substeps counted."""
    grid_xpbd.reset_launch_count()
    if record:
        profiling.enable()
    kept = {}
    for f in range(1, frames + 1):
        state = fn(state, cfg.dt, cfg.n_substeps)
        if f in keep:
            kept[f] = state
    counters = profiling.read().counters if record else {}
    profiling.disable()
    torch.cuda.synchronize()
    return (kept, counters, grid_xpbd.launch_count(),
            grid_xpbd.resident_substep_count())


def _same(a, b):
    """The fields that differ in bits, of x, v and the feature planes."""
    diff = []
    for f in ("x", "v", "edge_alive", "rest_scale"):
        p, q = getattr(a, f), getattr(b, f)
        if p is None and q is None:
            continue
        if not torch.equal(p, q):
            diff.append(f)
    return diff


@pytest.mark.cuda
@pytest.mark.parametrize("record", [False, True], ids=["off", "recorder"])
@pytest.mark.parametrize("n_iter", [1, 2, 8])
@pytest.mark.parametrize("branch", BRANCHES)
def test_resident_is_the_per_sweep_launches_to_the_bit(
        cuda, recorder, monkeypatch, branch, n_iter, record):
    """The 64k curtain under each instantiation that fits there (plain,
    tearing, plasticity, wind, strain limit, capsule and box colliders,
    the self-collision force plane) and 1, 2 and 8 sweeps: x, v and the
    feature planes after frames 1, 10 and 30 equal the per-sweep launches'
    bit for bit, with the recorder off and on; one launch a substep (and
    the strain launch), every substep resident; the counters of the last
    sweep equal."""
    top, cfg, s0 = _curtain(branch, n_iter, cuda)
    shape = top.grid_shape
    n_sub = cfg.n_substeps
    want, c_want, l_want, r_want = _run(
        _build(top, cfg, monkeypatch, False), cfg, s0, 30, record)
    got, c_got, l_got, r_got = _run(
        _build(top, cfg, monkeypatch, True), cfg, s0, 30, record)
    for f in (1, 10, 30):
        assert _same(got[f], want[f]) == [], f
    assert l_want == 30 * grid_xpbd.launches_per_frame(cfg, n_sub, shape, 0)
    assert l_got == 30 * grid_xpbd.launches_per_frame(cfg, n_sub, shape)
    assert l_got == 30 * (n_sub * (1 + int(branch == "strain"))
                          + int(branch in ("tear", "plastic")))
    assert (r_want, r_got) == (0, 30 * n_sub)
    if record:
        for name in ("edges_checked", "edges_unmet"):
            assert c_got[f"grid_xpbd.{name}"] == c_want[f"grid_xpbd.{name}"]
        assert c_got["grid_xpbd.edges_checked"] > 0
        assert c_want["grid_xpbd.flag_polls"] == 0
        assert c_got["grid_xpbd.flag_polls"] >= 0
    assert float((want[30].x - s0.x).abs().max()) > 1e-3


def _poison_allocator(device):
    """Fill the caching allocator's free blocks with NaN, so the tensors
    allocated next start as NaN."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    held = [torch.full((n,), float("nan"), device=device)
            for n in [256 * 1024] * 64 + [16 * 1024 * 1024] * 16]
    del held
    torch.cuda.synchronize(device)


@pytest.mark.cuda
@pytest.mark.parametrize("branch", ["plain", "tear", "strain", "force"])
def test_resident_reads_no_unwritten_memory(cuda, monkeypatch, branch):
    """Scratch planes from NaN-filled allocations and stage flags filled
    with NaN's bits, before the first launch and again after many: the
    same bits as a clean run."""
    top, cfg, s0 = _curtain(branch, 8, cuda)
    first = _run(_build(top, cfg, monkeypatch, True), cfg, s0, 10,
                 False)[0][10]
    _poison_allocator(cuda)
    fn = _build(top, cfg, monkeypatch, True)
    fn.flags.view(torch.float32).fill_(float("nan"))
    poisoned = _run(fn, cfg, s0, 10, False)[0][10]
    fn.flags.view(torch.float32).fill_(float("nan"))
    again = _run(fn, cfg, s0, 10, False)[0][10]
    assert _same(poisoned, first) == [] and _same(again, first) == []
    assert bool(torch.isfinite(first.x).all())


@pytest.mark.cuda
@pytest.mark.parametrize("branch", ["plain", "tear", "force"])
def test_resident_repeats_bit_equal(cuda, monkeypatch, branch):
    """24 runs of the same frame from one state give one result to the
    bit: a flag that let a tile read a neighbour's plane early, or a
    shared-memory race, would show as runs that differ."""
    top, cfg, s0 = _curtain(branch, 8, cuda)
    fn = _build(top, cfg, monkeypatch, True)
    want = fn(s0, cfg.dt, cfg.n_substeps)
    for k in range(23):
        assert _same(fn(s0, cfg.dt, cfg.n_substeps), want) == [], k


@pytest.mark.cuda
def test_a_262k_grid_takes_the_per_sweep_launches(cuda, monkeypatch):
    """512 x 512 is 1,024 tiles, past the card's resident CTAs: the plan
    keeps the predict and one launch a sweep, as before; forced resident,
    the cooperative launch is refused, never run another way."""
    top, cfg, s0 = _curtain("plain", 8, cuda, "cloth_bench_262k")
    assert grid_xpbd.resident_slots() < grid_xpbd.tiles(top.grid_shape)
    fn = grid_xpbd.make_cuda_step(top, cfg)
    assert fn.resident is False
    _, _, launches, resident = _run(fn, cfg, s0, 2, False)
    assert launches == 2 * cfg.n_substeps * (1 + 8)
    assert launches == 2 * grid_xpbd.launches_per_frame(
        cfg, cfg.n_substeps, top.grid_shape)
    assert resident == 0
    monkeypatch.setattr(grid_xpbd, "resident_slots", lambda: 1 << 30)
    forced = grid_xpbd.make_cuda_step(top, cfg)
    assert forced.resident is True
    with pytest.raises(RuntimeError, match="cudaError"):
        forced(s0, cfg.dt, 1)


@pytest.mark.cuda
def test_without_sweeps_the_epilogue_launch_stays(cuda):
    """n_iterations = 0 plans no resident launch: the predict and the
    epilogue launch a substep."""
    top, cfg, s0 = _curtain("plain", 0, cuda)
    fn = grid_xpbd.make_cuda_step(top, cfg)
    assert fn.resident is False
    _, _, launches, resident = _run(fn, cfg, s0, 1, False)
    assert (launches, resident) == (2 * cfg.n_substeps, 0)


@pytest.mark.cuda
def test_the_64k_curtain_fits_the_card(cuda):
    """Every instantiation holds at least two CTAs an SM, so the curtain's
    256 tiles are resident under the recorder too."""
    props = torch.cuda.get_device_properties(cuda)
    assert grid_xpbd.resident_slots() >= 2 * props.multi_processor_count
    assert grid_xpbd.resident_slots() >= grid_xpbd.tiles((256, 256))
