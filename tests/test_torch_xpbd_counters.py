"""The grid XPBD sweep's counting instantiation (``csrc/grid_xpbd.cu``,
launched for each substep's last Jacobi sweep while the recorder of
``softbodyunity_torch/utils/profiling.py`` is on), on the card: the
positions are the same bits with the recorder off and on, and the counts
equal a plain count of the same constraints at the same evaluation point
on a 64 x 64 curtain.  The card tests skip without a CUDA device; the file
imports no jax, so on the card:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_xpbd_counters.py
"""

import dataclasses

import pytest
import torch

import softbodyunity_torch as tsb
from softbodyunity_torch.core.config import Solver
from softbodyunity_torch.kernels import grid_xpbd, stencil
from softbodyunity_torch.utils import profiling

# the counting sweep's threshold: |C| > UNMET * rest
UNMET = 1e-3
# absolute band (m) about the threshold in which the kernel's float32 |C|
# and the plain float32 |C| may fall on either side: the two evaluation
# points differ by rounding (FMA contraction over seven sweeps, some 1e-9 m
# on a 0.63 m curtain) against a threshold of 1e-5 m
BAND = 1e-7


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


def _curtain(device, n=64, n_substeps=16):
    """``cloth_bench_64k_xpbd`` cut to ``n`` x ``n`` with a seeded start
    velocity: ``(top, cfg, state)``."""
    _, cfg = tsb.presets.build("cloth_bench_64k_xpbd")
    host = tsb.cloth_grid(n, n, spacing=0.01, mass=0.01, shear=True,
                          bend=True, pinned=("top",), springs=cfg.springs,
                          xpbd=cfg.xpbd, plane_height=-8.0,
                          origin=(0.0, 0.0, 0.0), orientation="xy")
    cfg = dataclasses.replace(cfg, n_substeps=n_substeps)
    top, state = tsb.init(host, device=device)
    g = torch.Generator().manual_seed(2**31 + 20)
    v = 0.5 * torch.rand((n * n, 3), generator=g) - 0.25
    v = torch.where(top.inv_mass[:, None].cpu() > 0, v, 0.0).to(device)
    return top, cfg, state.replace(v=v, x_prev=state.x - cfg.dt * v)


def _frames(top, cfg, state, frames, record):
    if record:
        profiling.enable()
    for _ in range(frames):
        state = tsb.step(top, cfg, state)
    counters = profiling.read().counters if record else {}
    profiling.disable()
    torch.cuda.synchronize()
    return state, counters


def _plain_counts(top, cfg, state):
    """``(checked, lo, hi)`` of one substep from ``state`` on the plain
    path: the last sweep evaluates the constraints at the position after
    ``n_iterations - 1`` sweeps; unmet counted with the threshold moved by
    -+ BAND."""
    ny, nx = top.grid_shape
    before_last = stencil.make_stencil_step(top, dataclasses.replace(
        cfg, xpbd=dataclasses.replace(cfg.xpbd,
                                      n_iterations=cfg.xpbd.n_iterations - 1)))
    x3 = stencil.to_planes(before_last(state, cfg.dt, 1).x, ny, nx)
    offsets = stencil._xpbd_offsets(cfg, top.grid_spacing, True, True)
    checked = lo = hi = 0
    for di, dj, _, rest in offsets:
        live = stencil._valid_mask(ny, nx, di, dj, x3.device, x3.dtype) > 0
        c = (stencil._edge_lengths(x3, di, dj) - rest).abs()[live]
        checked += int(live.sum())
        lo += int((c > UNMET * rest + BAND).sum())
        hi += int((c > UNMET * rest - BAND).sum())
    return checked, lo, hi


EDGES_64 = 2 * 64 * 63 + 2 * 63 ** 2 + 2 * 64 * 62   # structural, shear, bend


@pytest.mark.cuda
def test_positions_the_same_bits_with_the_recorder_on(cuda, recorder):
    """Three frames of the 64 x 64 curtain with the recorder off and on:
    positions and velocities bit for bit, the same launches."""
    top, cfg, s0 = _curtain(cuda)
    grid_xpbd.reset_launch_count()
    off, _ = _frames(top, cfg, s0, 3, False)
    launches = grid_xpbd.launch_count()
    grid_xpbd.reset_launch_count()
    on, counters = _frames(top, cfg, s0, 3, True)
    assert grid_xpbd.launch_count() == launches == (
        3 * grid_xpbd.launches_per_frame(cfg, 16, top.grid_shape))
    assert torch.equal(on.x, off.x) and torch.equal(on.v, off.v)
    assert counters["grid_xpbd.edges_checked"] > 0


@pytest.mark.cuda
def test_counts_equal_the_plain_count(cuda, recorder):
    """Four frames of one substep, each counted on the card and on the
    plain path from the card's state: the live constraints the last sweep
    evaluated, every constraint of the grid once, and those unmet by more
    than a thousandth of their rest length, within the band of rounding
    about the threshold."""
    top, cfg, state = _curtain(cuda, n_substeps=1)
    _frames(top, cfg, state, 1, False)         # both instantiations built
    _frames(top, cfg, state, 1, True)
    for _ in range(4):
        new, c = _frames(top, cfg, state, 1, True)
        checked, lo, hi = _plain_counts(top, cfg, state)
        assert checked == c["grid_xpbd.edges_checked"] == EDGES_64
        assert lo <= c["grid_xpbd.edges_unmet"] <= hi
        assert 0 < c["grid_xpbd.edges_unmet"] < checked
        state = new


@pytest.mark.cuda
def test_a_frame_counts_every_substep(cuda, recorder):
    """A frame of 16 substeps counts each substep's last sweep."""
    top, cfg, s0 = _curtain(cuda)
    _, c = _frames(top, cfg, s0, 1, True)
    assert c["grid_xpbd.edges_checked"] == 16 * EDGES_64
    assert 0 < c["grid_xpbd.edges_unmet"] < 16 * EDGES_64


@pytest.mark.cuda
def test_the_counters_zeroed_by_enable(cuda, recorder):
    """A second recording counts its own frames only."""
    top, cfg, s0 = _curtain(cuda, n_substeps=2)
    _, first = _frames(top, cfg, s0, 2, True)
    _, second = _frames(top, cfg, s0, 1, True)
    assert first["grid_xpbd.edges_checked"] == 2 * second[
        "grid_xpbd.edges_checked"]


def test_no_counter_without_a_sweep_to_count(recorder):
    """The counters' names, and on the CPU (the plain path) nothing
    counted: the counting lives in the kernel."""
    assert grid_xpbd.COUNTERS == ("edges_checked", "edges_unmet",
                                  "flag_polls")
    top, cfg, s0 = _curtain("cpu", n=8, n_substeps=2)
    assert cfg.solver == Solver.XPBD
    profiling.enable()
    tsb.step(top, cfg, s0)
    counters = profiling.read().counters
    profiling.disable()
    assert counters.get("grid_xpbd.edges_checked", 0) == 0
