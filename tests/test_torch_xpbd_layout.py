"""What the XPBD kernel wrappers compute on the host, on the CPU: the grid
sweep's tile geometry (the owner rectangles and strips of
csrc/grid_common.cuh's Tile at its compiled tile, and
kernels/grid_scene.py::sweep_pattern), the lattice
launch counts (kernels/lattice_xpbd.py, lattice_euler.py, lattice_verlet.py),
and the ctypes mirrors of the C substep structs, field by field against the
sources.  The kernels
themselves run only on the card (tests/test_torch_cuda.py)."""

import re
from pathlib import Path

import numpy as np
import pytest

import softbodyunity_torch as tsb
from softbodyunity_torch.core.config import Solver, XPBDParams
from softbodyunity_torch.kernels import (grid_features, grid_scene,
                                         grid_xpbd, lattice, lattice_euler,
                                         lattice_verlet, lattice_xpbd)
from softbodyunity_torch.kernels.stencil import _xpbd_offsets

CSRC = Path(grid_xpbd.__file__).resolve().parent / "csrc"
SIX = [(0, 1), (1, 0), (1, 1), (1, -1), (0, 2), (2, 0)]
_EULER_VERLET = {Solver.SEMI_IMPLICIT_EULER: lattice_euler,
                 Solver.VERLET: lattice_verlet}


def _tile():
    """csrc/grid_common.cuh's compiled tile, (columns, rows), which
    grid_xpbd.cu's sweep uses."""
    assert "constexpr int kTileX" not in (CSRC / "grid_xpbd.cu").read_text()
    m = re.search(r"constexpr int kTileX = (\d+), kTileY = (\d+);",
                  (CSRC / "grid_common.cuh").read_text())
    return int(m.group(1)), int(m.group(2))


def _rects(offsets, tx, ty):
    """csrc/grid_xpbd.cu's OwnerRect of each offset: (r0, c0, rows, cols,
    base)."""
    out, base = [], 0
    for di, dj in offsets:
        rows, cols = ty + abs(di), tx + abs(dj)
        out.append((min(0, -di), min(0, -dj), rows, cols, base))
        base += rows * cols
    return out, base


def _frame_and_terms(offsets, tx, ty):
    """csrc/grid_xpbd.cu's Tile: the frame's halo and the shared memory of
    the frame (float4 xe, w) and the rectangles (float4 dlam, n)."""
    halo = max(max(abs(di), abs(dj)) for di, dj in offsets)
    _, terms = _rects(offsets, tx, ty)
    return halo, 16 * ((ty + 2 * halo) * (tx + 2 * halo) + terms)


def test_compiled_tiles_fit_static_shared_memory():
    """Every compiled sweep's frame and rectangles fit the 48 KB of static
    shared memory a kernel has without asking; 32 x 8 with all six offsets:
    432 frame vertices and 1,738 edge terms."""
    assert _tile() == (32, 8)
    for pattern in grid_scene.PATTERNS:
        halo, shared = _frame_and_terms(pattern, *_tile())
        assert halo == max(max(abs(a), abs(b)) for a, b in pattern)
        assert shared <= 48 * 1024
    assert _frame_and_terms(SIX, 32, 8) == (2, 16 * (432 + 1738))


def test_sweep_pattern_names_a_compiled_pattern():
    rows = [(di, dj, 0.0, 1.0) for di, dj in SIX]
    assert grid_scene.sweep_pattern(rows) == 3
    for p, pattern in enumerate(grid_scene.PATTERNS):
        assert grid_scene.sweep_pattern(
            [(di, dj, 1.0, 1.0) for di, dj in pattern]) == p
    with pytest.raises(ValueError, match="offsets"):
        grid_scene.sweep_pattern(rows[:3])
    with pytest.raises(ValueError, match="offsets"):
        grid_scene.sweep_pattern(rows[1::-1])


def test_strips_and_own_entries_cover_each_rectangle_once():
    """The sweep's split of each rectangle: thread (x, y) takes entry (y, x)
    and the strip list (rows past ty over all columns, then columns past tx
    over the tile's rows) takes the rest, each entry once."""
    tx, ty = _tile()
    rects, _ = _rects(SIX, tx, ty)
    seen = {}
    for o, (_, _, rows, cols, _) in enumerate(rects):
        for y in range(ty):
            for x in range(tx):
                seen[o, y, x] = seen.get((o, y, x), 0) + 1
    sb = 0
    for o, ((di, dj), (_, _, nr, nc, _)) in enumerate(zip(SIX, rects)):
        strip_rows = abs(di) * nc
        n = strip_rows + ty * abs(dj)
        for e in range(n):
            if e < strip_rows:
                r, c = ty + e // nc, e % nc
            else:
                r, c = (e - strip_rows) // abs(dj), tx + (e - strip_rows) % abs(dj)
            seen[o, r, c] = seen.get((o, r, c), 0) + 1
        sb += n
    want = {(o, r, c) for o, (_, _, nr, nc, _) in enumerate(rects)
            for r in range(nr) for c in range(nc)}
    assert set(seen) == want and set(seen.values()) == {1}
    # the strips take about one entry a thread: 202 for 32 x 8
    assert sb == sum(nr * nc for _, _, nr, nc, _ in rects) - 6 * tx * ty
    assert sb <= 2 * tx * ty


@pytest.mark.parametrize("ny,nx", [(53, 37), (130, 19), (16, 32), (9, 65),
                                   (24, 96)])
@pytest.mark.parametrize("offsets", [SIX, SIX[:2]], ids=["six", "structural"])
def test_owner_rectangles_cover_each_tile_and_own_each_edge_once(
        offsets, ny, nx):
    """With the sweep's index arithmetic: every edge with an endpoint in a
    tile has its owner in that tile's rectangle for the offset, inside the
    staged frame with its far end; the tiles write each edge's lambda
    exactly once; and the edges a tile evaluates past its own are those
    owned by frame vertices."""
    tx, ty = _tile()
    halo, _ = _frame_and_terms(offsets, tx, ty)
    rects, total = _rects(offsets, tx, ty)
    written = np.zeros((len(offsets), ny, nx), dtype=int)
    evaluated = 0
    for i0 in range(0, ny, ty):
        for j0 in range(0, nx, tx):
            seen = set()
            for o, ((di, dj), (r0, c0, rows, cols, base)) in enumerate(
                    zip(offsets, rects)):
                for e in range(rows * cols):
                    qi, qj = i0 + r0 + e // cols, j0 + c0 + e % cols
                    bi, bj = qi + di, qj + dj
                    if not (0 <= qi < ny and 0 <= qj < nx
                            and 0 <= bi < ny and 0 <= bj < nx):
                        continue
                    for pi, pj in ((qi, qj), (bi, bj)):   # in the frame
                        assert -halo <= pi - i0 < ty + halo
                        assert -halo <= pj - j0 < tx + halo
                    evaluated += 1
                    seen.add((o, qi, qj))
                    if i0 <= qi < i0 + ty and j0 <= qj < j0 + tx:
                        written[o, qi, qj] += 1
            # every edge with an endpoint in the tile was evaluated here
            for o, (di, dj) in enumerate(offsets):
                for pi in range(i0, min(i0 + ty, ny)):
                    for pj in range(j0, min(j0 + tx, nx)):
                        for qi, qj in ((pi, pj), (pi - di, pj - dj)):
                            if (0 <= qi < ny and 0 <= qj < nx
                                    and 0 <= qi + di < ny
                                    and 0 <= qj + dj < nx):
                                assert (o, qi, qj) in seen
    edges = 0
    for o, (di, dj) in enumerate(offsets):
        valid = np.zeros((ny, nx), dtype=bool)
        valid[max(0, -di):ny - max(0, di), max(0, -dj):nx - max(0, dj)] = True
        assert np.array_equal(written[o], valid.astype(int))
        edges += int(valid.sum())
    # the evaluations past one per edge are the frame-owned edges, a
    # fraction of the edges set by the tile's perimeter
    assert edges <= evaluated <= edges * (1 + 2.0 * (1 / tx + 1 / ty))


def test_grid_offsets_of_the_presets_take_the_six_offset_sweep():
    host, cfg = tsb.presets.build("cloth_bench_64k_xpbd")
    offs = _xpbd_offsets(cfg, 0.05, True, True)
    assert [(di, dj) for di, dj, _, _ in offs] == SIX
    assert grid_scene.sweep_pattern(offs) == 3


@pytest.mark.parametrize("n_iter,want", [(0, 2), (1, 3), (4, 9), (8, 17)])
def test_lattice_xpbd_launches_per_substep(n_iter, want):
    cfg = tsb.SimConfig(solver=Solver.XPBD,
                        xpbd=XPBDParams(n_iterations=n_iter))
    assert lattice_xpbd.launches_per_substep(None, cfg) == want


@pytest.mark.parametrize("slots", [0, 264], ids=["sweeps", "resident"])
@pytest.mark.parametrize("n_iter,strain,want,want_resident", [
    (0, False, 2, 2), (8, False, 9, 1), (0, True, 1 + 1, 1 + 1),
    (8, True, 1 + 8 + 1, 1 + 1)])
def test_grid_xpbd_launches_per_substep(n_iter, strain, want, want_resident,
                                        slots):
    """Per sweep (no resident CTA): the predict, the sweeps and the strain
    launch; resident (the 64k curtain's 256 tiles on 264 CTAs): one launch
    and the strain launch, where there are sweeps."""
    cfg = tsb.SimConfig(
        solver=Solver.XPBD, xpbd=XPBDParams(n_iterations=n_iter),
        strain_limit=tsb.StrainLimitParams(enabled=strain, iterations=4))
    assert grid_xpbd.launches_per_substep(cfg, (256, 256), slots) == (
        want_resident if slots else want)


def test_lattice_xpbd_step_needs_a_cuda_device():
    cfg = tsb.SimConfig(solver=Solver.XPBD)
    host = tsb.tet_cube(6, spacing=0.08, springs=cfg.springs, xpbd=cfg.xpbd)
    top, _ = tsb.init(host, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        lattice_xpbd.make_cuda_step(top, cfg)
    assert lattice.lattice_xpbd_applicable(top, cfg)


def _c_fields(source: str, struct: str):
    """The field names of ``struct`` in a C source, in order."""
    body = re.search(r"struct %s \{(.*?)\n\};" % struct, source, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        words = re.sub(r"\[\d+\]", "", decl).replace("*", " ").split(",")
        names.append(words[0].split()[-1])
        names += [w.strip() for w in words[1:]]
    return names


def _py_fields(cls):
    return [name for name, _ in cls._fields_]


def test_ctypes_structs_mirror_the_c_structs():
    """Each ctypes Structure the wrappers hand to a substep entry has the
    fields of its C struct, in the same order (lattice_xpbd_substep_size and
    grid_xpbd_substep_size check the sizes on the card)."""
    common = (CSRC / "grid_common.cuh").read_text()
    grid = (CSRC / "grid_xpbd.cu").read_text()
    lat = (CSRC / "lattice_xpbd.cu").read_text()
    euler = (CSRC / "lattice_euler.cu").read_text()
    verlet = (CSRC / "lattice_verlet.cu").read_text()
    pairs = [
        (common, "Colliders", grid_scene.CollidersStruct),
        (common, "Wind", grid_scene.WindStruct),
        (common, "FeatParams", grid_features.FeatParamsStruct),
        (grid, "Params", grid_xpbd._Params),
        (grid, "GridXpbdSubstep", grid_xpbd._Substep),
        (lat, "Params", lattice_xpbd._Params),
        (lat, "LatticeXpbdSubstep", lattice_xpbd._Substep),
        (euler, "Params", lattice_euler._Params),
        (euler, "LatticeEulerSubstep", lattice_euler._Substep),
        (euler, "LatticeEulerPlanes", lattice_euler._Planes),
        (verlet, "Params", lattice_verlet._Params),
        (verlet, "LatticeVerletSubstep", lattice_verlet._Substep),
        (verlet, "LatticeVerletPlanes", lattice_verlet._Planes),
    ]
    for source, name, cls in pairs:
        assert _c_fields(source, name) == _py_fields(cls), name


def _cube(volume_stiffness, solver):
    cfg = tsb.SimConfig(solver=solver, volume_stiffness=volume_stiffness)
    host = tsb.tet_cube(6, spacing=0.08, springs=cfg.springs, xpbd=cfg.xpbd)
    top, _ = tsb.init(host, device="cpu")
    return top, cfg


@pytest.mark.parametrize("volume_stiffness,want", [(0.5, 3), (0.0, 1)])
@pytest.mark.parametrize("solver", [Solver.SEMI_IMPLICIT_EULER,
                                    Solver.VERLET])
def test_lattice_euler_verlet_launches_per_substep(solver, volume_stiffness,
                                                   want):
    """Integrate, tet and gather passes; the integrate alone without the
    volume constraint.  A Verlet call adds one velocity-estimate launch."""
    module = _EULER_VERLET[solver]
    top, cfg = _cube(volume_stiffness, solver)
    assert module.launches_per_substep(top, cfg) == want
    first = int(solver == Solver.VERLET)
    assert module.launches_per_call(top, cfg, 16) == 16 * want + first
    assert module.launches_per_call(top, cfg, 1) == want + first
    assert module.launches_per_call(top, cfg, 0) == 0


@pytest.mark.parametrize("solver", [Solver.SEMI_IMPLICIT_EULER,
                                    Solver.VERLET])
def test_lattice_euler_verlet_step_needs_a_cuda_device(solver):
    top, cfg = _cube(0.5, solver)
    with pytest.raises(ValueError, match="CUDA device"):
        _EULER_VERLET[solver].make_cuda_step(top, cfg)
    assert (lattice.lattice_applicable(top, cfg)
            if solver == Solver.SEMI_IMPLICIT_EULER
            else lattice.lattice_verlet_applicable(top, cfg))
