"""What the grid Euler, Verlet and strain-sweep wrappers compute on the host,
on the CPU: the shared tile of csrc/grid_common.cuh as the tiled Euler and
Verlet substeps (csrc/grid_euler.cu, grid_verlet.cu) and the one-launch
strain sweeps use it (shared memory, the split of each owner rectangle into
the threads' own entries and the strips, the edges each tile evaluates),
the launch counts of kernels/grid_euler.py, grid_verlet.py and
grid_strain.py, the Verlet frame's buffer rotation, the ctypes mirrors of
the frame and sweep structs against the sources, and the deterministic
vertex normals (solver/normals.py) against the JAX package and the
``index_add_`` sum they replace.  The kernels themselves run only on the
card (tests/test_torch_cuda.py)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import softbodyunity_torch as tsb
from softbodyunity_torch.core.config import Solver
from softbodyunity_torch.kernels import (grid_euler, grid_scene, grid_strain,
                                         grid_verlet, grid_xpbd)
from softbodyunity_torch.solver.normals import incident_faces, vertex_normals
from softbodyunity_tpu.solver.normals import vertex_normals as j_vertex_normals

CSRC = Path(grid_euler.__file__).resolve().parent / "csrc"
COMMON = (CSRC / "grid_common.cuh").read_text()
EULER = (CSRC / "grid_euler.cu").read_text()
VERLET = (CSRC / "grid_verlet.cu").read_text()
# the tiled substep kernels, each on Tile<P> through the shared staging and
# spring terms of grid_common.cuh
TILED = {"grid_euler.cu": EULER, "grid_verlet.cu": VERLET}


def _uses_shared_tile(source: str, kernel: str) -> bool:
    """Whether ``kernel`` in ``source`` takes its tile, staging and spring
    terms from grid_common.cuh (the index arithmetic the tests below hold)."""
    body = source[source.index(kernel):]
    body = body[:body.index("\n}\n")]
    return all(call in body for call in (
        "using T = Tile<P>;", "stage_frame<T", "tile_spring_terms<P, kFeat>(",
        "tile_spring_force<P>(terms, ty, tx)"))


def _tile():
    """The compiled tile, (columns, rows)."""
    m = re.search(r"constexpr int kTileX = (\d+), kTileY = (\d+);", COMMON)
    return int(m.group(1)), int(m.group(2))


def _rects(offsets, tx, ty):
    """Tile::NR, NC and B of each offset: (r0, c0, rows, cols, base)."""
    out, base = [], 0
    for di, dj in offsets:
        rows, cols = ty + abs(di), tx + abs(dj)
        out.append((min(0, -di), min(0, -dj), rows, cols, base))
        base += rows * cols
    return out, base


def _halo(offsets):
    return max(max(abs(di), abs(dj)) for di, dj in offsets)


def _strip(di, dj, nc, tx, ty, e):
    """Tile::strip_row and strip_col of strip entry e."""
    rows = abs(di) * nc
    cols = abs(dj) if dj else 1
    if e < rows:
        return ty + e // nc, e % nc
    return (e - rows) // cols, tx + (e - rows) % cols


def _euler_terms(offsets, tx, ty):
    """The buffer of terms of the wide Euler kernel (grid_euler_wide_kernel):
    its offsets go in two groups, [0, n / 2) and [n / 2, n), through one buffer
    as large as the larger group's rectangles."""
    half = len(offsets) // 2
    return max(_rects(offsets[:half], tx, ty)[1],
               _rects(offsets[half:], tx, ty)[1])


def test_tiles_fit_static_shared_memory():
    """Every compiled pattern's frame and rectangles fit the 48 KB of static
    shared memory: the Euler and Verlet substeps stage x and v (Verlet's
    velocity estimate; two float4 a frame vertex) and the float4 terms of
    every offset (grid_euler_substep_kernel, grid_verlet_substep_kernel)
    or of the larger of two groups (grid_euler_wide_kernel), the strain
    sweeps x and w (one) and every offset's terms; 32 x 8 with all six
    offsets: 432 frame vertices, 1,738 terms, 889 in the larger Euler
    group, so that eight CTAs of the wide kernel fit an SM's 228 KB (each
    with its 1 KB the card reserves) and five of the other."""
    tx, ty = _tile()
    assert (tx, ty) == (32, 8)
    for pattern in grid_scene.PATTERNS:
        h = _halo(pattern)
        frame = (ty + 2 * h) * (tx + 2 * h)
        _, terms = _rects(pattern, tx, ty)
        assert 16 * (2 * frame + terms) <= 48 * 1024   # Euler, Verlet
        assert 16 * (2 * frame + _euler_terms(pattern, tx, ty)) <= 48 * 1024
        assert 16 * (frame + terms) <= 48 * 1024       # strain sweeps
    six = grid_scene.PATTERNS[3]
    assert _rects(six, 32, 8)[1] == 1738
    one, two = 16 * (2 * 432 + 1738), 16 * (2 * 432 + _euler_terms(six, 32, 8))
    assert (one, two) == (41632, 28048)
    assert 5 * (one + 1024) <= 228 * 1024 < 6 * (one + 1024)
    assert 8 * (two + 1024) <= 228 * 1024


@pytest.mark.parametrize("source", list(TILED))
@pytest.mark.parametrize("pattern", range(4))
def test_own_entries_and_strips_cover_each_rectangle_once(pattern, source):
    """The split of each offset's rectangle among a tile's threads (the
    Euler and Verlet substeps', the strain sweeps' and the XPBD sweep's,
    each substep kernel through grid_common.cuh's tile_spring_terms): thread
    (x, y) takes entry (y, x) of every rectangle, and the strip list (rows
    past ty over all columns, then columns past tx over the tile's rows,
    Tile::strip_row and strip_col) takes the rest, one entry a thread; each
    entry once."""
    kernel = source.replace(".cu", "_substep_kernel(")
    assert _uses_shared_tile(TILED[source], kernel)
    offsets = grid_scene.PATTERNS[pattern]
    tx, ty = _tile()
    rects, total = _rects(offsets, tx, ty)
    seen = {}
    for o, (_, _, nr, nc, _) in enumerate(rects):
        for y in range(ty):
            for x in range(tx):
                seen[o, y, x] = seen.get((o, y, x), 0) + 1
    n_strips = 0
    for o, ((di, dj), (_, _, nr, nc, _)) in enumerate(zip(offsets, rects)):
        s = abs(di) * nc + ty * abs(dj)
        for e in range(s):
            key = (o, *_strip(di, dj, nc, tx, ty, e))
            seen[key] = seen.get(key, 0) + 1
        n_strips += s
    want = {(o, r, c) for o, (_, _, nr, nc, _) in enumerate(rects)
            for r in range(nr) for c in range(nc)}
    assert set(seen) == want and set(seen.values()) == {1}
    assert n_strips == total - len(offsets) * tx * ty
    assert n_strips <= tx * ty   # at most one strip entry a thread


@pytest.mark.parametrize("source", list(TILED))
@pytest.mark.parametrize("ny,nx", [(53, 37), (300, 5), (16, 32), (9, 65)])
@pytest.mark.parametrize("pattern", range(4))
def test_tiles_evaluate_each_edge_with_an_endpoint_in_them(pattern, ny,
                                                           nx, source):
    """With the kernels' index arithmetic (the Euler and Verlet substeps
    take it from grid_common.cuh): every edge with an endpoint in a
    tile has its owner in that tile's rectangle for the offset, both ends
    inside the staged frame; the tiles write each edge's feature entries
    exactly once (the tile of its owner); and the evaluations past one an
    edge are the frame-owned edges, a fraction set by the tile's
    perimeter."""
    assert _uses_shared_tile(TILED[source],
                             source.replace(".cu", "_substep_kernel("))
    offsets = grid_scene.PATTERNS[pattern]
    tx, ty = _tile()
    halo = _halo(offsets)
    rects, _ = _rects(offsets, tx, ty)
    written = np.zeros((len(offsets), ny, nx), dtype=int)
    evaluated = 0
    for i0 in range(0, ny, ty):
        for j0 in range(0, nx, tx):
            seen = set()
            for o, ((di, dj), (r0, c0, rows, cols, _)) in enumerate(
                    zip(offsets, rects)):
                for e in range(rows * cols):
                    qi, qj = i0 + r0 + e // cols, j0 + c0 + e % cols
                    bi, bj = qi + di, qj + dj
                    if not (0 <= qi < ny and 0 <= qj < nx
                            and 0 <= bi < ny and 0 <= bj < nx):
                        continue
                    for pi, pj in ((qi, qj), (bi, bj)):
                        assert -halo <= pi - i0 < ty + halo
                        assert -halo <= pj - j0 < tx + halo
                    evaluated += 1
                    seen.add((o, qi, qj))
                    if i0 <= qi < i0 + ty and j0 <= qj < j0 + tx:
                        written[o, qi, qj] += 1
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
    assert edges <= evaluated <= edges * (1 + 2.0 * (1 / tx + 1 / ty))


def _cfg(solver, strain=False, iterations=4, feature=False, wind=False,
         self_collision=False):
    return tsb.SimConfig(
        solver=solver,
        strain_limit=tsb.StrainLimitParams(enabled=strain,
                                           iterations=iterations),
        tear=tsb.TearParams(enabled=feature),
        wind=tsb.WindParams(velocity=(1.0, 0.0, 0.0), drag=0.2, lift=0.5)
        if wind else tsb.WindParams(),
        self_collision=tsb.SelfCollisionParams(enabled=self_collision,
                                               method="block"))


@pytest.mark.parametrize("calls", ["frame", "substep"])
@pytest.mark.parametrize("wind", [False, True])
@pytest.mark.parametrize("feature", [False, True])
@pytest.mark.parametrize("strain,iterations,per_sub", [
    (False, 4, 1), (True, 4, 2), (True, 0, 2), (True, 9, 2)])
@pytest.mark.parametrize("module", [grid_euler, grid_verlet],
                         ids=["euler", "verlet"])
def test_grid_launches_per_substep_and_frame(module, strain, iterations,
                                             per_sub, feature, wind, calls):
    """The substep launch, and under the strain limit one more, which runs
    every sweep (with none, the epilogue alone); a frame adds the
    frame-end feature update.  The wind adds no launch, and neither does
    the call form: a frame from one C call, or one call a substep (with
    self-collision, whose block_pairs launch counts in kernels/blocks.py)."""
    solver = (Solver.SEMI_IMPLICIT_EULER if module is grid_euler
              else Solver.VERLET)
    cfg = _cfg(solver, strain, iterations, feature, wind,
               self_collision=calls == "substep")
    assert grid_strain.sweeps(cfg) == int(strain)
    assert grid_strain.n_sweeps(cfg) == max(iterations, 1)
    assert module.launches_per_substep(cfg) == per_sub
    assert module.launches_per_frame(cfg, 16) == 16 * per_sub + int(feature)
    assert module.launches_per_frame(cfg, 0) == 0


@pytest.mark.parametrize("slots", [0, 264], ids=["sweeps", "resident"])
@pytest.mark.parametrize("strain", [False, True])
def test_grid_xpbd_strain_is_one_launch(strain, slots):
    """The strain sweeps add one launch to either schedule: the predict and
    8 sweeps, or the resident launch (256 tiles on 264 CTAs)."""
    cfg = _cfg(Solver.XPBD, strain, 4).replace(
        xpbd=tsb.XPBDParams(n_iterations=8))
    assert grid_xpbd.launches_per_substep(cfg, (256, 256), slots) == (
        (1 if slots else 1 + 8) + int(strain))


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


def test_ctypes_structs_mirror_the_frame_and_sweep_structs():
    """The structs of grid_euler_substeps, grid_verlet_substeps and of the
    strain sweeps, field by field against the sources (the libraries'
    *_size functions check the sizes on the card)."""
    for source, name, cls in (
            (EULER, "Params", grid_euler._Params),
            (EULER, "GridEulerFrame", grid_euler._Frame),
            (VERLET, "Params", grid_verlet._Params),
            (VERLET, "GridVerletFrame", grid_verlet._Frame),
            (COMMON, "StrainSweeps", grid_strain.SweepsStruct),
            (COMMON, "StrainParams", grid_strain.StrainParamsStruct)):
        assert _c_fields(source, name) == [n for n, _ in cls._fields_], name


@pytest.mark.parametrize("strain", [False, True])
def test_verlet_frame_rotates_three_buffers(strain):
    """grid_verlet.buffers, as grid_verlet_substeps rotates them: each
    substep reads (x, x_prev) and writes out, three distinct buffers;
    without the strain limit (x, xp, out) <- (out, x, xp) after it, and
    under it the last sweep writes the new x over xp, (x, xp) <- (xp, x),
    out staying; a frame starts from buffers 0 and 1."""
    assert grid_verlet.buffers(0, strain)[:2] == (0, 1)
    for k in range(12):
        x, xp, out = grid_verlet.buffers(k, strain)
        assert sorted((x, xp, out)) == [0, 1, 2]
        want = (xp, x, out) if strain else (out, x, xp)
        assert grid_verlet.buffers(k + 1, strain) == want


def test_grid_euler_step_needs_a_cuda_device():
    host = tsb.cloth_grid(8, 8, spacing=0.05)
    cfg = _cfg(Solver.SEMI_IMPLICIT_EULER, strain=True)
    top, _ = tsb.init(host, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        grid_euler.make_cuda_step(top, cfg)
    with pytest.raises(ValueError, match="CUDA device"):
        grid_euler.make_strain_correction(top, cfg)


def _index_add_normals(triangles, x):
    """The sum the normals made before: index_add_, a corner at a time."""
    p0, p1, p2 = (x[triangles[:, c]] for c in range(3))
    fn = torch.linalg.cross(p1 - p0, p2 - p0)
    out = torch.zeros_like(x)
    for c in range(3):
        out.index_add_(0, triangles[:, c], fn)
    norm = torch.linalg.vector_norm(out, dim=1)
    return out / torch.clamp_min(norm, 1e-12)[:, None]


def _seeded_cloth(seed=11):
    host = tsb.cloth_grid(17, 23, spacing=0.1, orientation="xy")
    rng = np.random.default_rng(seed)
    x = host.positions0 + 0.03 * rng.standard_normal(host.positions0.shape)
    return host, x


def test_normals_match_jax_on_a_seeded_cloth():
    """float32, against the JAX package's segment_sum normals: 1e-5, the
    twin tolerance of tests/test_torch_port.py (sums in another order, a
    few ulps magnified by normalising near-flat sums)."""
    host, x = _seeded_cloth()
    tri = torch.tensor(host.triangles, dtype=torch.int64)
    got = vertex_normals(tri, torch.tensor(x, dtype=torch.float32)).numpy()
    want = np.asarray(j_vertex_normals(jnp.asarray(host.triangles),
                                       jnp.asarray(x, jnp.float32)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_normals_are_the_index_add_sum_to_the_bit(dtype):
    """The fixed-order gather adds each vertex's faces in index_add_'s
    order on the CPU (corner 0 over all faces, then corners 1 and 2), so
    it gives the old sum's bits: on the seeded cloth and on a random mesh
    of high valence; through api.normals, whose table is built once a
    scene."""
    host, x = _seeded_cloth()
    rng = np.random.default_rng(2)
    meshes = [(torch.tensor(host.triangles, dtype=torch.int64),
               torch.tensor(x, dtype=dtype)),
              (torch.tensor(rng.integers(0, 150, (2000, 3))),
               torch.tensor(rng.standard_normal((160, 3)), dtype=dtype))]
    for tri, xt in meshes:
        assert torch.equal(vertex_normals(tri, xt),
                           _index_add_normals(tri, xt))
    top, s0 = tsb.init(host, device="cpu", dtype=dtype)
    s = s0.replace(x=torch.tensor(x, dtype=dtype))
    assert torch.equal(tsb.normals(top, s),
                       _index_add_normals(top.triangles, s.x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_normals_on_a_pole_mesh(dtype):
    """A fan of 64 faces round one pole on a jittered disc: the table is
    as wide as the pole's valence and the gather is index_add_'s sum to
    the bit; the float32 result matches the JAX normals at 1e-5."""
    n_ring = 64
    ring = np.arange(1, n_ring + 1)
    tri_np = np.stack([np.zeros(n_ring, np.int64), ring,
                       np.roll(ring, -1)], axis=1)
    angle = 2.0 * np.pi * np.arange(n_ring) / n_ring
    rng = np.random.default_rng(5)
    x_np = np.concatenate([[[0.0, 0.0, 0.4]], np.stack(
        [np.cos(angle), np.sin(angle), np.zeros(n_ring)], axis=1)])
    x_np = x_np + 0.02 * rng.standard_normal(x_np.shape)
    tri = torch.tensor(tri_np)
    xt = torch.tensor(x_np, dtype=dtype)
    assert incident_faces(tri, n_ring + 1).shape == (n_ring + 1, n_ring)
    got = vertex_normals(tri, xt)
    assert torch.equal(got, _index_add_normals(tri, xt))
    if dtype == torch.float32:
        want = np.asarray(j_vertex_normals(jnp.asarray(tri_np),
                                           jnp.asarray(x_np, jnp.float32)))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_incident_face_table():
    """Row v lists v's faces, corner 0 over all faces first, then corners 1
    and 2, padded with the zero face F."""
    tri = torch.tensor([[0, 1, 2], [2, 1, 3], [3, 0, 2]])
    table = incident_faces(tri, 5)
    assert table.tolist() == [[0, 2, 3], [0, 1, 3], [1, 0, 2], [2, 1, 3],
                              [3, 3, 3]]
