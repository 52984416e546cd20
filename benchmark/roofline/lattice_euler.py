"""The work of one substep of ``csrc/lattice_euler.cu`` (integrate, tet
pass and gather) on a ``tet_box`` scene, counted from the configuration
file's sizes: each input byte read once, each output byte written once,
and the operations the substep's function needs.

The lattice of ``nx ny nz`` vertices has ``(nx - 1) ny nz`` axis edges
along x (and so along y and z), one face diagonal a lattice square
(``(nx - 1)(ny - 1) nz`` squares across z, and so across x and y), in 9
index-delta groups, and ``5 (nx - 1)(ny - 1)(nz - 1)`` tets in 10 delta
patterns: for a cube of side ``n``, ``3 n^2 (n - 1)`` axis edges,
``3 n (n - 1)^2`` diagonals and ``5 (n - 1)^3`` tets.

Operations, counted from the plain banded substep (``solver/banded.py``,
``solver/step.py``), each add, multiply, divide, sqrt and max as one:

- a spring edge: d 3, |d|^2 5, sqrt 1, max 1, n 3 (a divide a component),
  dv 3, rel_v 5, fmag 4, force 3, added at both ends 6 = 34;
- a tet of the volume pass: edges 9, three cross products 27, /6 on the 9
  gradient components 9, g0 9, the volume's dot 5 and /6 1, C 1, the
  denominator (4 squared norms 20, times w 4, summed 3) 27, max 1,
  -C / max 2, the 4 corners' w s 4 and times g 12, added into dx 12 = 119;
- a vertex: the v and x update and the plane test 22; with the volume
  term, stiffness dx / count, x + dx and v + dx / dt 15.

Bytes: positions and velocities in and out (12 floats a vertex), the
inverse masses, the ownership word that stands for the edge and tet masks,
and, with the volume term, the tet count (4 B a vertex each); the edge
table (12 B a group), the tet table (16 B a pattern) and the plane (16 B).
Contact work depends on the data: the plane's response counts 0, as the
vertices in contact vary.
"""

from .peaks import bound_s

OPS_BANDED_EDGE = 34
OPS_TET = 119
OPS_EULER_VERTEX = 22
OPS_EULER_VOLUME_VERTEX = 15
EDGE_GROUPS = 9
TET_PATTERNS = 10


def sizes(config: dict):
    """``(vertices, edges, tets)`` of the configuration's box."""
    scene = config["scene"]
    a, b, c = scene["nx"], scene["ny"], scene["nz"]
    axis = (a - 1) * b * c + a * (b - 1) * c + a * b * (c - 1)
    diagonal = ((a - 1) * (b - 1) * c + (a - 1) * b * (c - 1)
                + a * (b - 1) * (c - 1))
    return a * b * c, axis + diagonal, 5 * (a - 1) * (b - 1) * (c - 1)


def counts(config: dict):
    """``(bytes, operations)`` of one substep of ``config``'s scene."""
    n_vert, n_edge, n_tet = sizes(config)
    volume = config["sim"]["volume_stiffness"] != 0.0
    per_vertex = 4 * (3 + 3 + 3 + 3) + 4 * (1 + 1 + int(volume))
    nbytes = (n_vert * per_vertex + 12 * EDGE_GROUPS
              + 16 * TET_PATTERNS * int(volume) + 16)
    ops = OPS_BANDED_EDGE * n_edge + OPS_EULER_VERTEX * n_vert
    if volume:
        ops += OPS_TET * n_tet + OPS_EULER_VOLUME_VERTEX * n_vert
    return nbytes, ops


def bound_per_substep(config: dict):
    """(least seconds one substep could take on the card, "bytes" or
    "operations")."""
    return bound_s(*counts(config))
