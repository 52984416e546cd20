"""The work of one substep of ``csrc/grid_xpbd.cu`` (the predict and
``n_iterations`` Jacobi sweeps, the last running the epilogue), counted
from the configuration file's sizes: each input byte read once, each
output byte written once, and the operations the substep's function needs.
So the count reads the same work whatever implements it: a kernel that
keeps its evaluation points on chip between sweeps, or one that streams
them through device memory every sweep, is held to the same bound.

Operations, counted from the plain XPBD substep
(``kernels/stencil.py::xpbd_substep_grid``), each add, multiply, divide,
sqrt and max as one:

- a constraint in one sweep: d 3, |d|^2 5, sqrt 1, max 1, n 3, C 1, dlam
  7, lambda 1, the two corrections 8, added at both ends 6 = 36;
- a vertex once a substep: the predict 12 and the epilogue 6 = 18;
- a vertex in one sweep: the evaluation point, the averaged update and the
  plane test, 12.

Bytes: positions, velocities, inverse masses and Jacobi weights in (3 + 3
+ 1 + 1 floats a vertex), positions and velocities out (3 + 3), the
constraint table (16 B a class) and the plane (16 B).  The sweeps' lambdas
and deltas live inside the substep: neither in nor out.  Contact work
depends on the data: the plane's response counts 0, as the vertices in
contact vary.
"""

from .peaks import bound_s

OPS_XPBD_EDGE = 36
OPS_XPBD_VERTEX_ONCE = 18
OPS_XPBD_VERTEX_SWEEP = 12


def sizes(config: dict):
    """``(vertices, constraints, constraint classes)`` of the grid."""
    scene = config["scene"]
    ny, nx = scene["ny"], scene["nx"]
    # structural (0, 1), (1, 0); shear (1, 1), (1, -1); bend (0, 2), (2, 0)
    edges = ny * (nx - 1) + (ny - 1) * nx
    classes = 2
    if scene["shear"]:
        edges += 2 * (ny - 1) * (nx - 1)
        classes += 2
    if scene["bend"]:
        edges += ny * (nx - 2) + (ny - 2) * nx
        classes += 2
    return ny * nx, edges, classes


def counts(config: dict):
    """``(bytes, operations)`` of one substep of ``config``'s scene."""
    n, edges, classes = sizes(config)
    sweeps = config["sim"]["xpbd"]["n_iterations"]
    nbytes = 4 * n * (3 + 3 + 1 + 1 + 3 + 3) + 16 * classes + 16
    ops = (sweeps * (OPS_XPBD_EDGE * edges + OPS_XPBD_VERTEX_SWEEP * n)
           + OPS_XPBD_VERTEX_ONCE * n)
    return nbytes, ops


def bound_per_substep(config: dict):
    """(least seconds one substep could take on the card, "bytes" or
    "operations")."""
    return bound_s(*counts(config))
