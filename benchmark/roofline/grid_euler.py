"""The work of one substep of ``csrc/grid_euler.cu``, counted from the
configuration file's sizes: each input byte read once, each output byte
written once, and the operations the substep's function needs.

Operations, counted from the plain semi-implicit Euler substep, each add,
multiply, divide, sqrt and max as one:

- a spring edge: d 3, |d|^2 5, sqrt 1, max 1, reciprocal 1, n 3, dv 3,
  rel_v 5, fmag 4, force 3, added at both ends 6 = 35;
- a vertex: the v and x update and the plane test, 22.

Bytes: positions, velocities and inverse masses in (3 + 3 + 1 floats a
vertex), positions and velocities out (3 + 3), the spring table (16 B an
offset) and the plane (16 B); with self-collision, the force plane that
the substep reads (3 floats a vertex).  Contact work depends on the data:
the plane's response counts 0, as the vertices in contact vary.
"""

from .peaks import bound_s

OPS_SPRING_EDGE = 35
OPS_EULER_VERTEX = 22


def counts(config: dict):
    """``(bytes, operations)`` of one substep of ``config``'s scene."""
    scene = config["scene"]
    ny, nx = scene["ny"], scene["nx"]
    n = ny * nx
    # structural (0, 1), (1, 0); shear (1, 1), (1, -1); bend (0, 2), (2, 0)
    edges = ny * (nx - 1) + (ny - 1) * nx
    n_off = 2
    if scene["shear"]:
        edges += 2 * (ny - 1) * (nx - 1)
        n_off += 2
    if scene["bend"]:
        edges += ny * (nx - 2) + (ny - 2) * nx
        n_off += 2
    nbytes = 4 * n * (3 + 3 + 1 + 3 + 3) + 16 * n_off + 16
    if (config["sim"].get("self_collision") or {}).get("enabled"):
        nbytes += 4 * 3 * n
    ops = OPS_SPRING_EDGE * edges + OPS_EULER_VERTEX * n
    return nbytes, ops


def bound_per_substep(config: dict):
    """(least seconds one substep could take on the card, "bytes" or
    "operations")."""
    return bound_s(*counts(config))
