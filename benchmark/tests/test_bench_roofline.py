"""The roofline's counts against a count by hand at 256 x 256."""

import json
import os

import pytest

from benchmark.roofline import grid_euler, peaks
from benchmark.tests import small


def config(name):
    with open(os.path.join(small.BENCH, "configs", name + ".json")) as f:
        return json.load(f)


def test_curtain_counts_by_hand():
    n = 256 * 256
    # structural 2 x 255 x 256, shear 2 x 255 x 255, bend 2 x 254 x 256
    edges = 130560 + 130050 + 130048
    nbytes, ops = grid_euler.counts(config("cloth64k"))
    assert nbytes == 4 * n * 13 + 16 * 6 + 16
    assert ops == 35 * edges + 22 * n
    bound, kind = grid_euler.bound_per_substep(config("cloth64k"))
    assert kind == "bytes"
    assert bound == pytest.approx(nbytes / 3.35e12)
    assert bound * 1e6 == pytest.approx(1.017, abs=1e-3)


def test_the_force_plane_counts_in_the_bytes():
    n = 256 * 256
    edges = 130560 + 130050          # no bend springs
    nbytes, ops = grid_euler.counts(config("selfcollide64k"))
    assert nbytes == 4 * n * 13 + 12 * n + 16 * 4 + 16
    assert ops == 35 * edges + 22 * n
    plain = config("selfcollide64k")
    plain["sim"]["self_collision"]["enabled"] = False
    assert grid_euler.counts(plain)[0] == nbytes - 12 * n


def test_peaks():
    assert peaks.bound_s(3.35e12, 0) == (1.0, "bytes")
    assert peaks.bound_s(0, 67e12 * 2) == (2.0, "operations")
