"""The plain reference against scenes worked by hand, and against the
program's own plain float64 path on a small curtain."""

import json
import math
import os

import pytest
import torch

from benchmark import scene
from benchmark.reference import grid_cloth
from benchmark.tests import small


def two_vertices(**sim):
    """A 1 x 2 grid: one structural spring, nothing pinned."""
    config = {
        "scene": {"nx": 2, "ny": 1, "spacing": 0.1, "mass": 0.5,
                  "pinned": [], "shear": False, "bend": False,
                  "plane_height": -1.0, "origin": [0.0, 0.0, 0.0],
                  "orientation": "xy"},
        "sim": {"solver": "euler", "dt": 0.01, "n_substeps": 1,
                "gravity": [0.0, -10.0, 0.0], "global_damping": 0.0,
                "springs": {"k_structural": 100.0, "k_shear": 0.0,
                            "k_bend": 0.0, "damping": 0.0},
                "collision": {"enable_plane": True, "friction": 0.5,
                              "restitution": 0.0},
                "self_collision": None},
    }
    config["sim"].update(sim)
    return config


def test_one_spring_by_hand():
    ref = grid_cloth.GridCloth(two_vertices())
    # stretched by 0.02 m along x: force 100 * 0.02 = 2 N toward each other
    x = torch.tensor([[0.0, 0.0, 0.0], [0.12, 0.0, 0.0]], dtype=torch.float64)
    v = torch.zeros_like(x)
    x1, v1 = ref.frame(x, v)
    a = 2.0 / 0.5                       # 4 m/s^2 along the spring
    assert v1[0].tolist() == pytest.approx([a * 0.01, -0.1, 0.0])
    assert v1[1].tolist() == pytest.approx([-a * 0.01, -0.1, 0.0])
    assert x1[0].tolist() == pytest.approx([a * 1e-4, -1e-3, 0.0])


def test_plane_contact_by_hand():
    ref = grid_cloth.GridCloth(two_vertices(
        gravity=[0.0, 0.0, 0.0],
        springs={"k_structural": 0.0, "k_shear": 0.0, "k_bend": 0.0,
                 "damping": 0.0}))
    x = torch.tensor([[0.0, -0.999, 0.0], [0.1, -0.5, 0.0]],
                     dtype=torch.float64)
    v = torch.tensor([[2.0, -1.0, 1.0], [0.0, 0.0, 0.0]], dtype=torch.float64)
    x1, v1 = ref.frame(x, v)
    # vertex 0 crosses the plane: onto it, no downward speed, half its
    # tangential speed
    assert x1[0, 1].item() == -1.0
    assert v1[0].tolist() == pytest.approx([1.0, 0.0, 0.5])
    assert v1[1].tolist() == [0.0, 0.0, 0.0]


def test_pins_hold():
    config = two_vertices()
    config["scene"]["pinned"] = ["tl"]
    x1, v1 = grid_cloth.GridCloth(config).frame(
        torch.tensor([[0.0, 0.0, 0.0], [0.1, 0.0, 0.0]], dtype=torch.float64),
        torch.ones(2, 3, dtype=torch.float64))
    assert x1[0].tolist() == [0.0, 0.0, 0.0] and v1[0].tolist() == [0, 0, 0]


def test_pair_forces_against_all_pairs():
    g = torch.Generator().manual_seed(0)
    x = torch.rand(300, 3, generator=g, dtype=torch.float64) * 0.1
    x[7] = x[8]                                   # a coincident pair
    r, k = 0.02, 60.0
    f = grid_cloth.pair_forces(x, r, k)
    diff = x[:, None, :] - x[None, :, :]
    d = torch.sqrt(torch.clamp_min((diff ** 2).sum(-1), (1e-3 * r) ** 2))
    w = torch.where(d < r, k * (r - d) / d, 0.0)
    expect = (w[..., None] * diff).sum(dim=1)
    assert torch.allclose(f, expect, rtol=0, atol=1e-12)
    assert torch.allclose(f.sum(dim=0), torch.zeros(3, dtype=torch.float64),
                          atol=1e-12)


def test_flat_normals():
    with open(os.path.join(small.BENCH, "configs", "cloth64k.json")) as f:
        config = small.shrink(json.load(f), 5)
    ref = grid_cloth.GridCloth(config)
    n = ref.normals(grid_cloth.rest_positions(config["scene"]))
    # the curtain hangs in the xy plane, rows downward: (down) x (right)
    # faces +z
    assert torch.allclose(n, torch.tensor([0.0, 0.0, 1.0],
                                          dtype=torch.float64).expand(25, 3))


@pytest.mark.parametrize("name", ["cloth64k", "selfcollide64k"])
def test_against_the_programs_plain_float64_path(name):
    """Agreement to rounding with the program's plain path (its CPU
    version) in float64, over three frames with a seeded start."""
    import softbodyunity_torch as sb

    with open(os.path.join(small.BENCH, "configs", name + ".json")) as f:
        config = small.shrink(json.load(f), 20)
    host, cfg = scene.build(sb, config)
    top, state = sb.init(host, device="cpu", dtype=torch.float64)
    v = grid_cloth.start_velocity(config, scene.episode_generator(3, 0),
                                  "cpu").double()
    state = state.replace(v=v)
    ref = grid_cloth.GridCloth(config)
    x, vr = state.x, v
    for _ in range(3):
        state = sb.step(top, cfg, state)
        x, vr = ref.frame(x, vr)
    assert (state.x - x).abs().max().item() < 1e-12
    assert (state.v - vr).abs().max().item() < 1e-9
    assert (sb.normals(top, state) - ref.normals(x)).abs().max().item() < 1e-12
    assert math.isfinite(x.sum().item())
