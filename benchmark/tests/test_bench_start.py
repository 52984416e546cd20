"""The seeded start states: the same for one seed, different across seeds
and episodes, and within the stated speed."""

import json
import os

import torch

from benchmark import scene
from benchmark.reference import grid_cloth
from benchmark.tests import small


def config():
    with open(os.path.join(small.BENCH, "configs", "cloth64k.json")) as f:
        return small.shrink(json.load(f), 24)


def velocity(seed, episode):
    return grid_cloth.start_velocity(
        config(), scene.episode_generator(seed, episode), "cpu")


def test_one_seed_repeats():
    assert torch.equal(velocity(5, 0), velocity(5, 0))
    big = 2 ** 31 + 12345
    assert torch.equal(velocity(big, 3), velocity(big, 3))


def test_seeds_and_episodes_differ():
    assert not torch.equal(velocity(5, 0), velocity(6, 0))
    assert not torch.equal(velocity(5, 0), velocity(5, 1))
    assert scene.episode_seed(2 ** 70, 1) != scene.episode_seed(2 ** 70, 2)
    assert 0 <= scene.episode_seed(2 ** 70, 1) < 2 ** 63


def test_speed_and_pins():
    raw = velocity(11, 4)
    assert raw.dtype == torch.float32 and raw.shape == (24 * 24, 3)
    speed = raw.double().norm(dim=1)
    assert abs(float(speed.max()) - 0.5) < 1e-6
    assert torch.all(speed[:24] == 0.0)          # the pinned top row
