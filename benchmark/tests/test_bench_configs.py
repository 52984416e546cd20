"""Each configuration file builds the scene of the preset it names."""

import json
import os

import numpy as np
import pytest

from benchmark import scene
from benchmark.tests import small


@pytest.mark.parametrize("name", ["cloth64k", "selfcollide64k"])
def test_config_is_its_preset(name):
    import softbodyunity_torch as sb

    with open(os.path.join(small.BENCH, "configs", name + ".json")) as f:
        config = json.load(f)
    host, cfg = scene.build(sb, config)
    p_host, p_cfg = sb.presets.build(config["preset"])
    assert cfg == p_cfg
    for field in ("positions0", "edges", "rest_length", "edge_stiffness",
                  "inv_mass", "triangles"):
        assert np.array_equal(np.asarray(getattr(host, field)),
                              np.asarray(getattr(p_host, field))), field
    assert host.plane_height == p_host.plane_height
    assert host.grid_shape == p_host.grid_shape
    assert config["reduced"] == []
