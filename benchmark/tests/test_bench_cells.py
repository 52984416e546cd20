"""BENCHMARK.json against the benchmark's contract, the cells found by
name, and a cell added as new files alone."""

import json
import os
import re

import pytest

from benchmark import harness
from benchmark.tests import small

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(small.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_names_and_limits():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(small.ROOT, c["file"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert os.path.exists(os.path.join(
            small.BENCH, "traffic", w["traffic"] + ".json"))
    metrics = b["end_to_end"] + b["per_layer"]
    names = ([c["name"] for c in b["configs"]]
             + [w["name"] for w in b["workloads"]]
             + [m["name"] for m in metrics])
    for entry in b["configs"] + b["workloads"] + metrics:
        for key in ("why", "layer", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200
                assert "\n" not in entry[key] and "\t" not in entry[key]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(
        names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(small.BENCH, "metrics",
                                           m["name"] + ".py"))
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(b)) < 64 * 1024


def test_every_cell_reports_what_the_contract_asks():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for w in b["workloads"]:
        cell = harness.find_cell(w["name"], b)
        assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
        assert cell.per_layer
        for m in b["per_layer"]:
            if m["name"] in cell.per_layer:
                # the metric it moves is reported in the same cell
                assert m["moves"] in cell.end_to_end, (w["name"], m["name"])
                assert m["moves"] in e2e


def test_cells_found_by_name():
    cell = harness.find_cell("selfcollide64k.render")
    assert cell.config["name"] == "selfcollide64k"
    assert cell.traffic["episode_frames"] == 120
    assert cell.end_to_end == ["substeps_per_s", "frame_ms_p95", "setup_s"]
    assert cell.per_layer[:2] == ["step_host_us", "render_ms"]
    assert "selfcollide_device_us" in cell.per_layer
    cloth = harness.find_cell("cloth64k.render")
    assert cloth.end_to_end == ["frame_ms_p95", "setup_s"]
    assert "selfcollide_device_us" not in cloth.per_layer
    with pytest.raises(harness.Refused):
        harness.find_cell("cloth64k.sim")       # not a cell of BENCHMARK.json
    with pytest.raises(harness.Refused):
        harness.find_cell("no.such.cell")


FREE_FALL = '''"""A tet cube with no spring or volume force and the ground out of
reach: free fall under gravity with the global damping."""

import torch


def rest_positions(scene):
    n, h = scene["n"], scene["spacing"]
    i = torch.arange(n, dtype=torch.float64)
    grid = torch.stack(torch.meshgrid(i, i, i, indexing="ij"), dim=-1)
    return (grid.reshape(-1, 3) * h
            + torch.tensor(scene["origin"], dtype=torch.float64))


def start_velocity(config, generator, device):
    n = config["scene"]["n"] ** 3
    v = torch.rand(n, 3, generator=generator, dtype=torch.float64) - 0.5
    return v.to(device).float()


class Reference:
    def __init__(self, config, dtype=torch.float64, device="cpu"):
        sim = config["sim"]
        self.dt, self.n_substeps = sim["dt"], sim["n_substeps"]
        self.decay = 1.0 - sim["global_damping"] * self.dt
        self.g = torch.tensor(sim["gravity"], dtype=dtype, device=device)
        self.dtype, self.device = dtype, device

    def frame(self, x, v):
        x, v = x.to(self.device, self.dtype), v.to(self.device, self.dtype)
        for _ in range(self.n_substeps):
            v = (v + self.dt * self.g) * self.decay
            x = x + self.dt * v
        return x, v
'''


def test_a_cell_added_as_files_alone(tmp_path):
    """A configuration with another scene builder and its own reference, a
    mix and a metric are new files and new entries: the harness runs the
    cell with no file of it edited, and judges it by the new reference."""
    b, base = small.tree(tmp_path, n=12)
    cube = {
        "name": "cube_fall", "builder": "tet_cube", "reference": "free_fall",
        "scene": {"n": 6, "spacing": 0.1, "mass": 0.5, "plane_height": -50.0,
                  "origin": [0.0, 1.0, 0.0]},
        "sim": {"solver": "euler", "dt": 0.001, "n_substeps": 4,
                "gravity": [0.0, -9.81, 0.0], "global_damping": 0.5,
                "volume_stiffness": 0.0,
                "springs": {"k_structural": 0.0, "k_shear": 0.0,
                            "k_bend": 0.0, "damping": 0.0}},
        "check": {"episodes": 2, "frames": 3,
                  "limits": {"x_rms_first_m": 1e-6, "x_step_err_m": 1e-6}},
        "reduced": []}
    with open(os.path.join(base, "configs", "cube_fall.json"), "w") as f:
        json.dump(cube, f)
    with open(os.path.join(base, "reference", "free_fall.py"), "w") as f:
        f.write(FREE_FALL)
    with open(os.path.join(base, "traffic", "short.json"), "w") as f:
        json.dump({"episode_frames": 5, "warm_frames": 1,
                   "profile_seconds": 0.0}, f)
    with open(os.path.join(base, "metrics", "frames_per_s.py"), "w") as f:
        f.write("def read(run):\n    return run.frames / run.window_s\n")
    b["configs"].append({"name": "cube_fall", "source": "a test",
                         "file": "benchmark/configs/cube_fall.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "cube_fall.short", "config": "cube_fall",
                           "traffic": "short", "chips": 1, "why": "a test"})
    b["end_to_end"].append({"name": "frames_per_s", "unit": "frames/s",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["cube_fall.short"]})
    result, numbers, _ = harness.run_cell("cube_fall.short", 3, 0.5, False,
                                          device="cpu", bench=b, base=base)
    assert result["correct"] is True, numbers
    assert set(result["metrics"]) == {"setup_s", "frames_per_s"}
    assert result["metrics"]["frames_per_s"]["value"] > 0
    assert 0 < numbers["x_step_err_m"] <= 1e-6
