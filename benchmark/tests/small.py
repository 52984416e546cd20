"""A copy of the benchmark's tree with its configurations shrunk to a size
that a CPU test run holds: the same files, the grid cut to ``n`` x ``n``
and the ground moved with it, so that the self-colliding curtain's bottom
rows still start below it."""

import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def shrink(config: dict, n: int) -> dict:
    config = json.loads(json.dumps(config))
    scene = config["scene"]
    if scene["plane_height"] > -(scene["ny"] - 1) * scene["spacing"]:
        # the same share of the rows below the ground
        share = -scene["plane_height"] / ((scene["ny"] - 1) * scene["spacing"])
        scene["plane_height"] = -share * (n - 1) * scene["spacing"]
    scene["nx"] = scene["ny"] = n
    return config


def bench() -> dict:
    """``BENCHMARK.json``'s object."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def tree(tmp, n: int = 16, episode_frames: int = 0):
    """``(bench, base)``: :func:`bench`'s object and a benchmark folder
    under ``tmp`` whose configuration files are cut to ``n`` x ``n`` (and,
    given ``episode_frames``, whose mixes reset that often)."""
    bench_ = bench()
    base = os.path.join(str(tmp), "benchmark")
    os.makedirs(os.path.join(base, "configs"))
    for sub in ("traffic", "metrics", "reference"):
        shutil.copytree(os.path.join(BENCH, sub), os.path.join(base, sub))
    for name in os.listdir(os.path.join(base, "traffic")):
        path = os.path.join(base, "traffic", name)
        with open(path) as f:
            mix = json.load(f)
        mix["episode_frames"] = episode_frames or mix["episode_frames"]
        with open(path, "w") as f:
            json.dump(mix, f)
    for c in bench_["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            config = shrink(json.load(f), n)
        with open(os.path.join(str(tmp), c["file"]), "w") as f:
            json.dump(config, f)
    return bench_, base
