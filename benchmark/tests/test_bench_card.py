"""A short run of each cell on the card, end to end (skips without one):

    python -m pytest benchmark/tests/test_bench_card.py -q
"""

import json
import subprocess
import sys

import pytest

from benchmark.tests import small


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["cloth64k.render",
                                  "selfcollide64k.render"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_runs_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell,
         "--seed", "2147483659", "--seconds", "4", "--trace", str(trace)],
        cwd=small.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["check"]
    assert result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "check"
    if trace:
        assert result["device"]["busy_s"] > 0
        assert "grid_euler_roofline" in result["metrics"]
    else:
        assert "frame_ms_p95" in result["metrics"]
