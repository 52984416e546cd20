"""The check for the JAX side compares whole top-level module names, and the
reference imports nothing of the program."""

import subprocess
import sys

from benchmark import harness
from benchmark.tests import small


def test_whole_top_level_names(monkeypatch):
    # the port's name begins with the JAX package's: a prefix test is wrong
    monkeypatch.setitem(sys.modules, "softbodyunity_torch_extra", None)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", None)
    before = harness.forbidden_modules()
    for name in ("jax.numpy", "softbodyunity_tpu.api", "flax", "jaxlib"):
        monkeypatch.setitem(sys.modules, name, None)
    found = harness.forbidden_modules()
    assert "softbodyunity_torch" not in found
    assert set(found) - set(before) <= {"jax", "softbodyunity_tpu", "flax",
                                        "jaxlib"}
    assert {"jax", "softbodyunity_tpu", "flax", "jaxlib"} <= set(found)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.grid_cloth; "
            "import benchmark.roofline.grid_euler; "
            "tops = {m.split('.')[0] for m in sys.modules}; "
            "bad = tops & {'softbodyunity_torch', 'softbodyunity_tpu', "
            "'jax', 'jaxlib', 'flax'}; "
            "print(sorted(bad)); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=small.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_a_cpu_run_loads_nothing_of_the_jax_side(tmp_path):
    code = (
        "import sys; sys.path.insert(0, %r); "
        "from benchmark import harness; from benchmark.tests import small; "
        "b, base = small.tree(%r, n=8); "
        "harness.run_cell('cloth64k.render', 1, 0.2, False, device='cpu', "
        "bench=b, base=base); "
        "print(harness.forbidden_modules()); "
        "sys.exit(1 if harness.forbidden_modules() else 0)"
        % (small.ROOT, str(tmp_path)))
    out = subprocess.run([sys.executable, "-c", code], cwd=small.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]


def test_run_exits_without_the_program(tmp_path):
    """Beside ``BENCHMARK.json`` and its folder alone, a run prints no
    result and exits non-zero."""
    import shutil

    shutil.copytree(small.BENCH, tmp_path / "benchmark")
    shutil.copy(small.ROOT + "/BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "cloth64k.render",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
