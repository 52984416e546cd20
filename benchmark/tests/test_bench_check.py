"""The comparison that decides ``correct``: a sound run passes, and a run
with the timed path broken underneath, or with the control in the
program's place, does not.  On the CPU, with the program's plain path, at
a size a test run holds; the harness's look for a chip is skipped by
running on the CPU device."""

import json

import pytest
import torch

from benchmark import check, control, harness
from benchmark.tests import small

CELLS = ["cloth64k.render", "selfcollide64k.render"]


def run(tmp_path, cell, seconds=2.5):
    # short episodes, so that the window keeps frames past the first
    bench, base = small.tree(tmp_path, n=16, episode_frames=20)
    result, numbers, limits = harness.run_cell(
        cell, 20251017, seconds, False, device="cpu", bench=bench, base=base)
    assert json.loads(json.dumps(result)) == result
    assert list(result)[-1] == "check"
    return result, numbers, limits


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tmp_path, cell):
    result, numbers, limits = run(tmp_path, cell)
    assert result["correct"] is True, numbers
    assert result["failed"] == 0 and result["attempted"] > 0
    for name, limit in limits.items():
        assert result["check"][name] == {"value": numbers[name],
                                         "limit": limit}


def unchanged(sb_step):
    def step(top, cfg, state, *args, **kw):
        sb_step(top, cfg, state, *args, **kw)   # the work, its result lost
        return state
    return step


def altered(sb_step):
    def step(top, cfg, state, *args, **kw):
        new = sb_step(top, cfg, state, *args, **kw)
        x = new.x.clone()
        nx = int(round(x.shape[0] ** 0.5))
        x[nx * (nx // 2):nx * (nx // 2 + 1), 2] += 0.01   # a row, 1 cm off
        return new.replace(x=x)
    return step


@pytest.mark.parametrize("fault", [unchanged, altered],
                         ids=["state_unchanged", "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_step_is_not_correct(tmp_path, monkeypatch, cell, fault):
    import softbodyunity_torch as sb

    monkeypatch.setattr(sb, "step", fault(sb.step))
    result, numbers, limits = run(tmp_path, cell)
    assert result["correct"] is False, numbers
    assert any(numbers[k] > v for k, v in limits.items())


@pytest.mark.parametrize("cell", CELLS)
def test_the_bfloat16_control_fails(cell):
    """The reference in bfloat16 in the program's place, judged by the same
    comparison, fails one of the cell's numbers."""
    found = harness.find_cell(cell)
    found.config = small.shrink(found.config, 24)
    prog = harness.Program(found, "cpu")
    kept = control.episodes_of(prog, found, 5)

    def start(episode):
        s = prog.start(5, episode)
        return s.x, s.v

    ref = prog.reference
    limits = found.config["check"]["limits"]
    numbers = check.compare(found.config, ref, kept, start, prog.device,
                            program=ref.Reference(found.config,
                                                  torch.bfloat16))
    assert any(numbers[k] > v for k, v in limits.items()), numbers
    sound = check.compare(found.config, ref, kept, start, prog.device)
    assert all(sound[k] <= v for k, v in limits.items()), sound


def test_a_nan_frame_fails_as_null(tmp_path, monkeypatch):
    import softbodyunity_torch as sb

    real = sb.step

    def step(top, cfg, state, *args, **kw):
        new = real(top, cfg, state, *args, **kw)
        return new.replace(x=new.x * float("nan"))

    monkeypatch.setattr(sb, "step", step)
    result, numbers, _ = run(tmp_path, "cloth64k.render", seconds=0.5)
    assert result["correct"] is False and result["failed"] > 0
    assert result["check"]["x_rms_first_m"]["value"] is None
    assert numbers["x_rms_first_m"] == float("inf")
    json.dumps(result, allow_nan=False)


@pytest.mark.parametrize("fault", control.PLANTED)
def test_a_broken_self_collision_is_not_correct(tmp_path, fault):
    """The self-collision force plane broken underneath (the pair forces
    dropped or halved, each tile's last partner tile left out), at 24 x 24
    so that the pile has three tiles: the run is not correct, and the
    number that isolates the layer says so."""
    bench, base = small.tree(tmp_path, n=24, episode_frames=20)
    with control.planted(fault):
        result, numbers, limits = harness.run_cell(
            "selfcollide64k.render", 20251017, 2.5, False, device="cpu",
            bench=bench, base=base)
    assert result["correct"] is False, numbers
    assert numbers["x_step_p90_m"] > limits["x_step_p90_m"]
