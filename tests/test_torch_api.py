"""softbodyunity_torch's public path as a whole, on the CPU: golden replay,
the hand-off of a running JAX scene to the port, dispatch and its refusals,
and the kernel build's keying.  The kernel itself is tested on the card by
tests/test_torch_cuda.py."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from softbodyunity_tpu import api as japi
from softbodyunity_tpu.models import presets as jpresets

import softbodyunity_torch as tsb
from softbodyunity_torch import convert
from softbodyunity_torch.core.config import (CollisionParams,
                                             PlasticityParams,
                                             SelfCollisionParams, Solver,
                                             StrainLimitParams, TearParams,
                                             WindParams)
from softbodyunity_torch.kernels import build, grid_euler

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


# tests/test_golden.py's tolerances.  The sphere scene starts with the sphere
# cutting the cloth, so contact chaos sets in at once; the first recorded
# frame (10) is also held to 2e-3: the port measures 8.4e-4 there on the CPU
# and the JAX package's f32 path 1.3e-3, while a force or contact bug shows
# at 1e-2 and up.
@pytest.mark.parametrize("name,tol,first_tol", [
    ("cloth_32_euler", 1e-4, 1e-4),
    ("cloth_hanging_sphere", 5e-2, 2e-3),
])
def test_golden_replay(name, tol, first_tol):
    data = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    golden = data["positions"]
    every = int(data["record_every"])
    host, cfg = tsb.presets.build(name)
    top, state = tsb.init(host, device="cpu")
    for r in range(golden.shape[0]):
        for _ in range(every):
            state = tsb.step(top, cfg, state)
        drift = float(np.max(np.abs(state.x.numpy() - golden[r])))
        bound = first_tol if r == 0 else tol
        assert drift < bound, f"{name}: drift {drift:.3e} at frame {(r + 1) * every}"


# Both packages run the same stencil ops on the same f32 inputs; XLA may
# fuse and reorder, so agreement is to rounding (measured 0 on the smooth
# scene; 7.7e-7 x / 5.9e-5 v on the sphere scene, amplified by contact).
@pytest.mark.parametrize("name,atol_x,atol_v", [
    ("cloth_32_euler", 1e-6, 1e-5),
    ("cloth_hanging_sphere", 1e-5, 1e-3),
])
def test_handoff_from_running_jax_scene(name, atol_x, atol_v):
    """JAX steps 10 frames, the state crosses to the port as numpy arrays,
    then both step 10 more frames."""
    jhost, jcfg = jpresets.build(name)
    jtop, js = japi.init(jhost)
    for _ in range(10):
        js = japi.step(jtop, jcfg, js)
    host = convert.host_from_arrays(
        {f.name: getattr(jhost, f.name) for f in dataclasses.fields(jhost)})
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    top, _ = tsb.init(host, device="cpu")
    ts = convert.state_from_arrays(np.asarray(js.x), np.asarray(js.v),
                                   np.asarray(js.x_prev), device="cpu")
    for _ in range(10):
        js = japi.step(jtop, jcfg, js)
        ts = tsb.step(top, cfg, ts)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), atol=atol_x)
    np.testing.assert_allclose(ts.v.numpy(), np.asarray(js.v), atol=atol_v)
    np.testing.assert_allclose(ts.x_prev.numpy(), np.asarray(js.x_prev),
                               atol=atol_x)


def test_step_contract_on_cpu():
    """Pinned vertices stay bit-frozen, x_prev = x - dt*v, rollout equals
    repeated step, and the CPU path never launches the kernel."""
    host, cfg = tsb.presets.build("cloth_hanging_sphere")
    top, s0 = tsb.init(host, device="cpu")
    grid_euler.reset_launch_count()
    s = s0
    for _ in range(3):
        s = tsb.step(top, cfg, s)
    assert grid_euler.launch_count() == 0
    pinned = torch.from_numpy(host.inv_mass == 0.0)
    assert int(pinned.sum()) == 2
    assert torch.equal(s.x[pinned], s0.x[pinned])
    assert torch.equal(s.x_prev, s.x - cfg.dt * s.v)
    s_roll, xs = tsb.rollout(top, cfg, s0, 3)
    assert xs.shape == (3, host.positions0.shape[0], 3)
    assert torch.equal(xs[-1], s.x) and torch.equal(s_roll.v, s.v)
    assert s.x.is_contiguous() and s.v.is_contiguous()


_UNPORTED = {
    "xpbd": dict(solver=Solver.XPBD),
    "verlet": dict(solver=Solver.VERLET),
    "wind": dict(wind=WindParams(velocity=(1.0, 0.0, 0.0), drag=0.2)),
    "strain_limit": dict(strain_limit=StrainLimitParams(enabled=True)),
    "tear": dict(tear=TearParams(enabled=True)),
    "plasticity": dict(plasticity=PlasticityParams(enabled=True)),
    "capsules": dict(collision=CollisionParams(enable_capsules=True)),
    "boxes": dict(collision=CollisionParams(enable_boxes=True)),
    "sdf": dict(collision=CollisionParams(enable_sdf=True)),
    "self_collision": dict(self_collision=SelfCollisionParams(enabled=True)),
    "general_path": dict(backend="jnp"),
}


@pytest.mark.parametrize("what", sorted(_UNPORTED))
def test_unported_branch_raises(what):
    host, cfg = tsb.presets.build("cloth_32_euler")
    top, state = tsb.init(host, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsb.step(top, cfg.replace(**_UNPORTED[what]), state)


def test_non_grid_scene_raises():
    host, cfg = tsb.presets.build("cloth_32_euler")
    top, state = tsb.init(host, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        tsb.step(dataclasses.replace(top, grid_shape=None), cfg, state)


def test_init_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    host, _ = tsb.presets.build("cloth_32_euler")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsb.init(host, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsb.init(host)          # the default device is cuda, never the CPU


def test_cuda_step_refuses_cpu_topology():
    host, cfg = tsb.presets.build("cloth_32_euler")
    top, _ = tsb.init(host, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        grid_euler.make_cuda_step(top, cfg)


def test_build_key_follows_sources(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    p1 = build.library_path("k")
    assert p1 == build.library_path("k")
    (tmp_path / "common.cuh").write_text("// shared\n")
    p2 = build.library_path("k")
    (tmp_path / "k.cu").write_text("// v2\n")
    p3 = build.library_path("k")
    assert len({p1, p2, p3}) == 3
    assert p3.parent == build.BUILD_DIR and p3.suffix == ".so"


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(build.os, "access", lambda *a: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._find_nvcc()
