"""Tearing and plasticity on grid cloth in softbodyunity_torch, held to the
JAX package on the CPU: the plain feature math (tear check, plastic flow,
the edge <-> plane maps) against the JAX stencil's, the port's plain step of
each solver against the JAX stencil step and the JAX row-tiled Pallas
kernels (interpret mode, the scenes and tiles of tests/test_tearing.py and
tests/test_plasticity.py), the float64 step against the NumPy oracle, the
kernels' launch-start form against the end-of-substep form, dispatch, and
the hand-off of a torn or plastically deformed JAX scene.  Inputs are made
with numpy from a fixed seed and handed to both packages.  The kernels
themselves are tested on the card by tests/test_torch_cuda.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softbodyunity_tpu import api as japi
from softbodyunity_tpu.core.config import (CollisionParams, PlasticityParams,
                                           SimConfig, Solver, SpringParams,
                                           TearParams, XPBDParams)
from softbodyunity_tpu.core.topology import cloth_grid as j_cloth_grid
from softbodyunity_tpu.kernels import stencil as jstencil
from softbodyunity_tpu.kernels.pallas_tiled import (make_tiled_step,
                                                    make_tiled_verlet_step,
                                                    make_tiled_xpbd_step)
from softbodyunity_tpu.oracle import reference as oracle

import softbodyunity_torch as tsb
from softbodyunity_torch import api, convert
from softbodyunity_torch.core.config import CollisionParams as TCollision
from softbodyunity_torch.core.config import StrainLimitParams, WindParams
from softbodyunity_torch.kernels import dispatch, grid_features, stencil

torch.set_num_threads(1)

SOLVERS = [Solver.SEMI_IMPLICIT_EULER, Solver.VERLET, Solver.XPBD]
FEATURES = ["tear", "plastic", "both"]
_TILED = {Solver.SEMI_IMPLICIT_EULER: make_tiled_step,
          Solver.VERLET: make_tiled_verlet_step,
          Solver.XPBD: make_tiled_xpbd_step}


def _scene(solver, feature, ny=12):
    """The 8-wide hanging cloth of tests/test_tearing.py and
    tests/test_plasticity.py, pinned along its top row (JAX host and
    config): "tear" rips at 3 % strain; "plastic" creeps past 2 % (rate
    0.25); "both" rips at 3 % while creeping at rate 0.05, slow enough
    that edges still tear."""
    tear = feature in ("tear", "both")
    plastic = feature in ("plastic", "both")
    cfg = SimConfig(
        solver=solver,
        springs=SpringParams(k_structural=300.0, k_shear=150.0,
                             k_bend=60.0, damping=0.3),
        xpbd=XPBDParams(compliance_distance=3e-4, compliance_bend=1e-3,
                        n_iterations=4),
        tear=TearParams(enabled=tear, strain_limit=0.03),
        plasticity=PlasticityParams(
            enabled=plastic, yield_strain=0.02,
            creep=0.05 if feature == "both" else 0.25),
        collision=CollisionParams(enable_plane=True),
        global_damping=0.1,
    )
    host = j_cloth_grid(
        8, ny, spacing=0.05, shear=True, bend=True, pinned=("top",),
        springs=cfg.springs, xpbd=cfg.xpbd, plane_height=-5.0,
        orientation="xy",
    )
    return host, cfg


def _port(host, cfg):
    return (convert.host_from_arrays(
                {f.name: getattr(host, f.name)
                 for f in dataclasses.fields(host)}),
            convert.config_from_dict(dataclasses.asdict(cfg)))


def _jax_state(jtop, cfg, state):
    return japi.ensure_plastic_state(jtop, cfg,
                                     japi.ensure_tear_state(jtop, cfg, state))


# --- the feature math ----------------------------------------------------------

def _random_planes(seed, ny=12, nx=8):
    """A perturbed 8x12 grid (strains of a few percent either way, around
    the 3 % tear limit), plastic scales in [0.9, 1.2] and random liveness,
    as numpy arrays."""
    rng = np.random.default_rng(seed)
    host = j_cloth_grid(nx, ny, spacing=0.05, shear=True, bend=True,
                        orientation="xy")
    x = host.positions0 + 0.003 * rng.standard_normal(host.positions0.shape)
    x3 = x.T.reshape(3, ny, nx).astype(np.float32)
    scale = rng.uniform(0.9, 1.2, (6, ny, nx)).astype(np.float32)
    alive = (rng.uniform(size=(6, ny, nx)) < 0.8).astype(np.float32)
    return x3, scale, alive


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tear_math_matches_jax(seed):
    x3, scale, alive = _random_planes(seed)
    cfg = SimConfig()
    offs = stencil._offsets(cfg, 0.05, True, True)
    assert offs == jstencil._offsets(cfg, 0.05, True, True)
    tx, ts, ta = (torch.from_numpy(a) for a in (x3, scale, alive))
    for rs_t, rs_j in ((None, None), (ts, jnp.asarray(scale))):
        got = stencil.tear_ok_planes(tx, offs, 0.03, rest_scale=rs_t)
        want = jstencil.tear_ok_planes(jnp.asarray(x3), offs, 0.03,
                                       rest_scale=rs_j)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        both = np.stack([g.numpy() for g in got])
        assert 0.2 < both.mean() < 0.98      # the threshold is exercised
        got = stencil.tear_update_grid(tx, offs, ta, 0.03, rest_scale=rs_t)
        want = jstencil.tear_update_grid(jnp.asarray(x3), offs,
                                         jnp.asarray(alive), 0.03,
                                         rest_scale=rs_j)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plastic_math_matches_jax(seed):
    x3, scale, _ = _random_planes(seed)
    cfg = SimConfig()
    offs = stencil._offsets(cfg, 0.05, True, True)
    pp = PlasticityParams(enabled=True, yield_strain=0.02, creep=0.25)
    tpp = convert.config_from_dict(dataclasses.asdict(
        cfg.replace(plasticity=pp))).plasticity
    got = stencil.plastic_update_grid(torch.from_numpy(x3), offs,
                                      torch.from_numpy(scale), tpp).numpy()
    want = np.asarray(jstencil.plastic_update_grid(
        jnp.asarray(x3), offs, jnp.asarray(scale), pp))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (got != scale).mean() > 0.2       # the flow is exercised


@pytest.mark.parametrize("shear,bend", [(False, False), (True, False),
                                        (True, True)])
def test_tear_plane_maps_match_jax(shear, bend):
    host = j_cloth_grid(7, 5, spacing=0.05, shear=shear, bend=bend)
    jtop, _ = japi.init(host)
    cfg = SimConfig()
    offs = stencil._offsets(cfg, 0.05, shear, bend)
    j_to, j_from = jstencil.tear_plane_maps(jtop, offs, 5, 7)
    top, _ = tsb.init(_port(host, cfg)[0], device="cpu")
    to_p, from_p, idx = stencil.tear_plane_maps(top, offs, 5, 7)
    e = host.edges.shape[0]
    vals = np.arange(1, e + 1, dtype=np.float32)
    planes = to_p(torch.from_numpy(vals))
    np.testing.assert_array_equal(planes.numpy(),
                                  np.asarray(j_to(jnp.asarray(vals))))
    np.testing.assert_array_equal(from_p(planes).numpy(), vals)
    np.testing.assert_array_equal(
        np.asarray(j_from(jnp.asarray(planes.numpy()))), vals)
    assert len(set(idx.tolist())) == e       # one plane entry per edge


# --- the plain step of each solver -----------------------------------------------

def _port_run(host, cfg, dtype=torch.float32):
    thost, tcfg = _port(host, cfg)
    top, s0 = tsb.init(thost, device="cpu", dtype=dtype)
    return top, tcfg, s0


# x: the JAX tests' own 5e-5 (tests/test_tearing.py:275-277).  rest_scale:
# the JAX tests' 1e-6 against the stencil (the port computes its ops), and
# 1e-5 against the tiled kernels and for Verlet, whose x parts from XLA's by
# up to 3e-7 (XLA folds dt * dt), which the scales amplify by 1 / rest = 20
@pytest.mark.parametrize("feature", FEATURES)
@pytest.mark.parametrize("solver", SOLVERS)
def test_plain_step_matches_jax_stencil_and_tiled(solver, feature):
    ny = 32 if solver == Solver.XPBD else 24
    tile = 16 if solver == Solver.XPBD else 8
    host, cfg = _scene(solver, feature, ny=ny)
    jtop, js = japi.init(host)
    js = _jax_state(jtop, cfg, js)
    j_st = jax.jit(lambda t, s: jstencil.make_stencil_step(t, cfg)(
        s, cfg.dt, 64))(jtop, js)
    j_tiled = _TILED[solver](jtop, cfg, tile=tile, interpret=True)(
        js, cfg.dt, 64)
    top, tcfg, s0 = _port_run(host, cfg)
    got = stencil.make_stencil_step(top, tcfg)(s0, tcfg.dt, 64)
    for want, scale_tol in ((j_st, 1e-5 if solver == Solver.VERLET else 1e-6),
                            (j_tiled, 1e-5)):
        np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                                   atol=5e-5)
        if cfg.tear.enabled:
            np.testing.assert_array_equal(got.edge_alive.numpy(),
                                          np.asarray(want.edge_alive))
        if cfg.plasticity.enabled:
            np.testing.assert_allclose(got.rest_scale.numpy(),
                                       np.asarray(want.rest_scale),
                                       atol=scale_tol)
    if cfg.tear.enabled:
        assert float(got.edge_alive.min()) == 0.0, "nothing tore"
    if cfg.plasticity.enabled:
        assert float(got.rest_scale.max()) > 1.0 + 1e-3, "no flow"
    pinned = host.inv_mass == 0.0
    np.testing.assert_array_equal(got.x.numpy()[pinned],
                                  host.positions0[pinned].astype(np.float32))


@pytest.mark.parametrize("feature", FEATURES)
@pytest.mark.parametrize("solver", SOLVERS)
def test_f64_plain_step_matches_oracle(solver, feature):
    """50 frames in float64 against ``oracle.step`` (tier 1 of ROADMAP's
    fidelity tiers): within 1e-6, with equal masks and scales."""
    host, cfg = _scene(solver, feature)
    top, tcfg, s = _port_run(host, cfg, dtype=torch.float64)
    x = host.positions0.copy()
    v = np.zeros_like(x)
    xp = x.copy()
    e = host.edges.shape[0]
    alive = np.ones(e) if cfg.tear.enabled else None
    scale = np.ones(e) if cfg.plasticity.enabled else None
    for _ in range(50):
        out = oracle.step(host, cfg, x, v, xp, alive=alive, rest_scale=scale)
        x, v, xp = out[:3]
        if alive is not None:
            alive = out[3]
        if scale is not None:
            scale = out[-1]
        s = tsb.step(top, tcfg, s)
    assert float(np.max(np.abs(s.x.numpy() - x))) < 1e-6
    if alive is not None:
        np.testing.assert_array_equal(s.edge_alive.numpy(), alive)
        assert alive.min() == 0.0, "nothing tore"
    if scale is not None:
        np.testing.assert_allclose(s.rest_scale.numpy(), scale, atol=1e-9)
        assert scale.max() > 1.0 + 1e-3, "no flow"


@pytest.mark.parametrize("feature", FEATURES)
@pytest.mark.parametrize("solver", SOLVERS)
def test_launch_start_form_matches_end_of_substep_form(solver, feature):
    """The kernels' reformulation (update at each launch's start but the
    first, once more at the frame's end) against the end-of-substep update,
    bit for bit, over two frames."""
    host, cfg = _scene(solver, feature)
    top, tcfg, s0 = _port_run(host, cfg)
    end_form = stencil.make_stencil_step(top, tcfg)
    start_form = grid_features.make_launch_start_step(top, tcfg)
    a = b = s0
    for _ in range(2):
        a = end_form(a, tcfg.dt, 32)
        b = start_form(b, tcfg.dt, 32)
    for name in ("x", "v", "x_prev", "edge_alive", "rest_scale"):
        ga, gb = getattr(a, name), getattr(b, name)
        assert (ga is None) == (gb is None), name
        assert ga is None or torch.equal(ga, gb), name
    if tcfg.tear.enabled:
        assert float(a.edge_alive.min()) == 0.0


# --- dispatch and the public path ---------------------------------------------------

@pytest.mark.parametrize("feature", ["tear", "plastic"])
def test_feature_grid_of_any_size_builds_a_step(feature):
    """A 400x330 grid (132k vertices, past the TPU's whole-VMEM cap) with a
    feature plane takes the grid path: on the CPU its plain version."""
    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER, feature)
    thost = tsb.cloth_grid(400, 330, spacing=0.05, shear=True, bend=True,
                           pinned=("top",), orientation="xy")
    tcfg = _port(host, cfg)[1]
    top, s0 = tsb.init(thost, device="cpu")
    fn = dispatch.maybe_fast_step(top, tcfg)
    assert fn.__qualname__ == "make_stencil_step.<locals>.fn"
    s = tsb.step(top, tcfg, s0, n_substeps=1)
    e = thost.edges.shape[0]
    field = s.edge_alive if feature == "tear" else s.rest_scale
    assert field.shape == (e,) and bool(torch.isfinite(s.x).all())


@pytest.mark.parametrize("what,item", [
    ("wind", "Queue 1 item 6"), ("strain_limit", "Queue 1 item 6"),
    # capsule and box contact refused under Queue 1 item 2 until its branch
    # was ported; the ids stay, and an SDF collider beside them refuses
    pytest.param("capsules", "Queue 1 item 6", id="capsules-Queue 1 item 2"),
    pytest.param("boxes", "Queue 1 item 6", id="boxes-Queue 1 item 2"),
    ("sdf", "Queue 1 item 6")])
def test_feature_scene_with_unported_branch_raises(what, item):
    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER, "both")
    top, tcfg, s0 = _port_run(host, cfg)
    # wind, the strain limit and capsule and box contact run with the
    # feature planes since their branches were ported: those cases hold
    # that an SDF collider beside them still refuses
    sdf = TCollision(enable_sdf=True)
    tcfg = tcfg.replace(**{
        "wind": dict(wind=WindParams(velocity=(1.0, 0.0, 0.0), drag=0.2),
                     collision=sdf),
        "strain_limit": dict(strain_limit=StrainLimitParams(enabled=True),
                             collision=sdf),
        "capsules": dict(collision=TCollision(enable_capsules=True,
                                              enable_sdf=True)),
        "boxes": dict(collision=TCollision(enable_boxes=True,
                                           enable_sdf=True)),
        "sdf": dict(collision=TCollision(enable_sdf=True)),
    }[what])
    with pytest.raises(NotImplementedError, match=item):
        tsb.step(top, tcfg, s0)


def test_step_and_rollout_start_every_edge_live_and_unscaled():
    host, cfg = _scene(Solver.XPBD, "both")
    top, tcfg, s0 = _port_run(host, cfg)
    assert s0.edge_alive is None and s0.rest_scale is None
    filled = api.ensure_plastic_state(top, tcfg,
                                      api.ensure_tear_state(top, tcfg, s0))
    e = host.edges.shape[0]
    assert torch.equal(filled.edge_alive, torch.ones(e))
    assert torch.equal(filled.rest_scale, torch.ones(e))
    s = tsb.step(top, tcfg, s0)
    s_roll, xs = tsb.rollout(top, tcfg, s0, 1)
    assert torch.equal(s.x, xs[0]) and torch.equal(s.edge_alive,
                                                   s_roll.edge_alive)
    assert torch.equal(s.rest_scale, s_roll.rest_scale)
    # a config without the features leaves the fields alone
    off = tcfg.replace(tear=dataclasses.replace(tcfg.tear, enabled=False))
    assert api.ensure_tear_state(top, off, s0).edge_alive is None


@pytest.mark.parametrize("feature", ["tear", "plastic"])
def test_torn_or_deformed_jax_state_carries_across(feature):
    """A JAX scene stepped until it tore (or flowed) is carried across with
    ``convert.state_from_arrays`` and stepped on by both packages: the masks
    stay equal, x within the JAX tests' 5e-5."""
    host, cfg = _scene(Solver.SEMI_IMPLICIT_EULER, feature)
    jtop, js = japi.init(host)
    # 20 substeps: the top row has begun to tear (8 of 478 edges)
    js = japi.step(jtop, cfg, js, n_substeps=20)
    field = "edge_alive" if feature == "tear" else "rest_scale"
    jfield = np.array(getattr(js, field))
    assert (jfield.min() == 0.0 if feature == "tear"
            else jfield.max() > 1.0 + 1e-3)
    top, tcfg, _ = _port_run(host, cfg)
    s = convert.state_from_arrays(
        np.asarray(js.x), np.asarray(js.v), np.asarray(js.x_prev), "cpu",
        **{field: jfield})
    assert torch.equal(getattr(s, field), torch.from_numpy(jfield))
    for _ in range(2):
        js = japi.step(jtop, cfg, js)
        s = tsb.step(top, tcfg, s)
    np.testing.assert_allclose(s.x.numpy(), np.asarray(js.x), atol=5e-5)
    if feature == "tear":
        np.testing.assert_array_equal(s.edge_alive.numpy(),
                                      np.asarray(js.edge_alive))
        assert float(s.edge_alive.sum()) < jfield.sum()   # it tore further
    else:
        np.testing.assert_allclose(s.rest_scale.numpy(),
                                   np.asarray(js.rest_scale), atol=1e-6)
