"""The hand-written grid_euler CUDA kernel against its plain PyTorch version,
on the card.  These tests skip without a CUDA device: the kernel has no CPU
mode.  The file imports no jax, so it runs where JAX is absent; there run it
without the repository's conftest (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import softbodyunity_torch as tsb
from softbodyunity_torch.core.config import CollisionParams
from softbodyunity_torch.kernels import grid_euler, stencil

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the grid_euler kernel runs only "
                    "on the card")
    return torch.device("cuda")


def _scene16(shear=True, bend=True, sphere=False):
    cfg = tsb.SimConfig(
        springs=tsb.SpringParams(k_structural=500.0, k_shear=250.0,
                                 k_bend=100.0, damping=0.6),
        collision=CollisionParams(enable_plane=True, enable_spheres=sphere,
                                  friction=0.2),
        global_damping=0.3,
    )
    host = tsb.cloth_grid(
        16, 8, spacing=0.05, shear=shear, bend=bend, pinned=("tl", "tr"),
        springs=cfg.springs, xpbd=cfg.xpbd, plane_height=-0.25,
        orientation="xy",
        sphere_centers=np.array([[0.35, -0.4, 0.0]]) if sphere else None,
        sphere_radii=np.array([0.15]) if sphere else None,
    )
    return host, cfg


# the kernel differs from its plain version by rounding (nvcc's FMA
# contraction), as the Pallas kernel differs from its twin (rsqrt), so
# these are tests/test_pallas.py's kernel-vs-twin tolerances
@pytest.mark.cuda
@pytest.mark.parametrize("shear,bend,sphere,n_sub,atol_x,atol_v", [
    (False, False, False, 64, 5e-4, 5e-2),
    (True, True, False, 64, 5e-6, 5e-4),
    (True, True, True, 96, 2e-5, 5e-2),
])
def test_kernel_matches_plain_on_card(cuda, shear, bend, sphere, n_sub,
                                      atol_x, atol_v):
    host, cfg = _scene16(shear, bend, sphere)
    top, s0 = tsb.init(host, device=cuda)
    want = stencil.make_stencil_step(top, cfg)(s0, cfg.dt, n_sub)
    grid_euler.reset_launch_count()
    got = grid_euler.make_cuda_step(top, cfg)(s0, cfg.dt, n_sub)
    torch.cuda.synchronize()
    assert grid_euler.launch_count() == n_sub
    torch.testing.assert_close(got.x, want.x, atol=atol_x, rtol=0)
    torch.testing.assert_close(got.v, want.v, atol=atol_v, rtol=0)
    pinned = torch.from_numpy(host.inv_mass == 0.0).to(cuda)
    assert torch.equal(got.x[pinned], s0.x[pinned])


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    host, cfg = _scene16()
    top, s0 = tsb.init(host, device=cuda)
    step = grid_euler.make_cuda_step(top, cfg)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        step(s0.replace(x=s0.x.clone().requires_grad_()), cfg.dt, 1)
    with pytest.raises(ValueError, match="contiguous"):
        step(s0.replace(x=s0.x.t().contiguous().t()), cfg.dt, 1)
    top64, _ = tsb.init(host, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        grid_euler.make_cuda_step(top64, cfg)
