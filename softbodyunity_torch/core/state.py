"""Dynamic simulation state.

A frozen dataclass of tensors with the fields of the JAX package's ``State``
(``softbodyunity_tpu/core/state.py``); ``step`` returns a new ``State`` and
never writes into the one it was given.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class State:
    """Per-vertex dynamic tensors, shape ``[N, 3]``.

    ``x_prev`` is the previous-substep position, the Verlet integrator's
    history term; the Euler and XPBD paths return ``x - dt * v`` there, as
    the JAX package's fast paths do.  The optional fields hold the tear
    liveness (TearParams) and plastic rest scale (PlasticityParams) of the
    grid paths, one value per edge of ``Topology.edges`` (``api.step`` fills
    them when a config turns the feature on), and the shape-matching
    quaternions, which no path of the port carries yet.
    """

    x: torch.Tensor        # [N, 3] positions
    v: torch.Tensor        # [N, 3] velocities
    x_prev: torch.Tensor   # [N, 3] previous positions
    edge_alive: Optional[torch.Tensor] = None     # [E] tear liveness
    rest_scale: Optional[torch.Tensor] = None     # [E] plastic rest scale
    cluster_quat: Optional[torch.Tensor] = None   # [K, 4] cluster rotations

    @property
    def n_vertices(self) -> int:
        return self.x.shape[-2]

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)


def make_state(positions, device, dtype=torch.float32) -> State:
    """Initial rest state on ``device``: zero velocity, ``x_prev = x``."""
    x = torch.tensor(np.asarray(positions), dtype=dtype, device=device)
    return State(x=x, v=torch.zeros_like(x), x_prev=x.clone())
