"""Carry a scene across from the JAX package, as plain NumPy data.

A scene built or advanced by ``softbodyunity_tpu`` plays the part that
weights play in a model port: these functions rebuild it here from arrays and
plain Python values, so both packages compute the same thing from the same
inputs.  Nothing here imports jax; the caller fetches JAX arrays with
``np.asarray``.

    host  = host_from_arrays({f.name: getattr(jax_host, f.name)
                              for f in dataclasses.fields(jax_host)})
    cfg   = config_from_dict(dataclasses.asdict(jax_cfg))
    state = state_from_arrays(np.asarray(s.x), np.asarray(s.v),
                              np.asarray(s.x_prev), device="cuda")
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from .core.config import SimConfig
from .core.state import State
from .core.topology import HostTopology


def host_from_arrays(fields: dict) -> HostTopology:
    """``HostTopology`` from the JAX ``HostTopology``'s fields (NumPy arrays
    and plain values; the two classes have the same fields); an unknown or
    missing field raises ``TypeError``."""
    return HostTopology(**fields)


def _rebuild(cls, d: dict):
    kw = {}
    defaults = cls()
    names = {f.name for f in dataclasses.fields(cls)}
    for key, value in d.items():
        if key not in names:
            raise TypeError(f"{cls.__name__} has no field {key!r}")
        default = getattr(defaults, key)
        if dataclasses.is_dataclass(default):
            value = _rebuild(type(default), value)
        elif isinstance(default, enum.Enum):
            # an enum of the other package, or its value
            value = type(default)(getattr(value, "value", value))
        elif isinstance(default, tuple):
            value = tuple(value)
        kw[key] = value
    return cls(**kw)


def config_from_dict(d: dict) -> SimConfig:
    """``SimConfig`` from ``dataclasses.asdict`` of the JAX config (or the
    same dict after a JSON round trip: lists become tuples, enum values
    become ``Solver`` members)."""
    return _rebuild(SimConfig, d)


def state_from_arrays(x, v, x_prev, device, dtype=torch.float32) -> State:
    """``State`` on ``device`` from ``[N, 3]`` position, velocity and
    previous-position arrays."""
    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return State(x=t(x), v=t(v), x_prev=t(x_prev))
