"""The scene of a configuration file, built through the program's public
API, and the generator of each episode's seeded start.

The configuration file (``configs/<name>.json``) states every size and
coefficient.  Its ``builder`` names the program's scene function
(``softbodyunity_torch.<builder>``), called with the ``scene`` section as
keyword arguments; its ``sim`` section fills the program's ``SimConfig``
field by field.  So a change to the program's presets cannot change what
the benchmark runs (``tests/test_bench_configs.py`` holds each file equal
to the preset it names), and a configuration with another builder is a new
file, not a new branch here.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import inspect

import torch


def episode_seed(seed: int, episode: int) -> int:
    """A 63-bit generator seed for episode ``episode`` of run ``seed``;
    any whole numbers, however large, give one."""
    digest = hashlib.sha256(f"{seed}:{episode}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def episode_generator(seed: int, episode: int) -> torch.Generator:
    """The CPU generator that an episode's start is drawn from, so that
    every device makes the same start."""
    return torch.Generator().manual_seed(episode_seed(seed, episode))


def _plain(value):
    """JSON lists as tuples, as the program's parameters take them."""
    if isinstance(value, list):
        return tuple(_plain(v) for v in value)
    return value


def _field(default, value):
    """``value`` from the configuration file in the type of the field whose
    default is ``default``: a parameter group, an enum or a tuple."""
    if dataclasses.is_dataclass(default):
        return type(default)(**{k: _plain(v) for k, v in value.items()})
    if isinstance(default, enum.Enum):
        return type(default)(value)
    return _plain(value)


def sim_config(sb, sim: dict):
    """The program's ``SimConfig`` of a configuration's ``sim`` section:
    each key a field, each object a parameter group; a null keeps the
    field's default."""
    defaults = sb.SimConfig()
    fields = {f.name for f in dataclasses.fields(defaults)}
    unknown = set(sim) - fields
    if unknown:
        raise ValueError(f"sim keys the program does not know: {sorted(unknown)}")
    return sb.SimConfig(**{k: _field(getattr(defaults, k), v)
                           for k, v in sim.items() if v is not None})


def build(sb, config: dict):
    """``(HostTopology, SimConfig)`` of ``config`` through the program's API
    (``sb`` is the program's package).  The builder also gets each
    parameter group of the ``SimConfig`` that it takes by name (the
    springs' stiffnesses, the XPBD compliances)."""
    cfg = sim_config(sb, config["sim"])
    builder = getattr(sb, config["builder"])
    kwargs = {k: _plain(v) for k, v in config["scene"].items()}
    for name in inspect.signature(builder).parameters:
        if name not in kwargs and hasattr(cfg, name):
            kwargs[name] = getattr(cfg, name)
    return builder(**kwargs), cfg
