"""The comparison that decides a run's ``correct``.

During the window the loop keeps, for a sample of its episodes drawn from
the seed (a reservoir, so every episode of the window is as likely to be
kept), the frames that :func:`frames_for` draws: the state the program was
given for the frame and the positions and normals it delivered to the
host.  Keeping them copies nothing on the device.  Once the window has
closed, the plain float64 reference (the module of ``reference/`` that the
configuration names, on the same device) works each kept frame out again, from the state the program was given for
it (the first frame from the episode's seeded start state, which the
benchmark made): float32 parts from float64 chaotically within an episode
on both curtains (the hanging curtain wrinkles, the pile crushes), so the
reference follows the program a frame at a time.  Where the configuration
asks for ``trajectory``, it also runs the kept episode from its start on its
own state, and the gap there is held to a limit between that chaos and the
control's.

The numbers (each against the limit its configuration file states):

- ``x_rms_first_m``: the root mean square distance of the delivered
  positions from the reference's after an episode's first frame: where the
  start is a crush, some 10,000 vertices part chaotically there, and their
  mean square varies little from seed to seed where their largest gap
  does;
- ``x_step_err_m``: the largest distance of a delivered vertex position
  from the reference's, in the frames after the first;
- ``x_step_p999_m``: the distance that 99.9 % of the vertices lie within,
  in the frames after the first: in the pile a few dozen vertices, caught
  between others and the ground, part chaotically within one frame;
- ``x_step_p90_m``: the distance that 90 % of the vertices lie within, in
  the frames after the first: rounding where the program is sound, as the
  chaos of one frame reaches far fewer vertices, while a fault in the
  self-collision force plane (a partner tile left out, the forces halved)
  moves more than a tenth of the pile;
- ``x_err_m``: the largest distance from the reference's own trajectory
  (``trajectory``);
- ``n_err``: the largest distance of a delivered unit normal from the
  reference's normal at the delivered positions (worked out where the
  configuration judges it);
- ``step_builds``: step functions the program built inside the window
  (limit 0).
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List

import torch


def frames_for(rng: random.Random, config: dict, episode_frames: int):
    """The frames of one kept episode: the first, and
    ``check.frames - 1`` more drawn from the rest."""
    rest = list(range(2, episode_frames + 1))
    n = min(config["check"]["frames"] - 1, len(rest))
    return {1} | set(rng.sample(rest, n))


@dataclasses.dataclass
class Kept:
    """One kept frame."""

    frame: int
    before: object               # the program's State given for the frame
    x: torch.Tensor              # [N, 3] positions delivered
    normals: torch.Tensor        # [N, 3] normals delivered


class Sample:
    """A reservoir of ``check.episodes`` episodes of the window."""

    def __init__(self, seed: int, config: dict, episode_frames: int):
        self.rng = random.Random(f"check:{seed}")
        self.config = config
        self.episode_frames = episode_frames
        self.size = config["check"]["episodes"]
        self.slots: List[Optional[tuple]] = [None] * self.size
        self.seen = 0

    def begin(self, episode: int):
        """The frames to keep of ``episode`` and the list to keep them in,
        or None when the reservoir passes it over."""
        frames = frames_for(self.rng, self.config, self.episode_frames)
        slot = (self.seen if self.seen < self.size
                else self.rng.randrange(self.seen + 1))
        self.seen += 1
        if slot >= self.size:
            return None
        kept: List[Kept] = []
        self.slots[slot] = (episode, kept)
        return frames, kept

    def episodes(self):
        return [s for s in self.slots if s is not None]


def _dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-vertex distance, float64, NaN where either side is not finite."""
    d = torch.sqrt(((a.to(b.device).double() - b.double()) ** 2).sum(dim=1))
    return torch.where(torch.isfinite(d), d, torch.full_like(d, float("nan")))


def _share(d: torch.Tensor, q: float) -> float:
    """The distance that the share ``q`` of the vertices lie within (the
    largest where ``q`` leaves out less than one vertex)."""
    k = max(1, math.ceil(q * d.numel()))
    return float(torch.kthvalue(d, k).values)


def _numbers(kind: str, d: torch.Tensor) -> Dict[str, float]:
    """A judged frame's numbers, +inf where any distance is NaN (a NaN
    never passes): ``first`` (an episode's first frame) its root mean
    square, ``step`` (a later frame) its largest distance and its 99.9th
    and 90th percentiles, ``traj`` and ``normals`` their largest."""
    nan = bool(torch.isnan(d).any())
    if kind == "first":
        return {"x_rms_first_m": float("inf") if nan
                else float(torch.sqrt((d * d).mean()))}
    if kind == "step":
        if nan:
            return dict.fromkeys(("x_step_err_m", "x_step_p999_m",
                                  "x_step_p90_m"), float("inf"))
        return {"x_step_err_m": float(d.max()),
                "x_step_p999_m": _share(d, 0.999),
                "x_step_p90_m": _share(d, 0.9)}
    name = "x_err_m" if kind == "traj" else "n_err"
    return {name: float("inf") if nan else float(d.max())}


def quantiles(d: torch.Tensor) -> Dict[str, float]:
    """The spread of one frame's distances, for the readings in PERF.md."""
    s = torch.sort(d.double()).values
    n = s.numel() - 1
    return {"max": float(s[-1]), "p999": _share(s, 0.999),
            "p99": float(s[int(0.99 * n)]),
            "p90": float(s[int(0.9 * n)]), "median": float(s[n // 2]),
            "rms": float(torch.sqrt((s * s).mean()))}


def compare(config: dict, reference, kept_episodes, start_state, device,
            dtype=torch.float64, program=None, detail=None):
    """The numbers compared, from the kept episodes ``[(episode, [Kept])]``.
    ``reference`` is the configuration's reference module (``reference/``);
    ``start_state(episode)`` gives ``(x, v)``, the float32 start state the
    program was handed.  ``dtype`` and ``program`` serve the control: with
    ``program`` (an object with the reference's ``frame`` and ``normals``,
    such as the reference in a lower precision) the frames judged are its,
    from the same inputs, and not the program's.  Every number is worked
    out but ``n_err``, which only where the configuration judges it.
    ``detail``, a dict, receives the :func:`quantiles` of every frame
    judged, by kind."""
    ref = reference.Reference(config, dtype=dtype, device=device)
    with_normals = "n_err" in config["check"]["limits"]
    worst: Dict[str, float] = {}

    def judge(kind, d):
        for name, value in _numbers(kind, d).items():
            worst[name] = max(worst.get(name, 0.0), value)
        if detail is not None and not bool(torch.isnan(d).any()):
            detail.setdefault(kind, []).append(quantiles(d))

    for episode, kept in kept_episodes:
        if not kept:
            continue
        x0, v0 = start_state(episode)
        kept = sorted(kept, key=lambda k: k.frame)
        # each kept frame from the state the program was given for it, the
        # first from the episode's start state
        for k in kept:
            xb, vb = (x0, v0) if k.frame == 1 else (k.before.x, k.before.v)
            xr, _ = ref.frame(xb, vb)
            if program is None:
                x, normals = k.x, k.normals
            else:
                x, _ = program.frame(xb, vb)
                normals = program.normals(x) if with_normals else None
            judge("first" if k.frame == 1 else "step", _dist(x, xr))
            if with_normals:
                judge("normals", _dist(normals, ref.normals(x)))
        if config["check"].get("trajectory"):
            # the episode from its start, the reference's own state
            xr, vr = x0, v0
            xp, vp = x0, v0
            frame = 0
            for k in kept:
                while frame < k.frame:
                    xr, vr = ref.frame(xr, vr)
                    if program is not None:
                        xp, vp = program.frame(xp, vp)
                    frame += 1
                judge("traj", _dist(k.x if program is None else xp, xr))
    return worst
