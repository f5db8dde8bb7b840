"""The comparison that decides `correct`.

Each compared number is the largest, over the frames the check sampled, of
one output's relative RMS gap: ‖program − reference‖₂ / ‖reference −
mean(reference)‖₂ over that frame's tensor, or over the tensor averaged in
k×k blocks first (`<output>_pool<k>`). A frame that is not finite reads
inf. The limits are the cell's (`workloads/<name>.json`, "limits"),
each set between the program's readings and the control's (PERF.md)."""

from __future__ import annotations

import math
import sys

import torch
import torch.nn.functional as F


def rel_rms_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.double(), ref.double()
    if got.shape != ref.shape:
        return math.inf
    if not torch.isfinite(got).all():
        return math.inf
    spread = torch.linalg.vector_norm(ref - ref.mean()).item()
    gap = torch.linalg.vector_norm(got - ref).item()
    return gap / spread if spread > 0 else (0.0 if gap == 0 else math.inf)


def pooled(x: torch.Tensor, k: int) -> torch.Tensor:
    """[C, H, W] averaged over k×k blocks."""
    return F.avg_pool2d(x.double()[None], k)[0] if k > 1 else x


def gap_of(name: str):
    """The gap function of a compared number: "<output>" or
    "<output>_pool<k>" (the output averaged over k×k blocks first) of frame
    row b, or "drive", the driving signal of the frame's stream s."""
    if name == "drive":
        return lambda out, ref, b, s, drive: rel_rms_gap(out["drive"][s], drive[s])
    key, _, k = name.partition("_pool")
    k = int(k) if k else 1
    return lambda out, ref, b, s, drive: rel_rms_gap(pooled(out[key][b], k), pooled(ref[key][b], k))


class Check:
    """Collects the gaps of every compared frame by name."""

    def __init__(self, limits: dict):
        self.limits = dict(limits)
        self.gaps = {name: gap_of(name) for name in self.limits}
        self.worst = {name: 0.0 for name in self.limits}
        self.frames = 0
        self.failed = 0

    def add(self, gaps: dict):
        self.frames += 1
        bad = False
        for name, value in gaps.items():
            if name not in self.limits:
                raise KeyError(f"no limit for the compared number {name!r}")
            self.worst[name] = max(self.worst[name], value)
            bad |= not value <= self.limits[name]
        self.failed += int(bad)

    @property
    def correct(self) -> bool:
        return self.frames > 0 and self.failed == 0

    def lines(self) -> dict:
        """{name: {"value", "limit"}}, and each as a last line on stderr."""
        out = {}
        for name, limit in self.limits.items():
            out[name] = {"value": self.worst[name], "limit": limit}
        print(f"check: {self.frames} frames compared, {self.failed} over a limit",
              file=sys.stderr)
        for name, v in out.items():
            print(f"check {name} {v['value']!r} limit {v['limit']}", file=sys.stderr)
        return out
