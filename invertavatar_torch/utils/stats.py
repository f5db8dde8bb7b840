"""Metric accumulation and logging sinks.

Counterpart of `invertavatar_tpu/utils/stats.py`: counters accumulate
[num, sum, sum of squares] per name, and `sync` sums the pending triples over
the ranks of a data-parallel run before a tick closes; `StatsLogger` appends
one JSON line per tick to `stats.jsonl` and, where `torch.utils.tensorboard`
imports and its writer opens, each name's mean to a TensorBoard event file in
the same directory (rank 0's alone). As in the JAX package, a sink that
cannot be opened is simply absent.
"""

from __future__ import annotations

import json
import os
import re
import time
import zlib
from collections import defaultdict
from typing import Dict

import numpy as np


class Collector:
    def __init__(self, regex: str = ".*"):
        self._regex = re.compile(regex)
        self._moments: Dict[str, np.ndarray] = defaultdict(lambda: np.zeros(3, np.float64))
        self._deltas: Dict[str, np.ndarray] = {}

    def report(self, name: str, value) -> None:
        arr = np.asarray(value, np.float64).ravel()
        if arr.size == 0:
            return
        self._moments[name] += np.array([arr.size, arr.sum(), np.square(arr).sum()])

    def sync(self) -> None:
        """Sum the pending [num, sum, sum of squares] of every name over the
        ranks of the default process group, in float64 (the reference's
        training_stats all-reduce); a no-op without a process group. Every
        rank calls it at the same point, having reported the same names.
        First a fixed-length digest of the names (their count and a crc32 of
        the sorted names, each reduced to its maximum and minimum) is
        all-reduced, so that ranks whose names differ all raise
        `RuntimeError` before the sums, whose sizes would then differ."""
        import torch
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            return
        names = sorted(self._moments)
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
        crc = zlib.crc32("\n".join(names).encode())
        digest = torch.tensor([len(names), -len(names), crc, -crc], dtype=torch.float64,
                              device=device)
        dist.all_reduce(digest, op=dist.ReduceOp.MAX)
        count_hi, count_lo, crc_hi, crc_lo = digest.cpu().tolist()
        if count_hi != -count_lo or crc_hi != -crc_lo:
            raise RuntimeError(f"Collector.sync: ranks reported different names (rank "
                               f"{dist.get_rank()}: {names})")
        if not names:
            return
        flat = np.stack([self._moments[n] for n in names]).ravel()
        total = torch.from_numpy(flat).to(device)
        dist.all_reduce(total)
        total = total.cpu().numpy()
        for i, n in enumerate(names):
            self._moments[n] = total[3 * i:3 * i + 3].copy()

    def update(self) -> None:
        """Close a tick: the moments reported since the last update become
        what `mean` / `std` / `as_dict` read."""
        self._deltas = {k: v.copy() for k, v in self._moments.items()}
        self._moments.clear()

    def names(self):
        return [n for n in self._deltas if self._regex.fullmatch(n)]

    def mean(self, name: str) -> float:
        d = self._deltas.get(name)
        if d is None or d[0] == 0:
            return float("nan")
        return float(d[1] / d[0])

    def std(self, name: str) -> float:
        d = self._deltas.get(name)
        if d is None or d[0] == 0:
            return float("nan")
        mean = d[1] / d[0]
        return float(np.sqrt(max(d[2] / d[0] - mean * mean, 0)))

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {name: {"num": float(self._deltas[name][0]), "mean": self.mean(name),
                       "std": self.std(name)} for name in self.names()}


class StatsLogger:
    """Sinks: `stats.jsonl` in `run_dir` and, with `use_tensorboard`, a
    TensorBoard event file there (`tensorboard` is None when the import or
    the writer fails)."""

    def __init__(self, run_dir: str, use_tensorboard: bool = True):
        os.makedirs(run_dir, exist_ok=True)
        self._jsonl = open(os.path.join(run_dir, "stats.jsonl"), "a")
        self.tensorboard = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tensorboard = SummaryWriter(run_dir)
            except Exception:
                self.tensorboard = None

    def write(self, collector: Collector, step: int) -> None:
        stats = collector.as_dict()
        entry = {**stats, "timestamp": time.time(), "step": step}
        self._jsonl.write(json.dumps(entry) + "\n")
        self._jsonl.flush()
        if self.tensorboard is not None:
            for name, st in stats.items():
                self.tensorboard.add_scalar(name, st["mean"], global_step=step)
            self.tensorboard.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self.tensorboard is not None:
            self.tensorboard.close()
