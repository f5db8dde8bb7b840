"""Kernel B3 (`ops/plane_sample.py:sample_planes_windowed`, the name the
renderer calls) against its roofline."""

import torch

from benchmark.lib.bounds import b3_work
from benchmark.lib.roofline import share

NAME, UNIT, BETTER, SOURCE = "b3_roofline", "%", "higher", "device_trace"
LAYER, MOVES = "kernel B3 (ops/plane_sample.py:sample_planes_windowed)", "frames_per_s"
SITE = ("invertavatar_torch.render.renderer", "sample_planes_windowed")


def work(args, kwargs):
    planes, grid = args[:2]
    payload = args[2] if len(args) > 2 else kwargs.get("payload_dtype", torch.float32)
    return b3_work(tuple(planes.shape), tuple(grid.shape), torch.empty((), dtype=payload).element_size())


def read(summary):
    return share(summary, NAME)
