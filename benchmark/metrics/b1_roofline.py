"""Kernel B1 (`ops/fused_render.py:fused_render`, the name the renderer
calls) against its roofline."""

from benchmark.lib.bounds import b1_work
from benchmark.lib.roofline import share

NAME, UNIT, BETTER, SOURCE = "b1_roofline", "%", "higher", "device_trace"
LAYER, MOVES = "kernel B1 (ops/fused_render.py:fused_render)", "frames_per_s"
SITE = ("invertavatar_torch.render.renderer", "fused_render")


def work(args, kwargs):
    planes, grid, params = args[:3]
    return b1_work(tuple(planes.shape), tuple(grid.shape), tuple(params[0].shape),
                   kwargs.get("return_raw", args[5] if len(args) > 5 else False))


def read(summary):
    return share(summary, NAME)
