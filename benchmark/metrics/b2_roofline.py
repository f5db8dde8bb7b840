"""Kernel B2 (`ops/fused_render.py:fused_merged_march`, the name the
renderer calls) against its roofline."""

from benchmark.lib.bounds import b2_work
from benchmark.lib.roofline import share

NAME, UNIT, BETTER, SOURCE = "b2_roofline", "%", "higher", "device_trace"
LAYER, MOVES = "kernel B2 (ops/fused_render.py:fused_merged_march)", "frames_per_s"
SITE = ("invertavatar_torch.render.renderer", "fused_merged_march")


def work(args, kwargs):
    planes, proj_m, is_fine, _src, _d_m, coarse, params = args[:7]
    S = kwargs["S"] if "S" in kwargs else args[8]
    return b2_work(tuple(planes.shape), tuple(proj_m.shape), tuple(is_fine.shape),
                   tuple(coarse.shape), tuple(params[0].shape), S)


def read(summary):
    return share(summary, NAME)
