"""The whole step's share of the card's dense bf16 peak: the reference's
model FLOPs a frame (convolutions and matrix products, counted once by
`torch.utils.flop_counter.FlopCounterMode`) times the frames a second of
the untraced window, the rate `frames_per_s` reads."""

from benchmark.lib.bounds import PEAK_BF16_FLOPS

NAME, UNIT, BETTER, SOURCE = "mfu", "%", "higher", "host_clock"
LAYER, MOVES = "whole step (synthesis_withTexture; Next3D synthesis)", "frames_per_s"


def read(summary):
    flops = summary.get("flops_per_frame")
    if not flops:
        return None
    return 100.0 * flops * summary["frames_per_s"] / PEAK_BF16_FLOPS
