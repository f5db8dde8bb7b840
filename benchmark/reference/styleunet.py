"""[benchmark reference] A frozen copy of `invertavatar_torch/models/encoders/styleunet.py`:
plain PyTorch, nothing of the program imported; of the module, only the
encoder block that Next3D's conditional generators build on.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .upfirdn2d import downsample2d, setup_filter
from .layers import Conv2dLayer

_FIR = (1, 3, 3, 1)


class EncoderResBlock(nn.Module):
    """Optional FIR downsample, lrelu `fromrgb` (+ skip), then two convs, the
    second halving the resolution; returns (the block's input image, out)."""

    def __init__(self, img_channel: int, in_channel: int, out_channel: int,
                 downsample: bool = True, fromrgb_bias: bool = True,
                 fromrgb_activation: str = "lrelu"):
        super().__init__()
        self.downsample = downsample
        self.register_buffer("resample_filter", setup_filter(_FIR), persistent=False)
        self.fromrgb = Conv2dLayer(img_channel, in_channel, 1, bias=fromrgb_bias,
                                   activation=fromrgb_activation)
        self.conv1 = Conv2dLayer(in_channel, in_channel, 3, activation="lrelu")
        self.conv2 = Conv2dLayer(in_channel, out_channel, 3, down=2, activation="lrelu")

    def forward(self, inp: torch.Tensor, skip: Optional[torch.Tensor] = None):
        if self.downsample:
            inp = downsample2d(inp, self.resample_filter)
        out = self.fromrgb(inp)
        if skip is not None:
            out = out + skip
        return inp, self.conv2(self.conv1(out))
