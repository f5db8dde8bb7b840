"""[benchmark reference] A frozen copy of `invertavatar_torch/models/encoders/irse.py`:
plain PyTorch, nothing of the program imported. The text below is the
original module's, with two departures: the float32 operands of `Conv2d`
pass through `precision.tf32` (the control's rounding; a no-op outside it
and for bfloat16), and `BatchNorm` keeps only its evaluation branch (the
benchmark's paths never train it).

IR-SE ResNet trunk primitives, plain PyTorch (NCHW).

Module names follow the torch reference's Sequential layout (`input_layer.0`,
`body.3.res_layer.5.fc1`, ...), so the weight bridge fills them by name.

`BatchNorm` always normalises with its running statistics: the inversion
stages run the trunks with `train=False`.

Dtype policy: `Conv2d` and `PReLU` cast their float32 weights to the input's
dtype, and `BatchNorm` normalises in float32 and returns the input's dtype,
so a bfloat16 input runs the whole trunk in bfloat16 (the few-shot absorb's
`unet_eval_dtype`). `store_weights_in` rounds those weights once instead, to
the same values, so that no call casts them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .precision import tf32


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` whose weights take the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(tf32(x), tf32(self.weight.to(x.dtype)), bias)


class PReLU(nn.PReLU):
    """`nn.PReLU` whose weight takes the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.weight.to(x.dtype))


def store_weights_in(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Store the `Conv2d` and `PReLU` weights under `module` in `dtype`;
    `BatchNorm` keeps float32. Returns `module`."""
    for m in module.modules():
        if isinstance(m, (Conv2d, PReLU)):
            m.to(dtype)
    return module


class BatchNorm(nn.Module):
    """BatchNorm2d (eps 1e-5), torch parameter names, normalising by the
    running statistics."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        y = (x.float() - mean[:, None, None]) * inv[:, None, None]
        return (y + self.bias[:, None, None]).to(x.dtype)


class SEModule(nn.Module):
    """Squeeze-excite; fc1/fc2 are 1×1 convs without bias."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = Conv2d(channels, channels // reduction, 1, bias=False)
        self.fc2 = Conv2d(channels // reduction, channels, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(torch.relu(self.fc1(s))))


class BottleneckIRSE(nn.Module):
    """bottleneck_IR_SE: BN-conv-PReLU-conv-BN-SE residual + shortcut."""

    def __init__(self, in_ch: int, depth: int, stride: int):
        super().__init__()
        if in_ch == depth:
            self.shortcut_layer = nn.MaxPool2d(1, stride)
        else:
            self.shortcut_layer = nn.Sequential(
                Conv2d(in_ch, depth, 1, stride, 0, bias=False), BatchNorm(depth))
        self.res_layer = nn.Sequential(
            BatchNorm(in_ch),
            Conv2d(in_ch, depth, 3, 1, 1, bias=False),
            PReLU(depth),
            Conv2d(depth, depth, 3, stride, 1, bias=False),
            BatchNorm(depth),
            SEModule(depth, 16),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.res_layer(x) + self.shortcut_layer(x)


def get_blocks(num_layers: int = 50) -> List[Tuple[int, int, int]]:
    """(in_ch, depth, stride) per bottleneck. 8 is the tiny test layout: one
    bottleneck per stage with IR-SE-50's stage-end channels and strides."""
    cfg = {
        8: [(64, 64, 1), (64, 128, 1), (128, 256, 1), (256, 512, 1)],
        50: [(64, 64, 3), (64, 128, 4), (128, 256, 14), (256, 512, 3)],
    }[num_layers]
    out = []
    for in_ch, depth, units in cfg:
        out.append((in_ch, depth, 2))
        out.extend((depth, depth, 1) for _ in range(units - 1))
    return out


def _stage_of(tap: int) -> int:
    """Stage of a block index in the 50-layer layout (0-2 / 3-6 / 7-20 / 21-23)."""
    return 0 if tap <= 2 else 1 if tap <= 6 else 2 if tap <= 20 else 3


class IRSETrunk(nn.Module):
    """`input_layer` + IR-SE bottlenecks (`body`) with feature taps.

    `forward` returns (final, {tap: feature}). Taps are block indices; with
    `num_layers=8` they are given in the 50-layer numbering and read at the
    end of the same stage."""

    def __init__(self, inp_ch: int = 3, num_layers: int = 50, taps: Sequence[int] = (6, 20, 23)):
        super().__init__()
        self.num_layers = num_layers
        self.taps = tuple(taps)
        self.input_layer = nn.Sequential(
            Conv2d(inp_ch, 64, 3, 1, 1, bias=False), BatchNorm(64), PReLU(64))
        self.body = nn.Sequential(*(BottleneckIRSE(i, d, s) for i, d, s in get_blocks(num_layers)))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict[int, torch.Tensor]]:
        tiny = self.num_layers == 8
        wanted = {(_stage_of(t) if tiny else t) for t in self.taps}
        x = self.input_layer(x)
        seen = {}
        for i, block in enumerate(self.body):
            x = block(x)
            if i in wanted:
                seen[i] = x
        return x, {t: seen[_stage_of(t) if tiny else t] for t in self.taps}
