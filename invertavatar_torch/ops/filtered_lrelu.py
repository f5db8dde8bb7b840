"""Filtered leaky ReLU, plain PyTorch (NCHW).

Counterpart of `invertavatar_tpu/ops/filtered_lrelu.py` (reference
torch_utils/ops/filtered_lrelu.py `_filtered_lrelu_ref`), the StyleGAN3
antialiased nonlinearity: bias, FIR upsampling by `up` through `fu`, leaky
ReLU with gain and clamp, FIR downsampling by `down` through `fd`. Composed
from the port's `upfirdn2d` and `bias_act`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .bias_act import bias_act
from .upfirdn2d import upfirdn2d


def filtered_lrelu(x: torch.Tensor, fu: Optional[torch.Tensor] = None,
                   fd: Optional[torch.Tensor] = None, b: Optional[torch.Tensor] = None,
                   up: int = 1, down: int = 1, padding=0, gain: float = math.sqrt(2.0),
                   slope: float = 0.2, clamp: Optional[float] = None,
                   flip_filter: bool = False) -> torch.Tensor:
    """x [B, C, H, W]; `fu` / `fd` the up / down FIR filters (None: no
    filter); `b` [C]; `padding` on the upsampled image, as `upfirdn2d`
    takes it."""
    assert x.ndim == 4
    assert up >= 1 and down >= 1
    assert gain > 0 and slope >= 0
    x = bias_act(x, b)
    x = upfirdn2d(x, fu, up=up, padding=padding, gain=up ** 2, flip_filter=flip_filter)
    x = bias_act(x, None, act="lrelu", alpha=slope, gain=gain, clamp=clamp)
    return upfirdn2d(x, fd, down=down, flip_filter=flip_filter)
