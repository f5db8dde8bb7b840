"""[benchmark reference] A frozen copy of `invertavatar_torch/ops/upfirdn2d.py`: plain
PyTorch, every kernel route replaced by its plain version, nothing of the
program imported. The text below is the original module's.

Pad → upsample → FIR filter → downsample, plain PyTorch (NCHW).

Counterpart of `invertavatar_tpu/ops/upfirdn2d.py`: zero-stuff by `up`,
pad/crop by `padding` (w.r.t. the upsampled image; negative = crop), convolve
with `f` (flipped unless `flip_filter`), keep every `down`-th pixel. The FIR
runs as a single-channel `F.conv2d` over the batch of channels; separable
filters as two rank-1 passes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .misc import parse_padding, parse_scaling
from .precision import tf32


def setup_filter(f, normalize: bool = True, flip_filter: bool = False, gain: float = 1.0,
                 separable: Optional[bool] = None) -> torch.Tensor:
    """FIR filter for `upfirdn2d`: float32 `[fh, fw]` or `[taps]` (separable)."""
    if f is None:
        f = 1
    f = np.asarray(f, dtype=np.float32)
    assert f.ndim in [0, 1, 2]
    assert f.size > 0
    if f.ndim == 0:
        f = f[np.newaxis]
    if separable is None:
        separable = f.ndim == 1 and f.size >= 8
    if f.ndim == 1 and not separable:
        f = np.outer(f, f)
    assert f.ndim == (1 if separable else 2)
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f[::-1] if f.ndim == 1 else f[::-1, ::-1]
    f = f * (gain ** (f.ndim / 2))
    return torch.tensor(np.ascontiguousarray(f), dtype=torch.float32)


def filter_size(f: Optional[torch.Tensor]):
    if f is None:
        return 1, 1
    return int(f.shape[-1]), int(f.shape[0])


def pad_crop(x: torch.Tensor, px0: int, px1: int, py0: int, py1: int) -> torch.Tensor:
    """Zero-pad (positive) or crop (negative) the last two axes."""
    if px0 or px1 or py0 or py1:
        x = F.pad(x, [px0, px1, py0, py1])
    return x


def _scaled(x: torch.Tensor, gain: float) -> torch.Tensor:
    # the gain is rounded to x's dtype first, as the JAX op does
    return x * float(torch.tensor(gain).to(x.dtype)) if gain != 1.0 else x


def upfirdn2d(x: torch.Tensor, f: Optional[torch.Tensor], up=1, down=1, padding=0,
              flip_filter: bool = False, gain: float = 1.0) -> torch.Tensor:
    """Upsample, FIR-filter and downsample a batch of NCHW images."""
    assert x.ndim == 4, "expected NCHW input"
    if f is None:
        f = torch.ones((1, 1), dtype=torch.float32)
    assert f.ndim in (1, 2)
    upx, upy = parse_scaling(up)
    downx, downy = parse_scaling(down)
    px0, px1, py0, py1 = parse_padding(padding)
    B, C, H, W = x.shape

    if upx > 1 or upy > 1:
        x = x.reshape(B, C, H, 1, W, 1)
        x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
        x = x.reshape(B, C, H * upy, W * upx)
    x = pad_crop(x, px0, px1, py0, py1)

    f = f.to(device=x.device, dtype=x.dtype)
    if not flip_filter:
        f = f.flip(list(range(f.ndim)))
    # every channel takes the same filter: fold the channels into the batch
    # and run one single-channel conv. (The second derivative of a grouped
    # conv, which the R1 penalty takes, runs one conv per group: 28 s of a
    # flagship GAN step on an H100.)
    x = x.reshape(B * C, 1, *x.shape[2:])
    if f.ndim == 1:
        k = f.numel()
        x = F.conv2d(tf32(F.conv2d(tf32(x), tf32(f.reshape(1, 1, 1, k)))), tf32(f.reshape(1, 1, k, 1)))
    elif f.numel() > 1:
        x = F.conv2d(tf32(x), tf32(f[None, None]))
    else:
        x = x * f.reshape(())
    x = x.reshape(B, C, *x.shape[2:])
    x = x[:, :, ::downy, ::downx]
    return _scaled(x, gain)


def filter2d(x, f, padding=0, flip_filter=False, gain=1.0):
    """Filter NCHW images, output padded to match the input."""
    px0, px1, py0, py1 = parse_padding(padding)
    fw, fh = filter_size(f)
    p = [px0 + fw // 2, px1 + (fw - 1) // 2, py0 + fh // 2, py1 + (fh - 1) // 2]
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def upsample2d(x, f, up=2, padding=0, flip_filter=False, gain=1.0):
    """Upsample NCHW images with a FIR filter."""
    upx, upy = parse_scaling(up)
    px0, px1, py0, py1 = parse_padding(padding)
    fw, fh = filter_size(f)
    p = [
        px0 + (fw + upx - 1) // 2,
        px1 + (fw - upx) // 2,
        py0 + (fh + upy - 1) // 2,
        py1 + (fh - upy) // 2,
    ]
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter, gain=gain * upx * upy)


def downsample2d(x, f, down=2, padding=0, flip_filter=False, gain=1.0):
    """Downsample NCHW images with a FIR filter."""
    downx, downy = parse_scaling(down)
    px0, px1, py0, py1 = parse_padding(padding)
    fw, fh = filter_size(f)
    p = [
        px0 + (fw - downx + 1) // 2,
        px1 + (fw - downx) // 2,
        py0 + (fh - downy + 1) // 2,
        py1 + (fh - downy) // 2,
    ]
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter, gain=gain)
