"""[benchmark reference] A frozen copy of `invertavatar_torch/ops/resize.py`: plain
PyTorch, every kernel route replaced by its plain version, nothing of the
program imported. The text below is the original module's.

Bilinear resize (half-pixel centres, optional antialias), plain PyTorch (NCHW).

Counterpart of `invertavatar_tpu/ops/resize.py`, which calls
`jax.image.resize(method="linear", antialias=...)`. `F.interpolate` with
`mode="bilinear", align_corners=False` uses the same pixel convention, and its
antialiased path widens the triangle kernel on downsampling the same way;
tests/test_torch_ops.py holds the two together for down- and up-sizing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size, antialias: bool = True) -> torch.Tensor:
    """Resize NCHW images to `size=(H, W)` (computed in float32)."""
    H, W = size
    if tuple(x.shape[-2:]) == (H, W):
        return x
    out = F.interpolate(x.float(), size=(H, W), mode="bilinear", align_corners=False,
                        antialias=antialias)
    return out.to(x.dtype)
