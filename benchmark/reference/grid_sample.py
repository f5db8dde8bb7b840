"""[benchmark reference] A frozen copy of `invertavatar_torch/ops/grid_sample.py`: plain
PyTorch, every kernel route replaced by its plain version, nothing of the
program imported. The text below is the original module's.

Bilinear grid sampling (align_corners=False, zeros padding), plain PyTorch.

Counterpart of `invertavatar_tpu/ops/grid_sample.py`. The JAX op is written
out as four gathers because it targets the TPU; its semantics are exactly
those of `F.grid_sample(mode="bilinear", padding_mode="zeros",
align_corners=False)`, which this wraps. Taps are read in the image's dtype
and blended in float32, as in the JAX op.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample NCHW `img` at `grid` `[B, Ho, Wo, 2]` (x indexes W, y indexes H,
    both in [-1, 1]) -> `[B, C, Ho, Wo]` float32; out-of-bounds taps are zero."""
    return F.grid_sample(img.float(), grid.float(), mode="bilinear", padding_mode="zeros",
                         align_corners=False)
