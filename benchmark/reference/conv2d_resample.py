"""[benchmark reference] A frozen copy of `invertavatar_torch/ops/conv2d_resample.py`: plain
PyTorch, every kernel route replaced by its plain version, nothing of the
program imported. The text below is the original module's.

2D convolution with optional FIR up/downsampling (NCHW / OIHW), plain PyTorch.

Counterpart of `invertavatar_tpu/ops/conv2d_resample.py`. The padding algebra
is the same; the upsampling conv runs as `F.conv_transpose2d` (which skips the
structural zeros of the zero-stuffed grid) followed by the FIR.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .misc import parse_padding
from .upfirdn2d import filter_size, pad_crop, upfirdn2d
from .precision import tf32


def conv2d_resample(
    x: torch.Tensor,
    w: torch.Tensor,
    f: Optional[torch.Tensor] = None,
    up: int = 1,
    down: int = 1,
    padding=0,
    groups: int = 1,
    flip_weight: bool = True,
) -> torch.Tensor:
    """Convolve NCHW `x` with OIHW `w`, with optional FIR up/downsampling.

    `padding` is w.r.t. the upsampled image; `flip_weight=True` is correlation
    (torch conv2d semantics), False is convolution.
    """
    assert x.ndim == 4 and w.ndim == 4
    kh, kw = int(w.shape[2]), int(w.shape[3])
    fw, fh = filter_size(f)
    px0, px1, py0, py1 = parse_padding(padding)

    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2

    w = w.to(x.dtype)
    if up > 1:
        assert groups == 1
        # Correlating the zero-stuffed, (py0, py1)-padded grid with w_ (w
        # flipped unless flip_weight) equals the transposed conv with the
        # unflipped-w_ kernel, cropped/padded to the same window.
        H, W = x.shape[2], x.shape[3]
        w_t = (w.flip([2, 3]) if flip_weight else w).transpose(0, 1)
        y = F.conv_transpose2d(tf32(x), tf32(w_t), stride=up)  # [(H-1)*up + kh, (W-1)*up + kw]
        h_out = H * up + py0 + py1 - kh + 1
        w_out = W * up + px0 + px1 - kw + 1
        y0 = kh - 1 - py0
        x0 = kw - 1 - px0
        y = pad_crop(
            y,
            -x0, x0 + w_out - y.shape[3],
            -y0, y0 + h_out - y.shape[2],
        )
        y = upfirdn2d(y, f, gain=up**2)
        if down > 1:
            y = upfirdn2d(y, f, down=down)
        return y

    x = pad_crop(x, px0, px1, py0, py1)
    x = F.conv2d(tf32(x), tf32(w if flip_weight else w.flip([2, 3])), groups=groups)
    if down > 1:
        x = upfirdn2d(x, f, down=down)
    return x
