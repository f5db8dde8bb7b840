"""Multi-scale SSIM, plain PyTorch (NCHW).

Counterpart of `invertavatar_tpu/losses/ms_ssim.py` (the reference's
encoder_inversion/criteria/ms_ssim.py semantics): per-scale SSIM and
contrast-structure with an 11-tap Gaussian window (valid convolution), 2×
average pooling between scales, weights [0.0448, 0.2856, 0.3001, 0.2363,
0.1333]. Inputs in [0, 1] by default (`val_range`). The fidelity scripts use
it as a weight-free perceptual gate.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    xs = np.arange(size) - size // 2
    g = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable depthwise valid convolution: along W, then along H."""
    C, k = x.shape[1], win.shape[0]
    x = F.conv2d(x, win.view(1, 1, 1, k).expand(C, 1, 1, k), groups=C)
    return F.conv2d(x, win.view(1, 1, k, 1).expand(C, 1, k, 1), groups=C)


def ssim(x: torch.Tensor, y: torch.Tensor, val_range: float = 1.0, win_size: int = 11,
         sigma: float = 1.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (mean SSIM, mean contrast-structure)."""
    win = torch.from_numpy(_gaussian_window(win_size, sigma)).to(x.device)
    C1 = (0.01 * val_range) ** 2
    C2 = (0.03 * val_range) ** 2
    mu_x, mu_y = _blur(x, win), _blur(y, win)
    sxx = _blur(x * x, win) - mu_x * mu_x
    syy = _blur(y * y, win) - mu_y * mu_y
    sxy = _blur(x * y, win) - mu_x * mu_y
    cs = (2 * sxy + C2) / (sxx + syy + C2)
    s = ((2 * mu_x * mu_y + C1) / (mu_x ** 2 + mu_y ** 2 + C1)) * cs
    return s.mean(), cs.mean()


def ms_ssim(x: torch.Tensor, y: torch.Tensor, val_range: float = 1.0,
            weights: Sequence[float] = _MSSSIM_WEIGHTS) -> torch.Tensor:
    """MS-SSIM over `len(weights)` scales; x, y [B, C, H, W]."""
    levels = len(weights)
    vals = []
    for i in range(levels):
        s, cs = ssim(x, y, val_range)
        vals.append(s if i == levels - 1 else cs)
        if i < levels - 1:
            x, y = F.avg_pool2d(x, 2), F.avg_pool2d(y, 2)
    vals = torch.stack(vals).clamp(min=0.0)
    return torch.prod(vals ** torch.tensor(weights, dtype=vals.dtype, device=vals.device))


def ms_ssim_loss(x: torch.Tensor, y: torch.Tensor, val_range: float = 1.0) -> torch.Tensor:
    return 1.0 - ms_ssim(x, y, val_range)
