"""[benchmark reference] A frozen copy of `invertavatar_torch/render/ray_marcher.py`: plain
PyTorch, every kernel route replaced by its plain version, nothing of the
program imported. The text below is the original module's.

MipNeRF-style ray marching (counterpart of `invertavatar_tpu/render/ray_marcher.py`).

Midpoint colors/densities, softplus(σ−1) density activation, alpha compositing
with cumulative-product transmittance, depth clamped to the sampled range, rgb
scaled to (−1, 1). All float32.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def mip_ray_march(colors: torch.Tensor,  # [B, R, S, C]
                  densities: torch.Tensor,  # [B, R, S, 1]
                  depths: torch.Tensor,  # [B, R, S, 1]
                  white_back: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    colors = colors.float()
    dens = densities.float()[..., 0]
    dep = depths.float()[..., 0]

    deltas = dep[:, :, 1:] - dep[:, :, :-1]
    densities_mid = F.softplus((dens[:, :, :-1] + dens[:, :, 1:]) * 0.5 - 1.0)
    depths_mid = (dep[:, :, :-1] + dep[:, :, 1:]) * 0.5

    alpha = 1.0 - torch.exp(-densities_mid * deltas)
    alpha_shifted = torch.cat([torch.ones_like(alpha[:, :, :1]), 1.0 - alpha + 1e-10], dim=-1)
    weights = alpha * torch.cumprod(alpha_shifted, dim=-1)[:, :, :-1]  # [B, R, S-1]

    colors_mid = (colors[:, :, :-1] + colors[:, :, 1:]) * 0.5
    composite_rgb = torch.einsum("brs,brsc->brc", weights, colors_mid)
    weight_total = weights.sum(dim=-1, keepdim=True)
    composite_depth = (weights * depths_mid).sum(dim=-1, keepdim=True) / weight_total
    composite_depth = torch.nan_to_num(composite_depth, nan=float("inf"), posinf=float("inf"))
    composite_depth = torch.clamp(composite_depth, dep.min(), dep.max())

    if white_back:
        composite_rgb = composite_rgb + 1.0 - weight_total

    composite_rgb = composite_rgb * 2.0 - 1.0
    return composite_rgb, composite_depth, weights[..., None]
