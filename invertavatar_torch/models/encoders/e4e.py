"""e4e W+ encoder, plain PyTorch (NCHW).

Counterpart of `invertavatar_tpu/models/encoders/e4e.py`: an IR-SE trunk with
FPN laterals and `n_styles` GradualStyleBlock heads; w0 from the deepest
feature plus per-style deltas, coarse/middle/fine split at 3/7.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..layers import FullyConnectedLayer
from .irse import IRSETrunk


def _lerp_axis(x: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    """Linear resample of axis `dim` to `size` samples at source positions
    (i + 0.5)·(n − 1)/(size − 1) − 0.5, clamped to the edge samples."""
    n = x.shape[dim]
    pos = (torch.arange(size, dtype=torch.float32, device=x.device) + 0.5) * ((n - 1) / (size - 1))
    pos = (pos - 0.5).clamp(0.0, n - 1)
    i0 = pos.floor().long().clamp(max=n - 2)
    shape = [1] * x.ndim
    shape[dim] = size
    f = (pos - i0).reshape(shape).to(x.dtype)
    return x.index_select(dim, i0) * (1 - f) + x.index_select(dim, i0 + 1) * f


def upsample_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Upsample `x` to `y`'s size and add it.

    This is the JAX package's upsample (`jax.image.scale_and_translate` with
    scale (H−1)/(h−1), no translation), not torch's
    `F.interpolate(align_corners=True)` that the reference calls: the two
    differ (by up to ~1.5 at 16→32 on unit-scale features). The port
    follows the JAX package."""
    out = _lerp_axis(_lerp_axis(x.float(), y.shape[2], 2), y.shape[3], 3)
    return out.to(y.dtype) + y


class GradualStyleBlock(nn.Module):
    """log2(spatial) stride-2 conv + LeakyReLU(0.01) pairs, then an FC."""

    def __init__(self, in_c: int, out_c: int, spatial: int):
        super().__init__()
        self.out_c = out_c
        layers = []
        ch = in_c
        for _ in range(int(math.log2(spatial))):
            layers += [nn.Conv2d(ch, out_c, 3, 2, 1), nn.LeakyReLU(0.01)]
            ch = out_c
        self.convs = nn.Sequential(*layers)
        self.linear = FullyConnectedLayer(out_c, out_c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(self.convs(x).reshape(x.shape[0], self.out_c))


class Encoder4Editing(IRSETrunk):
    """The e4e encoder: 256² images [B, inp_ch, 256, 256] -> ws [B, n_styles, 512].

    `trunk_layers_n=8` builds the tiny test trunk."""

    def __init__(self, n_styles: int = 14, inp_ch: int = 3, coarse_ind: int = 3,
                 middle_ind: int = 7, trunk_layers_n: int = 50):
        super().__init__(inp_ch, trunk_layers_n, taps=(6, 20, 23))
        self.coarse_ind = coarse_ind
        self.middle_ind = middle_ind
        self.latlayer1 = nn.Conv2d(256, 512, 1)
        self.latlayer2 = nn.Conv2d(128, 512, 1)
        self.styles = nn.ModuleList(
            GradualStyleBlock(512, 512, 16 if i < coarse_ind else 32 if i < middle_ind else 64)
            for i in range(n_styles))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, feats = super().forward(x)
        c1, c2, c3 = feats[6], feats[20], feats[23]
        p2 = upsample_add(c3, self.latlayer1(c2))
        p1 = upsample_add(p2, self.latlayer2(c1))
        srcs = [c3 if i < self.coarse_ind else p2 if i < self.middle_ind else p1
                for i in range(len(self.styles))]
        deltas = [style(f) for style, f in zip(self.styles, srcs)]
        w0 = deltas[0]
        return torch.stack([w0] + [w0 + d for d in deltas[1:]], dim=1)


class E4E(nn.Module):
    """The encoder plus the `latent_avg` buffer; 512² inputs are 2×2-mean
    pooled to 256² first."""

    def __init__(self, n_styles: int = 14, inp_ch: int = 3):
        super().__init__()
        self.encoder = Encoder4Editing(n_styles, inp_ch)
        self.register_buffer("latent_avg", torch.zeros(1, 512))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[2] != 256:
            x = nn.functional.avg_pool2d(x, 2)
        return self.encoder(x) + self.latent_avg[None]


class LatentCodesDiscriminator(nn.Module):
    """The latent discriminator: an `n_mlp`-layer MLP on w -> [N, 1] logits."""

    def __init__(self, style_dim: int = 512, n_mlp: int = 4):
        super().__init__()
        layers = []
        for _ in range(n_mlp - 1):
            layers += [nn.Linear(style_dim, style_dim), nn.LeakyReLU(0.2)]
        layers.append(nn.Linear(style_dim, 1))
        self.mlp = nn.Sequential(*layers)

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        return self.mlp(w)
