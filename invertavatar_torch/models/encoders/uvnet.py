"""Inversion network, plain PyTorch (NCHW): the part the e4e stage needs.

Counterpart of `invertavatar_tpu/models/encoders/uvnet.py`: `InversionNet`
holds the frozen tri-plane `generator`, the e4e `encoder` and the
`latent_avg` / `black_uv_bg` buffers, with the torch reference's names, and
`encode` gives the W+ codes. The UV-space and tri-plane U-Net offset encoders
of the one-shot and few-shot stages are not ported yet (ROADMAP A9).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.resize import resize_bilinear
from ..triplane import TriPlaneGenerator
from .e4e import Encoder4Editing


def adaptive_avg_pool(x: torch.Tensor, res: int) -> torch.Tensor:
    """AdaptiveAvgPool2d((res, res)) of NCHW `x` for an integer downscale."""
    H = x.shape[2]
    if H == res:
        return x
    assert H % res == 0, (H, res)
    return F.avg_pool2d(x, H // res)


class InversionNet(nn.Module):
    def __init__(self, generator_cfg: Dict[str, Any], n_styles: int = 14,
                 encoding_texture: bool = False, encoding_triplane: bool = False,
                 trunk_layers_n: int = 50):
        super().__init__()
        if encoding_texture or encoding_triplane:
            raise NotImplementedError(
                "the U-Net offset encoders (encoding_texture / encoding_triplane) are not "
                "ported yet (ROADMAP A9)")
        self.generator = TriPlaneGenerator(**generator_cfg)
        self.encoder = Encoder4Editing(n_styles=n_styles, inp_ch=3, trunk_layers_n=trunk_layers_n)
        self.register_buffer("latent_avg", torch.zeros(1, 512))
        self.register_buffer("black_uv_bg", -torch.ones(1, 3, 256, 256))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """e4e W+ codes + latent_avg: x [B, 3, H, W] -> [B, n_styles, 512]."""
        if x.shape[2] > 256:
            x = adaptive_avg_pool(x, 256)
        elif x.shape[2] < 256:
            # only shrunken test generators render below 256²
            x = resize_bilinear(x, (256, 256))
        return self.encoder(x) + self.latent_avg[None]
