"""Super-resolution modules (counterpart of `invertavatar_tpu/models/superresolution.py`).

The shipped 512² generator uses `SuperresolutionHybrid8XDC`: two
SynthesisBlocks (32ch→256ch@256², 256→128@512²) fed the last w repeated ×3,
with the feature/rgb inputs re-interpolated to 128² (antialiased). The 4X/2X
variants use the no-upsample first block.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.resize import resize_bilinear
from ..utils import trace
from .synthesis import SynthesisBlock


class _SRBase(nn.Module):
    block0_out = 128
    block1_out = 64
    input_resolution = 128
    block0_res = 256
    block1_res = 512
    block0_noup = False

    def __init__(self, channels: int, img_resolution: int, sr_num_fp16_res: int = 0,
                 sr_antialias: bool = True):
        super().__init__()
        self.sr_antialias = sr_antialias
        use_fp16 = sr_num_fp16_res > 0
        clamp = 256.0 if use_fp16 else None
        self.block0 = SynthesisBlock(channels, self.block0_out, w_dim=512,
                                     resolution=self.block0_res, img_channels=3,
                                     use_fp16=use_fp16, conv_clamp=clamp,
                                     no_upsample=self.block0_noup)
        self.block1 = SynthesisBlock(self.block0_out, self.block1_out, w_dim=512,
                                     resolution=self.block1_res, img_channels=3,
                                     use_fp16=use_fp16, conv_clamp=clamp)

    def _needs_resize(self, x: torch.Tensor) -> bool:
        return x.shape[-1] != self.input_resolution

    @trace.spanned("superres")
    def forward(self, rgb, x, ws, noise_mode: str = "random", generator=None):
        """rgb `[B,3,h,w]`, x `[B,C,h,w]`, ws `[B,num_ws,512]` -> `[B,3,R,R]`."""
        ws = ws[:, -1:, :].repeat(1, 3, 1)
        if self._needs_resize(x):
            size = (self.input_resolution, self.input_resolution)
            x = resize_bilinear(x, size, antialias=self.sr_antialias)
            rgb = resize_bilinear(rgb, size, antialias=self.sr_antialias)
        with trace.span(f"superres.b{self.block0_res}"):
            x, rgb = self.block0(x, rgb, ws, noise_mode=noise_mode, generator=generator)
        with trace.span(f"superres.b{self.block1_res}"):
            x, rgb = self.block1(x, rgb, ws, noise_mode=noise_mode, generator=generator)
        return rgb


class SuperresolutionHybrid8XDC(_SRBase):
    """512² SR with deeper channels: the shipped module."""

    block0_out = 256
    block1_out = 128


class SuperresolutionHybrid8X(_SRBase):
    """512² SR."""


class SuperresolutionHybrid4X(_SRBase):
    """256² SR; the first block runs at the input resolution."""

    block0_res = 128
    block1_res = 256
    block0_noup = True

    def _needs_resize(self, x: torch.Tensor) -> bool:
        return x.shape[-1] < self.input_resolution  # 4X upsamples only smaller inputs


class SuperresolutionHybrid2X(_SRBase):
    """128² SR."""

    input_resolution = 64
    block0_res = 64
    block1_res = 128
    block0_noup = True
