"""StyleGAN2 discriminators and the EG3D dual discriminator, plain PyTorch
(NCHW).

Counterpart of `invertavatar_tpu/models/discriminator.py` (reference
`networks_stylegan2_new.py` DiscriminatorBlock / MinibatchStdLayer /
DiscriminatorEpilogue / Discriminator and `dual_discriminator.py`):
`DualDiscriminator`, the 3D GAN's critic, scores the 512² image beside the
antialiased upsampling of the raw neural render, conditioned on the camera
through a mapping network (`cmap`). The blocks at the top `num_fp16_res`
resolutions compute in bfloat16 (the JAX package's `dtype_fp16`) unless
`force_fp32`; the epilogue computes in float32. Module names follow the torch
reference (`b512.fromrgb`, `b4.fc`, `mapping.embed`, ...). The blocks are
the reference's "resnet" architecture, the one every shipped configuration
uses (the JAX package's "skip" and "orig" variants have no caller). The video
discriminators are not ported yet (ROADMAP A12).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..ops.resize import resize_bilinear
from ..parallel.mesh import batch_rand, gather_rows, local_rows
from .layers import Conv2dLayer, FullyConnectedLayer
from .mapping import MappingNetwork


class DiscriminatorBlock(nn.Module):
    """fromrgb (the first block only), conv0, conv1 (down 2) and the 1×1
    `skip` (down 2) beside them."""

    def __init__(self, in_channels: int, tmp_channels: int, out_channels: int, resolution: int,
                 img_channels: int, activation: str = "lrelu",
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = None, use_fp16: bool = False):
        super().__init__()
        self.in_channels = in_channels
        self.resolution = resolution
        self.use_fp16 = use_fp16
        if in_channels == 0:
            self.fromrgb = Conv2dLayer(img_channels, tmp_channels, 1, activation=activation,
                                       conv_clamp=conv_clamp)
        self.conv0 = Conv2dLayer(tmp_channels, tmp_channels, 3, activation=activation,
                                 conv_clamp=conv_clamp)
        self.conv1 = Conv2dLayer(tmp_channels, out_channels, 3, activation=activation, down=2,
                                 resample_filter=resample_filter, conv_clamp=conv_clamp)
        self.skip = Conv2dLayer(tmp_channels, out_channels, 1, bias=False, down=2,
                                resample_filter=resample_filter)

    def forward(self, x: Optional[torch.Tensor], img: torch.Tensor,
                force_fp32: bool = False) -> torch.Tensor:
        """x: the previous block's features (None in the first block, which
        reads `img` instead)."""
        dtype = torch.bfloat16 if (self.use_fp16 and not force_fp32) else torch.float32
        if self.in_channels == 0:
            x = self.fromrgb(img.to(dtype))
        else:
            assert x.shape[1:] == (self.in_channels, self.resolution, self.resolution), x.shape
            x = x.to(dtype)
        y = self.skip(x, gain=math.sqrt(0.5))
        x = y + self.conv1(self.conv0(x), gain=math.sqrt(0.5))
        assert x.dtype == dtype
        return x


class MinibatchStdLayer(nn.Module):
    """Appends `num_channels` channels of the feature std over groups of
    `group_size` items (the batch index b = g·n + i), or of the largest size
    below it that divides the batch. The JAX package's layer (and the
    reference's) takes min(group_size, batch) and fails where that does not
    divide the batch, as in the few-shot D phase at batch 1, which scores 6
    or 18 frames; where it runs, the two agree. Under a data mesh the groups
    are those of the global batch, as in JAX's one program over the mesh:
    each rank gathers the features of every rank (`gather_rows`, a few KB at
    the 4² epilogue) and takes the statistics of its own rows' groups. The
    same operations run without a mesh, so that a mesh of one rank gives the
    same bits."""

    def __init__(self, group_size: Optional[int] = 4, num_channels: int = 1):
        super().__init__()
        self.group_size = group_size
        self.num_channels = num_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xg = gather_rows(x.float())
        N, C, H, W = xg.shape
        G = N if self.group_size is None else next(
            g for g in range(min(self.group_size, N), 0, -1) if N % g == 0)
        F = self.num_channels
        y = xg.reshape(G, -1, F, C // F, H, W)
        y = y - y.mean(dim=0)
        y = (y.square().mean(dim=0) + 1e-8).sqrt()
        y = y.mean(dim=(2, 3, 4))  # [n, F]
        # row b = g·n + i of the (global) batch takes group i's statistics
        y = y.index_select(0, local_rows(x.shape[0], x.device) % y.shape[0])
        return torch.cat([x, y[:, :, None, None].expand(-1, -1, H, W).to(x.dtype)], dim=1)


class DiscriminatorEpilogue(nn.Module):
    """The 4² head in float32: minibatch std, conv, fc, out, and the
    projection onto `cmap` when conditioned."""

    def __init__(self, in_channels: int, cmap_dim: int, resolution: int,
                 mbstd_group_size: Optional[int] = 4, mbstd_num_channels: int = 1,
                 activation: str = "lrelu", conv_clamp: Optional[float] = None):
        super().__init__()
        self.in_channels = in_channels
        self.cmap_dim = cmap_dim
        self.resolution = resolution
        self.mbstd = (MinibatchStdLayer(mbstd_group_size, mbstd_num_channels)
                      if mbstd_num_channels > 0 else None)
        self.conv = Conv2dLayer(in_channels + mbstd_num_channels, in_channels, 3,
                                activation=activation, conv_clamp=conv_clamp)
        self.fc = FullyConnectedLayer(in_channels * resolution ** 2, in_channels,
                                      activation=activation)
        self.out = FullyConnectedLayer(in_channels, 1 if cmap_dim == 0 else cmap_dim)

    def forward(self, x: torch.Tensor, cmap: Optional[torch.Tensor]) -> torch.Tensor:
        assert x.shape[1:] == (self.in_channels, self.resolution, self.resolution), x.shape
        x = x.float()
        if self.mbstd is not None:
            x = self.mbstd(x)
        x = self.out(self.fc(self.conv(x).flatten(1)))
        if self.cmap_dim > 0:
            x = (x * cmap).sum(dim=1, keepdim=True) * (1 / math.sqrt(self.cmap_dim))
        return x


class _DiscriminatorCore(nn.Module):
    """The block pyramid `b{res}` from `img_resolution` down to 8², the
    camera mapping and the `b4` epilogue."""

    def __init__(self, c_dim: int, img_resolution: int, img_channels: int,
                 channel_base: int = 32768,
                 channel_max: int = 512, num_fp16_res: int = 4,
                 conv_clamp: Optional[float] = 256.0, cmap_dim: Optional[int] = None,
                 disc_c_noise: float = 0.0, mbstd_group_size: Optional[int] = 4):
        super().__init__()
        self.c_dim = c_dim
        self.img_resolution = img_resolution
        self.disc_c_noise = disc_c_noise
        log2 = int(np.log2(img_resolution))
        self.block_resolutions = [2 ** i for i in range(log2, 2, -1)]
        fp16_resolution = max(2 ** (log2 + 1 - num_fp16_res), 8)

        def channels(res):
            return min(channel_base // res, channel_max)

        if cmap_dim is None:
            cmap_dim = channels(4)
        if c_dim == 0:
            cmap_dim = 0
        for res in self.block_resolutions:
            self.add_module(f"b{res}", DiscriminatorBlock(
                channels(res) if res < img_resolution else 0, channels(res), channels(res // 2),
                res, img_channels, conv_clamp=conv_clamp, use_fp16=res >= fp16_resolution))
        if c_dim > 0:
            self.mapping = MappingNetwork(0, c_dim, cmap_dim, num_ws=None, w_avg_beta=None)
        self.b4 = DiscriminatorEpilogue(channels(4), cmap_dim, 4, conv_clamp=conv_clamp,
                                        mbstd_group_size=mbstd_group_size)

    def _score(self, img: torch.Tensor, c: Optional[torch.Tensor],
               force_fp32: bool = False) -> torch.Tensor:
        x = None
        for res in self.block_resolutions:
            x = getattr(self, f"b{res}")(x, img, force_fp32=force_fp32)
        cmap = self.mapping(None, c) if self.c_dim > 0 else None
        return self.b4(x, cmap)


class Discriminator(_DiscriminatorCore):
    """The single-image StyleGAN2 discriminator: img [B, C, R, R], c -> [B, 1]."""

    def forward(self, img: torch.Tensor, c: Optional[torch.Tensor],
                force_fp32: bool = False) -> torch.Tensor:
        return self._score(img, c, force_fp32=force_fp32)


class DualDiscriminator(_DiscriminatorCore):
    """The EG3D dual discriminator: {"image": [B, 3, R, R], "image_raw": [B,
    3, r, r]}, camera c [B, ≥c_dim] -> logits [B, 1]. `img_channels` counts
    the pair (6). `disc_c_noise` > 0 jitters the camera by `generator`'s
    draws times its per-column std."""

    def forward(self, img: Dict[str, torch.Tensor], c: Optional[torch.Tensor],
                force_fp32: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        image = img["image"]
        image_raw = resize_bilinear(img["image_raw"], tuple(image.shape[2:]), antialias=True)
        if self.c_dim > 0 and c is not None:
            c = c[:, :self.c_dim]
            if self.disc_c_noise > 0:
                noise = batch_rand(c.shape, generator, c.device, normal=True)
                c = c + noise * gather_rows(c).std(dim=0) * self.disc_c_noise
        return self._score(torch.cat([image, image_raw], dim=1), c, force_fp32=force_fp32)


class SingleDiscriminator(_DiscriminatorCore):
    """Scores the 512² image alone."""

    def forward(self, img: Dict[str, torch.Tensor], c: Optional[torch.Tensor],
                force_fp32: bool = False) -> torch.Tensor:
        return self._score(img["image"], c, force_fp32=force_fp32)


class DummyDualDiscriminator(_DiscriminatorCore):
    """The dual discriminator whose raw half fades out: `raw_fade` scales the
    upsampled raw image."""

    def forward(self, img: Dict[str, torch.Tensor], c: Optional[torch.Tensor],
                raw_fade: float = 1.0, force_fp32: bool = False) -> torch.Tensor:
        image = img["image"]
        image_raw = resize_bilinear(img["image_raw"], tuple(image.shape[2:]),
                                    antialias=True) * raw_fade
        return self._score(torch.cat([image, image_raw], dim=1), c, force_fp32=force_fp32)


def filtered_resizing(image: torch.Tensor, size: int, filter_mode="antialiased") -> torch.Tensor:
    """Resize NCHW images to size² by the dual discriminator's modes:
    "antialiased", "none", or a float blend of the two (the antialiased
    share)."""
    if filter_mode == "antialiased":
        return resize_bilinear(image, (size, size), antialias=True)
    if filter_mode == "none":
        return resize_bilinear(image, (size, size), antialias=False)
    if isinstance(filter_mode, float):
        assert 0 < filter_mode < 1
        filtered = resize_bilinear(image, (size, size), antialias=True)
        aliased = resize_bilinear(image, (size, size), antialias=False)
        return (1 - filter_mode) * aliased + filter_mode * filtered
    raise ValueError(f"unsupported filter_mode {filter_mode}")
