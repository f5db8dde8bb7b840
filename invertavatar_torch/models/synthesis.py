"""StyleGAN2 synthesis network with the v20 extensions, plain PyTorch (NCHW).

Counterpart of `invertavatar_tpu/models/synthesis.py`:
  1. `return_list` multi-resolution feature taps [img_lo, x_lo, ..., x_hi, img_hi]
  2. `cond_list` face-copy alpha blending injected at each pyramid level
  3. CS-SFT `feat_conditions`, a per-resolution (scale, shift) applied to half
     the channels between conv0 and conv1

The `num_fp16_res` highest resolutions compute in bfloat16 (the JAX package's
stand-in for the reference's fp16); ToRGB outputs accumulate in float32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ops.upfirdn2d import setup_filter, upsample2d
from ..utils import trace
from ..utils.misc import assert_shape
from .layers import SynthesisLayer, ToRGBLayer
from .mapping import MappingNetwork


class SynthesisBlock(nn.Module):
    """One resolution level: (conv0 up) + conv1 + ToRGB accumulation (the
    "skip" architecture, the only one the v20 generator uses)."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, resolution: int,
                 img_channels: int, resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = 256.0, use_fp16: bool = False,
                 no_upsample: bool = False):
        super().__init__()
        self.in_channels = in_channels
        self.w_dim = w_dim
        self.resolution = resolution
        self.img_channels = img_channels
        self.use_fp16 = use_fp16
        self.no_upsample = no_upsample
        self.register_buffer("resample_filter", setup_filter(resample_filter), persistent=False)
        up = 1 if no_upsample else 2
        self.num_conv = 1 if in_channels == 0 else 2
        self.num_torgb = 1  # the "skip" architecture: every block has a ToRGB

        if in_channels == 0:
            self.const = nn.Parameter(torch.randn([out_channels, resolution, resolution]))
        else:
            self.conv0 = SynthesisLayer(in_channels, out_channels, w_dim=w_dim,
                                        resolution=resolution, up=up, conv_clamp=conv_clamp,
                                        resample_filter=resample_filter)
        self.conv1 = SynthesisLayer(out_channels, out_channels, w_dim=w_dim,
                                    resolution=resolution, conv_clamp=conv_clamp,
                                    resample_filter=resample_filter)
        self.torgb = ToRGBLayer(out_channels, img_channels, w_dim=w_dim, conv_clamp=conv_clamp)

    def forward(self, x, img, ws, condition: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                force_fp32: bool = False, noise_mode: str = "random",
                generator: Optional[torch.Generator] = None):
        assert_shape(ws, [None, self.num_conv + self.num_torgb, self.w_dim])
        dtype = torch.bfloat16 if (self.use_fp16 and not force_fp32) else torch.float32
        w_iter = iter(ws.unbind(dim=1))
        layer_kw = dict(noise_mode=noise_mode, generator=generator)

        if self.in_channels == 0:
            x = self.const.to(dtype)[None].expand(ws.shape[0], -1, -1, -1)
            with trace.span("conv1"):
                x = self.conv1(x, next(w_iter), **layer_kw)
        else:
            in_res = self.resolution if self.no_upsample else self.resolution // 2
            assert_shape(x, [None, self.in_channels, in_res, in_res])
            with trace.span("conv0"):
                x = self.conv0(x.to(dtype), next(w_iter), **layer_kw)
                if condition is not None:
                    # CS-SFT: modulate the second half of the channels
                    half = x.shape[1] // 2
                    scale, shift = condition
                    x_sft = x[:, half:] * scale.to(x.dtype) + shift.to(x.dtype)
                    x = torch.cat([x[:, :half], x_sft], dim=1)
            with trace.span("conv1"):
                x = self.conv1(x, next(w_iter), **layer_kw)

        with trace.span("torgb"):
            if img is not None and not self.no_upsample:
                in_res = self.resolution // 2
                assert_shape(img, [None, self.img_channels, in_res, in_res])
                img = upsample2d(img, self.resample_filter)

            y = self.torgb(x, next(w_iter)).float()
            img = img + y if img is not None else y

        assert x.dtype == dtype
        assert img is None or img.dtype == torch.float32
        return x, img


class SynthesisNetwork(nn.Module):
    """Full pyramid 4 → img_resolution with the v20 taps/conditioning."""

    def __init__(self, w_dim: int, img_resolution: int, img_channels: int,
                 channel_base: int = 32768, channel_max: int = 512, num_fp16_res: int = 4,
                 conv_clamp: Optional[float] = 256.0):
        super().__init__()
        self.w_dim = w_dim
        self.img_resolution = img_resolution
        log2 = int(np.log2(img_resolution))
        self.block_resolutions = [2**i for i in range(2, log2 + 1)]
        channels = {res: min(channel_base // res, channel_max) for res in self.block_resolutions}
        fp16_resolution = max(2 ** (log2 + 1 - num_fp16_res), 8)
        self.num_ws = 0
        for res in self.block_resolutions:
            self.num_ws += 1 if res == 4 else 2
            if res == img_resolution:
                self.num_ws += 1
            setattr(self, f"b{res}", SynthesisBlock(
                in_channels=channels[res // 2] if res > 4 else 0,
                out_channels=channels[res], w_dim=w_dim, resolution=res,
                img_channels=img_channels, conv_clamp=conv_clamp,
                use_fp16=(res >= fp16_resolution)))

    @trace.spanned("stylegan")
    def forward(self, ws: torch.Tensor, cond_list: Optional[List[torch.Tensor]] = None,
                return_list: bool = False,
                feat_conditions: Optional[Dict[int, Tuple[torch.Tensor, torch.Tensor]]] = None,
                out_res: Tuple[int, ...] = (32, 256), noise_mode: str = "random",
                force_fp32: bool = False, generator: Optional[torch.Generator] = None):
        assert_shape(ws, [None, self.num_ws, self.w_dim])
        ws = ws.float()
        log2 = int(np.log2(self.img_resolution))

        # Per-block w slices: a block sees num_conv + 1 ws (its ToRGB takes the
        # last) and the index advances by num_conv, so a ToRGB reuses the next
        # block's first w.
        block_ws = []
        w_idx = 0
        for res in self.block_resolutions:
            num_conv = 1 if res == 4 else 2
            block_ws.append(ws[:, w_idx:w_idx + num_conv + 1])
            w_idx += num_conv

        x = img = None
        x_list: List[torch.Tensor] = []
        start_layer = int(np.log2(out_res[0])) - 2
        end_layer = (log2 - 2) if len(out_res) == 1 else (int(np.log2(out_res[1])) - 2)
        for index, (res, cur_ws) in enumerate(zip(self.block_resolutions, block_ws)):
            cond_feat = feat_conditions.get(res) if feat_conditions is not None else None
            with trace.span(f"stylegan.b{res}"):
                x, img = getattr(self, f"b{res}")(x, img, cur_ws, condition=cond_feat,
                                                  force_fp32=force_fp32, noise_mode=noise_mode,
                                                  generator=generator)
                if index >= start_layer:
                    if return_list:
                        if index == start_layer:
                            x_list.append(img)
                        x_list.append(x)
                    if cond_list is not None:
                        if index == start_layer:
                            # face-copy blend into the low-res image tap
                            c0, a0 = cond_list[0][:, :-1], cond_list[0][:, -1:]
                            img = c0 * a0 + img * (1 - a0)
                        if index < end_layer:
                            cond = cond_list[1 + index - start_layer]
                            c, a = cond[:, :-1], cond[:, -1:]
                            x = (c * a + x.float() * (1 - a)).to(x.dtype)
        if return_list:
            x_list.append(img)
            return x_list
        return img


class Generator(nn.Module):
    """Mapping + synthesis wrapper."""

    def __init__(self, z_dim: int, c_dim: int, w_dim: int, img_resolution: int,
                 img_channels: int, mapping_ws: int = -1, channel_base: int = 32768,
                 channel_max: int = 512, num_fp16_res: int = 4,
                 conv_clamp: Optional[float] = 256.0, map_num_layers: int = 8,
                 map_lr_multiplier: float = 0.01, map_w_avg_beta: Optional[float] = 0.998):
        super().__init__()
        self.synthesis = SynthesisNetwork(w_dim=w_dim, img_resolution=img_resolution,
                                          img_channels=img_channels, channel_base=channel_base,
                                          channel_max=channel_max, num_fp16_res=num_fp16_res,
                                          conv_clamp=conv_clamp)
        self.num_ws = self.synthesis.num_ws
        self.mapping = MappingNetwork(z_dim=z_dim, c_dim=c_dim, w_dim=w_dim,
                                      num_ws=mapping_ws if mapping_ws != -1 else self.num_ws,
                                      num_layers=map_num_layers,
                                      lr_multiplier=map_lr_multiplier, w_avg_beta=map_w_avg_beta)

    def forward(self, z, c, truncation_psi=1.0, truncation_cutoff=None, update_emas=False,
                **synthesis_kwargs):
        ws = self.mapping(z, c, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff, update_emas=update_emas)
        return self.synthesis(ws, **synthesis_kwargs)
