"""ConvGRU U-Net offset encoders of the few-shot stage, plain PyTorch (NCHW).

Counterpart of `invertavatar_tpu/models/encoders/unet_encoders.py` (reference
encoder_inversion/models/unet_encoders.py). Two IR-SE U-Nets predict offsets
on top of the e4e inversion:
  * `TriPlanefeatEncoder` ("texture_unet"): 7-channel UV-space input →
    additive offsets for the texture feature taps at 32/32/64/128;
  * `TriPlaneSFTfeatEncoder` ("triplane_unet"): 6-channel image-space input →
    per-resolution CS-SFT (scale, shift) for the static backbone.
Both gather evidence over T frames through ConvGRU cells in the decoder; the
states carry across chunks. Inputs are [B, T, C, H, W]; module names follow
the torch reference, so the weight bridge and checkpoint import fill them by
name. The modules follow the input's dtype (see `irse`): a bfloat16 input and
bfloat16 states run the U-Net in bfloat16 with BatchNorm in float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.resize import resize_bilinear
from .irse import BatchNorm, Conv2d, IRSETrunk, PReLU

UNET_TAPS = (2, 6, 20, 21)  # trunk taps the decoders read (50-layer numbering)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    return x if r == 1 else F.pixel_shuffle(x, r)


def adaptive_avg_pool(x: torch.Tensor, res: int) -> torch.Tensor:
    """AdaptiveAvgPool2d((res, res)) of NCHW `x` for an integer downscale."""
    H = x.shape[2]
    if H == res:
        return x
    assert H % res == 0, (H, res)
    return F.avg_pool2d(x, H // res)


def _fit_res(x: torch.Tensor, res: int) -> torch.Tensor:
    """Pool down to `res` or, for shrunken test inputs only, resize up."""
    if x.shape[2] == res:
        return x
    if x.shape[2] > res:
        return adaptive_avg_pool(x, res)
    return resize_bilinear(x, (res, res))


def _expand_T(x: torch.Tensor, T: int) -> torch.Tensor:
    """[B, C, H, W] -> [B·T, C, H, W], each item repeated T times in place."""
    return x.repeat_interleave(T, dim=0)


class ConvGRU(nn.Module):
    """Convolutional GRU over feature maps: the gates read [x, h] and the
    candidate [x, r·h]; `ih` gives (r, z) along channels."""

    def __init__(self, channels: int):
        super().__init__()
        self.ih = nn.Sequential(Conv2d(channels * 2, channels * 2, 3, 1, 1))
        self.hh = nn.Sequential(Conv2d(channels * 2, channels, 3, 1, 1))

    def cell(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        r, z = torch.sigmoid(self.ih(torch.cat([x, h], dim=1))).chunk(2, dim=1)
        c = torch.tanh(self.hh(torch.cat([x, r * h], dim=1)))
        return (1 - z) * h + z * c

    def forward(self, x: torch.Tensor, h: Optional[torch.Tensor] = None, seq2seq: bool = False):
        """x: [B, T, C, H, W] (a time series) or [B, C, H, W] (one frame) ->
        (output, final state); `seq2seq` returns every step's output."""
        if x.ndim == 4:
            out = self.cell(x, torch.zeros_like(x) if h is None else h)
            return out, out
        if h is None:
            h = torch.zeros_like(x[:, 0])
        outs = []
        for t in range(x.shape[1]):
            h = self.cell(x[:, t], h)
            outs.append(h)
        return (torch.stack(outs, dim=1) if seq2seq else h), h


class DoubleConv(nn.Module):
    """BN, two (conv, PReLU), PReLU."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.double_conv = nn.Sequential(
            BatchNorm(in_ch), Conv2d(in_ch, out_ch, 3, 1, 1), PReLU(out_ch),
            Conv2d(out_ch, out_ch, 3, 1, 1), PReLU(out_ch), PReLU(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.double_conv(x)


class Up(nn.Module):
    """PixelShuffle, concatenation with the skip tap, DoubleConv."""

    def __init__(self, in_ch: int, out_ch: int, upscale: int = 2):
        super().__init__()
        self.upscale = upscale
        self.conv = DoubleConv(in_ch, out_ch)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.cat([x2, pixel_shuffle(x1, self.upscale)], dim=1))


class RecurrentUp(Up):
    """`Up`, then a ConvGRU over the T frames of each item."""

    def __init__(self, in_ch: int, out_ch: int, upscale: int = 2):
        super().__init__(in_ch, out_ch, upscale)
        self.conv_gru = ConvGRU(out_ch)

    def forward(self, x1, x2, T: int, r: Optional[torch.Tensor] = None, seq2seq: bool = False):
        x = super().forward(x1, x2)
        return self.conv_gru(x.reshape(x.shape[0] // T, T, *x.shape[1:]), r, seq2seq)


class _UNetBase(IRSETrunk):
    """The IR-SE trunk with taps (2, 6, 20, 21) and the four-stage decoder
    `up1`…`up4` (recurrent with `use_gru`)."""

    def __init__(self, inp_ch: int, res: Optional[int], use_gru: bool, trunk_layers_n: int):
        super().__init__(inp_ch, trunk_layers_n, taps=UNET_TAPS)
        self.res = res
        self.use_gru = use_gru
        up = RecurrentUp if use_gru else Up
        self.up1 = up(1024, 512, upscale=1)
        self.up2 = up(384, 384)
        self.up3 = up(224, 256)
        self.up4 = up(128, 96)

    def decode(self, x: torch.Tensor, r_list: Optional[Sequence]):
        """x [B, T, C, H, W] -> (the decoder features after up1…up4, at 1/16…1/2
        of the input, each [B·T, ·]; the new GRU states, None without GRUs)."""
        assert x.ndim == 5, "expected [B, T, C, H, W]"
        B, T = x.shape[:2]
        x = x.reshape(B * T, *x.shape[2:])
        if self.res is not None:
            x = _fit_res(x, self.res)
        tp, feats = IRSETrunk.forward(self, x)
        r_list = [None] * 4 if r_list is None else list(r_list)
        outs, new_r = [], []
        for i, (up, skip) in enumerate(zip((self.up1, self.up2, self.up3, self.up4),
                                           (feats[21], feats[20], feats[6], feats[2]))):
            if self.use_gru:
                tp, r = up(tp if i == 0 else _expand_T(tp, T), skip, T, r_list[i])
                new_r.append(r)
            else:
                tp = up(tp, skip)
            outs.append(tp)
        return outs, (new_r if self.use_gru else None)


class TriPlanefeatEncoder(_UNetBase):
    """texture_unet: [B, T, 7, 256, 256] (UV texture 3, UV Δimage 3, mask 1)
    -> offsets for the texture taps [img32, x32, x64, x128] (`out_channels`
    wide) and the GRU states."""

    def __init__(self, inp_ch: int = 7, res: Optional[int] = 256, use_gru: bool = True,
                 out_channels: Tuple[int, int, int, int] = (32, 512, 512, 256),
                 trunk_layers_n: int = 50):
        super().__init__(inp_ch, res, use_gru, trunk_layers_n)
        oc = out_channels
        self.outconv0 = Conv2d(384, oc[0], 1, padding=0)
        self.outconv1 = Conv2d(384, oc[1], 1, padding=0)
        self.outconv2 = Conv2d(256, oc[2], 1, padding=0)
        self.outconv3 = Conv2d(96, oc[3], 1, padding=0)

    def forward(self, x: torch.Tensor, r_list=None):
        (_, t32, t64, t128), new_r = self.decode(x, r_list)
        return [self.outconv0(t32), self.outconv1(t32), self.outconv2(t64),
                self.outconv3(t128)], new_r


def _cond_head(in_ch: int, out_ch: int) -> nn.Sequential:
    return nn.Sequential(Conv2d(in_ch, in_ch, 3, 1, 1), nn.LeakyReLU(0.2),
                         Conv2d(in_ch, out_ch, 3, 1, 1))


def _final_head() -> nn.Sequential:
    """The 256² SFT head's trunk: 24 -> 96 channels, two (conv, PReLU)."""
    return nn.Sequential(Conv2d(24, 96, 3, 1, 1), PReLU(96), Conv2d(96, 96, 3, 1, 1), PReLU(96))


class TriPlaneSFTfeatEncoder(_UNetBase):
    """triplane_unet: [B, T, 6, 256, 256] (image 3, Δimage 3) -> {res:
    (scale, shift)} for 16…256 with the GRU states. The widths follow the
    generator's channel scheme (`channel_base`, `channel_max`), halved with
    `sft_half`."""

    BODY_OUT = {16: 512, 32: 384, 64: 256, 128: 96, 256: 96}

    def __init__(self, inp_ch: int = 6, res: Optional[int] = 256, use_gru: bool = True,
                 sft_half: bool = True, channel_base: int = 32768, channel_max: int = 512,
                 trunk_layers_n: int = 50):
        super().__init__(inp_ch, res, use_gru, trunk_layers_n)
        for r, body in self.BODY_OUT.items():
            ch = min(channel_base // r, channel_max)
            ch = ch // 2 if sft_half else ch
            self.add_module(f"condition_scale{r}", _cond_head(body, ch))
            self.add_module(f"condition_shift{r}", _cond_head(body, ch))
        self.final_head = _final_head()

    def _heads(self, r: int, tp: torch.Tensor):
        return getattr(self, f"condition_scale{r}")(tp), getattr(self, f"condition_shift{r}")(tp)

    def forward(self, x: torch.Tensor, r_list=None):
        feats, new_r = self.decode(x, r_list)
        cond: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {
            r: self._heads(r, tp) for r, tp in zip((16, 32, 64, 128), feats)}
        cond[256] = self._heads(256, self.final_head(pixel_shuffle(feats[-1], 2)))
        return cond, new_r
