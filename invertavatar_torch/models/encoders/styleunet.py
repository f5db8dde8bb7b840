"""Style-U-Net conditional synthesis family, plain PyTorch (NCHW).

Counterpart of `invertavatar_tpu/models/encoders/styleunet.py` (reference
`encoder_inversion/models/networks_styleunet.py`): an `EncoderResBlock`
pyramid ingests the condition image, fusion convs inject its multi-scale
features into a decoder pyramid (optionally ConvGRU-recurrent over T frames)
that emits an image or the multi-resolution feature list. Module names follow
the torch reference key space (`encoder.{i}.fromrgb`, `fusion.{i}`,
`b{res}.conv0`, `b{res}.gru.ih.0`, ...), so `utils/weights.jax_to_state_dict`
fills them with a strict `load_state_dict`.

As in the JAX trees, only the fusion convs the forward runs exist (those of
the levels below `num_cond_res`). `CondSynthesisNetworkWithConvFusion`
builds its fusion convs for a clip length `T` fixed at construction (the
reference's 4); the JAX module sizes them from the first call's clip.
Clip inputs are [B, T, C, H, W]; the recurrent variants return the GRU
states beside their output, to be fed back as `r_list` for the next chunk.
The networks build on CUDA unless `device="cpu"`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ...ops.resize import resize_bilinear
from ...ops.upfirdn2d import downsample2d, setup_filter, upsample2d
from ...utils.misc import resolve_device
from ..layers import Conv2dLayer

_FIR = (1, 3, 3, 1)


class StyleConvGRU(nn.Module):
    """ConvGRU with equalized-lr gates (`ih.0`, `hh.0`): the gates read
    [x, h] and the candidate [x, r·h]; `ih` gives (r, z) along channels."""

    def __init__(self, channels: int):
        super().__init__()
        self.ih = nn.Sequential(Conv2dLayer(channels * 2, channels * 2, 3))
        self.hh = nn.Sequential(Conv2dLayer(channels * 2, channels, 3))

    def cell(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        r, z = torch.sigmoid(self.ih(torch.cat([x, h], dim=1))).chunk(2, dim=1)
        c = torch.tanh(self.hh(torch.cat([x, r * h], dim=1)))
        return (1 - z) * h + z * c

    def forward(self, x: torch.Tensor, h: Optional[torch.Tensor] = None):
        """x [B, T, C, H, W] (the T steps, returning the final state) or
        [B, C, H, W] (one step) -> (output, state), the same tensor."""
        if x.ndim == 4:
            out = self.cell(x, torch.zeros_like(x) if h is None else h)
            return out, out
        if h is None:
            h = torch.zeros_like(x[:, 0])
        for t in range(x.shape[1]):
            h = self.cell(x[:, t], h)
        return h, h


class EncoderResBlock(nn.Module):
    """Optional FIR downsample, lrelu `fromrgb` (+ skip), then two convs, the
    second halving the resolution; returns (the block's input image, out)."""

    def __init__(self, img_channel: int, in_channel: int, out_channel: int,
                 downsample: bool = True, fromrgb_bias: bool = True,
                 fromrgb_activation: str = "lrelu"):
        super().__init__()
        self.downsample = downsample
        self.register_buffer("resample_filter", setup_filter(_FIR), persistent=False)
        self.fromrgb = Conv2dLayer(img_channel, in_channel, 1, bias=fromrgb_bias,
                                   activation=fromrgb_activation)
        self.conv1 = Conv2dLayer(in_channel, in_channel, 3, activation="lrelu")
        self.conv2 = Conv2dLayer(in_channel, out_channel, 3, down=2, activation="lrelu")

    def forward(self, inp: torch.Tensor, skip: Optional[torch.Tensor] = None):
        if self.downsample:
            inp = downsample2d(inp, self.resample_filter)
        out = self.fromrgb(inp)
        if skip is not None:
            out = out + skip
        return inp, self.conv2(self.conv1(out))


class _UpConvs(nn.Module):
    """conv0 (2× up) and conv1, lrelu, and the lrelu ToRGB skip."""

    def __init__(self, img_channel: int, in_channel: int, out_channel: int,
                 conv1_in: Optional[int] = None, torgb: bool = True):
        super().__init__()
        self.register_buffer("resample_filter", setup_filter(_FIR), persistent=False)
        self.conv0 = Conv2dLayer(in_channel, out_channel, 3, up=2, activation="lrelu")
        self.conv1 = Conv2dLayer(conv1_in or out_channel, out_channel, 3, activation="lrelu")
        if torgb:
            self.torgb = Conv2dLayer(out_channel, img_channel, 1, activation="lrelu")

    def _skip(self, x: torch.Tensor, img: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """Upsample `img` and add this block's ToRGB of `x` (if it has one)."""
        if img is not None:
            img = upsample2d(img, self.resample_filter)
        if hasattr(self, "torgb"):
            y = self.torgb(x)
            img = img + y if img is not None else y
        return img


class DecoderBlock(_UpConvs):
    """Two up-convs + lrelu ToRGB skip accumulation."""

    def forward(self, x, img):
        x = self.conv1(self.conv0(x))
        return x, self._skip(x, img)


def _time_major(x: torch.Tensor, T: int) -> torch.Tensor:
    """[B·T, C, H, W] -> [B, T, C, H, W]."""
    return x.reshape(x.shape[0] // T, T, *x.shape[1:])


class RecurrentDecoderBlock(_UpConvs):
    """DecoderBlock whose conv1 output runs through a ConvGRU over the T
    frames; the ToRGB reads the GRU's final state ([B, ...])."""

    def __init__(self, img_channel: int, in_channel: int, out_channel: int):
        super().__init__(img_channel, in_channel, out_channel)
        self.gru = StyleConvGRU(out_channel)

    def forward(self, x, img, T: int, r=None):
        x = self.conv1(self.conv0(x))
        x, r = self.gru(_time_major(x, T), r)
        return x, self._skip(x, img), r


class DecoderBlockNew(_UpConvs):
    """DecoderBlock_new: the condition features concatenate between conv0
    and conv1; a ToRGB only for the "skip" architecture; a ConvGRU after
    conv1 with `use_gru` (then `forward` takes T and returns the state)."""

    def __init__(self, img_channel: int, in_channel: int, out_channel: int,
                 cond_channel: int = 0, architecture: str = "skip", use_gru: bool = False):
        super().__init__(img_channel, in_channel, out_channel,
                         conv1_in=out_channel + cond_channel, torgb=architecture == "skip")
        self.cond_channel = cond_channel
        self.use_gru = use_gru
        if use_gru:
            self.gru = StyleConvGRU(out_channel)

    def forward(self, x, img, cond=None, T: int = 0, r=None):
        x = self.conv0(x)
        if self.cond_channel > 0:
            x = torch.cat([x, cond], dim=1)
        x = self.conv1(x)
        if self.use_gru:
            x, r = self.gru(_time_major(x, T), r)
        img = self._skip(x, img)
        return (x, img, r) if self.use_gru else (x, img)


class ConvFusionDecoderBlock(_UpConvs):
    """ConvFusionDecoderBlock: the T frames' conv1 features stack along
    channels ((T, C) order, the reference's `flatten(1, 2)`) into one conv."""

    def __init__(self, img_channel: int, in_channel: int, out_channel: int, T: int = 4):
        super().__init__(img_channel, in_channel, out_channel)
        self.T = T
        self.conv_fusion = Conv2dLayer(out_channel * T, out_channel, 3, activation="lrelu")

    def forward(self, x, img, T: int, r=None):
        assert T == self.T, f"conv_fusion is built for T={self.T}, not {T}"
        x = self.conv1(self.conv0(x))
        x = self.conv_fusion(_time_major(x, T).flatten(1, 2))
        return x, self._skip(x, img), r


class DecoderBlockSFT(_UpConvs):
    """DecoderBlock_SFT: a ConvGRU between conv0 and conv1 (`use_gru`), and
    with `out_sft` the (scale, shift) heads `condition_scale` /
    `condition_shift` (half the channels each) on the output."""

    def __init__(self, img_channel: int, in_channel: int, out_channel: int,
                 architecture: str = "orig", use_gru: bool = False, out_sft: bool = False):
        super().__init__(img_channel, in_channel, out_channel, torgb=architecture == "skip")
        self.use_gru = use_gru
        if use_gru:
            self.gru = StyleConvGRU(out_channel)
        if out_sft:
            self.condition_scale = Conv2dLayer(out_channel, out_channel // 2, 3)
            self.condition_shift = Conv2dLayer(out_channel, out_channel // 2, 3)

    def forward(self, x, img, T: Optional[int] = None, r=None):
        x = self.conv0(x)
        if self.use_gru:
            x, r = self.gru(_time_major(x, T), r)
        x = self.conv1(x)
        img = self._skip(x, img)
        sft = None
        if hasattr(self, "condition_scale"):
            sft = (self.condition_scale(x), self.condition_shift(x))
        return x, sft, img, r


class _StyleUNet(nn.Module):
    """The shared pyramid: encoder specs, fusion specs and the used levels.

    Levels run over `block_res` = 2·final_size … img_resolution; the encoder
    runs in_size → final_size. Fusion conv i (of the i-th decoder level)
    exists where 2^(i + log2 final_size) < num_cond_res."""

    def __init__(self, img_resolution: int, img_channels: int, cond_channels: int,
                 in_size: int, final_size: int, channel_base: int, channel_max: int,
                 num_cond_res: int, fusion: bool = True):
        super().__init__()
        self.img_resolution = img_resolution
        self.img_channels = img_channels
        self.in_size = in_size
        self.final_size = final_size
        self.channel_base = channel_base
        self.channel_max = channel_max
        self.num_cond_res = num_cond_res
        self.flog2 = int(np.log2(final_size))
        log2 = int(np.log2(img_resolution))
        self.block_res = [2 ** i for i in range(self.flog2 + 1, log2 + 1)]
        enc_res = [2 ** i for i in range(int(np.log2(in_size)), self.flog2 - 1, -1)]
        self.encoder = nn.ModuleList(
            EncoderResBlock(cond_channels, self._ch(res), self._ch(res // 2),
                            downsample=res < in_size)
            for res in enc_res[:-1])
        self.fused_levels = [i for i in range(len(self.block_res))
                             if 2 ** (i + self.flog2) < num_cond_res]
        if fusion:
            specs = [(self._ch(res) * (2 if res > final_size else 1), self._ch(res))
                     for res in enc_res[::-1]]
            self.fusion = nn.ModuleDict({str(i): Conv2dLayer(*specs[i], 3)
                                         for i in self.fused_levels})
        self.start_layer = int(np.log2(32)) - self.flog2 - 1

    def _ch(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    def _encode(self, x_in: torch.Tensor) -> List[torch.Tensor]:
        """The encoder's outputs, deepest (final_size) first."""
        conds, cond_out = [], None
        for block in self.encoder:
            x_in, cond_out = block(x_in, cond_out)
            conds.append(cond_out)
        return conds[::-1]

    def _fuse(self, index: int, x, conds):
        """The level's decoder input: its fusion conv over the deepest
        feature (level 0) or [x, that level's feature]; else x."""
        if index not in self.fused_levels:
            return x
        inp = conds[0] if index == 0 else torch.cat([x, conds[index]], dim=1)
        return self.fusion[str(index)](inp)

    def _tap(self, x_list: list, index: int, x, img):
        """The `return_list` taps: [img at 32², x at 32², ..., x at the top]."""
        if index >= self.start_layer:
            if index == self.start_layer:
                x_list.append(img)
            x_list.append(x)


class CondSynthesisNetworkWithGRU(_StyleUNet):
    """Recurrent style-U-Net: a [B, T, C, H, W] clip through the encoder
    frame by frame, each decoder level's GRU folding the T frames into one
    state; returns (image | feature list, the GRU states)."""

    def __init__(self, img_resolution: int, img_channels: int, cond_channels: int = 3,
                 in_size: int = 64, final_size: int = 4, channel_base: int = 32768,
                 channel_max: int = 512, num_cond_res: int = 64, device="cuda"):
        device = resolve_device(device)
        super().__init__(img_resolution, img_channels, cond_channels, in_size, final_size,
                         channel_base, channel_max, num_cond_res)
        for res in self.block_res:
            setattr(self, f"b{res}", RecurrentDecoderBlock(img_channels, self._ch(res // 2),
                                                           self._ch(res)))
        self.to(device)

    def forward(self, x_cond: torch.Tensor, r_list=None, fix_encoder: bool = False,
                return_list: bool = False):
        assert x_cond.ndim == 5
        B, T = x_cond.shape[:2]
        conds = self._encode(x_cond.reshape(B * T, *x_cond.shape[2:]))
        if fix_encoder:
            conds = [c.detach() for c in conds]
        r_list = [None] * len(self.block_res) if r_list is None else r_list
        new_r = list(r_list)
        x = img = None
        x_list: List[torch.Tensor] = []
        for index, res in enumerate(self.block_res):
            x = self._fuse(index, x, conds)
            x, img, new_r[index] = getattr(self, f"b{res}")(x, img, T, r_list[index])
            if return_list:
                self._tap(x_list, index, x, img)
            x = x.repeat_interleave(T, dim=0)
        if return_list:
            x_list.append(img)
            return x_list, new_r
        return img, new_r


class CondSynthesisNetwork(_StyleUNet):
    """The non-recurrent style-U-Net over one condition image [B, C, H, W];
    `residual_arch` adds the condition image (antialiased to the output's
    size where the sizes differ) onto the output."""

    def __init__(self, img_resolution: int, img_channels: int, cond_channels: int = 3,
                 in_size: int = 64, final_size: int = 4, channel_base: int = 32768,
                 channel_max: int = 512, num_cond_res: int = 64, residual_arch: bool = False,
                 device="cuda"):
        device = resolve_device(device)
        super().__init__(img_resolution, img_channels, cond_channels, in_size, final_size,
                         channel_base, channel_max, num_cond_res)
        self.residual_arch = residual_arch
        for res in self.block_res:
            setattr(self, f"b{res}", DecoderBlock(img_channels, self._ch(res // 2),
                                                  self._ch(res)))
        self.to(device)

    def forward(self, x_cond: torch.Tensor, return_list: bool = False):
        assert x_cond.ndim == 4
        conds = self._encode(x_cond)
        x = img = None
        x_list: List[torch.Tensor] = []
        for index, res in enumerate(self.block_res):
            x = self._fuse(index, x, conds)
            x, img = getattr(self, f"b{res}")(x, img)
            if return_list:
                self._tap(x_list, index, x, img)
        if self.residual_arch:
            assert img.shape[1] == x_cond.shape[1]
            img = img + resize_bilinear(x_cond, tuple(img.shape[-2:]), antialias=True)
        if return_list:
            x_list.append(img)
            return x_list
        return img


class CondSynthesisNetworkNew(_StyleUNet):
    """CondSynthesisNetwork_new: no fusion convs; the encoder feature of each
    level concatenates between the decoder block's convs; only the 32² block
    has a ToRGB skip. Needs in_size == img_resolution."""

    def __init__(self, img_resolution: int, img_channels: int, cond_channels: int = 3,
                 in_size: int = 64, final_size: int = 4, channel_base: int = 32768,
                 channel_max: int = 512, num_cond_res: int = 64, device="cuda"):
        device = resolve_device(device)
        super().__init__(img_resolution, img_channels, cond_channels, in_size, final_size,
                         channel_base, channel_max, num_cond_res, fusion=False)
        for res in self.block_res:
            setattr(self, f"b{res}", DecoderBlockNew(
                img_channels, self._ch(res // 2), self._ch(res),
                cond_channel=self._ch(res) if res < img_resolution else 0,
                architecture="skip" if res == 32 else "orig"))
        self.to(device)

    def forward(self, x_cond: torch.Tensor, return_list: bool = False):
        assert x_cond.ndim == 4
        cond_list = self._encode(x_cond) + [None]  # final_size … in_size/2, then none
        x, img = cond_list[0], None
        x_list: List[torch.Tensor] = []
        for index, res in enumerate(self.block_res):
            x, img = getattr(self, f"b{res}")(x, img, cond_list[index + 1])
            if return_list:
                self._tap(x_list, index, x, img)
        if return_list:
            x_list.append(img)
            return x_list
        return img


class CondSynthesisNetworkWithConvFusion(_StyleUNet):
    """CondSynthesisNetwork_withConvFusion: `CondSynthesisNetworkWithGRU`
    with each level's GRU replaced by a conv over the T stacked frames
    (clips of exactly `T` frames); `r_list` passes through unchanged."""

    def __init__(self, img_resolution: int, img_channels: int, cond_channels: int = 3,
                 in_size: int = 64, final_size: int = 4, channel_base: int = 32768,
                 channel_max: int = 512, num_cond_res: int = 64, T: int = 4, device="cuda"):
        device = resolve_device(device)
        super().__init__(img_resolution, img_channels, cond_channels, in_size, final_size,
                         channel_base, channel_max, num_cond_res)
        for res in self.block_res:
            setattr(self, f"b{res}", ConvFusionDecoderBlock(
                img_channels, self._ch(res // 2), self._ch(res), T=T))
        self.to(device)

    def forward(self, x_cond: torch.Tensor, r_list=None, fix_encoder: bool = False,
                return_list: bool = False):
        assert x_cond.ndim == 5
        B, T = x_cond.shape[:2]
        conds = self._encode(x_cond.reshape(B * T, *x_cond.shape[2:]))
        if fix_encoder:
            conds = [c.detach() for c in conds]
        r_list = [None] * len(self.block_res) if r_list is None else r_list
        new_r = list(r_list)
        x = img = None
        x_list: List[torch.Tensor] = []
        for index, res in enumerate(self.block_res):
            x = self._fuse(index, x, conds)
            x, img, new_r[index] = getattr(self, f"b{res}")(x, img, T, r_list[index])
            if return_list:
                self._tap(x_list, index, x, img)
            x = x.repeat_interleave(T, dim=0)
        if return_list:
            x_list.append(img)
            return x_list, new_r
        return img, new_r


class CondSynthesisNetworkSFT(_StyleUNet):
    """CondSynthesisNetwork_SFT over a [B, T, C, H, W] clip: the GRU sits
    between each level's convs, and the output is {res: (scale, shift)} for
    every res ≥ `out_start_res` (the generator's CS-SFT conditions), beside
    the GRU states. Only the reference's `use_gru=True` path exists (its
    other branch re-expands an already [B·T] tensor)."""

    def __init__(self, img_resolution: int, img_channels: int, cond_channels: int = 3,
                 in_size: int = 64, final_size: int = 4, channel_base: int = 32768,
                 channel_max: int = 512, num_cond_res: int = 64, out_start_res: int = 16,
                 device="cuda"):
        device = resolve_device(device)
        super().__init__(img_resolution, img_channels, cond_channels, in_size, final_size,
                         channel_base, channel_max, num_cond_res)
        self.out_start_res = out_start_res
        for res in self.block_res:
            setattr(self, f"b{res}", DecoderBlockSFT(
                img_channels, self._ch(res // 2), self._ch(res), architecture="orig",
                use_gru=True, out_sft=res >= out_start_res))
        self.to(device)

    def forward(self, x_cond: torch.Tensor, r_list=None):
        assert x_cond.ndim == 5, "the use_gru path expects [B, T, C, H, W] clips"
        B, T = x_cond.shape[:2]
        conds = self._encode(x_cond.reshape(B * T, *x_cond.shape[2:]))
        r_list = [None] * len(self.block_res) if r_list is None else r_list
        new_r = list(r_list)
        x = img = None
        out: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        start = int(np.log2(self.out_start_res)) - self.flog2 - 1
        for index, res in enumerate(self.block_res):
            x = self._fuse(index, x, conds)
            x, sft, img, new_r[index] = getattr(self, f"b{res}")(x, img, T, r_list[index])
            if index >= start:
                out[res] = sft
            x = x.repeat_interleave(T, dim=0)
        return out, new_r


class PlainSynthesisNetwork(nn.Module):
    """The decoder-only pyramid seeded by external (x, img) features at
    `final_size` (reference networks_styleunet.py SynthesisNetwork)."""

    def __init__(self, img_resolution: int, img_channels: int, final_size: int = 4,
                 channel_base: int = 32768, channel_max: int = 512, device="cuda"):
        device = resolve_device(device)
        super().__init__()
        self.final_size = final_size
        self.flog2 = int(np.log2(final_size))
        log2 = int(np.log2(img_resolution))
        self.block_res = [2 ** i for i in range(self.flog2 + 1, log2 + 1)]
        ch = {res: min(channel_base // res, channel_max) for res in [final_size] + self.block_res}
        for res in self.block_res:
            setattr(self, f"b{res}", DecoderBlock(img_channels, ch[res // 2], ch[res]))
        self.to(device)

    def forward(self, x: torch.Tensor, img: torch.Tensor, return_list: bool = False):
        assert x.shape[-1] == img.shape[-1] == self.final_size
        start_out_res = 32
        x_list: List[torch.Tensor] = []
        if start_out_res == self.final_size:
            x_list += [img, x]
        start_layer = int(np.log2(start_out_res)) - self.flog2 - 1
        for index, res in enumerate(self.block_res):
            x, img = getattr(self, f"b{res}")(x, img)
            if return_list and index >= start_layer:
                if index == start_layer:
                    x_list.append(img)
                x_list.append(x)
        if return_list:
            x_list.append(img)
            return x_list
        return img

