"""SegFormer (MixViT) blocks and the one-shot SegFormer U-Net decoders, plain
PyTorch.

Counterpart of `invertavatar_tpu/models/encoders/transformer.py` (reference
`encoder_inversion/models/mmseg/mix_transformer.py` and
`unet_transformer.py`): the MixFFN, spatial-reduction attention, pre-norm
blocks and overlapping patch embedding, and the two decoders of the improved
one-shot network: `TriPlanefeatSegformerDecoder` (texture offsets) and
`TriPlaneSFTfeatSegformerDecoder` (CS-SFT conditions). Both decode a full
IR-SE-50 trunk (taps 2, 6, 20, 21) through `UpLayer`s that mix each scale with
ViT blocks. Images are NCHW and attention tokens [B, N, C]; module names
follow the torch reference. Attention is a float32 `torch.matmul` and
softmax, as the JAX package computes it (at HIGHEST precision).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .irse import Conv2d, IRSETrunk
from .unet_encoders import UNET_TAPS, DoubleConv, _cond_head, _final_head, _fit_res, pixel_shuffle


def _to_image(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Tokens [B, H·W, C] -> [B, C, H, W]."""
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], H, W)


def _to_tokens(img: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> tokens [B, H·W, C]."""
    return img.flatten(2).transpose(1, 2)


class _DWConvWrap(nn.Module):
    """The reference's DWConv: a 3×3 depthwise conv (child `dwconv`) over the
    token grid."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 3, 1, 1, groups=dim)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        return _to_tokens(self.dwconv(_to_image(x, H, W)))


class Mlp(nn.Module):
    """MixFFN: fc1, depthwise conv, exact GELU, fc2."""

    def __init__(self, in_features: int, hidden_features: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.dwconv = _DWConvWrap(hidden_features)
        self.fc2 = nn.Linear(hidden_features, in_features)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        return self.fc2(F.gelu(self.dwconv(self.fc1(x), H, W)))


class Attention(nn.Module):
    """Spatial-reduction multi-head attention: keys and values from the
    tokens, or, with `sr_ratio` > 1, from a strided conv of their grid."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False, sr_ratio: int = 1):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.sr_ratio = sr_ratio
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv = nn.Linear(dim, dim * 2, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = Conv2d(dim, dim, sr_ratio, sr_ratio, 0)
            self.norm = nn.LayerNorm(dim)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, N, C = x.shape
        hd = C // self.num_heads
        q = self.q(x).reshape(B, N, self.num_heads, hd).transpose(1, 2)
        x_kv = self.norm(_to_tokens(self.sr(_to_image(x, H, W)))) if self.sr_ratio > 1 else x
        kv = self.kv(x_kv).reshape(B, -1, 2, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        attn = torch.softmax(torch.matmul(q, kv[0].transpose(-2, -1)) * self.scale, dim=-1)
        out = torch.matmul(attn, kv[1]).transpose(1, 2).reshape(B, N, C)
        return self.proj(out)


class Block(nn.Module):
    """Pre-norm transformer block (drop-path is identity at inference)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = False,
                 sr_ratio: int = 1):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn = Attention(dim, num_heads, qkv_bias, sr_ratio)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), H, W)
        return x + self.mlp(self.norm2(x), H, W)


class OverlapPatchEmbed(nn.Module):
    """Strided overlapping patch embedding: [B, C, H, W] -> (tokens, H', W')."""

    def __init__(self, patch_size: int = 7, stride: int = 4, in_chans: int = 3,
                 embed_dim: int = 768):
        super().__init__()
        self.proj = Conv2d(in_chans, embed_dim, patch_size, stride, patch_size // 2)
        self.norm = nn.LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor):
        x = self.proj(x)
        return self.norm(_to_tokens(x)), x.shape[2], x.shape[3]


class TransformerBlock(nn.Module):
    """Patch embedding (stride 2), `num_vit` ViT blocks (4 heads, MLP ratio
    2), LayerNorm, pixel shuffle ×2, and a 1×1 conv back to `in_chans`."""

    def __init__(self, in_chans: int, embed_dim: int = 1024, num_vit: int = 2):
        super().__init__()
        self.embed_dim = embed_dim
        self.patch_embed = OverlapPatchEmbed(7, 2, in_chans, embed_dim)
        self.ViT = nn.ModuleList(Block(embed_dim, num_heads=4, mlp_ratio=2, sr_ratio=1)
                                 for _ in range(num_vit))
        self.norm = nn.LayerNorm(embed_dim)
        self.mlp = Conv2d(embed_dim // 4, in_chans, 1, padding=0)

    def forward(self, f: torch.Tensor) -> torch.Tensor:
        tokens, H, W = self.patch_embed(f)
        for blk in self.ViT:
            tokens = blk(tokens, H, W)
        return self.mlp(pixel_shuffle(_to_image(self.norm(tokens), H, W), 2))


class UpLayer(nn.Module):
    """Pixel shuffle, concatenation with the skip tap, optional ViT mixing,
    DoubleConv."""

    def __init__(self, in_ch: int, out_ch: int, upscale: int = 2, num_vit: int = 0):
        super().__init__()
        self.upscale = upscale
        if num_vit > 0:
            self.transformer = TransformerBlock(in_ch, num_vit=num_vit)
        self.conv = DoubleConv(in_ch, out_ch)

    def forward(self, x1: torch.Tensor, x2: Optional[torch.Tensor] = None) -> torch.Tensor:
        x1 = pixel_shuffle(x1, self.upscale)
        x = x1 if x2 is None else torch.cat([x2, x1], dim=1)
        if hasattr(self, "transformer"):
            x = self.transformer(x)
        return self.conv(x)


class _SegformerBase(IRSETrunk):
    """The IR-SE-50 trunk (taps 2, 6, 20, 21) and the decoder `up1`…`up4`;
    `up4_vit` ViT blocks at the last scale."""

    def __init__(self, inp_ch: int, res: Optional[int], up4_vit: int):
        super().__init__(inp_ch, 50, taps=UNET_TAPS)
        self.res = res
        self.up1 = UpLayer(1024, 512, upscale=1, num_vit=4)
        self.up2 = UpLayer(384, 384, num_vit=4)
        self.up3 = UpLayer(224, 256, num_vit=3)
        self.up4 = UpLayer(128, 96, num_vit=up4_vit)

    def decode(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x [B, C, H, W] -> the features after up1…up4 (1/16…1/2 of the
        trunk's input)."""
        assert x.ndim == 4
        if self.res is not None:
            x = _fit_res(x, self.res)
        tp, feats = IRSETrunk.forward(self, x)
        outs = []
        for up, skip in zip((self.up1, self.up2, self.up3, self.up4),
                            (feats[21], feats[20], feats[6], feats[2])):
            tp = up(tp, skip)
            outs.append(tp)
        return outs


class TriPlanefeatSegformerDecoder(_SegformerBase):
    """One-shot texture offsets: [B, 7, 256, 256] -> offsets for the texture
    taps [img32, x32, x64, x128] (`out_channels` wide)."""

    def __init__(self, inp_ch: int = 7, res: Optional[int] = 256,
                 out_channels: Tuple[int, int, int, int] = (32, 512, 512, 256)):
        super().__init__(inp_ch, res, up4_vit=3)
        oc = out_channels
        self.outconv0 = Conv2d(384, oc[0], 1, padding=0)
        self.outconv1 = Conv2d(384, oc[1], 1, padding=0)
        self.outconv2 = Conv2d(256, oc[2], 1, padding=0)
        self.outconv3 = Conv2d(96, oc[3], 1, padding=0)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        _, t32, t64, t128 = self.decode(x)
        return [self.outconv0(t32), self.outconv1(t32), self.outconv2(t64), self.outconv3(t128)]


class TriPlaneSFTfeatSegformerDecoder(_SegformerBase):
    """One-shot CS-SFT conditions: [B, 6, 256, 256] -> {res: (scale, shift)}
    for 16…256, as wide as the generator's channel scheme (halved with
    `sft_half`)."""

    BODY_OUT = {16: 512, 32: 384, 64: 256, 128: 96, 256: 96}

    def __init__(self, inp_ch: int = 6, res: Optional[int] = 256, sft_half: bool = True,
                 channel_base: int = 32768, channel_max: int = 512):
        super().__init__(inp_ch, res, up4_vit=2)
        for r, body in self.BODY_OUT.items():
            ch = min(channel_base // r, channel_max)
            ch = ch // 2 if sft_half else ch
            self.add_module(f"condition_scale{r}", _cond_head(body, ch))
            self.add_module(f"condition_shift{r}", _cond_head(body, ch))
        self.final_head = _final_head()

    def _heads(self, r: int, tp: torch.Tensor):
        return getattr(self, f"condition_scale{r}")(tp), getattr(self, f"condition_shift{r}")(tp)

    def forward(self, x: torch.Tensor) -> Dict[int, Tuple[torch.Tensor, torch.Tensor]]:
        feats = self.decode(x)
        cond = {r: self._heads(r, tp) for r, tp in zip((16, 32, 64, 128), feats)}
        cond[256] = self._heads(256, self.final_head(pixel_shuffle(feats[-1], 2)))
        return cond
