"""MoCo-v2 feature-similarity loss, plain PyTorch (NCHW).

Counterpart of `invertavatar_tpu/losses/moco.py` (reference
encoder_inversion/criteria/moco_loss.py): the cosine alignment of
L2-normalised ResNet-50 features (torchvision's trunk through the global
average pool, without `fc`) at 224². Module names are torchvision's
(`conv1`, `bn1`, `layer{1..4}.{i}.conv{1..3}` / `bn{1..3}` /
`downsample.{0,1}`), so the published MoCo checkpoint loads once the
reference's `module.encoder_q.` prefix is stripped. No shipped configuration
uses the loss. The trunk's blocks also build the DeepLab backbones
(`models/segmentation.py`).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.encoders.irse import BatchNorm, Conv2d
from ..ops.resize import resize_bilinear
from ..utils.misc import resolve_device


def _max_pool_3x3s2p1(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2, padding=1)


class Bottleneck(nn.Module):
    """torchvision's Bottleneck (expansion 4); `dilation` as its
    `replace_stride_with_dilation` sets it in the DeepLab backbones. Its
    BatchNorms take the batch statistics when `train`."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1, has_downsample: bool = False,
                 dilation: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_ch, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=dilation,
                            dilation=dilation, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = (nn.ModuleList([Conv2d(in_ch, planes * 4, 1, stride=stride, bias=False),
                                          BatchNorm(planes * 4)])
                           if has_downsample else None)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x), train))
        out = torch.relu(self.bn2(self.conv2(out), train))
        out = self.bn3(self.conv3(out), train)
        if self.downsample is not None:
            conv, bn = self.downsample
            x = bn(conv(x), train)
        return torch.relu(out + x)


class _Layer(nn.Module):
    """`blocks` Bottlenecks `0`..: the first strides (with `first_dilation`)
    and projects the identity, the rest keep the shape (with `dilation`)."""

    def __init__(self, in_ch: int, planes: int, blocks: int, stride: int,
                 first_dilation: int = 1, dilation: int = 1):
        super().__init__()
        self.blocks = blocks
        self.add_module("0", Bottleneck(in_ch, planes, stride=stride, has_downsample=True,
                                        dilation=first_dilation))
        for i in range(1, blocks):
            self.add_module(str(i), Bottleneck(planes * 4, planes, dilation=dilation))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(self.blocks):
            x = getattr(self, str(i))(x, train)
        return x


class ResNet50Trunk(nn.Module):
    """torchvision resnet50 without `fc`: [B, 3, H, W] -> pooled [B, 2048]."""

    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        self.layer1 = _Layer(64, 64, 3, 1)
        self.layer2 = _Layer(256, 128, 4, 2)
        self.layer3 = _Layer(512, 256, 6, 2)
        self.layer4 = _Layer(1024, 512, 3, 2)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = _max_pool_3x3s2p1(torch.relu(self.bn1(self.conv1(x), train)))
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x, train)
        return x.mean(dim=(2, 3))


class MocoLoss(nn.Module):
    """`forward(y_hat, y, x)` -> (loss, sim_improvement): 1 − cos(ŷ, y) and
    the mean of cos(ŷ, y) − cos(y, x) over the batch, the target's features
    without gradient (the reference's per-sample logs are dropped). Images
    [B, 3, H, W]. Built on CUDA unless `device="cpu"`."""

    def __init__(self, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.model = ResNet50Trunk()
        self.to(device)

    def extract_feats(self, x: torch.Tensor) -> torch.Tensor:
        return F.normalize(self.model(resize_bilinear(x, (224, 224))), dim=1, eps=1e-12)

    def forward(self, y_hat: torch.Tensor, y: torch.Tensor,
                x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x_f = self.extract_feats(x)
        with torch.no_grad():
            y_f = self.extract_feats(y)
        yh_f = self.extract_feats(y_hat)
        diff_target = (yh_f * y_f).sum(dim=1)
        diff_views = (y_f * x_f).sum(dim=1)
        return (1.0 - diff_target).mean(), (diff_target - diff_views).mean()
