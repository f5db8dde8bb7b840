"""DeepLabV3 / DeepLabV3+ segmentation models, plain PyTorch (NCHW).

Counterpart of `invertavatar_tpu/models/segmentation.py` (reference
encoder_inversion/models/DeepLabV3Plus/network/{_deeplab.py, modeling.py,
utils.py}, vendored there and used by no shipped path): torchvision's
ResNet-50/101 trunk with `replace_stride_with_dilation` for output stride 8
or 16, the ASPP (1×1, three atrous 3×3 and image pooling), the DeepLabV3 and
V3+ heads, the atrous separable convolution, and the reference's `project`
head over the low-level feature. Module names are the reference's
(`backbone.conv1`, `classifier.aspp.convs.0.0`, `classifier.classifier.3`,
`project.4`, ...). BatchNorm uses its running statistics unless
`train=True`. The reference hardcodes its `project` head to 512 input
channels, which breaks its V3+ variant; here, as in the JAX package, the
head's width follows the low-level feature.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..losses.moco import _Layer, _max_pool_3x3s2p1
from ..ops.resize import resize_bilinear
from ..utils.misc import resolve_device
from .encoders.irse import BatchNorm, Conv2d


class _ConvBNReLU(nn.Module):
    """conv `0` (no bias), BatchNorm `1`, ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1, padding: int = 0,
                 dilation: int = 1):
        super().__init__()
        self.add_module("0", Conv2d(in_ch, out_ch, kernel, padding=padding, dilation=dilation,
                                    bias=False))
        self.add_module("1", BatchNorm(out_ch))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return torch.relu(getattr(self, "1")(getattr(self, "0")(x), train))


class ASPPPooling(nn.Module):
    """Global average pool, 1×1 conv `1`, BatchNorm `2`, ReLU, broadcast
    back over the feature's size."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.add_module("1", Conv2d(in_ch, out_ch, 1, bias=False))
        self.add_module("2", BatchNorm(out_ch))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        p = getattr(self, "1")(x.mean(dim=(2, 3), keepdim=True))
        p = torch.relu(getattr(self, "2")(p, train))
        return p.expand(-1, -1, *x.shape[2:])


class ASPP(nn.Module):
    """`convs`: a 1×1, three atrous 3×3 at `atrous_rates` and the image
    pooling, concatenated, then the 1×1 `project` (its dropout is the
    identity at inference)."""

    def __init__(self, in_ch: int, atrous_rates: Sequence[int], out_ch: int = 256):
        super().__init__()
        self.convs = nn.ModuleList(
            [_ConvBNReLU(in_ch, out_ch, 1)]
            + [_ConvBNReLU(in_ch, out_ch, 3, padding=r, dilation=r) for r in atrous_rates]
            + [ASPPPooling(in_ch, out_ch)])
        self.project = _ConvBNReLU(len(self.convs) * out_ch, out_ch, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.project(torch.cat([conv(x, train) for conv in self.convs], dim=1), train)


class AtrousSeparableConvolution(nn.Module):
    """`body.0`: a depthwise atrous conv (groups = in_ch), `body.1`: a
    pointwise conv."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1, padding: int = 0,
                 dilation: int = 1, bias: bool = True):
        super().__init__()
        self.body = nn.Sequential(
            Conv2d(in_ch, in_ch, kernel, stride=stride, padding=padding, dilation=dilation,
                   groups=in_ch, bias=bias),
            Conv2d(in_ch, out_ch, 1, bias=bias))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x)


class DeepLabHeadV3Plus(nn.Module):
    """The low-level feature projected to 48 channels beside the ASPP of the
    deep feature (upsampled to it), then `classifier` (3×3 conv `0`,
    BatchNorm `1`, ReLU, 1×1 conv `3` to the classes)."""

    def __init__(self, in_channels: int, low_level_channels: int, num_classes: int,
                 aspp_dilate: Sequence[int] = (12, 24, 36)):
        super().__init__()
        self.project = _ConvBNReLU(low_level_channels, 48, 1)
        self.aspp = ASPP(in_channels, aspp_dilate)
        self.classifier = nn.ModuleDict({"0": Conv2d(304, 256, 3, padding=1, bias=False),
                                         "1": BatchNorm(256),
                                         "3": Conv2d(256, num_classes, 1)})

    def forward(self, feature: Dict[str, torch.Tensor], train: bool = False) -> torch.Tensor:
        low = self.project(feature["low_level"], train)
        out = resize_bilinear(self.aspp(feature["out"], train), tuple(low.shape[2:]))
        c = self.classifier
        x = torch.relu(c["1"](c["0"](torch.cat([low, out], dim=1)), train))
        return c["3"](x)


class DeepLabHead(nn.Module):
    """`classifier`: the ASPP `0`, 3×3 conv `1`, BatchNorm `2`, ReLU, 1×1
    conv `4` to the classes."""

    def __init__(self, in_channels: int, num_classes: int,
                 aspp_dilate: Sequence[int] = (12, 24, 36)):
        super().__init__()
        self.classifier = nn.ModuleDict({"0": ASPP(in_channels, aspp_dilate),
                                         "1": Conv2d(256, 256, 3, padding=1, bias=False),
                                         "2": BatchNorm(256),
                                         "4": Conv2d(256, num_classes, 1)})

    def forward(self, feature: Dict[str, torch.Tensor], train: bool = False) -> torch.Tensor:
        c = self.classifier
        x = c["1"](c["0"](feature["out"], train))
        return c["4"](torch.relu(c["2"](x, train)))


class ResNetDilatedBackbone(nn.Module):
    """torchvision's resnet50 / 101 trunk (`layers` blocks per stage) with
    the strides of the last stages turned into dilations for
    `output_stride` 8 or 16: -> {"out": layer4, "low_level": the
    `low_level_layer`'s feature}."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), output_stride: int = 8,
                 low_level_layer: str = "layer1"):
        super().__init__()
        self.low_level_layer = low_level_layer
        if output_stride == 8:
            dilate = (False, True, True)
        else:
            dilate = (False, False, False) if output_stride == 32 else (False, False, True)
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        dilation, in_ch = 1, 64
        for idx, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if idx == 0 else 2
            first_dilation = dilation
            if idx > 0 and dilate[idx - 1]:
                dilation *= stride
                stride = 1
            self.add_module(f"layer{idx + 1}", _Layer(in_ch, planes, blocks, stride,
                                                      first_dilation=first_dilation,
                                                      dilation=dilation))
            in_ch = planes * 4

    def forward(self, x: torch.Tensor, train: bool = False) -> Dict[str, torch.Tensor]:
        x = _max_pool_3x3s2p1(torch.relu(self.bn1(self.conv1(x), train)))
        feats = {}
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x, train)
            feats[f"layer{i}"] = x
        return {"out": feats["layer4"], "low_level": feats[self.low_level_layer]}


def _upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """`nn.UpsamplingBilinear2d(scale_factor=2)` (align_corners=True)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


class _ProjectHead(nn.Module):
    """The reference's `project` over the low-level feature: 2× up, 3×3 conv
    `1` to 128, leaky ReLU 0.01, 2× up, 3×3 conv `4` to 64."""

    def __init__(self, in_ch: int = 512):
        super().__init__()
        self.add_module("1", Conv2d(in_ch, 128, 3, padding=1, bias=False))
        self.add_module("4", Conv2d(128, 64, 3, padding=1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(getattr(self, "1")(_upsample2x_align_corners(x)), 0.01)
        return getattr(self, "4")(_upsample2x_align_corners(x))


class DeepLabV3(nn.Module):
    """The reference's `_SimpleSegmentationModel`: images [B, 3, H, W] ->
    {"out": logits upsampled to H×W, "low_level": the projected low-level
    feature}."""

    def __init__(self, backbone: ResNetDilatedBackbone, classifier: nn.Module,
                 low_level_channels: int):
        super().__init__()
        self.backbone = backbone
        self.classifier = classifier
        self.project = _ProjectHead(low_level_channels)

    def forward(self, x: torch.Tensor, train: bool = False) -> Dict[str, torch.Tensor]:
        feats = self.backbone(x, train)
        logits = self.classifier(feats, train)
        return {"out": resize_bilinear(logits, tuple(x.shape[2:])),
                "low_level": self.project(feats["low_level"])}


def _factory(head: str, layers, num_classes: int, output_stride: int, device) -> DeepLabV3:
    device = resolve_device(device)
    aspp = (12, 24, 36) if output_stride == 8 else (6, 12, 18)
    if head == "deeplabv3plus":
        classifier, low, low_ch = DeepLabHeadV3Plus(2048, 256, num_classes, aspp), "layer1", 256
    else:
        classifier, low, low_ch = DeepLabHead(2048, num_classes, aspp), "layer2", 512
    backbone = ResNetDilatedBackbone(layers, output_stride, low_level_layer=low)
    return DeepLabV3(backbone, classifier, low_ch).to(device)


def deeplabv3_resnet50(num_classes: int = 21, output_stride: int = 8,
                       device="cuda") -> DeepLabV3:
    """Built on CUDA unless `device="cpu"`, as are the three below."""
    return _factory("deeplabv3", (3, 4, 6, 3), num_classes, output_stride, device)


def deeplabv3_resnet101(num_classes: int = 21, output_stride: int = 8,
                        device="cuda") -> DeepLabV3:
    return _factory("deeplabv3", (3, 4, 23, 3), num_classes, output_stride, device)


def deeplabv3plus_resnet50(num_classes: int = 21, output_stride: int = 8,
                           device="cuda") -> DeepLabV3:
    return _factory("deeplabv3plus", (3, 4, 6, 3), num_classes, output_stride, device)


def deeplabv3plus_resnet101(num_classes: int = 21, output_stride: int = 8,
                            device="cuda") -> DeepLabV3:
    return _factory("deeplabv3plus", (3, 4, 23, 3), num_classes, output_stride, device)
