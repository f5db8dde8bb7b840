"""Contextual (CX) loss family, plain PyTorch (NCHW).

Counterpart of `invertavatar_tpu/losses/contextual.py` (reference
encoder_inversion/criteria/cx_loss.py and criteria/contextual_loss/
functional.py): the contextual loss on cosine, L1 or L2 feature distances,
its bilateral (CoBi) blend with spatial distances, and `CXLoss` on the
relu3_4 features of VGG19 (torchvision's `features[:18]`, names
`vgg_model.slice1.{idx}`, so its state dict loads as it is). The relative
distance is clamped to ±10 as in cx_loss.py; `clamp_relative=False` gives
functional.py's unclamped form. No shipped configuration uses the loss.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_bilinear
from ..utils.misc import resolve_device


def compute_meshgrid(shape) -> torch.Tensor:
    """The (row, col) positions of an [N, C, H, W] feature map, each divided
    by its size + 1: [N, 2, H, W]."""
    N, _, H, W = shape
    rows = torch.arange(H, dtype=torch.float32) / (H + 1)
    cols = torch.arange(W, dtype=torch.float32) / (W + 1)
    rr, cc = torch.meshgrid(rows, cols, indexing="ij")
    return torch.stack([rr, cc])[None].expand(N, -1, -1, -1)


def _vectors(x: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] -> [N, HW, C]."""
    return x.reshape(x.shape[0], x.shape[1], -1).transpose(1, 2)


def compute_l2_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise squared L2 distances, at least 0: [N, HW(x), HW(y)]."""
    xv, yv = _vectors(x), _vectors(y)
    dist = (yv.square().sum(-1)[:, :, None] - 2 * (yv @ xv.transpose(1, 2))
            + xv.square().sum(-1)[:, None, :])
    return dist.transpose(1, 2).clamp(min=0.0)


def compute_l1_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """|Σ_c x − Σ_c y| pairwise: [N, HW(x), HW(y)]."""
    xs, ys = _vectors(x).sum(-1), _vectors(y).sum(-1)
    return (xs[:, :, None] - ys[:, None, :]).abs()


def compute_cosine_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """1 − cosine of the features centred on y's mean: [N, HW(x), HW(y)]."""
    y_mu = y.mean(dim=(0, 2, 3), keepdim=True)
    xn = F.normalize(x - y_mu, dim=1, eps=1e-12)
    yn = F.normalize(y - y_mu, dim=1, eps=1e-12)
    return 1.0 - _vectors(xn) @ _vectors(yn).transpose(1, 2)


def compute_relative_distance(dist_raw: torch.Tensor, clamp: bool = True) -> torch.Tensor:
    """Each distance over the row's least (+1e-5), clamped to ±10."""
    dist_tilde = dist_raw / (dist_raw.amin(dim=2, keepdim=True) + 1e-5)
    return dist_tilde.clamp(-10.0, 10.0) if clamp else dist_tilde


def compute_cx(dist_tilde: torch.Tensor, band_width: float) -> torch.Tensor:
    """The similarity softmax over y's positions."""
    w = torch.exp((1.0 - dist_tilde) / band_width)
    return w / w.sum(dim=2, keepdim=True)


def _distance(x, y, loss_type):
    if loss_type == "cosine":
        return compute_cosine_distance(x, y)
    if loss_type == "l1":
        return compute_l1_distance(x, y)
    return compute_l2_distance(x, y)


def contextual_loss(x: torch.Tensor, y: torch.Tensor, band_width: float = 0.5,
                    loss_type: str = "cosine", clamp_relative: bool = True) -> torch.Tensor:
    """The CX loss of feature maps [N, C, H, W]: −log of the mean over y's
    positions of the best contextual similarity, averaged over the batch."""
    cx = compute_cx(compute_relative_distance(_distance(x, y, loss_type), clamp=clamp_relative),
                    band_width)
    cx = cx.amax(dim=1).mean(dim=1)
    return (-torch.log(cx + 1e-5)).mean()


def contextual_bilateral_loss(x: torch.Tensor, y: torch.Tensor, weight_sp: float = 0.1,
                              band_width: float = 1.0,
                              loss_type: str = "cosine") -> torch.Tensor:
    """The CoBi loss: the feature CX blended with the CX of the positions'
    L2 distances by `weight_sp`."""
    grid = compute_meshgrid(x.shape).to(x.device)
    cx_sp = compute_cx(compute_relative_distance(compute_l2_distance(grid, grid)), band_width)
    cx_feat = compute_cx(compute_relative_distance(_distance(x, y, loss_type)), band_width)
    cx_combine = (1.0 - weight_sp) * cx_feat + weight_sp * cx_sp
    cx = cx_combine.amax(dim=2, keepdim=True).mean(dim=1)
    return (-torch.log(cx + 1e-5)).mean()


class _VGG19Slice(nn.Module):
    """torchvision vgg19 `features[:18]` (to relu3_4) as `slice1`."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for cout in (64, 64, "M", 128, 128, "M", 256, 256, 256, 256):
            if cout == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, cout, 3, padding=1), nn.ReLU()]
                cin = cout
        self.slice1 = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.slice1(x)


class CXLoss(nn.Module):
    """The CX loss of images [N, 3, H, W] on VGG19 relu3_4 features, without
    input normalisation (the reference's is commented out); images above
    256² are resized to 256² first. Built on CUDA unless `device="cpu"`."""

    def __init__(self, band_width: float = 0.5, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.band_width = band_width
        self.vgg_model = _VGG19Slice()
        self.to(device)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if x.shape[2] > 256:
            x = resize_bilinear(x, (256, 256))
            y = resize_bilinear(y, (256, 256))
        return contextual_loss(self.vgg_model(x), self.vgg_model(y), self.band_width)
