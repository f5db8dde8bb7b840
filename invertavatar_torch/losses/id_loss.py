"""ArcFace identity loss, plain PyTorch (NCHW).

Counterpart of `invertavatar_tpu/losses/id_loss.py` (the reference's
criteria/id_loss.py with model_irse.Backbone(112, 50, 'ir_se')): crop
[35:223, 32:220] of the image, resize to 112², embed with the IR-SE-50
ArcFace backbone to a unit 512-vector; the loss is 1 − ⟨f(x), f(y)⟩ averaged
over the batch.

The module names are the published `model_ir_se50.pth`'s (`input_layer.*`,
`body.*`, `output_layer.{0,3,4}.*`), so `load_arcface` reads that file by
path. It is not in the repository.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn as nn

from ..models.encoders.irse import BatchNorm, IRSETrunk
from ..ops.resize import resize_bilinear
from ..utils.misc import resolve_device
from .lpips import load_torch_weights


class _BN1d(nn.Module):
    """torch.nn.BatchNorm1d in inference form (the loss net is frozen)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean) * inv + self.bias


def _output_layer() -> nn.Sequential:
    """Sequential(BN2d, Dropout, Flatten, Linear(512·7·7, 512), BN1d); the
    dropout is the identity of a frozen net, the flatten is NCHW order."""
    return nn.Sequential(BatchNorm(512), nn.Identity(), nn.Flatten(),
                         nn.Linear(512 * 7 * 7, 512), _BN1d(512))


class ArcFaceBackbone(IRSETrunk):
    """model_irse.Backbone(112, 50, 'ir_se'): x [B, 3, 112, 112] -> unit
    embeddings [B, 512]. Frozen, in inference form."""

    def __init__(self):
        super().__init__(inp_ch=3, num_layers=50, taps=())
        self.output_layer = _output_layer()
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, _ = super().forward(x)
        x = self.output_layer(x)
        return x / torch.linalg.norm(x, dim=1, keepdim=True)


def extract_feats(backbone, x: torch.Tensor) -> torch.Tensor:
    """Crop [35:223, 32:220] and resize to 112² (antialiased bilinear, as
    `jax.image.resize(..., "linear")` downsamples), then embed. Those are
    256² indices: a larger image is cropped with them as they are."""
    x = x[:, :, 35:223, 32:220]
    return backbone(resize_bilinear(x, (112, 112), antialias=True))


def id_loss(backbone, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """1 − cosine similarity of the embeddings, averaged over the batch."""
    fx = extract_feats(backbone, x)
    fy = extract_feats(backbone, y)
    return torch.mean(1.0 - torch.sum(fx * fy, dim=1))


def load_arcface(path: str, rename: Optional[Mapping[str, str]] = None,
                 device="cuda") -> ArcFaceBackbone:
    """An `ArcFaceBackbone` filled from the torch state dict at `path` (the
    published `model_ir_se50.pth` key space), on CUDA unless `device="cpu"`
    is asked for."""
    device = resolve_device(device)
    return load_torch_weights(ArcFaceBackbone(), path, rename).to(device)
