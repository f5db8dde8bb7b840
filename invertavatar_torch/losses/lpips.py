"""LPIPS perceptual distance, plain PyTorch (NCHW inputs in [-1, 1]).

Counterpart of `invertavatar_tpu/losses/lpips.py` (the reference's
criteria/lpips v0.1): a frozen feature trunk (torchvision AlexNet or VGG16
`.features`), channel-unit-normalised activations at the standard taps,
squared differences weighted by the 1×1 `lin` heads, averaged over space and
summed over the taps, then averaged over the batch.

The module names are the JAX package's, which are the torch reference's:
`net.<index>` for the trunk's convolutions (torchvision's Sequential
indices) and `lin.<i>.1.weight` for the heads. The weights are not in the
repository: `load_lpips` reads a torch state dict in that key space by path.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..utils.misc import resolve_device

# z-score constants of the reference (networks.py:41-44)
_MEAN = (-0.030, -0.088, -0.188)
_STD = (0.458, 0.448, 0.450)

# (Sequential layout, indices of the ReLUs whose outputs are tapped, head widths)
# "C<in>,<out>,<k>,<s>,<p>" a convolution, "R" a ReLU, "M<k>,<s>" a max pool
_ALEX = (["C3,64,11,4,2", "R", "M3,2", "C64,192,5,1,2", "R", "M3,2", "C192,384,3,1,1", "R",
          "C384,256,3,1,1", "R", "C256,256,3,1,1", "R"],
         (1, 4, 7, 9, 11), (64, 192, 384, 256, 256))
_VGG_STAGES = ((3, 64, 2), (64, 128, 2), (128, 256, 3), (256, 512, 3), (512, 512, 3))


def _vgg_layout() -> Tuple[List[str], Tuple[int, ...], Tuple[int, ...]]:
    layers, taps = [], []
    for stage, (cin, cout, n) in enumerate(_VGG_STAGES):
        for i in range(n):
            layers += [f"C{cin if i == 0 else cout},{cout},3,1,1", "R"]
        taps.append(len(layers) - 1)
        if stage < len(_VGG_STAGES) - 1:
            layers.append("M2,2")
    return layers, tuple(taps), tuple(s[1] for s in _VGG_STAGES)


def _build(spec: Sequence[str]) -> nn.Sequential:
    mods = []
    for s in spec:
        if s == "R":
            mods.append(nn.ReLU())
        elif s[0] == "M":
            k, st = map(int, s[1:].split(","))
            mods.append(nn.MaxPool2d(k, st))
        else:
            cin, cout, k, st, p = map(int, s[1:].split(","))
            mods.append(nn.Conv2d(cin, cout, k, st, p))
    return nn.Sequential(*mods)


def _normalize_activation(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """LPIPS(x, y) -> scalar (the batch mean); x, y [B, 3, H, W] in [-1, 1].
    Every weight is frozen and the module stays in eval mode; gradients flow
    to the inputs."""

    def __init__(self, net_type: str = "alex"):
        super().__init__()
        if net_type == "alex":
            spec, taps, widths = _ALEX
        elif net_type == "vgg":
            spec, taps, widths = _vgg_layout()
        else:
            raise ValueError(f"net_type={net_type!r}: expected 'alex' or 'vgg'")
        self.taps = taps
        self.net = _build(spec)
        self.lin = nn.ModuleList(
            nn.Sequential(nn.Identity(), nn.Conv2d(nc, 1, 1, bias=False)) for nc in widths)
        self.register_buffer("mean", torch.tensor(_MEAN).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(_STD).view(1, 3, 1, 1), persistent=False)
        self.requires_grad_(False)
        self.eval()

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for i, layer in enumerate(self.net[:self.taps[-1] + 1]):
            x = layer(x)
            if i in self.taps:
                feats.append(_normalize_activation(x))
        return feats

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fx = self.features((x - self.mean) / self.std)
        fy = self.features((y - self.mean) / self.std)
        res = [head(torch.square(a - b)).mean(dim=(1, 2, 3))
               for head, a, b in zip(self.lin, fx, fy)]
        return torch.stack(res).sum(dim=0).mean()


_DROP_LEAVES = {"num_batches_tracked", "resample_filter"}


def load_torch_weights(module: nn.Module, path: str,
                       rename: Optional[Mapping[str, str]] = None) -> nn.Module:
    """Fill `module` from a torch state dict saved at `path` (read with
    `torch.load(weights_only=True)`: tensors only, no code runs). As the JAX
    `utils/torch_import.convert_state_dict`: `rename` maps key prefixes
    first, `num_batches_tracked` and `resample_filter` entries are dropped,
    and keys the module does not have are ignored; a key of the module that
    the file lacks is an error."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(state, Mapping):
        raise TypeError(f"{path}: expected a state dict, got {type(state).__name__}")
    tensors: Dict[str, torch.Tensor] = {}
    for name, t in state.items():
        for src, dst in (rename or {}).items():
            if name.startswith(src):
                name = dst + name[len(src):]
                break
        if name.rsplit(".", 1)[-1] not in _DROP_LEAVES:
            tensors[name] = t
    missing, _ = module.load_state_dict(tensors, strict=False)
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} of the module's entries, e.g. {missing[:5]}")
    return module


def load_lpips(path: str, net_type: str = "alex", rename: Optional[Mapping[str, str]] = None,
               device="cuda") -> LPIPS:
    """An `LPIPS` filled from the torch state dict at `path` (keys `net.<i>.*`
    and `lin.<i>.1.weight`; `rename` maps other prefixes onto them, e.g.
    `{"net.layers.": "net."}`), on CUDA unless `device="cpu"` is asked for."""
    device = resolve_device(device)
    return load_torch_weights(LPIPS(net_type), path, rename).to(device)
