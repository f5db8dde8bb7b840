"""[benchmark reference] A frozen copy of `invertavatar_torch/models/layers.py`: plain
PyTorch, every kernel route replaced by its plain version, nothing of the
program imported. The text below is the original module's.

StyleGAN2 primitive layers, plain PyTorch (NCHW, OIHW weights).

Counterpart of `invertavatar_tpu/models/layers.py`. Parameter names and
layouts follow the torch reference key space (`networks_stylegan2_new.py`):
conv weights `[out, in, kh, kw]`, FC weights `[out, in]`, `noise_const`
buffers `[res, res]`; `resample_filter` is rebuilt from its taps and kept out
of the state dict.

Like the JAX package, the modulated conv modulates activations and runs one
conv shared by the batch (the reference's non-fused path), then demodulates
the outputs. A layer computes in the dtype of its input; the synthesis block
casts to bfloat16 for its fp16 resolutions.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn

from .bias_act import bias_act, def_gain
from .conv2d_resample import conv2d_resample
from .upfirdn2d import setup_filter
from .mesh import batch_rand
from .misc import assert_shape
from .precision import tf32


class FullyConnectedLayer(nn.Module):
    """Equalized-lr fully connected layer."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 activation: str = "linear", lr_multiplier: float = 1.0, bias_init: float = 0.0):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.activation = activation
        self.lr_multiplier = lr_multiplier
        self.weight = nn.Parameter(torch.randn([out_features, in_features]) / lr_multiplier)
        self.bias = nn.Parameter(torch.full([out_features], float(bias_init))) if bias else None
        self.weight_gain = lr_multiplier / math.sqrt(in_features)

    def effective_params(self):
        """Gain-folded `(w [in, out], b [out])`, the layout the fused render
        kernels take (the JAX `return_params` layout)."""
        b = self.bias * self.lr_multiplier if self.bias is not None else None
        return (self.weight * self.weight_gain).t(), b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = (self.weight * self.weight_gain).to(x.dtype)
        x = tf32(x) @ tf32(w.t())
        b = (self.bias * self.lr_multiplier).to(x.dtype) if self.bias is not None else None
        return bias_act(x, b, act=self.activation)


class Conv2dLayer(nn.Module):
    """Equalized-lr conv with optional FIR up/downsampling, bias, activation,
    gain and clamp. It computes in its input's dtype (the discriminator's
    bf16 blocks cast their input)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, bias: bool = True,
                 activation: str = "linear", up: int = 1, down: int = 1,
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = None):
        super().__init__()
        self.activation = activation
        self.up = up
        self.down = down
        self.conv_clamp = conv_clamp
        self.padding = kernel_size // 2
        self.weight_gain = 1 / math.sqrt(in_channels * kernel_size ** 2)
        self.register_buffer("resample_filter", setup_filter(resample_filter), persistent=False)
        self.weight = nn.Parameter(torch.randn([out_channels, in_channels, kernel_size,
                                                kernel_size]))
        self.bias = nn.Parameter(torch.zeros([out_channels])) if bias else None

    def forward(self, x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
        w = (self.weight * self.weight_gain).to(x.dtype)
        x = conv2d_resample(x, w, f=self.resample_filter, up=self.up, down=self.down,
                            padding=self.padding, flip_weight=(self.up == 1))
        act_gain = def_gain(self.activation) * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias, act=self.activation, gain=act_gain, clamp=act_clamp)


def modulated_conv2d(
    x: torch.Tensor,  # [B, Cin, H, W]
    weight: torch.Tensor,  # [Cout, Cin, kh, kw]
    styles: torch.Tensor,  # [B, Cin]
    noise: Optional[torch.Tensor] = None,
    up: int = 1,
    down: int = 1,
    padding: int = 0,
    resample_filter: Optional[torch.Tensor] = None,
    demodulate: bool = True,
    flip_weight: bool = True,
) -> torch.Tensor:
    """Style-modulated conv: modulate activations, one shared conv, demodulate."""
    assert_shape(styles, [x.shape[0], weight.shape[1]])
    x = x * styles.to(x.dtype)[:, :, None, None]
    x = conv2d_resample(x, weight.to(x.dtype), f=resample_filter, up=up, down=down,
                        padding=padding, flip_weight=flip_weight)
    if demodulate:
        # d[b, o] = rsqrt(sum_{i,k} (w[o,i,k] * s[b,i])^2 + 1e-8)
        w2 = weight.float().square().sum(dim=(2, 3))  # [Cout, Cin]
        d = torch.rsqrt(tf32(styles.float().square()) @ tf32(w2.t()) + 1e-8)  # [B, Cout]
        x = x * d.to(x.dtype)[:, :, None, None]
    if noise is not None:
        x = x + noise.to(x.dtype)
    return x


class SynthesisLayer(nn.Module):
    """Modulated conv + noise + bias_act."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, resolution: int,
                 kernel_size: int = 3, up: int = 1, use_noise: bool = True,
                 activation: str = "lrelu", resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = None):
        super().__init__()
        self.in_channels = in_channels
        self.resolution = resolution
        self.up = up
        self.use_noise = use_noise
        self.activation = activation
        self.conv_clamp = conv_clamp
        self.padding = kernel_size // 2
        self.register_buffer("resample_filter", setup_filter(resample_filter), persistent=False)
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.randn([out_channels, in_channels, kernel_size, kernel_size]))
        if use_noise:
            self.register_buffer("noise_const", torch.randn([resolution, resolution]))
            self.noise_strength = nn.Parameter(torch.zeros([]))
        self.bias = nn.Parameter(torch.zeros([out_channels]))

    def forward(self, x: torch.Tensor, w: torch.Tensor, noise_mode: str = "random",
                gain: float = 1.0, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        assert noise_mode in ("random", "const", "none")
        in_res = self.resolution // self.up
        assert_shape(x, [None, self.in_channels, in_res, in_res])
        styles = self.affine(w.float())

        noise = None
        if self.use_noise and noise_mode == "random":
            noise = batch_rand([x.shape[0], 1, self.resolution, self.resolution], generator,
                               x.device, normal=True) * self.noise_strength
        elif self.use_noise and noise_mode == "const":
            noise = self.noise_const[None, None] * self.noise_strength

        x = modulated_conv2d(x, self.weight, styles, noise=noise, up=self.up,
                             padding=self.padding, resample_filter=self.resample_filter,
                             flip_weight=(self.up == 1))
        act_gain = def_gain(self.activation) * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias, act=self.activation, gain=act_gain, clamp=act_clamp)


class ToRGBLayer(nn.Module):
    """Modulated 1×1 conv without demodulation."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, kernel_size: int = 1,
                 conv_clamp: Optional[float] = None):
        super().__init__()
        self.conv_clamp = conv_clamp
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.randn([out_channels, in_channels, kernel_size, kernel_size]))
        self.bias = nn.Parameter(torch.zeros([out_channels]))
        self.weight_gain = 1.0 / math.sqrt(in_channels * kernel_size**2)

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        styles = self.affine(w.float()) * self.weight_gain
        x = modulated_conv2d(x, self.weight, styles, demodulate=False)
        return bias_act(x, self.bias, clamp=self.conv_clamp)


def normalize_2nd_moment(x: torch.Tensor, dim: int = 1, eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + eps)
