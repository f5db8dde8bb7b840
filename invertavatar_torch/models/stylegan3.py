"""StyleGAN3 (alias-free) generator, plain PyTorch (NCHW).

Counterpart of `invertavatar_tpu/models/stylegan3.py` (reference
`networks_stylegan3.py`): a Fourier-feature input turned and shifted by the
first w, then modulated 1×1 / 3×3 convolutions, each scaled by the inverse
root of its input's magnitude EMA and followed by `ops.filtered_lrelu` with
Kaiser (or radial jinc) low-pass filters, on a per-layer schedule of
cutoffs, sampling rates and sizes. Filter design and the schedule are numpy
and scipy at construction. Module and buffer names follow the reference
(`synthesis.input.affine`, `synthesis.L0_36_512.weight`, `magnitude_ema`,
...); the filters are rebuilt from the schedule and kept out of the state
dict, as the JAX trees lack them. `input.affine.bias` holds the reference's
[1, 0, 0, 0] start (`utils/weights.py` adds it to the JAX tree's zero bias).
No InvertAvatar entry point uses this generator; `metrics/equivariance.py`
measures it.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import scipy.signal
import scipy.special
import torch
import torch.nn as nn

from ..ops.conv2d_resample import conv2d_resample
from ..ops.filtered_lrelu import filtered_lrelu
from ..utils.misc import assert_shape, resolve_device
from .layers import FullyConnectedLayer
from .mapping import MappingNetwork


def design_lowpass_filter(numtaps: int, cutoff: float, width: float, fs: float,
                          radial: bool = False) -> Optional[np.ndarray]:
    """A separable Kaiser low-pass [numtaps] (scipy `firwin`), or a radial
    jinc one [numtaps, numtaps] under a Kaiser window; None for one tap."""
    assert numtaps >= 1
    if numtaps == 1:
        return None
    if not radial:
        return scipy.signal.firwin(numtaps=numtaps, cutoff=cutoff, width=width,
                                   fs=fs).astype(np.float32)
    x = (np.arange(numtaps) - (numtaps - 1) / 2) / fs
    r = np.hypot(*np.meshgrid(x, x))
    f = scipy.special.j1(2 * cutoff * (np.pi * r)) / (np.pi * r)
    beta = scipy.signal.kaiser_beta(scipy.signal.kaiser_atten(numtaps, width / (fs / 2)))
    w = np.kaiser(numtaps, beta)
    f *= np.outer(w, w)
    f /= np.sum(f)
    return f.astype(np.float32)


def sg3_modulated_conv2d(x: torch.Tensor, weight: torch.Tensor, styles: torch.Tensor,
                         input_gain: Optional[torch.Tensor] = None, demodulate: bool = True,
                         padding: int = 0) -> torch.Tensor:
    """x [B, Cin, H, W], weight [Cout, Cin, kh, kw], styles [B, Cin]. With
    `demodulate` the weight and the styles are first normalised to unit mean
    square (the styles over the whole batch), and the outputs divided by the
    modulated weight's norm; `input_gain` scales the modulation alone."""
    if demodulate:
        weight = weight * weight.square().mean(dim=(1, 2, 3), keepdim=True).rsqrt()
        styles = styles * styles.square().mean().rsqrt()
    s_in = styles if input_gain is None else styles * input_gain
    x = x * s_in.to(x.dtype)[:, :, None, None]
    x = conv2d_resample(x, weight.to(x.dtype), padding=padding, flip_weight=True)
    if demodulate:
        w2 = weight.float().square().sum(dim=(2, 3))  # [Cout, Cin]
        d = torch.rsqrt(styles.float().square() @ w2.t() + 1e-8)
        x = x * d.to(x.dtype)[:, :, None, None]
    return x


class SynthesisInput(nn.Module):
    """Fourier features of a `size`² grid at `sampling_rate`, their
    frequencies turned and shifted by `affine(w)` (rotation cos/sin,
    translation), faded out above `bandwidth`, then mixed by `weight`:
    w [B, w_dim] -> [B, channels, size, size]."""

    def __init__(self, w_dim: int, channels: int, size: int, sampling_rate: float,
                 bandwidth: float):
        super().__init__()
        self.channels = channels
        self.size = size
        self.sampling_rate = sampling_rate
        self.bandwidth = bandwidth
        freqs = torch.randn([channels, 2])
        radii = freqs.square().sum(dim=1, keepdim=True).sqrt()
        freqs = freqs / (radii * radii.square().exp().pow(0.25)) * bandwidth
        self.register_buffer("freqs", freqs)
        self.register_buffer("phases", torch.rand([channels]) - 0.5)
        self.register_buffer("transform", torch.eye(3))
        self.weight = nn.Parameter(torch.randn([channels, channels]))
        self.affine = FullyConnectedLayer(w_dim, 4)
        with torch.no_grad():
            self.affine.weight.zero_()
            self.affine.bias.copy_(torch.tensor([1.0, 0.0, 0.0, 0.0]))

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        t = self.affine(w)
        t = t / t[:, :2].norm(dim=1, keepdim=True)
        B = w.shape[0]
        eye = torch.eye(3, device=w.device, dtype=t.dtype)
        m_r = eye.repeat(B, 1, 1)
        m_r[:, 0, 0], m_r[:, 0, 1], m_r[:, 1, 0], m_r[:, 1, 1] = t[:, 0], -t[:, 1], t[:, 1], t[:, 0]
        m_t = eye.repeat(B, 1, 1)
        m_t[:, 0, 2], m_t[:, 1, 2] = -t[:, 2], -t[:, 3]
        transforms = m_r @ m_t @ self.transform[None]

        freqs = self.freqs[None] @ transforms[:, :2, :2]  # [B, C, 2]
        phases = self.phases[None] + (self.freqs[None] @ transforms[:, :2, 2:])[..., 0]
        amplitudes = (1 - (freqs.norm(dim=2) - self.bandwidth)
                      / (self.sampling_rate / 2 - self.bandwidth)).clamp(0, 1)

        # the sampling grid of `affine_grid` (align_corners=False)
        half = 0.5 * self.size / self.sampling_rate
        coords = ((torch.arange(self.size, device=w.device, dtype=torch.float32) + 0.5)
                  / self.size * 2 - 1) * half
        gy, gx = torch.meshgrid(coords, coords, indexing="ij")
        grid = torch.stack([gx, gy], dim=-1)  # [H, W, 2]
        x = torch.einsum("hwj,bcj->bchw", grid, freqs) + phases[:, :, None, None]
        x = torch.sin(x * (2 * np.pi)) * amplitudes[:, :, None, None]
        return torch.einsum("bchw,dc->bdhw", x, self.weight / math.sqrt(self.channels))


class SG3SynthesisLayer(nn.Module):
    """Modulated conv (3×3, or 1×1 in the ToRGB layer) scaled by the input
    magnitude EMA, then the filtered leaky ReLU between the layer's in and
    out sampling rates."""

    def __init__(self, w_dim: int, is_torgb: bool, is_critically_sampled: bool,
                 in_channels: int, out_channels: int, in_size: int, out_size: int,
                 in_sampling_rate: float, out_sampling_rate: float, in_cutoff: float,
                 out_cutoff: float, in_half_width: float, out_half_width: float,
                 conv_kernel: int = 3, filter_size: int = 6, lrelu_upsampling: int = 2,
                 use_radial_filters: bool = False, conv_clamp: Optional[float] = 256.0,
                 magnitude_ema_beta: float = 0.999):
        super().__init__()
        self.is_torgb = is_torgb
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.out_size = out_size
        self.conv_clamp = conv_clamp
        self.magnitude_ema_beta = magnitude_ema_beta
        self.conv_kernel = 1 if is_torgb else conv_kernel
        k = self.conv_kernel
        tmp_rate = max(in_sampling_rate, out_sampling_rate) * (1 if is_torgb
                                                               else lrelu_upsampling)
        self.up_factor = int(round(tmp_rate / in_sampling_rate))
        self.down_factor = int(round(tmp_rate / out_sampling_rate))
        up_taps = filter_size * self.up_factor if self.up_factor > 1 and not is_torgb else 1
        down_taps = (filter_size * self.down_factor
                     if self.down_factor > 1 and not is_torgb else 1)
        down_radial = use_radial_filters and not is_critically_sampled
        fu = design_lowpass_filter(up_taps, in_cutoff, in_half_width * 2, tmp_rate)
        fd = design_lowpass_filter(down_taps, out_cutoff, out_half_width * 2, tmp_rate,
                                   radial=down_radial)
        self.register_buffer("up_filter", None if fu is None else torch.from_numpy(fu),
                             persistent=False)
        self.register_buffer("down_filter", None if fd is None else torch.from_numpy(fd),
                             persistent=False)
        pad_total = (out_size - 1) * self.down_factor + 1
        pad_total -= (in_size + k - 1) * self.up_factor
        pad_total += up_taps + down_taps - 2
        pad_lo = (pad_total + self.up_factor) // 2
        pad_hi = pad_total - pad_lo
        self.padding = [int(pad_lo), int(pad_hi), int(pad_lo), int(pad_hi)]

        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.randn([out_channels, in_channels, k, k]))
        self.bias = nn.Parameter(torch.zeros([out_channels]))
        self.register_buffer("magnitude_ema", torch.ones([]))

    def forward(self, x: torch.Tensor, w: torch.Tensor, update_emas: bool = False):
        if update_emas:
            with torch.no_grad():
                cur = x.detach().float().square().mean()
                self.magnitude_ema.copy_(cur + self.magnitude_ema_beta
                                         * (self.magnitude_ema - cur))
        input_gain = self.magnitude_ema.rsqrt()
        styles = self.affine(w)
        if self.is_torgb:
            styles = styles * (1 / math.sqrt(self.in_channels * self.conv_kernel ** 2))
        x = sg3_modulated_conv2d(x, self.weight, styles, input_gain=input_gain,
                                 demodulate=not self.is_torgb, padding=self.conv_kernel - 1)
        x = filtered_lrelu(x, self.up_filter, self.down_filter, self.bias, up=self.up_factor,
                           down=self.down_factor, padding=self.padding,
                           gain=1.0 if self.is_torgb else math.sqrt(2.0),
                           slope=1.0 if self.is_torgb else 0.2, clamp=self.conv_clamp)
        assert_shape(x, [None, self.out_channels, self.out_size, self.out_size])
        return x


class SG3SynthesisNetwork(nn.Module):
    """The input and `num_layers` + 1 layers on the frequency schedule:
    cutoffs rise geometrically from `first_cutoff` to half the image
    resolution (the last `num_critical` layers critically sampled), widths
    follow `channel_base / 2 / cutoff`; ws [B, num_layers + 2, w_dim] ->
    [B, img_channels, R, R] float32."""

    def __init__(self, w_dim: int, img_resolution: int, img_channels: int,
                 channel_base: int = 32768, channel_max: int = 512, num_layers: int = 14,
                 num_critical: int = 2, first_cutoff: float = 2.0,
                 first_stopband: float = 2 ** 2.1, last_stopband_rel: float = 2 ** 0.3,
                 margin_size: int = 10, output_scale: float = 0.25):
        super().__init__()
        self.w_dim = w_dim
        self.num_layers = num_layers
        self.num_ws = num_layers + 2
        self.output_scale = output_scale
        last_cutoff = img_resolution / 2
        last_stopband = last_cutoff * last_stopband_rel
        exponents = np.minimum(np.arange(num_layers + 1) / (num_layers - num_critical), 1)
        cutoffs = first_cutoff * (last_cutoff / first_cutoff) ** exponents
        stopbands = first_stopband * (last_stopband / first_stopband) ** exponents
        rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, img_resolution))))
        half_widths = np.maximum(stopbands, rates / 2) - cutoffs
        sizes = rates + margin_size * 2
        sizes[-2:] = img_resolution
        sizes = sizes.astype(int)
        channels = np.rint(np.minimum((channel_base / 2) / cutoffs, channel_max))
        channels[-1] = img_channels
        channels = channels.astype(int)

        self.input = SynthesisInput(w_dim, int(channels[0]), int(sizes[0]), float(rates[0]),
                                    float(cutoffs[0]))
        self.layer_names = []
        for idx in range(num_layers + 1):
            prev = max(idx - 1, 0)
            name = f"L{idx}_{int(sizes[idx])}_{int(channels[idx])}"
            self.add_module(name, SG3SynthesisLayer(
                w_dim, is_torgb=idx == num_layers,
                is_critically_sampled=idx >= num_layers - num_critical,
                in_channels=int(channels[prev]), out_channels=int(channels[idx]),
                in_size=int(sizes[prev]), out_size=int(sizes[idx]),
                in_sampling_rate=float(rates[prev]), out_sampling_rate=float(rates[idx]),
                in_cutoff=float(cutoffs[prev]), out_cutoff=float(cutoffs[idx]),
                in_half_width=float(half_widths[prev]),
                out_half_width=float(half_widths[idx])))
            self.layer_names.append(name)

    def forward(self, ws: torch.Tensor, update_emas: bool = False) -> torch.Tensor:
        assert_shape(ws, [None, self.num_ws, self.w_dim])
        ws = ws.float()
        x = self.input(ws[:, 0])
        for i, name in enumerate(self.layer_names):
            x = getattr(self, name)(x, ws[:, i + 1], update_emas=update_emas)
        if self.output_scale != 1:
            x = x * self.output_scale
        return x.float()


class SG3Generator(nn.Module):
    """Mapping + alias-free synthesis: z [B, z_dim], c [B, c_dim] ->
    images [B, img_channels, R, R]. Built on CUDA unless `device="cpu"`."""

    def __init__(self, z_dim: int, c_dim: int, w_dim: int, img_resolution: int,
                 img_channels: int, map_num_layers: int = 2, num_layers: int = 14,
                 channel_base: int = 32768, channel_max: int = 512, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.synthesis = SG3SynthesisNetwork(w_dim, img_resolution, img_channels,
                                             channel_base=channel_base,
                                             channel_max=channel_max, num_layers=num_layers)
        self.num_ws = self.synthesis.num_ws
        self.mapping = MappingNetwork(z_dim, c_dim, w_dim, num_ws=self.num_ws,
                                      num_layers=map_num_layers)
        self.to(device)

    def forward(self, z: torch.Tensor, c: torch.Tensor, truncation_psi: float = 1.0,
                truncation_cutoff=None, update_emas: bool = False) -> torch.Tensor:
        ws = self.mapping(z, c, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff, update_emas=update_emas)
        return self.synthesis(ws, update_emas=update_emas)
