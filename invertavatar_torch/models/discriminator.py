"""StyleGAN2 discriminators and the EG3D dual discriminator, plain PyTorch
(NCHW).

Counterpart of `invertavatar_tpu/models/discriminator.py` (reference
`networks_stylegan2_new.py` DiscriminatorBlock / MinibatchStdLayer /
DiscriminatorEpilogue / Discriminator and `dual_discriminator.py`):
`DualDiscriminator`, the 3D GAN's critic, scores the 512² image beside the
antialiased upsampling of the raw neural render, conditioned on the camera
through a mapping network (`cmap`). The blocks at the top `num_fp16_res`
resolutions compute in bfloat16 (the JAX package's `dtype_fp16`) unless
`force_fp32`; the epilogue computes in float32. Module names follow the torch
reference (`b512.fromrgb`, `b4.fc`, `mapping.embed`, ...). The blocks take
the reference's three architectures: "resnet" (the default, the one every
shipped configuration uses), "skip" (each block also reads the image,
FIR-downsampled, through its own `fromrgb`, and so does the epilogue) and
"orig" (no residual branch). The video discriminators (`VideoDiscriminator`,
which scores a frame pair beside their time gap, and
`FusionVideoDiscriminator`, which fuses the frames' features mid-pyramid and
embeds the gaps with a `TemporalDifferenceEncoder`) are in the reference and
in no shipped configuration.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..ops.resize import resize_bilinear
from ..ops.upfirdn2d import downsample2d, setup_filter
from ..parallel.mesh import batch_rand, gather_rows, local_rows
from ..utils.misc import assert_shape, resolve_device
from .layers import Conv2dLayer, FullyConnectedLayer
from .mapping import MappingNetwork


class DiscriminatorBlock(nn.Module):
    """`fromrgb` (the first block, and every block of "skip"), conv0, conv1
    (down 2) and, in "resnet", the 1×1 `skip` (down 2) beside them."""

    def __init__(self, in_channels: int, tmp_channels: int, out_channels: int, resolution: int,
                 img_channels: int, architecture: str = "resnet", activation: str = "lrelu",
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = None, use_fp16: bool = False):
        super().__init__()
        assert architecture in ("orig", "skip", "resnet"), architecture
        self.in_channels = in_channels
        self.img_channels = img_channels
        self.resolution = resolution
        self.architecture = architecture
        self.use_fp16 = use_fp16
        self.register_buffer("resample_filter", setup_filter(resample_filter), persistent=False)
        if in_channels == 0 or architecture == "skip":
            self.fromrgb = Conv2dLayer(img_channels, tmp_channels, 1, activation=activation,
                                       conv_clamp=conv_clamp)
        self.conv0 = Conv2dLayer(tmp_channels, tmp_channels, 3, activation=activation,
                                 conv_clamp=conv_clamp)
        self.conv1 = Conv2dLayer(tmp_channels, out_channels, 3, activation=activation, down=2,
                                 resample_filter=resample_filter, conv_clamp=conv_clamp)
        if architecture == "resnet":
            self.skip = Conv2dLayer(tmp_channels, out_channels, 1, bias=False, down=2,
                                    resample_filter=resample_filter)

    def forward(self, x: Optional[torch.Tensor], img: Optional[torch.Tensor],
                force_fp32: bool = False):
        """x: the previous block's features (None in the first block). Returns
        the features and the image the next block reads: the downsampled
        image in "skip", else None once `fromrgb` has read it."""
        dtype = torch.bfloat16 if (self.use_fp16 and not force_fp32) else torch.float32
        if x is not None:
            assert_shape(x, [None, self.in_channels, self.resolution, self.resolution])
            x = x.to(dtype)
        if self.in_channels == 0 or self.architecture == "skip":
            assert_shape(img, [None, self.img_channels, self.resolution, self.resolution])
            img = img.to(dtype)
            y = self.fromrgb(img)
            x = x + y if x is not None else y
            img = (downsample2d(img, self.resample_filter) if self.architecture == "skip"
                   else None)
        if self.architecture == "resnet":
            y = self.skip(x, gain=math.sqrt(0.5))
            x = y + self.conv1(self.conv0(x), gain=math.sqrt(0.5))
        else:
            x = self.conv1(self.conv0(x))
        assert x.dtype == dtype
        return x, img


class MinibatchStdLayer(nn.Module):
    """Appends `num_channels` channels of the feature std over groups of
    `group_size` items (the batch index b = g·n + i), or of the largest size
    below it that divides the batch. The JAX package's layer (and the
    reference's) takes min(group_size, batch) and fails where that does not
    divide the batch, as in the few-shot D phase at batch 1, which scores 6
    or 18 frames; where it runs, the two agree. Under a data mesh the groups
    are those of the global batch, as in JAX's one program over the mesh:
    each rank gathers the features of every rank (`gather_rows`, a few KB at
    the 4² epilogue) and takes the statistics of its own rows' groups. The
    same operations run without a mesh, so that a mesh of one rank gives the
    same bits."""

    def __init__(self, group_size: Optional[int] = 4, num_channels: int = 1):
        super().__init__()
        self.group_size = group_size
        self.num_channels = num_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xg = gather_rows(x.float())
        N, C, H, W = xg.shape
        G = N if self.group_size is None else next(
            g for g in range(min(self.group_size, N), 0, -1) if N % g == 0)
        F = self.num_channels
        y = xg.reshape(G, -1, F, C // F, H, W)
        y = y - y.mean(dim=0)
        y = (y.square().mean(dim=0) + 1e-8).sqrt()
        y = y.mean(dim=(2, 3, 4))  # [n, F]
        # row b = g·n + i of the (global) batch takes group i's statistics
        y = y.index_select(0, local_rows(x.shape[0], x.device) % y.shape[0])
        return torch.cat([x, y[:, :, None, None].expand(-1, -1, H, W).to(x.dtype)], dim=1)


class DiscriminatorEpilogue(nn.Module):
    """The 4² head in float32: in "skip" the image's own `fromrgb`, then the
    minibatch std, conv, fc, out, and the projection onto `cmap` when
    conditioned."""

    def __init__(self, in_channels: int, cmap_dim: int, resolution: int, img_channels: int = 3,
                 architecture: str = "resnet", mbstd_group_size: Optional[int] = 4,
                 mbstd_num_channels: int = 1, activation: str = "lrelu",
                 conv_clamp: Optional[float] = None):
        super().__init__()
        self.in_channels = in_channels
        self.cmap_dim = cmap_dim
        self.resolution = resolution
        self.architecture = architecture
        if architecture == "skip":
            self.fromrgb = Conv2dLayer(img_channels, in_channels, 1, activation=activation)
        self.mbstd = (MinibatchStdLayer(mbstd_group_size, mbstd_num_channels)
                      if mbstd_num_channels > 0 else None)
        self.conv = Conv2dLayer(in_channels + mbstd_num_channels, in_channels, 3,
                                activation=activation, conv_clamp=conv_clamp)
        self.fc = FullyConnectedLayer(in_channels * resolution ** 2, in_channels,
                                      activation=activation)
        self.out = FullyConnectedLayer(in_channels, 1 if cmap_dim == 0 else cmap_dim)

    def forward(self, x: torch.Tensor, img: Optional[torch.Tensor],
                cmap: Optional[torch.Tensor]) -> torch.Tensor:
        assert_shape(x, [None, self.in_channels, self.resolution, self.resolution])
        x = x.float()
        if self.architecture == "skip":
            x = x + self.fromrgb(img.float())
        if self.mbstd is not None:
            x = self.mbstd(x)
        x = self.out(self.fc(self.conv(x).flatten(1)))
        if self.cmap_dim > 0:
            assert_shape(cmap, [None, self.cmap_dim])
            x = (x * cmap).sum(dim=1, keepdim=True) * (1 / math.sqrt(self.cmap_dim))
        return x


def _channel_plan(img_resolution: int, channel_base: int, channel_max: int, num_fp16_res: int,
                  cmap_dim: Optional[int], c_dim: int):
    """The block resolutions (img_resolution down to 8), the width of each
    resolution, the lowest resolution whose blocks use bfloat16 and the
    camera embedding's width (0 without a camera)."""
    log2 = int(np.log2(img_resolution))

    def channels(res):
        return min(channel_base // res, channel_max)

    if cmap_dim is None:
        cmap_dim = channels(4)
    return ([2 ** i for i in range(log2, 2, -1)], channels,
            max(2 ** (log2 + 1 - num_fp16_res), 8), 0 if c_dim == 0 else cmap_dim)


def _jitter_camera(c: torch.Tensor, disc_c_noise: float,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """`c` plus `generator`'s normal draws times its per-column std over the
    (global) batch times `disc_c_noise`."""
    if disc_c_noise > 0:
        noise = batch_rand(c.shape, generator, c.device, normal=True)
        c = c + noise * gather_rows(c).std(dim=0) * disc_c_noise
    return c


class _DiscriminatorCore(nn.Module):
    """The block pyramid `b{res}` from `img_resolution` down to 8², the
    camera mapping and the `b4` epilogue."""

    def __init__(self, c_dim: int, img_resolution: int, img_channels: int,
                 architecture: str = "resnet", channel_base: int = 32768,
                 channel_max: int = 512, num_fp16_res: int = 4,
                 conv_clamp: Optional[float] = 256.0, cmap_dim: Optional[int] = None,
                 disc_c_noise: float = 0.0, mbstd_group_size: Optional[int] = 4):
        super().__init__()
        self.c_dim = c_dim
        self.img_resolution = img_resolution
        self.disc_c_noise = disc_c_noise
        self.block_resolutions, channels, fp16_resolution, cmap_dim = _channel_plan(
            img_resolution, channel_base, channel_max, num_fp16_res, cmap_dim, c_dim)
        for res in self.block_resolutions:
            self.add_module(f"b{res}", DiscriminatorBlock(
                channels(res) if res < img_resolution else 0, channels(res), channels(res // 2),
                res, img_channels, architecture=architecture, conv_clamp=conv_clamp,
                use_fp16=res >= fp16_resolution))
        if c_dim > 0:
            self.mapping = MappingNetwork(0, c_dim, cmap_dim, num_ws=None, w_avg_beta=None)
        self.b4 = DiscriminatorEpilogue(channels(4), cmap_dim, 4, img_channels=img_channels,
                                        architecture=architecture, conv_clamp=conv_clamp,
                                        mbstd_group_size=mbstd_group_size)

    def _score(self, img: torch.Tensor, c: Optional[torch.Tensor],
               force_fp32: bool = False) -> torch.Tensor:
        x = None
        for res in self.block_resolutions:
            x, img = getattr(self, f"b{res}")(x, img, force_fp32=force_fp32)
        cmap = self.mapping(None, c) if self.c_dim > 0 else None
        return self.b4(x, img, cmap)


class Discriminator(_DiscriminatorCore):
    """The single-image StyleGAN2 discriminator: img [B, C, R, R], c -> [B, 1]."""

    def forward(self, img: torch.Tensor, c: Optional[torch.Tensor],
                force_fp32: bool = False) -> torch.Tensor:
        return self._score(img, c, force_fp32=force_fp32)


class DualDiscriminator(_DiscriminatorCore):
    """The EG3D dual discriminator: {"image": [B, 3, R, R], "image_raw": [B,
    3, r, r]}, camera c [B, ≥c_dim] -> logits [B, 1]. `img_channels` counts
    the pair (6). `disc_c_noise` > 0 jitters the camera by `generator`'s
    draws times its per-column std."""

    def forward(self, img: Dict[str, torch.Tensor], c: Optional[torch.Tensor],
                force_fp32: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        image = img["image"]
        image_raw = resize_bilinear(img["image_raw"], tuple(image.shape[2:]), antialias=True)
        if self.c_dim > 0 and c is not None:
            c = _jitter_camera(c[:, :self.c_dim], self.disc_c_noise, generator)
        return self._score(torch.cat([image, image_raw], dim=1), c, force_fp32=force_fp32)


class SingleDiscriminator(_DiscriminatorCore):
    """Scores the 512² image alone."""

    def forward(self, img: Dict[str, torch.Tensor], c: Optional[torch.Tensor],
                force_fp32: bool = False) -> torch.Tensor:
        return self._score(img["image"], c, force_fp32=force_fp32)


class DummyDualDiscriminator(_DiscriminatorCore):
    """The dual discriminator whose raw half fades out: `raw_fade` scales the
    upsampled raw image."""

    def forward(self, img: Dict[str, torch.Tensor], c: Optional[torch.Tensor],
                raw_fade: float = 1.0, force_fp32: bool = False) -> torch.Tensor:
        image = img["image"]
        image_raw = resize_bilinear(img["image_raw"], tuple(image.shape[2:]),
                                    antialias=True) * raw_fade
        return self._score(torch.cat([image, image_raw], dim=1), c, force_fp32=force_fp32)


class VideoDiscriminator(_DiscriminatorCore):
    """Reference dual_discriminator.py `VideoDiscriminator`: scores a frame
    pair. {"image": [B·T, C, H, W]} (frame-major per video), the frame times
    Ts [B, T] and cameras c [B, T, ≥c_dim] -> [B, 1]. The T frames stack
    along channels beside one channel of the gap Ts[:, 1] − Ts[:, 0], resized
    to `img_resolution` when they are not; the cameras of all T frames
    condition the score. `img_channels` and `c_dim` are per frame; the
    pyramid is built for `num_frames` frames. Built on CUDA unless
    `device="cpu"`."""

    def __init__(self, c_dim: int, img_resolution: int, img_channels: int,
                 num_frames: int = 2, device="cuda", **kw):
        device = resolve_device(device)
        super().__init__(c_dim * num_frames, img_resolution, img_channels * num_frames + 1, **kw)
        self.frame_c_dim = c_dim
        self.to(device)

    def forward(self, img: Dict[str, torch.Tensor], Ts: torch.Tensor, c: torch.Tensor,
                force_fp32: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        T = Ts.shape[1]
        BT, C, H, W = img["image"].shape
        B = BT // T
        dt = (Ts[:, 1] - Ts[:, 0]).reshape(B, 1, 1, 1).to(img["image"].dtype)
        x = torch.cat([img["image"].reshape(B, T * C, H, W), dt.expand(B, 1, H, W)], dim=1)
        if H != self.img_resolution:
            x = resize_bilinear(x, (self.img_resolution, self.img_resolution), antialias=True)
        c = _jitter_camera(c[..., :self.frame_c_dim].reshape(B, -1), self.disc_c_noise,
                           generator)
        return self._score(x, c, force_fp32=force_fp32)


def construct_log_spaced_freqs(max_num_frames: int, skip_small_t_freqs: int = 0) -> np.ndarray:
    """The Fourier frequencies π·2^k / 2^⌈log2 max_num_frames⌉, k below
    log2 of that, less the `skip_small_t_freqs` highest: [1, nf] float32."""
    time_resolution = 2 ** np.ceil(np.log2(max_num_frames))
    num_fourier_feats = int(np.ceil(np.log2(time_resolution)))
    powers = 2.0 ** np.arange(num_fourier_feats)
    powers = powers[:len(powers) - skip_small_t_freqs]
    return (powers[None].astype(np.float32) * np.pi) / time_resolution


class FixedTimeEncoder(nn.Module):
    """Log-spaced Fourier features of a time: [N] or [N, 1] -> [N, 2·nf]
    (sines, then cosines), from the `fourier_coefs` buffer."""

    def __init__(self, max_num_frames: int, skip_small_t_freqs: int = 0):
        super().__init__()
        self.register_buffer("fourier_coefs", torch.from_numpy(
            construct_log_spaced_freqs(max_num_frames, skip_small_t_freqs)))

    def get_dim(self) -> int:
        return self.fourier_coefs.shape[1] * 2

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        raw = self.fourier_coefs * t.reshape(-1).float()[:, None]
        return torch.cat([raw.sin(), raw.cos()], dim=1)


class TemporalDifferenceEncoder(nn.Module):
    """Embedding of the gaps between a video's frames: a learned embedding
    of the rounded gap beside its Fourier features, [B, T] -> [B, dim]
    (the first gap alone under "uniform" sampling, else every consecutive
    gap)."""

    def __init__(self, max_num_frames: int = 32, num_frames_per_video: int = 2,
                 sampling_type: str = "random", d: int = 256):
        super().__init__()
        self.num_frames_per_video = num_frames_per_video
        self.sampling_type = sampling_type
        if num_frames_per_video > 1:
            self.const_embed = nn.Embedding(max_num_frames, d)
            self.time_encoder = FixedTimeEncoder(max_num_frames)

    def get_dim(self) -> int:
        if self.num_frames_per_video == 1:
            return 1
        per = self.const_embed.embedding_dim + self.time_encoder.get_dim()
        return per if self.sampling_type == "uniform" else per * (self.num_frames_per_video - 1)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        B = t.shape[0]
        if self.num_frames_per_video == 1:
            return torch.zeros(B, 1, device=t.device)
        if self.sampling_type == "uniform":
            t_diffs = (t[:, 1] - t[:, 0]).reshape(-1)
        else:
            t_diffs = (t[:, 1:] - t[:, :-1]).reshape(-1)
        const_embs = self.const_embed(t_diffs.float().round().long())
        fourier = self.time_encoder(t_diffs[:, None])
        return torch.cat([const_embs, fourier], dim=1).reshape(B, -1)


class FusionVideoDiscriminator(nn.Module):
    """Reference dual_discriminator.py `FusionVideoDiscriminator`: the frames
    of a video, {"image": [B·T, C, H, W]}, run the blocks one by one down to
    `concat_res`, where their features (narrowed by `num_frames_div_factor`)
    stack along channels; the cameras c [B, T, ≥c_dim] of all frames beside
    the `TemporalDifferenceEncoder` embedding of the times Ts [B, T] feed the
    camera mapping. -> [B, 1]. Built on CUDA unless `device="cpu"`."""

    def __init__(self, c_dim: int, img_resolution: int, img_channels: int,
                 architecture: str = "resnet", channel_base: int = 32768,
                 channel_max: int = 512, num_fp16_res: int = 4,
                 conv_clamp: Optional[float] = 256.0, cmap_dim: Optional[int] = None,
                 disc_c_noise: float = 0.0, concat_res: int = 16,
                 num_frames_div_factor: int = 2, num_frames_per_video: int = 2,
                 max_num_frames: int = 32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.c_dim = c_dim
        self.img_resolution = img_resolution
        self.disc_c_noise = disc_c_noise
        self.concat_res = concat_res
        self.block_resolutions, channels, fp16_resolution, cmap_dim = _channel_plan(
            img_resolution, channel_base, channel_max, num_fp16_res, cmap_dim, c_dim)
        self.time_encoder = TemporalDifferenceEncoder(max_num_frames, num_frames_per_video)
        for res in self.block_resolutions:
            in_ch = channels(res) if res < img_resolution else 0
            out_ch = channels(res // 2)
            if res // 2 == concat_res:
                out_ch = out_ch // num_frames_div_factor
            if res == concat_res:
                in_ch = (in_ch // num_frames_div_factor) * num_frames_per_video
            self.add_module(f"b{res}", DiscriminatorBlock(
                in_ch, channels(res), out_ch, res, img_channels, architecture=architecture,
                conv_clamp=conv_clamp, use_fp16=res >= fp16_resolution))
        if c_dim > 0:
            self.mapping = MappingNetwork(
                0, c_dim * num_frames_per_video + self.time_encoder.get_dim(), cmap_dim,
                num_ws=None, w_avg_beta=None)
        self.b4 = DiscriminatorEpilogue(channels(4), cmap_dim, 4, img_channels=img_channels,
                                        architecture=architecture, conv_clamp=conv_clamp)
        self.to(device)

    def forward(self, img: Dict[str, torch.Tensor], Ts: torch.Tensor, c: torch.Tensor,
                force_fp32: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        T = Ts.shape[1]
        cur = img["image"]
        if cur.shape[2] != self.img_resolution:
            cur = resize_bilinear(cur, (self.img_resolution, self.img_resolution),
                                  antialias=True)
        cc = torch.cat([c[..., :self.c_dim].reshape(c.shape[0], -1), self.time_encoder(Ts)],
                       dim=1)
        cc = _jitter_camera(cc, self.disc_c_noise, generator)
        x = None
        for res in self.block_resolutions:
            if res == self.concat_res:
                # [(b t), ch, h, w] -> [b, (t ch), h, w]
                BT, ch, hh, ww = x.shape
                x = x.reshape(BT // T, T * ch, hh, ww)
                cur = None
            x, cur = getattr(self, f"b{res}")(x, cur, force_fp32=force_fp32)
        cmap = self.mapping(None, cc) if self.c_dim > 0 else None
        return self.b4(x, cur, cmap)


def filtered_resizing(image: torch.Tensor, size: int, filter_mode="antialiased") -> torch.Tensor:
    """Resize NCHW images to size² by the dual discriminator's modes:
    "antialiased", "none", or a float blend of the two (the antialiased
    share)."""
    if filter_mode == "antialiased":
        return resize_bilinear(image, (size, size), antialias=True)
    if filter_mode == "none":
        return resize_bilinear(image, (size, size), antialias=False)
    if isinstance(filter_mode, float):
        assert 0 < filter_mode < 1
        filtered = resize_bilinear(image, (size, size), antialias=True)
        aliased = resize_bilinear(image, (size, size), antialias=False)
        return (1 - filter_mode) * aliased + filter_mode * filtered
    raise ValueError(f"unsupported filter_mode {filter_mode}")
