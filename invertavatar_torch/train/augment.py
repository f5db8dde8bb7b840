"""ADA augmentation pipeline, plain PyTorch (NCHW).

Counterpart of `invertavatar_tpu/train/augment.py` (reference
`training/augment.py`): pixel blitting (x-flip, 90° rotations, integer
translation) and general geometric transforms (isotropic and anisotropic
scaling, rotation, fractional translation) composed into one inverse
homography and executed as a single warp between sym6 wavelet up- and
down-sampling; colour transforms composed into one 4×4 matrix; the sym2
filter-bank image-space amplification; additive noise and cutout. Each
transform is taken per item with probability (its strength)·`p`, the
adaptive probability. The draws come from a `torch.Generator`, in the JAX
pipe's order; `debug_percentile` replaces them (all but the noise image) by
a fixed percentile, as in the reference. As in the JAX pipe, the reflection
margin of the warp is fixed (`max_margin`, default width/2 plus the filter's
reach). Images have 1, 3 or 6 channels (6: the dual discriminator's pair,
each half transformed alike).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.grid_sample import grid_sample
from ..ops.upfirdn2d import downsample2d, setup_filter, upsample2d
from ..parallel.mesh import batch_rand

WAVELETS = {
    "sym2": [-0.12940952255092145, 0.22414386804185735, 0.836516303737469, 0.48296291314469025],
    "sym6": [
        0.015404109327027373, 0.0034907120842174702, -0.11799011114819057, -0.048311742585633,
        0.4910559419267466, 0.787641141030194, 0.3379294217276218, -0.07263752278646252,
        -0.021060292512300564, 0.04472490177066578, 0.0017677118642428036, -0.007800708325034148,
    ],
}


def _mat(rows, shape):
    """A batch of matrices from their row-major entries (tensors of [B])."""
    return torch.stack(rows, dim=-1).reshape(-1, *shape)


def _translate2d(tx: torch.Tensor, ty: torch.Tensor) -> torch.Tensor:
    z, o = torch.zeros_like(tx), torch.ones_like(tx)
    return _mat([o, z, tx, z, o, ty, z, z, o], (3, 3))


def _scale2d(sx: torch.Tensor, sy: torch.Tensor) -> torch.Tensor:
    z, o = torch.zeros_like(sx), torch.ones_like(sx)
    return _mat([sx, z, z, z, sy, z, z, z, o], (3, 3))


def _rotate2d(theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _mat([c, -s, z, s, c, z, z, z, o], (3, 3))


def _rotate3d(v, theta: torch.Tensor) -> torch.Tensor:
    vx, vy, vz = (float(a) for a in v[:3])
    s, c = torch.sin(theta), torch.cos(theta)
    cc = 1 - c
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _mat([vx * vx * cc + c, vx * vy * cc - vz * s, vx * vz * cc + vy * s, z,
                 vy * vx * cc + vz * s, vy * vy * cc + c, vy * vz * cc - vx * s, z,
                 vz * vx * cc - vy * s, vz * vy * cc + vx * s, vz * vz * cc + c, z,
                 z, z, z, o], (4, 4))


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    xflip: float = 0.0
    rotate90: float = 0.0
    xint: float = 0.0
    xint_max: float = 0.125
    scale: float = 0.0
    rotate: float = 0.0
    aniso: float = 0.0
    xfrac: float = 0.0
    scale_std: float = 0.2
    rotate_max: float = 1.0
    aniso_std: float = 0.2
    xfrac_std: float = 0.125
    brightness: float = 0.0
    contrast: float = 0.0
    lumaflip: float = 0.0
    hue: float = 0.0
    saturation: float = 0.0
    brightness_std: float = 0.2
    contrast_std: float = 0.5
    hue_max: float = 1.0
    saturation_std: float = 1.0
    imgfilter: float = 0.0
    imgfilter_bands: Sequence[float] = (1.0, 1.0, 1.0, 1.0)
    imgfilter_std: float = 1.0
    noise: float = 0.0
    cutout: float = 0.0
    noise_std: float = 0.1
    cutout_size: float = 0.5


def _filter_bank() -> np.ndarray:
    """The sym2 bandpass filter bank [4, taps]."""
    import scipy.signal

    Hz_lo = np.asarray(WAVELETS["sym2"])
    Hz_hi = Hz_lo * ((-1) ** np.arange(Hz_lo.size))
    Hz_lo2 = np.convolve(Hz_lo, Hz_lo[::-1]) / 2
    Hz_hi2 = np.convolve(Hz_hi, Hz_hi[::-1]) / 2
    Hz_fbank = np.eye(4, 1)
    for i in range(1, Hz_fbank.shape[0]):
        Hz_fbank = np.dstack([Hz_fbank, np.zeros_like(Hz_fbank)]).reshape(
            Hz_fbank.shape[0], -1)[:, :-1]
        Hz_fbank = scipy.signal.convolve(Hz_fbank, [Hz_lo2])
        lo = (Hz_fbank.shape[1] - Hz_hi2.size) // 2
        Hz_fbank[i, lo:lo + Hz_hi2.size] += Hz_hi2
    return Hz_fbank.astype(np.float32)


def _erfinv(x: float) -> float:
    import scipy.special

    return float(scipy.special.erfinv(x))


class AugmentPipe:
    """Stateless pipe: `pipe(images [B, C, H, W], p, generator)`; the
    adaptive probability `p` is an argument."""

    def __init__(self, cfg: AugmentConfig, max_margin: Optional[int] = None):
        self.cfg = cfg
        self.Hz_geom = setup_filter(WAVELETS["sym6"])
        self.Hz_fbank = torch.from_numpy(_filter_bank())
        self.max_margin = max_margin

    def __call__(self, images: torch.Tensor, p: float, generator: Optional[torch.Generator] = None,
                 debug_percentile: Optional[float] = None) -> torch.Tensor:
        cfg = self.cfg
        B, C, H, W = images.shape
        dev = images.device
        p = float(p)
        dp = debug_percentile

        def draw(*shape, normal=False):
            return batch_rand(shape, generator, dev, normal=normal)

        def gate(prob, val, default):
            take = draw(*((val.shape[0],) + (1,) * (val.ndim - 1))) < prob * p
            return torch.where(take, val, default)

        def full(like, value):
            return torch.full_like(like, float(value))

        # geometric: the inverse homography G (output pixel -> input pixel)
        G = torch.eye(3, device=dev).repeat(B, 1, 1)
        use_geom = False
        one = torch.ones(B, device=dev)
        if cfg.xflip > 0:
            i = gate(cfg.xflip, torch.floor(draw(B) * 2), torch.zeros(B, device=dev))
            if dp is not None:
                i = full(i, np.floor(dp * 2))
            G = G @ _scale2d(1 / (1 - 2 * i), one)
            use_geom = True
        if cfg.rotate90 > 0:
            i = gate(cfg.rotate90, torch.floor(draw(B) * 4), torch.zeros(B, device=dev))
            if dp is not None:
                i = full(i, np.floor(dp * 4))
            G = G @ _rotate2d(np.pi / 2 * i)
            use_geom = True
        if cfg.xint > 0:
            t = (draw(B, 2) * 2 - 1) * cfg.xint_max
            t = gate(cfg.xint, t, torch.zeros_like(t))
            if dp is not None:
                t = full(t, (dp * 2 - 1) * cfg.xint_max)
            G = G @ _translate2d(-torch.round(t[:, 0] * W), -torch.round(t[:, 1] * H))
            use_geom = True
        if cfg.scale > 0:
            s = gate(cfg.scale, torch.exp2(draw(B, normal=True) * cfg.scale_std), one)
            if dp is not None:
                s = full(s, np.exp2(_erfinv(dp * 2 - 1) * cfg.scale_std))
            G = G @ _scale2d(1 / s, 1 / s)
            use_geom = True
        p_rot = 1 - math.sqrt(min(max(1 - cfg.rotate * p, 0.0), 1.0))
        if cfg.rotate > 0:
            theta = (draw(B) * 2 - 1) * np.pi * cfg.rotate_max
            theta = torch.where(draw(B) < p_rot, theta, torch.zeros_like(theta))
            if dp is not None:
                theta = full(theta, (dp * 2 - 1) * np.pi * cfg.rotate_max)
            G = G @ _rotate2d(theta)
            use_geom = True
        if cfg.aniso > 0:
            s = gate(cfg.aniso, torch.exp2(draw(B, normal=True) * cfg.aniso_std), one)
            if dp is not None:
                s = full(s, np.exp2(_erfinv(dp * 2 - 1) * cfg.aniso_std))
            G = G @ _scale2d(1 / s, s)
            use_geom = True
        if cfg.rotate > 0:
            theta = (draw(B) * 2 - 1) * np.pi * cfg.rotate_max
            theta = torch.where(draw(B) < p_rot, theta, torch.zeros_like(theta))
            if dp is not None:
                theta = torch.zeros_like(theta)
            G = G @ _rotate2d(theta)
        if cfg.xfrac > 0:
            t = draw(B, 2, normal=True) * cfg.xfrac_std
            t = gate(cfg.xfrac, t, torch.zeros_like(t))
            if dp is not None:
                t = full(t, _erfinv(dp * 2 - 1) * cfg.xfrac_std)
            G = G @ _translate2d(-t[:, 0] * W, -t[:, 1] * H)
            use_geom = True
        if use_geom:
            images = self._execute_geom(images, G)

        # colour: one 4×4 matrix (colour in -> colour out)
        Cm = torch.eye(4, device=dev).repeat(B, 1, 1)
        use_color = False
        v_luma = np.asarray([1, 1, 1, 0]) / np.sqrt(3)
        vv = torch.from_numpy(np.outer(v_luma, v_luma).astype(np.float32)).to(dev)
        if cfg.brightness > 0:
            b = draw(B, normal=True) * cfg.brightness_std
            b = gate(cfg.brightness, b, torch.zeros_like(b))
            if dp is not None:
                b = full(b, _erfinv(dp * 2 - 1) * cfg.brightness_std)
            T = torch.eye(4, device=dev).repeat(B, 1, 1)
            T[:, :3, 3] = b[:, None]
            Cm = T @ Cm
            use_color = True
        if cfg.contrast > 0:
            c = gate(cfg.contrast, torch.exp2(draw(B, normal=True) * cfg.contrast_std), one)
            if dp is not None:
                c = full(c, np.exp2(_erfinv(dp * 2 - 1) * cfg.contrast_std))
            S = torch.eye(4, device=dev).repeat(B, 1, 1)
            S[:, 0, 0] = S[:, 1, 1] = S[:, 2, 2] = c
            Cm = S @ Cm
            use_color = True
        if cfg.lumaflip > 0:
            i = torch.floor(draw(B, 1, 1) * 2)
            i = gate(cfg.lumaflip, i, torch.zeros_like(i))
            if dp is not None:
                i = full(i, np.floor(dp * 2))
            Cm = (torch.eye(4, device=dev)[None] - 2 * vv[None] * i) @ Cm
            use_color = True
        if cfg.hue > 0 and C > 1:
            theta = (draw(B) * 2 - 1) * np.pi * cfg.hue_max
            theta = gate(cfg.hue, theta, torch.zeros_like(theta))
            if dp is not None:
                theta = full(theta, (dp * 2 - 1) * np.pi * cfg.hue_max)
            Cm = _rotate3d(v_luma, theta) @ Cm
            use_color = True
        if cfg.saturation > 0 and C > 1:
            s = torch.exp2(draw(B, 1, 1, normal=True) * cfg.saturation_std)
            s = gate(cfg.saturation, s, torch.ones_like(s))
            if dp is not None:
                s = full(s, np.exp2(_erfinv(dp * 2 - 1) * cfg.saturation_std))
            Cm = (vv[None] + (torch.eye(4, device=dev)[None] - vv[None]) * s) @ Cm
            use_color = True
        if use_color:
            images = self._apply_color(images, Cm)

        # image-space filtering: per-item gains of the four bands
        if cfg.imgfilter > 0:
            fbank = self.Hz_fbank.to(dev)
            num_bands = fbank.shape[0]
            expected_power = torch.tensor(np.array([10, 1, 1, 1]) / 13, dtype=torch.float32,
                                          device=dev)
            g = torch.ones(B, num_bands, device=dev)
            for i, band_strength in enumerate(cfg.imgfilter_bands):
                t_i = torch.exp2(draw(B, normal=True) * cfg.imgfilter_std)
                t_i = torch.where(draw(B) < cfg.imgfilter * p * band_strength, t_i,
                                  torch.ones_like(t_i))
                if dp is not None:
                    t_i = (full(t_i, np.exp2(_erfinv(dp * 2 - 1) * cfg.imgfilter_std))
                           if band_strength > 0 else torch.ones_like(t_i))
                t = torch.ones(B, num_bands, device=dev)
                t[:, i] = t_i
                t = t / (expected_power * t.square()).sum(dim=-1, keepdim=True).sqrt()
                g = g * t
            Hz_prime = g @ fbank  # [B, taps]
            taps = Hz_prime.shape[1]
            pad = taps // 2
            x = F.pad(images, (pad, pad, pad, pad), mode="reflect").reshape(
                1, B * C, H + 2 * pad, W + 2 * pad)
            k = Hz_prime.repeat_interleave(C, dim=0)  # [B·C, taps]; channel b·C + c
            x = F.conv2d(x, k[:, None, None, :], groups=B * C)
            x = F.conv2d(x, k[:, None, :, None], groups=B * C)
            images = x.reshape(B, C, H, W)

        # corruptions
        if cfg.noise > 0:
            sigma = draw(B, 1, 1, 1, normal=True).abs() * cfg.noise_std
            sigma = gate(cfg.noise, sigma, torch.zeros_like(sigma))
            if dp is not None:
                sigma = full(sigma, _erfinv(dp) * cfg.noise_std)
            images = images + draw(B, C, H, W, normal=True) * sigma
        if cfg.cutout > 0:
            size = torch.full((B, 2), cfg.cutout_size, device=dev)
            size = torch.where(draw(B, 1) < cfg.cutout * p, size, torch.zeros_like(size))
            center = draw(B, 2)
            if dp is not None:
                size = full(size, cfg.cutout_size)
                center = full(center, dp)
            cx = (torch.arange(W, device=dev) + 0.5) / W
            cy = (torch.arange(H, device=dev) + 0.5) / H
            mask_x = (cx[None, None, :] - center[:, 0, None, None]).abs() >= \
                size[:, 0, None, None] / 2
            mask_y = (cy[None, :, None] - center[:, 1, None, None]).abs() >= \
                size[:, 1, None, None] / 2
            images = images * (mask_x | mask_y).to(images.dtype)[:, None]
        return images

    @staticmethod
    def _apply_color(images: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
        """Apply the 4×4 colour matrices [B, 4, 4] to 1, 3 or 6 channels (6:
        each RGB half alike; 1: the mean of the colour rows)."""
        B, C, H, W = images.shape
        flat = images.reshape(B, C, H * W)
        A, b = Cm[:, :3, :3], Cm[:, :3, 3:]
        if C == 3:
            flat = A @ flat + b
        elif C == 6:
            flat = torch.cat([A @ flat[:, :3] + b, A @ flat[:, 3:] + b], dim=1)
        elif C == 1:
            Cr = Cm[:, :3, :].mean(dim=1, keepdim=True)  # [B, 1, 4]
            flat = flat * Cr[:, :, :3].sum(dim=2, keepdim=True) + Cr[:, :, 3:]
        else:
            raise ValueError(f"colour transforms take 1, 3 or 6 channels, not {C}")
        return flat.reshape(B, C, H, W)

    def _execute_geom(self, images: torch.Tensor, G_inv: torch.Tensor) -> torch.Tensor:
        """Warp [B, C, H, W] by the inverse homographies G_inv [B, 3, 3]:
        reflect-pad by the fixed margin, upsample ×2 (sym6), one bilinear
        sample, downsample ×2 back to H×W."""
        B, C, H, W = images.shape
        dev = images.device
        Hz = self.Hz_geom.to(dev)
        Hz_pad = Hz.shape[0] // 4
        m = self.max_margin if self.max_margin is not None else W // 2
        m = int(min(m + Hz_pad * 2, W - 1))
        images = F.pad(images, (m, m, m, m), mode="reflect")
        images = upsample2d(images, Hz, up=2)

        def s2(a):
            return _scale2d(torch.full((1,), a, device=dev), torch.full((1,), a, device=dev))

        def t2(a):
            return _translate2d(torch.full((1,), a, device=dev), torch.full((1,), a, device=dev))

        # the pixel-space mapping of the ×2 canvas (symmetric margins: no shift)
        G = s2(2.0) @ G_inv @ s2(0.5)
        G = t2(-0.5) @ G @ t2(0.5)
        Hs, Ws = images.shape[2], images.shape[3]
        out_h, out_w = (H + Hz_pad * 2) * 2, (W + Hz_pad * 2) * 2
        A = _scale2d(torch.full((1,), 2.0 / Ws, device=dev), torch.full((1,), 2.0 / Hs,
                                                                       device=dev)) @ G
        A = A @ _scale2d(torch.full((1,), out_w / 2.0, device=dev),
                         torch.full((1,), out_h / 2.0, device=dev))
        ys, xs = torch.meshgrid((torch.arange(out_h, device=dev) + 0.5) * 2.0 / out_h - 1.0,
                                (torch.arange(out_w, device=dev) + 0.5) * 2.0 / out_w - 1.0,
                                indexing="ij")
        pts = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1).reshape(-1, 3)  # [P, 3]
        grid = torch.einsum("bij,pj->bpi", A, pts)[..., :2].reshape(B, out_h, out_w, 2)
        images = grid_sample(images, grid)
        images = downsample2d(images, Hz, down=2, padding=-Hz_pad * 2, flip_filter=True)
        assert images.shape[2:] == (H, W), images.shape
        return images
