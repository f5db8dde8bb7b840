"""Equivariance metrics EQ-T, EQ-T_frac and EQ-R, plain PyTorch (NCHW).

Counterpart of `invertavatar_tpu/metrics/equivariance.py` (reference
metrics/equivariance.py) for the StyleGAN3 generator family: the host
draws concrete translations and rotations, the images are transformed on
their own device, and the PSNR sums are float64. No generator of the port
takes an input transform yet (StyleGAN3 is not ported), so a caller's
`synthesis_fn(ws, transform)` supplies one.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops.grid_sample import grid_sample
from ..ops.upfirdn2d import filter2d, upsample2d


def sinc(x: torch.Tensor) -> torch.Tensor:
    y = (x * np.pi).abs()
    z = torch.sin(y) / y.clamp(min=1e-30)
    return torch.where(y < 1e-30, torch.ones_like(z), z)


def lanczos_window(x: torch.Tensor, a) -> torch.Tensor:
    x = x.abs() / a
    return torch.where(x < 1, sinc(x), torch.zeros_like(x))


def _sinc_np(x: np.ndarray) -> np.ndarray:
    """`sinc` of a float64 array evaluated in float32, as the JAX package
    evaluates it."""
    return sinc(torch.from_numpy(np.asarray(x, np.float32))).numpy()


def _lanczos_np(x: np.ndarray, a) -> np.ndarray:
    return lanczos_window(torch.from_numpy(np.asarray(x, np.float32)), a).numpy()


def rotation_matrix(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)


def _filter2d(x: torch.Tensor, f: np.ndarray, padding) -> torch.Tensor:
    """`filter2d` with explicit [x0, x1, y0, y1] padding."""
    return filter2d(x, torch.from_numpy(np.asarray(f, np.float32)), padding=list(padding))


def apply_integer_translation(x: torch.Tensor, tx, ty):
    """equivariance.py:46-63. x [N, C, H, W]; tx, ty in image fractions.
    Returns (shifted image, mask)."""
    N, C, H, W = x.shape
    ix = int(np.rint(float(tx) * W))
    iy = int(np.rint(float(ty) * H))
    z = torch.zeros_like(x, dtype=torch.float32)
    m = torch.zeros_like(x, dtype=torch.float32)
    if abs(ix) < W and abs(iy) < H:
        src = x[:, :, max(-iy, 0):H + min(-iy, 0), max(-ix, 0):W + min(-ix, 0)]
        z[:, :, max(iy, 0):H + min(iy, 0), max(ix, 0):W + min(ix, 0)] = src
        m[:, :, max(iy, 0):H + min(iy, 0), max(ix, 0):W + min(ix, 0)] = 1
    return z, m


def apply_fractional_translation(x: torch.Tensor, tx, ty, a: int = 3):
    """equivariance.py:65-97: a shift by Lanczos-windowed sinc resampling."""
    N, C, H, W = x.shape
    txp, typ = float(tx) * W, float(ty) * H
    ix, iy = int(np.floor(txp)), int(np.floor(typ))
    fx, fy = txp - ix, typ - iy
    b = a - 1

    z = torch.zeros_like(x, dtype=torch.float32)
    zx0, zy0 = max(ix - b, 0), max(iy - b, 0)
    zx1, zy1 = min(ix + a, 0) + W, min(iy + a, 0) + H
    if zx0 < zx1 and zy0 < zy1:
        taps = np.arange(a * 2) - b
        filt_x = _sinc_np(taps - fx) * _sinc_np((taps - fx) / a)
        filt_y = _sinc_np(taps - fy) * _sinc_np((taps - fy) / a)
        y = _filter2d(x, (filt_x / filt_x.sum())[None, :], (b, a, 0, 0))
        y = _filter2d(y, (filt_y / filt_y.sum())[:, None], (0, 0, b, a))
        y = y[:, :, max(b - iy, 0):H + b + a + min(-iy - a, 0),
              max(b - ix, 0):W + b + a + min(-ix - a, 0)]
        z[:, :, zy0:zy1, zx0:zx1] = y
    m = torch.zeros_like(x, dtype=torch.float32)
    mx0, my0 = max(ix + a, 0), max(iy + a, 0)
    mx1, my1 = min(ix - b, 0) + W, min(iy - b, 0) + H
    if mx0 < mx1 and my0 < my1:
        m[:, :, my0:my1, mx0:mx1] = 1
    return z, m


def construct_affine_bandlimit_filter(mat, a=3, amax=16, aflt=64, up=4, cutoff_in=1.0,
                                      cutoff_out=1.0) -> torch.Tensor:
    """equivariance.py:100-131: the FFT-composed oriented sinc·Lanczos filter."""
    mat = np.asarray(mat, np.float32)
    taps = np.roll((np.arange(aflt * up * 2 - 1) + 1) / up - aflt, 1 - aflt * up)
    yi, xi = np.meshgrid(taps, taps, indexing="ij")
    out = np.stack([xi, yi], axis=2) @ mat[:2, :2].T
    xo, yo = out[..., 0], out[..., 1]

    fi = _sinc_np(xi * cutoff_in) * _sinc_np(yi * cutoff_in)
    fo = _sinc_np(xo * cutoff_out) * _sinc_np(yo * cutoff_out)
    f = np.fft.ifftn(np.fft.fftn(fi) * np.fft.fftn(fo)).real

    wi = _lanczos_np(xi, a) * _lanczos_np(yi, a)
    wo = _lanczos_np(xo, a) * _lanczos_np(yo, a)
    w = np.fft.ifftn(np.fft.fftn(wi) * np.fft.fftn(wo)).real

    f = f * w
    c = (aflt - amax) * up
    f = np.roll(f, (aflt * up - 1, aflt * up - 1), axis=(0, 1))[c:-c, c:-c]
    f = np.pad(f, ((0, 1), (0, 1))).reshape(amax * 2, up, amax * 2, up)
    f = f / f.sum(axis=(0, 2), keepdims=True) / (up ** 2)
    f = f.reshape(amax * 2 * up, amax * 2 * up)[:-1, :-1]
    return torch.from_numpy(np.asarray(f, np.float32))


def _affine_grid(theta: np.ndarray, N: int, H: int, W: int, device) -> torch.Tensor:
    """`F.affine_grid(align_corners=False)` of one [2, 3] theta, computed in
    float64 as the JAX package does -> [N, H, W, 2] (x, y)."""
    xs = (2 * np.arange(W) + 1) / W - 1
    ys = (2 * np.arange(H) + 1) / H - 1
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    pts = np.stack([gx, gy, np.ones_like(gx)], axis=-1)  # [H, W, 3]
    g = torch.from_numpy(np.asarray(pts @ theta.T, np.float32)).to(device)
    return g[None].expand(N, H, W, 2)


def _grid_sample_nearest(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Nearest-texel sampling with zero padding (align_corners=False; ties
    round half to even)."""
    B, C, H, W = img.shape
    gx = (grid[..., 0] + 1) * (W * 0.5) - 0.5
    gy = (grid[..., 1] + 1) * (H * 0.5) - 0.5
    xi, yi = torch.round(gx).long(), torch.round(gy).long()
    valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    flat = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(B, 1, -1)
    vals = torch.gather(img.reshape(B, C, H * W), 2, flat.expand(B, C, flat.shape[2]))
    return vals.reshape(B, C, *grid.shape[1:3]) * valid[:, None]


def apply_affine_transformation(x: torch.Tensor, mat, up=4, **filter_kwargs):
    """equivariance.py:136-166."""
    N, C, H, W = x.shape
    mat = np.asarray(mat, np.float32)
    f = construct_affine_bandlimit_filter(mat, up=up, **filter_kwargs)
    p = f.shape[0] // 2

    theta = np.linalg.inv(mat)
    theta[:2, 2] *= 2
    theta[0, 2] += 1 / up / W
    theta[1, 2] += 1 / up / H
    theta[0, :] *= W / (W + p / up * 2)
    theta[1, :] *= H / (H + p / up * 2)
    g = _affine_grid(theta[:2, :3], N, H, W, x.device)

    y = upsample2d(x, f.to(x.device), up=up, padding=p)
    z = grid_sample(y, g)
    m = torch.zeros_like(y, dtype=torch.float32)
    c = p * 2 + 1
    m[:, :, c:-c, c:-c] = 1
    return z, _grid_sample_nearest(m, g)


def apply_fractional_rotation(x: torch.Tensor, angle, a=3, **filter_kwargs):
    mat = rotation_matrix(float(angle))
    return apply_affine_transformation(x, mat, a=a, amax=a * 2, **filter_kwargs)


def apply_fractional_pseudo_rotation(x: torch.Tensor, angle, a=3, **filter_kwargs):
    mat = rotation_matrix(-float(angle))
    f = construct_affine_bandlimit_filter(mat, a=a, amax=a * 2, up=1, **filter_kwargs)
    y = filter2d(x, f.to(x.device), padding=[0, 0, 0, 0])
    m = torch.zeros_like(y, dtype=torch.float32)
    c = f.shape[0] // 2
    m[:, :, c:-c, c:-c] = 1
    return y, m


def compute_equivariance_metrics(synthesis_fn: Callable, mapping_fn: Callable, z_dim: int,
                                 c_sampler: Callable, img_resolution: int,
                                 num_samples: int = 200, batch_size: int = 4,
                                 translate_max: float = 0.125, rotate_max: float = 1.0,
                                 compute_eqt_int: bool = False, compute_eqt_frac: bool = False,
                                 compute_eqr: bool = False, seed: int = 0):
    """equivariance.py:194-270: the PSNR between renders of transformed
    inputs and transformed renders. `synthesis_fn(ws, transform [3, 3]
    numpy) -> images [N, C, H, W]`, `mapping_fn(z, c) -> ws` (z numpy),
    `c_sampler(n, rng) -> labels`."""
    assert compute_eqt_int or compute_eqt_frac or compute_eqr
    rng = np.random.RandomState(seed)
    I = np.eye(3, dtype=np.float32)  # noqa: E741
    sums = None
    for _ in range(0, num_samples, batch_size):
        z = rng.randn(batch_size, z_dim).astype(np.float32)
        c = np.asarray(c_sampler(batch_size, rng))
        ws = mapping_fn(z, c)
        orig = synthesis_fn(ws, I)
        s = []
        if compute_eqt_int:
            t = (rng.rand(2) * 2 - 1) * translate_max
            t = np.round(t * img_resolution) / img_resolution
            M = I.copy()
            M[:2, 2] = -t
            img = synthesis_fn(ws, M)
            ref, mask = apply_integer_translation(orig, t[0], t[1])
            s += [torch.square(ref - img) * mask, mask]
        if compute_eqt_frac:
            t = (rng.rand(2) * 2 - 1) * translate_max
            M = I.copy()
            M[:2, 2] = -t
            img = synthesis_fn(ws, M)
            ref, mask = apply_fractional_translation(orig, t[0], t[1])
            s += [torch.square(ref - img) * mask, mask]
        if compute_eqr:
            angle = (rng.rand() * 2 - 1) * (rotate_max * np.pi)
            img = synthesis_fn(ws, rotation_matrix(-angle))
            ref, ref_mask = apply_fractional_rotation(orig, angle)
            pseudo, pseudo_mask = apply_fractional_pseudo_rotation(img, angle)
            mask = ref_mask * pseudo_mask
            s += [torch.square(ref - pseudo) * mask, mask]
        s = np.asarray([float(v.double().sum()) for v in s])
        sums = s if sums is None else sums + s
    mses = sums[0::2] / sums[1::2]
    psnrs = np.log10(2) * 20 - np.log10(mses) * 10
    return tuple(psnrs) if len(psnrs) > 1 else float(psnrs[0])
