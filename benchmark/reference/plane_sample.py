"""[benchmark reference] A frozen copy of `invertavatar_torch/ops/plane_sample.py (plain versions only)`: plain
PyTorch, every kernel route replaced by its plain version, nothing of the
program imported. The text below is the original module's.

Structured tri-plane bilinear sampling (kernel B3), its plain version alone.

Counterpart of `invertavatar_tpu/ops/plane_sample.py` and
`invertavatar_tpu/ops/pallas_plane_sample.py`. The renderer's structured
passes (ray-tile × depth-stratum points) sample the planes here:

  * `sample_planes_windowed` (B3, replaces the Pallas `_kernel` /
    `sample_planes_windowed_pallas`): per point, the four bilinear taps of a
    channels-last plane (zeros outside it), summed in float32. The payload
    is float32 (the exact route and training) or bfloat16, and the output
    has the payload's dtype, as the TPU kernel's does.

The TPU formulation cuts the points into (tile, stratum) blocks and drops
taps outside a per-block window, because TPU gathers are slow. The CUDA
kernels (`csrc/plane_sample.cu`) gather each point's taps directly, so they
need no window and are exact where a footprint overflows one. The window is
still computed (`coarse_window_for`), because the renderer routes on it.

Non-finite coordinates, per point, in the plain version and the kernel
alike: a NaN in x or y gives NaN in every channel of its sample; ±inf in x
or y (and no NaN), like any coordinate far off the plane, a sample of 0.

Each wrapper runs its plain PyTorch version (`*_reference`, same module) when
its tensors lie on the CPU and launches the kernel when they lie on a CUDA
device; there is no other route.
"""

from __future__ import annotations

import math

import torch


# ------------------------------------------------------------ window bounds


def coarse_window_for(resolution: int, tile: int = 16) -> int:
    """Texel window bounding a square ray-tile × stratum footprint (the JAX
    renderer routes on it; 32 at the flagship's 128² render, tile 16)."""
    frac = tile / max(resolution, 1)
    texels = int(math.ceil(frac * 0.25 * 3.4 * 2 * 128))
    return max(16, min(128, texels + 4))


# ------------------------------------------------------------ plain versions


def _taps(grid: torch.Tensor, H: int, W: int):
    """The four bilinear taps of each point: (flat texel index, weight) pairs,
    weights zeroed for taps outside the plane (zeros padding). grid `[N, M, 2]`
    plane-space xy in [-1, 1] (align_corners=False).

    Non-finite coordinates are decided before any cast, as the kernels decide
    them: a point with a NaN in x or y takes the plane's texels (0..1, 0..1)
    with NaN weights, so that its samples are NaN; a point with ±inf (and no
    NaN), or more than 1e8 texels off the plane, has no taps: it samples 0."""
    gx = (grid[..., 0].float() + 1.0) * (W * 0.5) - 0.5
    gy = (grid[..., 1].float() + 1.0) * (H * 0.5) - 0.5
    x0f, y0f = torch.floor(gx), torch.floor(gy)
    wx, wy = gx - x0f, gy - y0f
    nan = torch.isnan(gx) | torch.isnan(gy)
    off = torch.isinf(gx) | torch.isinf(gy) | (x0f.abs() >= 1e8) | (y0f.abs() >= 1e8)
    x0 = torch.where(nan, 0.0, torch.where(off, -2.0, x0f)).long()
    y0 = torch.where(nan, 0.0, torch.where(off, -2.0, y0f)).long()
    out = []
    for dy, dx, w in ((0, 0, (1 - wx) * (1 - wy)), (0, 1, wx * (1 - wy)),
                      (1, 0, (1 - wx) * wy), (1, 1, wx * wy)):
        yi, xi = y0 + dy, x0 + dx
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        out.append((yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1), torch.where(valid, w, 0.0)))
    return out


def bilinear_sample_reference(planes: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Zeros-padded bilinear samples of each plane, summed in float32.

    planes `[N, H, W, C]` (sampled as given), grid `[N, M, 2]` -> `[N, M, C]`
    float32."""
    N, H, W, C = planes.shape
    flat = planes.float().reshape(N, H * W, C)
    out = 0.0
    for idx, w in _taps(grid, H, W):
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
        out = out + vals * w[..., None]
    return out


def sample_planes_windowed_reference(planes: torch.Tensor, grid: torch.Tensor,
                                     payload_dtype=torch.float32) -> torch.Tensor:
    """Plain version of `sample_planes_windowed` (same arguments and output)."""
    N, H, W, C = planes.shape
    out = bilinear_sample_reference(planes.to(payload_dtype), grid.reshape(N, -1, 2))
    return out.reshape(*grid.shape[:-1], C).to(payload_dtype)
