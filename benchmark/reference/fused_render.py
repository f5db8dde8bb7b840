"""[benchmark reference] A frozen copy of `invertavatar_torch/ops/fused_render.py (plain versions only)`: plain
PyTorch, every kernel route replaced by its plain version, nothing of the
program imported. The text below is the original module's.

Fused tri-plane sampling + OSG decoder (B1) and the merged coarse∪fine march (B2).

Counterpart of `invertavatar_tpu/ops/pallas_fused_render.py`. Two CUDA kernels
(`csrc/fused_render.cu`) replace its two Pallas kernels:

  * `fused_render` (B1, replaces `_kernel` / `fused_render_pallas`): per point,
    bilinear samples of the three planes from a bf16 payload (fp32
    accumulation, zeros outside the plane), mean over planes, the decoder MLP
    C→HID, softplus, HID→1+C, and the MipNeRF sigmoid clamp on rgb. With
    `return_raw` it writes the tile-major `[T·S, P, 1+C]` layout in bf16 that
    the importance CDF and B2 read.
  * `fused_merged_march` (B2, replaces `_kernel_march` /
    `fused_merged_march_pallas`): per tile, walk the tile-shared merged depth
    list; each fine slot re-samples and decodes all rays of the tile as B1,
    coarse slots read the B1 raw rows; then the MipNeRF march per ray.

Both kernels run the decoder MLP on the tensor cores (TF32 with a three-term
split, so it keeps float32 accuracy; see the note in `csrc/fused_render.cu`).

Each wrapper runs its plain PyTorch version (`*_reference`, same module) when
its tensors lie on the CPU and launches the kernel when they lie on a CUDA
device; there is no other route. The TPU kernels drop bilinear taps that fall
outside a per-block window; the CUDA gather has no window, so where a
footprint overflows the window the port is the exact one.

Tile layout (as in the JAX wrappers): a `res × res` ray image is cut into
T = (res/th)·(res/tw) tiles of P = th·tw rays; tile t = ty·(res/tw) + tx and
in-tile ray p = py·tw + px hold ray (ty·th + py)·res + tx·tw + px.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .plane_sample import bilinear_sample_reference
from .precision import tf32

# --------------------------------------------------------------- tile helpers


def tile_shape(tile) -> Tuple[int, int]:
    """int -> square tile, (th, tw) -> rectangular (rows × columns of rays)."""
    if isinstance(tile, (tuple, list)):
        return int(tile[0]), int(tile[1])
    return int(tile), int(tile)


def tile_rays(res: int, tile, device) -> torch.Tensor:
    """`[T, P]` ray index of each (tile, in-tile ray)."""
    th, tw = tile_shape(tile)
    r = torch.arange(res * res, device=device).reshape(res // th, th, res // tw, tw)
    return r.permute(0, 2, 1, 3).reshape(-1, th * tw)


def untile(x: torch.Tensor, res: int, tile) -> torch.Tensor:
    """`[T, P, ...]` tile-major -> `[R, ...]` ray-major."""
    th, tw = tile_shape(tile)
    tail = x.shape[2:]
    x = x.reshape(res // th, res // tw, th, tw, *tail)
    return x.permute(0, 2, 1, 3, *range(4, x.ndim)).reshape(res * res, *tail)


# ------------------------------------------------------------ plain versions


def _bilinear_sum(planes: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Σ over planes of the zeros-padded bilinear sample: planes `[3, H, W, C]`
    float32, pts `[3, M, 2]` plane-space xy in [-1, 1] -> `[M, C]` float32."""
    return bilinear_sample_reference(planes, pts).sum(dim=0)


def _decode(x: torch.Tensor, decoder_params) -> torch.Tensor:
    """OSG decoder on plane-mean features `[M, C]` -> `[M, 1+C]` (σ raw, rgb)."""
    w1, b1, w2, b2 = (p.float() for p in decoder_params)
    o = tf32(F.softplus(tf32(x) @ tf32(w1) + b1)) @ tf32(w2) + b2
    rgb = torch.sigmoid(o[:, 1:]) * (1 + 2 * 0.001) - 0.001
    return torch.cat([o[:, :1], rgb], dim=1)


def _payload(planes: torch.Tensor) -> torch.Tensor:
    return planes.to(torch.bfloat16).float()


def fused_render_reference(planes, grid, decoder_params, res: int, tile=16,
                           return_raw: bool = False):
    """Plain version of `fused_render` (same arguments and outputs)."""
    N, H, W, C = planes.shape
    R, S = grid.shape[1], grid.shape[2]
    rays = tile_rays(res, tile, grid.device)  # [T, P]
    T, P = rays.shape
    pts = grid.float()[:, rays].permute(0, 1, 3, 2, 4).reshape(N, T * S * P, 2)
    x = _bilinear_sum(_payload(planes), pts) * (1.0 / 3.0)
    out = _decode(x, decoder_params).reshape(T * S, P, -1)
    if return_raw:
        return out.to(torch.bfloat16)
    out = untile(out.reshape(T, S, P, -1).permute(0, 2, 1, 3), res, tile)  # [R, S, O]
    return out[..., 1:], out[..., :1]


def fused_merged_march_reference(planes, proj_m, is_fine, src, d_m, coarse_out,
                                 decoder_params, res: int, S: int, tile=16):
    """Plain version of `fused_merged_march` (same arguments and outputs); the
    march runs vectorised over slots with `cumprod`."""
    N, H, W, C = planes.shape
    T, Sm = is_fine.shape
    P = proj_m.shape[3]
    fine = is_fine.bool()
    base = torch.arange(T, device=src.device)[:, None] * S
    rows = torch.where(fine, base, base + src.long())  # [T, Sm] raw row of coarse slots
    cur = coarse_out[rows].float()  # [T, Sm, P, O]
    pts = proj_m.float()[:, fine].reshape(N, -1, 2)
    x = _bilinear_sum(_payload(planes), pts) * (1.0 / 3.0)
    cur[fine] = _decode(x, decoder_params).reshape(-1, P, C + 1)

    d = d_m.float()
    delta = (d[:, 1:] - d[:, :-1])[..., None]  # [T, Sm-1, 1]
    d_mid = ((d[:, 1:] + d[:, :-1]) * 0.5)[..., None]
    sig = cur[..., 0]
    dens = F.softplus((sig[:, :-1] + sig[:, 1:]) * 0.5 - 1.0)
    alpha = 1.0 - torch.exp(-dens * delta)  # [T, Sm-1, P]
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], dim=1), dim=1)[:, :-1]
    w = alpha * trans
    rgb = (w[..., None] * (cur[:, :-1, :, 1:] + cur[:, 1:, :, 1:]) * 0.5).sum(dim=1)  # [T, P, C]
    wsum = w.sum(dim=1)
    depth = (w * d_mid).sum(dim=1) / wsum
    depth = torch.nan_to_num(depth, nan=float("inf"), posinf=float("inf"))
    depth = torch.clamp(depth, d.min(), d.max())
    out = torch.cat([rgb * 2.0 - 1.0, depth[..., None], wsum[..., None]], dim=-1)  # [T, P, C+2]
    out = untile(out, res, tile)
    return out[:, :C], out[:, C:C + 1], out[:, C + 1:]


