"""Fused tri-plane sampling + OSG decoder (B1) and the merged coarse∪fine march (B2).

Counterpart of `invertavatar_tpu/ops/pallas_fused_render.py`. Two CUDA kernels
(`csrc/fused_render.cu`) replace its two Pallas kernels:

  * `fused_render` (B1, replaces `_kernel` / `fused_render_pallas`): per point,
    bilinear samples of the three planes from a bf16 payload (fp32
    accumulation, zeros outside the plane), mean over planes, the decoder MLP
    C→HID, softplus, HID→1+C, and the MipNeRF sigmoid clamp on rgb. With
    `return_raw` it writes the tile-major `[T·S, P, 1+C]` layout in bf16 that
    the importance CDF and B2 read.
  * `fused_merged_march` (B2, replaces `_kernel_march` /
    `fused_merged_march_pallas`): per ray, walk the tile-shared merged depth
    list; fine slots re-sample and decode as B1, coarse slots read the B1 raw
    row; then the MipNeRF march, all in registers.

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

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..utils import cuda_build
from .plane_sample import bilinear_sample_reference

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
    o = F.softplus(x @ w1 + b1) @ w2 + b2
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


# ------------------------------------------------------------------- kernels

_CU_SOURCE = "fused_render"
_SUPPORTED_C = (8, 32)  # the tests' and the flagship's plane channels


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(_CU_SOURCE)
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.fused_render_launch.argtypes = [P, P, P, P, I, I, I, I, I, I, I, I, I, P]
        lib.fused_render_launch.restype = I
        lib.merged_march_launch.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P]
        lib.merged_march_launch.restype = I
        lib._typed = True
    return lib


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def _pack_decoder(decoder_params, C: int, device) -> Tuple[torch.Tensor, int]:
    """One float32 buffer `[w1ᵀ (HID×C) | b1 | w2 (HID×OP) | b2 (OP)]`, OP = 1+C
    padded to a multiple of 4, as the kernels stage it in shared memory."""
    w1, b1, w2, b2 = (p.detach().float().to(device) for p in decoder_params)
    HID = w1.shape[1]
    _check(tuple(w1.shape) == (C, HID) and tuple(b1.shape) == (HID,)
           and tuple(w2.shape) == (HID, C + 1) and tuple(b2.shape) == (C + 1,),
           f"decoder params must be w1 [C,HID], b1 [HID], w2 [HID,1+C], b2 [1+C] with C={C}")
    _check(HID % 4 == 0, "the decoder's hidden width must be a multiple of 4")
    OP = (C + 1 + 3) // 4 * 4
    pad = OP - (C + 1)
    return torch.cat([w1.t().reshape(-1), b1, F.pad(w2, (0, pad)).reshape(-1),
                      F.pad(b2, (0, pad))]).contiguous(), HID


def _cuda_inputs(planes: torch.Tensor, others: Sequence[torch.Tensor]) -> torch.Tensor:
    """Validate device/grad and return the bf16 channels-last payload."""
    _check(planes.device.type == "cuda", f"expected CUDA tensors, got {planes.device}")
    for t in others:
        _check(t.device == planes.device, "all inputs must lie on the planes' device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (planes, *others)):
        raise RuntimeError("the fused render kernels have no backward; call them under no_grad")
    _check(planes.shape[-1] in _SUPPORTED_C, f"plane channels must be one of {_SUPPORTED_C}")
    payload = planes.to(torch.bfloat16).contiguous()
    _check(payload.data_ptr() % 16 == 0, "planes must be 16-byte aligned")
    return payload


def _stream() -> ctypes.c_void_p:
    # Kernels run on PyTorch's current stream. Temporaries a wrapper frees on
    # return (packed weights, contiguous copies) stay valid for the kernel:
    # the caching allocator hands their memory only to work queued after it
    # on the same stream.
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def fused_render(planes, grid, decoder_params, res: int, tile=16, return_raw: bool = False):
    """Fused tri-plane sampling + OSG decoder.

    planes `[3, H, W, C]` (any float dtype; sampled from its bf16 rounding),
    grid `[3, R, S, 2]` plane-space xy in [-1, 1] with rays row-major,
    decoder_params (w1 [C,HID], b1 [HID], w2 [HID,1+C], b2 [1+C]) gain-folded.
    Returns (rgb [R, S, C], sigma [R, S, 1]) float32, or with `return_raw` the
    tile-major `[T·S, P, 1+C]` bf16 layout (σ raw first).
    """
    N, H, W, C = planes.shape
    _check(N == 3 and grid.ndim == 4 and grid.shape[0] == 3 and grid.shape[-1] == 2,
           "planes must be [3,H,W,C] and grid [3,R,S,2]")
    th, tw = tile_shape(tile)
    R, S = grid.shape[1], grid.shape[2]
    _check(R == res * res and res % th == 0 and res % tw == 0, "tile must divide res, R = res²")
    if planes.device.type == "cpu" and grid.device.type == "cpu":
        return fused_render_reference(planes, grid, decoder_params, res, tile, return_raw)

    payload = _cuda_inputs(planes, [grid])
    _check(grid.dtype == torch.float32, "grid must be float32")
    grid = grid.contiguous()
    wpack, HID = _pack_decoder(decoder_params, C, planes.device)
    T, P = (res // th) * (res // tw), th * tw
    out = torch.empty((T * S, P, C + 1), device=planes.device,
                      dtype=torch.bfloat16 if return_raw else torch.float32)
    rc = _lib().fused_render_launch(
        payload.data_ptr(), grid.data_ptr(), wpack.data_ptr(), out.data_ptr(),
        C, H, W, res, th, tw, S, HID, 0 if return_raw else 1, _stream())
    _raise_on(rc, "fused_render")
    fused_render.launches += 1
    if return_raw:
        return out
    out = untile(out.reshape(T, S, P, C + 1).permute(0, 2, 1, 3), res, tile)
    return out[..., 1:], out[..., :1]


def fused_merged_march(planes, proj_m, is_fine, src, d_m, coarse_out, decoder_params,
                       res: int, S: int, tile=16):
    """Merged coarse∪fine pass with the MipNeRF march.

    proj_m `[3, T, Sm, P, 2]` plane-space xy of every merged slot, is_fine /
    src `[T, Sm]` int32 (slot kind; index in its own list), d_m `[T, Sm]`
    merged depths (shared by a tile), coarse_out the `fused_render` raw output.
    Returns ray-major (rgb [R, C] in (−1, 1), depth [R, 1], weight sum [R, 1]);
    depth is clamped to the global [min d_m, max d_m].
    """
    N, H, W, C = planes.shape
    T, Sm = is_fine.shape
    th, tw = tile_shape(tile)
    P = th * tw
    _check(N == 3 and tuple(proj_m.shape) == (3, T, Sm, P, 2), "proj_m must be [3,T,Sm,P,2]")
    _check(T == (res // th) * (res // tw) and tuple(src.shape) == (T, Sm)
           and tuple(d_m.shape) == (T, Sm), "is_fine/src/d_m must be [T,Sm]")
    _check(tuple(coarse_out.shape) == (T * S, P, C + 1), "coarse_out must be [T*S,P,1+C]")
    if planes.device.type == "cpu" and proj_m.device.type == "cpu":
        return fused_merged_march_reference(planes, proj_m, is_fine, src, d_m, coarse_out,
                                            decoder_params, res, S, tile)

    payload = _cuda_inputs(planes, [proj_m, is_fine, src, d_m, coarse_out])
    _check(proj_m.dtype == torch.float32 and d_m.dtype == torch.float32,
           "proj_m and d_m must be float32")
    _check(is_fine.dtype == torch.int32 and src.dtype == torch.int32,
           "is_fine and src must be int32")
    _check(coarse_out.dtype == torch.bfloat16, "coarse_out must be the bf16 raw layout")
    proj_m, is_fine, src, d_m, coarse_out = (
        t.contiguous() for t in (proj_m, is_fine, src, d_m, coarse_out))
    wpack, HID = _pack_decoder(decoder_params, C, planes.device)
    # global depth range, left on the device so the frame never waits on a copy
    drange = torch.stack([d_m.min(), d_m.max()])
    out = torch.empty((T, P, C + 2), device=planes.device, dtype=torch.float32)
    rc = _lib().merged_march_launch(
        payload.data_ptr(), proj_m.data_ptr(), is_fine.data_ptr(), src.data_ptr(),
        d_m.data_ptr(), coarse_out.data_ptr(), wpack.data_ptr(), drange.data_ptr(),
        out.data_ptr(), C, H, W, T, Sm, S, P, HID, _stream())
    _raise_on(rc, "fused_merged_march")
    fused_merged_march.launches += 1
    out = untile(out, res, tile)
    return out[:, :C], out[:, C:C + 1], out[:, C + 1:]


fused_render.launches = 0
fused_merged_march.launches = 0
