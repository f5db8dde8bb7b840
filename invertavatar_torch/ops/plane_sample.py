"""Structured tri-plane bilinear sampling (kernel B3) and its transpose.

Counterpart of `invertavatar_tpu/ops/plane_sample.py` and
`invertavatar_tpu/ops/pallas_plane_sample.py`. The renderer's structured
passes (ray-tile × depth-stratum points) sample the planes here:

  * `sample_planes_windowed` (B3, replaces the Pallas `_kernel` /
    `sample_planes_windowed_pallas`): per point, the four bilinear taps of a
    channels-last plane (zeros outside it), summed in float32. The payload
    is float32 (the exact route and training) or bfloat16, and the output
    has the payload's dtype, as the TPU kernel's does.
  * `windowed_sample_transpose` (replaces the XLA transpose of the same
    name): d plane[y, x, c] = Σ_p tent_y · tent_x · cot[p, c], the exact
    gradient of the sampling with respect to the planes.
  * `sample_planes_windowed_cvjp`: the two as one `torch.autograd.Function`.

The TPU formulation cuts the points into (tile, stratum) blocks and drops
taps outside a per-block window, because TPU gathers are slow. The CUDA
kernels (`csrc/plane_sample.cu`) gather each point's taps directly, so they
need no window and are exact where a footprint overflows one. The window is
still computed (`coarse_window_for`), because the renderer routes on it. A
point with a NaN or infinite coordinate samples NaN in the forward, as in
JAX; the transpose gives it no taps.

Each wrapper runs its plain PyTorch version (`*_reference`, same module) when
its tensors lie on the CPU and launches the kernel when they lie on a CUDA
device; there is no other route.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from ..utils import cuda_build

# ------------------------------------------------------------ window bounds


def coarse_window_for(resolution: int, tile: int = 16) -> int:
    """Texel window bounding a square ray-tile × stratum footprint (the JAX
    renderer routes on it; 32 at the flagship's 128² render, tile 16)."""
    frac = tile / max(resolution, 1)
    texels = int(math.ceil(frac * 0.25 * 3.4 * 2 * 128))
    return max(16, min(128, texels + 4))


def coarse_window_rect(resolution: int, th: int, tw: int) -> Tuple[int, int]:
    """Per-axis window bound for a rectangular th × tw pixel tile."""
    span = 0.25 * 3.4 * 2 * 128 / max(resolution, 1)
    wy = max(12, min(192, int(math.ceil(th * span)) + 4))
    wx = max(12, min(192, int(math.ceil(tw * span)) + 4))
    return wy, wx


# ------------------------------------------------------------ plain versions


def _taps(grid: torch.Tensor, H: int, W: int):
    """The four bilinear taps of each point: (flat texel index, weight) pairs,
    weights zeroed for taps outside the plane (zeros padding). grid `[N, M, 2]`
    plane-space xy in [-1, 1] (align_corners=False)."""
    gx = (grid[..., 0].float() + 1.0) * (W * 0.5) - 0.5
    gy = (grid[..., 1].float() + 1.0) * (H * 0.5) - 0.5
    x0f, y0f = torch.floor(gx), torch.floor(gy)
    wx, wy = gx - x0f, gy - y0f
    x0, y0 = x0f.long(), y0f.long()
    out = []
    for dy, dx, w in ((0, 0, (1 - wx) * (1 - wy)), (0, 1, wx * (1 - wy)),
                      (1, 0, (1 - wx) * wy), (1, 1, wx * wy)):
        yi, xi = y0 + dy, x0 + dx
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        out.append((yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1), w * valid))
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


def windowed_sample_transpose_reference(grid: torch.Tensor, cot: torch.Tensor,
                                        planes_shape) -> torch.Tensor:
    """Plain version of `windowed_sample_transpose`: `index_add_` of tap
    weight × cotangent into zeroed float32 planes."""
    N, H, W, C = planes_shape
    cot = cot.float().reshape(N, -1, C)
    base = torch.arange(N, device=cot.device)[:, None] * (H * W)
    out = torch.zeros((N * H * W, C), dtype=torch.float32, device=cot.device)
    for idx, w in _taps(grid.reshape(N, -1, 2), H, W):
        out.index_add_(0, (idx + base).reshape(-1), (cot * w[..., None]).reshape(-1, C))
    return out.reshape(N, H, W, C)


# ------------------------------------------------------------------- kernels

_CU_SOURCE = "plane_sample"
_PAYLOADS = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(_CU_SOURCE)
    if not getattr(lib, "_typed", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.plane_sample_launch.argtypes = [P, P, P, I, I, I, I, L, I, P]
        lib.plane_sample_launch.restype = I
        lib.plane_sample_transpose_launch.argtypes = [P, P, P, I, I, I, I, L, P]
        lib.plane_sample_transpose_launch.restype = I
        lib._typed = True
    return lib


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def _stream() -> ctypes.c_void_p:
    # Temporaries a wrapper frees on return stay valid for the kernel: the
    # caching allocator hands their memory only to work queued after it on
    # the same stream.
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous at a 16-byte aligned address (the kernels load 16 bytes
    at a time); a view that starts elsewhere is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_shapes(planes_shape, grid: torch.Tensor):
    N, H, W, C = planes_shape
    _check(grid.ndim >= 3 and grid.shape[0] == N and grid.shape[-1] == 2,
           "grid must be [N, ..., 2] with N = the planes' leading dim")
    _check(C % 8 == 0, "plane channels must be a multiple of 8")


def sample_planes_windowed(planes: torch.Tensor, grid: torch.Tensor,
                           payload_dtype=torch.float32) -> torch.Tensor:
    """Bilinear samples of each plane at its own points (kernel B3).

    planes `[N, H, W, C]` (cast to `payload_dtype`, float32 or bfloat16),
    grid `[N, R, S, 2]` plane-space xy in [-1, 1] (any point layout after the
    leading N) -> `[N, R, S, C]` in `payload_dtype`, summed in float32.
    """
    _check(planes.ndim == 4, "planes must be [N, H, W, C]")
    _check_shapes(planes.shape, grid)
    _check(payload_dtype in _PAYLOADS, f"payload must be one of {list(_PAYLOADS)}")
    if planes.device.type == "cpu" and grid.device.type == "cpu":
        return sample_planes_windowed_reference(planes, grid, payload_dtype)

    _check(planes.device.type == "cuda" and grid.device == planes.device,
           f"expected CUDA tensors on one device, got {planes.device} and {grid.device}")
    _check(grid.dtype == torch.float32, "grid must be float32")
    _check(planes.shape[0] <= 65535, "at most 65535 planes per launch")
    N, H, W, C = planes.shape
    payload = _aligned(planes.detach().to(payload_dtype))
    grid = _aligned(grid.detach())
    out = torch.empty((*grid.shape[:-1], C), device=planes.device, dtype=payload_dtype)
    M = grid[0].numel() // 2
    rc = _lib().plane_sample_launch(payload.data_ptr(), grid.data_ptr(), out.data_ptr(),
                                    N, H, W, C, M, _PAYLOADS[payload_dtype], _stream())
    _raise_on(rc, "plane_sample")
    sample_planes_windowed.launches += 1
    return out


def windowed_sample_transpose(grid: torch.Tensor, cot: torch.Tensor, planes_shape) -> torch.Tensor:
    """Transpose of `sample_planes_windowed` with respect to the planes.

    grid `[N, R, S, 2]`, cot `[N, R, S, C]` -> float32 `[N, H, W, C]`. The
    kernel adds each tap's share of four channels with one 16-byte float32
    vector atomic, so the order of the sums (and the last bits) changes from
    run to run."""
    N, H, W, C = (int(s) for s in planes_shape)
    _check_shapes((N, H, W, C), grid)
    _check(tuple(cot.shape) == (*grid.shape[:-1], C), "cot must be [N, R, S, C] like the output")
    if grid.device.type == "cpu" and cot.device.type == "cpu":
        return windowed_sample_transpose_reference(grid, cot, (N, H, W, C))

    _check(grid.device.type == "cuda" and cot.device == grid.device,
           f"expected CUDA tensors on one device, got {grid.device} and {cot.device}")
    _check(grid.dtype == torch.float32, "grid must be float32")
    grid = _aligned(grid.detach())
    cot = _aligned(cot.detach().float())
    out = torch.zeros((N, H, W, C), device=grid.device, dtype=torch.float32)
    M = grid[0].numel() // 2
    rc = _lib().plane_sample_transpose_launch(grid.data_ptr(), cot.data_ptr(), out.data_ptr(),
                                              N, H, W, C, M, _stream())
    _raise_on(rc, "plane_sample_transpose")
    windowed_sample_transpose.launches += 1
    return out


sample_planes_windowed.launches = 0
windowed_sample_transpose.launches = 0


class _WindowedSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, planes, grid):
        ctx.save_for_backward(grid)
        ctx.planes_meta = (tuple(planes.shape), planes.dtype)
        return sample_planes_windowed(planes, grid, torch.float32)

    @staticmethod
    def backward(ctx, cot):
        (grid,) = ctx.saved_tensors
        shape, dtype = ctx.planes_meta
        d_planes = windowed_sample_transpose(grid, cot, shape).to(dtype)
        # the grid's cotangent is zero by contract (see below)
        return d_planes, None


def sample_planes_windowed_cvjp(planes: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Differentiable structured sampling: B3 (float32 payload) forward, the
    transpose kernel backward.

    As in the JAX package, no gradient flows to `grid`: every training
    caller's ray grid is parameter-free (cameras are data, importance depths
    are detached), so do not use this where coordinates need gradients."""
    return _WindowedSample.apply(planes, grid)
