"""Visualisation helpers: snapshot image grids, the vertex-image condition
and density cross-sections.

Counterpart of `invertavatar_tpu/utils/vis.py`: the reference's tick-time
`reals.png` / `fakes.png` grids (training_loop.py:460-472),
`visualize_mesh_condition` (triplane_v20.py:71-87) and the cross-section of
training/crosssection_utils.py:13-23. PIL is imported where a PNG is
written.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch


def save_image_grid(images, path: str, drange=(-1, 1),
                    grid_wh: Optional[Tuple[int, int]] = None) -> None:
    """[N, C, H, W] floats (tensor or array) in `drange` -> a tiled PNG, row
    by row, `grid_wh` (columns, rows) or the smallest square grid."""
    import PIL.Image

    if hasattr(images, "detach"):
        images = images.detach().float().cpu().numpy()
    lo, hi = drange
    imgs = np.clip((np.asarray(images, np.float32) - lo) * (255 / (hi - lo)), 0, 255)
    imgs = imgs.astype(np.uint8).transpose(0, 2, 3, 1)
    N, H, W, C = imgs.shape
    if grid_wh is None:
        gw = int(np.ceil(np.sqrt(N)))
        gh = int(np.ceil(N / gw))
    else:
        gw, gh = grid_wh
    grid = np.zeros((gh * H, gw * W, C), np.uint8)
    for i in range(min(N, gw * gh)):
        r, c = divmod(i, gw)
        grid[r * H:(r + 1) * H, c * W:(c + 1) * W] = imgs[i]
    PIL.Image.fromarray(grid[..., 0] if C == 1 else grid).save(path)


def visualize_mesh_condition(uvcoords_image: np.ndarray,
                             fill_alpha: Optional[np.ndarray] = None) -> np.ndarray:
    """uvcoords_image [B, H, W, 3] (the dataset's layout) -> uint8: the uv
    channels as colours, black outside the mask (its third channel, or
    `fill_alpha`)."""
    vis = np.asarray(uvcoords_image, np.float32).copy()
    mask = vis[..., 2:3] if fill_alpha is None else fill_alpha
    vis = np.where(mask > 0, vis, -1.0)
    return np.clip((vis + 1) * 127.5, 0, 255).astype(np.uint8)


def sample_cross_section(sample_mixed_fn: Callable, ws: torch.Tensor, mesh_condition,
                         resolution: int = 256, w: float = 1.2) -> np.ndarray:
    """σ on the x = 0 plane over [-w/2, w/2]², for shape snapshots:
    `sample_mixed_fn` is `TriPlaneGenerator.sample_mixed` (or one like it),
    evaluated on `ws`'s device. Returns [B, 1, resolution, resolution]."""
    a = torch.linspace(w / 2, -w / 2, resolution, device=ws.device)
    b = torch.linspace(-w / 2, w / 2, resolution, device=ws.device)
    A, B = torch.meshgrid(a, b, indexing="ij")
    coords = torch.stack([torch.zeros_like(A), A, B], dim=-1).reshape(1, -1, 3)
    coords = coords.expand(ws.shape[0], coords.shape[1], 3)
    with torch.no_grad():
        sigma = sample_mixed_fn(coords, ws, mesh_condition)["sigma"]
    return sigma.float().cpu().numpy().reshape(-1, 1, resolution, resolution)
