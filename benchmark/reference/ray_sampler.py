"""[benchmark reference] A frozen copy of `invertavatar_torch/render/ray_sampler.py`: plain
PyTorch, every kernel route replaced by its plain version, nothing of the
program imported. The text below is the original module's.

Camera-ray generation (counterpart of `invertavatar_tpu/render/ray_sampler.py`).

Pixel-index homogeneous coordinates through K⁻¹ (intrinsics scaled by the
render resolution), rotated into world space by cam2world, normalized.
"""

from __future__ import annotations

from typing import Tuple

import torch


def sample_rays(cam2world: torch.Tensor, intrinsics: torch.Tensor, resolution: int,
                normalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (ray_origins [N, R², 3], ray_dirs [N, R², 3]); pixel order row-major."""
    K = intrinsics.float().clone()
    K[:, :2] *= resolution
    K_inv = torch.linalg.inv(K)

    xs = torch.arange(resolution, dtype=torch.float32, device=cam2world.device)
    yg, xg = torch.meshgrid(xs, xs, indexing="ij")  # [H, W]
    homo = torch.stack([xg, yg, torch.ones_like(xg)], dim=-1).reshape(-1, 3)  # [R², 3]

    dirs_cam = torch.einsum("nij,mj->nmi", K_inv, homo)
    rays_d = torch.einsum("nij,nmj->nmi", cam2world[:, :3, :3].float(), dirs_cam)
    if normalize:
        rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rays_o = cam2world[:, None, :3, 3].float().expand_as(rays_d)
    return rays_o, rays_d
