"""Camera-ray generation (counterpart of `invertavatar_tpu/render/ray_sampler.py`).

Pixel-index homogeneous coordinates through K⁻¹ (intrinsics scaled by the
render resolution), rotated into world space by cam2world, normalized.
K⁻¹ is the LU solve of `torch.linalg.inv` without its singularity check:
that check reads the factorisation's status on the host, which waits for
every kernel queued before it. A singular K gives non-finite rays, as
`jnp.linalg.inv` does in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch


def sample_rays(cam2world: torch.Tensor, intrinsics: torch.Tensor, resolution: int,
                normalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (ray_origins [N, R², 3], ray_dirs [N, R², 3]); pixel order row-major."""
    K = intrinsics.float().clone()
    K[:, :2] *= resolution
    K_inv = torch.linalg.inv_ex(K).inverse

    xs = torch.arange(resolution, dtype=torch.float32, device=cam2world.device)
    yg, xg = torch.meshgrid(xs, xs, indexing="ij")  # [H, W]
    homo = torch.stack([xg, yg, torch.ones_like(xg)], dim=-1).reshape(-1, 3)  # [R², 3]

    dirs_cam = torch.einsum("nij,mj->nmi", K_inv, homo)
    rays_d = torch.einsum("nij,nmj->nmi", cam2world[:, :3, :3].float(), dirs_cam)
    if normalize:
        rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rays_o = cam2world[:, None, :3, 3].float().expand_as(rays_d)
    return rays_o, rays_d
