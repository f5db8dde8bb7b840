"""Dense density sampling over the tri-plane generator, for mesh export.

Counterpart of `invertavatar_tpu/utils/shapes.py` (reference
inversion/model_utils.py:90-113 and the eg3d `--shapes` tradition): a voxel
grid of sample coordinates and its densities from a `sample_mixed`
callable, such as `TriPlaneGenerator.sample_mixed`, in chunks so that the
card's memory stays flat. Marching cubes runs on the caller's side.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .misc import resolve_device


def create_samples(N: int = 512, voxel_origin=(0, 0, 0), cube_length: float = 2.0):
    """Voxel-grid sample coordinates (model_utils.py:90-112), z fastest, then
    y, then x: ([1, N³, 3] float32, origin corner, voxel size)."""
    origin = np.array(voxel_origin, np.float64) - cube_length / 2
    voxel_size = cube_length / (N - 1)
    idx = np.arange(N ** 3, dtype=np.int64)
    samples = np.zeros((N ** 3, 3), np.float32)
    samples[:, 2] = idx % N
    samples[:, 1] = (idx // N) % N
    samples[:, 0] = (idx // (N * N)) % N
    samples[:, 0] = samples[:, 0] * voxel_size + origin[2]
    samples[:, 1] = samples[:, 1] * voxel_size + origin[1]
    samples[:, 2] = samples[:, 2] * voxel_size + origin[0]
    return samples[None], origin, voxel_size


def sample_density_grid(sample_mixed_fn: Callable, ws, mesh_condition,
                        voxel_resolution: int = 256, voxel_origin=(0, 0, 0),
                        cube_length: float = 0.3, coordinate_scale: float = 0.9,
                        max_batch: int = 100000, device="cuda") -> np.ndarray:
    """σ over the voxel grid, [N, N, N] float32 numpy: `sample_mixed_fn(coords
    [1, M, 3] on `device`, ws, mesh_condition) -> {"sigma"}` in chunks of
    `max_batch` points (the last padded to a whole chunk, as the JAX package
    pads it); the coordinates are scaled by `coordinate_scale`
    (model_utils.py:117 `0.9 * samples`)."""
    device = resolve_device(device)
    samples, _, _ = create_samples(voxel_resolution, voxel_origin, cube_length)
    samples = samples * coordinate_scale
    M = samples.shape[1]
    n_chunks = -(-M // max_batch)
    coords = np.pad(samples[0], ((0, n_chunks * max_batch - M), (0, 0)))
    sigmas = []
    with torch.no_grad():
        for i in range(n_chunks):
            chunk = torch.from_numpy(coords[i * max_batch:(i + 1) * max_batch]).to(device)[None]
            sigmas.append(sample_mixed_fn(chunk, ws, mesh_condition)["sigma"].reshape(-1)
                          .float().cpu().numpy())
    vol = np.concatenate(sigmas)[:M]
    return vol.reshape(voxel_resolution, voxel_resolution, voxel_resolution)
