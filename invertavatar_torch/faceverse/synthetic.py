"""Synthetic FaceVerse assets at the real topology scale.

Counterpart of `invertavatar_tpu/faceverse/synthetic.py`, with the same
numpy draws: the published model dict is not in the repository, so benchmarks
and smoke runs that need the online-driving raster build a grid-triangulated
face disc with the real coefficient layout (150 id, 52 expression, 251
texture, 38 pose/light/eye). `n_grid=173` gives 29,929 vertices and 59,168
faces, the FaceVerse v3 mesh size.
"""

from __future__ import annotations

import numpy as np
import torch

from ..flagship import example_inputs
from .manager import FaceverseManager
from .model import FaceVerseAssets

ID_D, EXP_D, TEX_D = 150, 52, 251
COEFF_DIM = ID_D + EXP_D + TEX_D + 38  # + rotation / gamma / translation / eye tail


def grid_faces(n_grid: int) -> np.ndarray:
    """Two triangles per grid cell, row-major: [a, a+1, a+n], [a+1, a+n+1, a+n]."""
    a = (np.arange(n_grid - 1)[:, None] * n_grid + np.arange(n_grid - 1)[None]).ravel()
    first = np.stack([a, a + 1, a + n_grid], 1)
    second = np.stack([a + 1, a + n_grid + 1, a + n_grid], 1)
    return np.stack([first, second], 1).reshape(-1, 3).astype(np.int32)


def synthetic_assets(n_grid: int = 124, seed: int = 0) -> FaceVerseAssets:
    """Grid-triangulated face disc with random blendshape bases."""
    rng = np.random.RandomState(seed)
    us, vs = np.meshgrid(np.linspace(0.05, 0.95, n_grid), np.linspace(0.05, 0.95, n_grid))
    uv = np.stack([us.ravel(), vs.ravel()], -1).astype(np.float32)
    V = uv.shape[0]
    xy = (uv - 0.5) * 0.5
    z = 0.15 - ((uv - 0.5) ** 2).sum(-1) * 0.4
    meanshape = np.stack([xy[:, 0], xy[:, 1], z], -1).reshape(1, -1).astype(np.float32)
    return FaceVerseAssets(
        meanshape=meanshape,
        id_base=(rng.randn(3 * V, ID_D) * 1e-3).astype(np.float32),
        exp_base=(rng.randn(3 * V, EXP_D) * 2e-3).astype(np.float32),
        uv_per_ver=uv,
        tri=grid_faces(n_grid),
        ver_inds=(0, 8, 16),
        id_dims=ID_D,
        exp_dims=EXP_D,
        tex_dims=TEX_D,
    )


def point_buf(tri: np.ndarray, V: int) -> np.ndarray:
    """Per-vertex face adjacency [V, max(8, most faces at a vertex)] int64, in
    ascending face order, padded with the index F: pair it with `tri` and
    one degenerate face appended (`uv_model_dict`), whose normal is zero."""
    F = len(tri)
    v = np.asarray(tri, np.int64).reshape(-1)
    f = np.repeat(np.arange(F), 3)
    order = np.argsort(v, kind="stable")
    v, f = v[order], f[order]
    counts = np.bincount(v, minlength=V)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    buf = np.full((V, max(8, int(counts.max()))), F, np.int64)
    buf[v, np.arange(len(v)) - start[v]] = f
    return buf


def uv_model_dict(assets: FaceVerseAssets) -> dict:
    """The model-dict entries the uvRender step reads (`data/preprocess.py`)
    for synthetic assets: 'uv_per_ver' (the grid's UV atlas), 'tri' with one
    degenerate face appended and 'point_buf' padded with its index."""
    V = assets.uv_per_ver.shape[0]
    tri = np.concatenate([assets.tri, [[0, 0, 0]]], axis=0).astype(np.int32)
    return {"uv_per_ver": assets.uv_per_ver, "tri": tri, "point_buf": point_buf(assets.tri, V)}


def synthetic_manager(n_grid: int = 124, seed: int = 0, device="cuda"):
    """(FaceverseManager on `device` with its identity set, drive-coefficient
    bank [8, COEFF_DIM] as numpy)."""
    rng = np.random.RandomState(seed)
    assets = synthetic_assets(n_grid, seed)
    fv2fl = np.eye(4, dtype=np.float32) * 0.6
    fv2fl[3, 3] = 1.0
    V = assets.uv_per_ver.shape[0]
    mgr = FaceverseManager(assets, fv2fl=fv2fl, face_mask=np.ones(V, np.float32), device=device)
    coeffs = (rng.randn(8, COEFF_DIM) * 0.1).astype(np.float32)
    mgr.set_identity(coeffs[0])
    return mgr, coeffs


def synthetic_source_clip(manager: FaceverseManager, coeffs, n: int, seed: int = 0):
    """A seeded stand-in for a preprocessed source clip of n frames on the
    manager's device: frames [n, 3, 512, 512] uniform in [-1, 1], the UV
    inputs [n, 6, 256, 256] (a seeded UV texture ‖ the manager's
    `uvcoords_image` of `coeffs[i]`), the frontal camera [n, 25] and the
    uvcoords [n, 256, 256, 3]."""
    rng = np.random.RandomState(seed)
    dev = manager.device
    with torch.no_grad():
        uvc = torch.cat([manager.make_driven_rendering(coeffs[i]) for i in range(n)])
    images = torch.from_numpy(rng.uniform(-1, 1, (n, 3, 512, 512)).astype(np.float32)).to(dev)
    tex = torch.from_numpy(rng.uniform(-1, 1, (n, 3, 256, 256)).astype(np.float32)).to(dev)
    cams = torch.from_numpy(np.repeat(example_inputs(1)[1], n, axis=0)).to(dev)
    return images, torch.cat([tex, uvc.permute(0, 3, 1, 2)], dim=1), cams, uvc


def coeff_trajectory(n_frames: int, seed: int = 3) -> np.ndarray:
    """Smooth sinusoidal drive coefficients [n_frames, COEFF_DIM]: expression
    and eye channels move, identity and texture hold."""
    rng = np.random.RandomState(seed)
    base = (rng.randn(COEFF_DIM) * 0.1).astype(np.float32)
    amp = np.zeros(COEFF_DIM, np.float32)
    amp[ID_D:ID_D + EXP_D] = rng.rand(EXP_D) * 0.6  # expression sweep
    amp[-4:] = 0.2  # eye coefficients
    phase = rng.rand(COEFF_DIM) * 2 * np.pi
    freq = 0.3 + rng.rand(COEFF_DIM) * 0.8
    t = np.arange(n_frames, dtype=np.float32)[:, None]
    return base[None] + amp[None] * np.sin(freq[None] * t + phase[None])
