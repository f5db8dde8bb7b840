"""Frechet Inception Distance and the feature statistics behind it.

Counterpart of `invertavatar_tpu/metrics/fid.py` (reference
`metrics/frechet_inception_distance.py` + `metrics/metric_utils.py:61-217`).
The statistics are float64 numpy on the host, as in the JAX package: a
detector maps uint8 NHWC images to [N, D] features, which come off the card
once per batch. The real side's statistics are cached per (dataset,
detector); the generated side samples (label, vertex image) pairs from the
dataset as the reference's vert-conditioned sampler does.

The detector is a callable. For the published numbers pass
`make_torch_inception_detector` over the reference's torchscript Inception
(`inception-2015-12-05.pt`, read by path; it is not in the repository).
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, Optional

import numpy as np
import scipy.linalg


class FeatureStats:
    """Running mean and covariance (reference metric_utils.FeatureStats)."""

    def __init__(self, max_items: Optional[int] = None):
        self.max_items = max_items
        self.num_items = 0
        self.raw_mean = None
        self.raw_cov = None

    def append(self, feats: np.ndarray):
        feats = np.asarray(feats, np.float64)
        if self.max_items is not None:
            remaining = self.max_items - self.num_items
            if remaining <= 0:
                return
            feats = feats[:remaining]
        if self.raw_mean is None:
            d = feats.shape[1]
            self.raw_mean = np.zeros(d)
            self.raw_cov = np.zeros((d, d))
        self.raw_mean += feats.sum(axis=0)
        self.raw_cov += feats.T @ feats
        self.num_items += feats.shape[0]

    @property
    def is_full(self) -> bool:
        return self.max_items is not None and self.num_items >= self.max_items

    def get_mean_cov(self):
        mean = self.raw_mean / self.num_items
        cov = self.raw_cov / self.num_items - np.outer(mean, mean)
        return mean, cov

    def save(self, path: str):
        """Write the statistics (numbers and float64 arrays only) to `path`."""
        np.savez(path, max_items=np.asarray(-1 if self.max_items is None else self.max_items),
                 num_items=np.asarray(self.num_items), raw_mean=self.raw_mean,
                 raw_cov=self.raw_cov)

    @classmethod
    def load(cls, path: str) -> "FeatureStats":
        with np.load(path, allow_pickle=False) as f:
            max_items = int(f["max_items"])
            obj = cls(None if max_items < 0 else max_items)
            obj.num_items = int(f["num_items"])
            obj.raw_mean, obj.raw_cov = f["raw_mean"], f["raw_cov"]
        return obj


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """FID of two Gaussians (reference frechet_inception_distance.py:35-41).
    `sqrtm` is called without `disp` (removed in SciPy 1.18; without it
    every version returns the root alone)."""
    m = np.square(mu1 - mu2).sum()
    s = scipy.linalg.sqrtm(np.dot(sigma1, sigma2))
    return float(np.real(m + np.trace(sigma1 + sigma2 - s * 2)))


def to_uint8(images: np.ndarray) -> np.ndarray:
    """[-1, 1] float images -> uint8."""
    return np.clip((np.asarray(images) + 1) * 127.5, 0, 255).astype(np.uint8)


def dataset_feature_stats(dataset, detector_fn: Callable[[np.ndarray], np.ndarray],
                          max_items: Optional[int] = None, batch_size: int = 16,
                          cache_dir: Optional[str] = None, cache_tag: str = "") -> FeatureStats:
    """Feature statistics of the dataset's first `max_items` images
    (`dataset[i]["image"]`, NHWC uint8 or [-1, 1] floats), cached in
    `cache_dir` under the md5 of (dataset path, item count, `cache_tag`), as
    the JAX package keys them. The cache is a `.npz` of arrays: loading it
    runs no code (the JAX package pickles it)."""
    n = len(dataset) if max_items is None else min(len(dataset), max_items)
    cache_path = None
    if cache_dir:
        key = hashlib.md5(f"{getattr(dataset, 'path', '')}-{n}-{cache_tag}".encode()).hexdigest()
        cache_path = os.path.join(cache_dir, f"fid-real-stats-{key}.npz")
        if os.path.exists(cache_path):
            return FeatureStats.load(cache_path)
    stats = FeatureStats(max_items=n)
    for start in range(0, n, batch_size):
        imgs = np.stack([dataset[i]["image"] for i in range(start, min(start + batch_size, n))])
        if imgs.dtype != np.uint8:
            imgs = to_uint8(imgs)
        stats.append(detector_fn(imgs))
    if cache_path:
        os.makedirs(cache_dir, exist_ok=True)
        stats.save(cache_path)
    return stats


def generator_feature_stats(sample_fn: Callable[[int, np.random.RandomState], np.ndarray],
                            detector_fn: Callable[[np.ndarray], np.ndarray], num_items: int,
                            batch_size: int = 8, seed: int = 0) -> FeatureStats:
    """Feature statistics of `num_items` generated images. `sample_fn(batch,
    rng)` draws (z, label, vertex image) itself, as the reference's
    vert-conditioned sampler (metric_utils.py:61-88), and returns [-1, 1]
    NHWC images."""
    stats = FeatureStats(max_items=num_items)
    rng = np.random.RandomState(seed)
    while not stats.is_full:
        stats.append(detector_fn(to_uint8(sample_fn(batch_size, rng))))
    return stats


def compute_fid(real_stats: FeatureStats, gen_stats: FeatureStats) -> float:
    mu_r, sig_r = real_stats.get_mean_cov()
    mu_g, sig_g = gen_stats.get_mean_cov()
    return frechet_distance(mu_g, sig_g, mu_r, sig_r)


def compute_kid(real_feats: np.ndarray, gen_feats: np.ndarray, num_subsets: int = 100,
                max_subset_size: int = 1000, seed: int = 0) -> float:
    """Kernel Inception Distance (reference kernel_inception_distance.py)."""
    rng = np.random.RandomState(seed)
    n = real_feats.shape[1]
    m = min(min(real_feats.shape[0], gen_feats.shape[0]), max_subset_size)
    t = 0.0
    for _ in range(num_subsets):
        x = gen_feats[rng.choice(gen_feats.shape[0], m, replace=False)]
        y = real_feats[rng.choice(real_feats.shape[0], m, replace=False)]
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += (a.sum() - np.trace(a)) / (m - 1) - b.sum() * 2 / m
    return float(t / num_subsets / m)


def make_torch_inception_detector(detector_path: str, device="cuda"):
    """The reference's torchscript Inception network (inception-2015-12-05.pt,
    metric_utils.py get_feature_detector) on `device` (CUDA unless
    `device="cpu"` is asked for). Returns detect(uint8 NHWC numpy) ->
    features [N, 2048] float32 numpy."""
    import torch

    from ..utils.misc import resolve_device

    device = resolve_device(device)
    model = torch.jit.load(detector_path, map_location=device).eval()

    def detect(images_u8: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(np.transpose(images_u8, (0, 3, 1, 2))))
        with torch.no_grad():
            feats = model(x.to(device), return_features=True)
        return feats.float().cpu().numpy()

    return detect


def make_vert_conditioned_sample_fn(G, z_dim: int = 512, dataset=None):
    """Generator sampler for metric evaluation (reference
    metric_utils.py:61-88): `sample_fn(batch, rng)` draws z ~ N(0, 1), then
    `batch` dataset indices, from `rng` (a `np.random.RandomState`, in the
    JAX package's order), renders their (label, vertex image) pairs with `G`
    (the EMA generator, on its own device) in evaluation mode with constant
    synthesis noise, and returns [-1, 1] NHWC float32 numpy images. The
    renderer's and the super-resolution's draws come from a
    `torch.Generator` seeded by one more `rng` draw, where JAX seeds its key.

    `dataset[i]` provides "c" [25] and "v": {"uvcoords_image" [256, 256,
    3]} (the training dataset's layout)."""
    import torch

    device = next(G.parameters()).device

    def sample_fn(batch: int, rng: np.random.RandomState) -> np.ndarray:
        z = rng.randn(batch, z_dim).astype(np.float32)
        idx = rng.randint(len(dataset), size=batch)
        items = [dataset[int(i)] for i in idx]
        c = np.stack([np.asarray(it["c"], np.float32) for it in items])
        uvc = np.stack([np.asarray(it["v"]["uvcoords_image"], np.float32) for it in items])
        gen = torch.Generator(device=device).manual_seed(int(rng.randint(0, 2 ** 31 - 1)))
        with torch.no_grad():
            img = G(torch.from_numpy(z).to(device), torch.from_numpy(c).to(device),
                    {"uvcoords_image": torch.from_numpy(uvc).to(device)}, evaluation=True,
                    noise_mode="const", generator=gen)["image"]
        return img.float().permute(0, 2, 3, 1).cpu().numpy()

    return sample_fn
