"""Inception score, precision/recall and perceptual path length.

Counterpart of `invertavatar_tpu/metrics/extra.py` (reference
metrics/inception_score.py, precision_recall.py, perceptual_path_length.py).
The math runs in numpy on the host, as in the JAX package; the generator and
LPIPS hooks are callables that may work on the card and hand back tensors,
which come to the host once per batch.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np


def host(x) -> np.ndarray:
    """A tensor on any device, or an array, as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def compute_is(gen_probs: np.ndarray, num_splits: int = 10) -> Tuple[float, float]:
    """Inception score over class probabilities (inception_score.py:20-38)."""
    num_gen = len(gen_probs)
    scores = []
    for i in range(num_splits):
        part = gen_probs[i * num_gen // num_splits:(i + 1) * num_gen // num_splits]
        kl = part * (np.log(part) - np.log(np.mean(part, axis=0, keepdims=True)))
        kl = np.mean(np.sum(kl, axis=1))
        scores.append(np.exp(kl))
    return float(np.mean(scores)), float(np.std(scores))


def _cdist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a2 = np.sum(np.square(a), axis=1, keepdims=True)
    b2 = np.sum(np.square(b), axis=1, keepdims=True)
    d2 = a2 - 2 * (a @ b.T) + b2.T
    return np.sqrt(np.clip(d2, 0, None))


def compute_pr(real_features: np.ndarray, gen_features: np.ndarray, nhood_size: int = 3,
               row_batch_size: int = 10000, col_batch_size: int = 10000) -> dict:
    """Improved precision/recall (precision_recall.py:38-76): a probe counts
    as covered if it lies within the k-NN radius of any manifold sample."""
    results = {}
    for name, manifold, probes in (("precision", real_features, gen_features),
                                   ("recall", gen_features, real_features)):
        def dists(batch):
            return np.concatenate([_cdist(batch, manifold[j:j + col_batch_size])
                                   for j in range(0, len(manifold), col_batch_size)], axis=1)

        # the k-th smallest, the self-distance 0 included: index nhood_size
        kth = np.concatenate([
            np.partition(dists(manifold[i:i + row_batch_size]), nhood_size, axis=1)[:, nhood_size]
            for i in range(0, len(manifold), row_batch_size)])
        pred = np.concatenate([np.any(dists(probes[i:i + row_batch_size]) <= kth[None, :], axis=1)
                               for i in range(0, len(probes), row_batch_size)])
        results[name] = float(np.mean(pred.astype(np.float64)))
    return results


def slerp(a: np.ndarray, b: np.ndarray, t) -> np.ndarray:
    """Spherical interpolation (perceptual_path_length.py:24-34)."""
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    d = np.sum(a * b, axis=-1, keepdims=True)
    p = t * np.arccos(np.clip(d, -1.0, 1.0))
    c = b - d * a
    c = c / np.linalg.norm(c, axis=-1, keepdims=True)
    out = a * np.cos(p) + c * np.sin(p)
    return out / np.linalg.norm(out, axis=-1, keepdims=True)


def compute_ppl(mapping_fn: Callable, synth_fn: Callable, lpips_fn: Callable, z_dim: int,
                c_sampler: Callable, num_samples: int = 2000, epsilon: float = 1e-4,
                space: str = "w", sampling: str = "end", batch_size: int = 8,
                seed: int = 0) -> float:
    """PPL (perceptual_path_length.py:37-131): the LPIPS distance between
    eps-separated interpolation points, scaled by 1/eps², averaged over the
    1%-99% band. `mapping_fn(z, c) -> w [B, num_ws, w_dim]`, `synth_fn(w, c)
    -> images` (handed to `lpips_fn` as they are), `lpips_fn(a, b) -> [B]`
    distances, `c_sampler(n, rng) -> labels`; z, c and w are numpy."""
    rng = np.random.RandomState(seed)
    dists = []
    for _ in range(0, num_samples, batch_size):
        c = host(c_sampler(batch_size, rng))
        t = rng.rand(batch_size, 1) * (1.0 if sampling == "full" else 0.0)
        z0 = rng.randn(batch_size, z_dim).astype(np.float32)
        z1 = rng.randn(batch_size, z_dim).astype(np.float32)
        if space == "w":
            w0 = host(mapping_fn(z0, c))
            w1 = host(mapping_fn(z1, c))
            wt0 = w0 + (w1 - w0) * t[:, :, None]
            wt1 = w0 + (w1 - w0) * (t + epsilon)[:, :, None]
        else:
            wt0 = host(mapping_fn(slerp(z0, z1, t), c))
            wt1 = host(mapping_fn(slerp(z0, z1, t + epsilon), c))
        d = host(lpips_fn(synth_fn(wt0, c), synth_fn(wt1, c))).reshape(-1)
        dists.append(d / (epsilon ** 2))
    dists = np.concatenate([np.atleast_1d(d) for d in dists])
    lo = np.percentile(dists, 1, method="lower")
    hi = np.percentile(dists, 99, method="higher")
    return float(np.extract(np.logical_and(dists >= lo, dists <= hi), dists).mean())
