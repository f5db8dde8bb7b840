"""Metric registry and dispatcher (reference metrics/metric_main.py:29-82).

Counterpart of `invertavatar_tpu/metrics/metric_main.py`, with the same ten
names. Each metric takes its hooks as keyword arguments (`dataset`,
`sample_fn`, `detector_fn`, ...; `metrics/fid.py` builds them);
`calc_metric` times one and appends its `metric-<name>.jsonl` line to
`run_dir`.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict

import numpy as np

from .extra import compute_is, compute_ppl, compute_pr
from .fid import (compute_fid, compute_kid, dataset_feature_stats, generator_feature_stats,
                  to_uint8)

_metric_fns: Dict[str, Callable] = {}


def register_metric(fn: Callable) -> Callable:
    assert fn.__name__ not in _metric_fns
    _metric_fns[fn.__name__] = fn
    return fn


def list_metrics():
    return sorted(_metric_fns)


def calc_metric(metric: str, run_dir: str | None = None, **kwargs) -> Dict:
    if metric not in _metric_fns:
        raise ValueError(f"unknown metric {metric}; have {list_metrics()}")
    t0 = time.time()
    results = _metric_fns[metric](**kwargs)
    entry = {"results": results, "metric": metric, "total_time": time.time() - t0,
             "timestamp": time.time()}
    if run_dir is not None:
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, f"metric-{metric}.jsonl"), "a") as f:
            f.write(json.dumps(entry) + "\n")
    return entry


def _real_features(dataset, detector_fn, n_real: int) -> np.ndarray:
    """The detector's features of the dataset's first `n_real` images, 16 at
    a time (the images as the dataset holds them)."""
    return np.concatenate(
        [detector_fn(np.stack([dataset[i]["image"] for i in range(s, min(s + 16, n_real))]))
         for s in range(0, n_real, 16)])


def _generated(sample_fn, fn, num_gen: int) -> np.ndarray:
    """`fn` of `num_gen` generated images (uint8), 8 at a time from
    `RandomState(0)`."""
    rng = np.random.RandomState(0)
    out, got = [], 0
    while got < num_gen:
        imgs = sample_fn(8, rng)
        out.append(fn(to_uint8(imgs)))
        got += imgs.shape[0]
    return np.concatenate(out)[:num_gen]


def _fid(name, dataset, sample_fn, detector_fn, num_real, num_gen, cache_dir):
    real = dataset_feature_stats(dataset, detector_fn, max_items=num_real, cache_dir=cache_dir)
    gen = generator_feature_stats(sample_fn, detector_fn, num_items=num_gen)
    return {name: compute_fid(real, gen)}


@register_metric
def fid50k_full(dataset=None, sample_fn=None, detector_fn=None, max_real=None, num_gen=50000,
                cache_dir=None):
    """FID between the full real set and 50k vert-conditioned samples
    (reference frechet_inception_distance.py:18 + training_loop.py:494-503)."""
    return _fid("fid50k_full", dataset, sample_fn, detector_fn, max_real, num_gen, cache_dir)


@register_metric
def fid2k(dataset=None, sample_fn=None, detector_fn=None, cache_dir=None):
    """Small-sample FID for quick evaluation ticks."""
    return _fid("fid2k", dataset, sample_fn, detector_fn, 2000, 2000, cache_dir)


@register_metric
def fid64(dataset=None, sample_fn=None, detector_fn=None, cache_dir=None):
    """Tiny-sample FID (64 real, 64 generated) for smoke runs."""
    return _fid("fid64", dataset, sample_fn, detector_fn, 64, 64, cache_dir)


@register_metric
def kid50k_full(dataset=None, sample_fn=None, detector_fn=None, max_real=1000000,
                num_gen=50000):
    real = _real_features(dataset, detector_fn, min(len(dataset), max_real))
    return {"kid50k_full": compute_kid(real, _generated(sample_fn, detector_fn, num_gen))}


@register_metric
def is50k(sample_fn=None, prob_detector_fn=None, num_gen=50000, num_splits=10):
    """Inception score (reference metric_main.py:161-165 + inception_score.py);
    `prob_detector_fn(uint8 images) -> class probabilities [N, 1008]`."""
    mean, std = compute_is(_generated(sample_fn, prob_detector_fn, num_gen), num_splits)
    return {"is50k_mean": mean, "is50k_std": std}


@register_metric
def pr50k3_full(dataset=None, sample_fn=None, detector_fn=None, max_real=200000, num_gen=50000,
                nhood_size=3):
    """Improved precision/recall (metric_main.py:105-109 + precision_recall.py)."""
    real = _real_features(dataset, detector_fn, min(len(dataset), max_real))
    res = compute_pr(real, _generated(sample_fn, detector_fn, num_gen), nhood_size=nhood_size)
    return {"pr50k3_full_precision": res["precision"], "pr50k3_full_recall": res["recall"]}


@register_metric
def ppl2_wend(mapping_fn=None, synth_fn=None, lpips_fn=None, z_dim=512, c_sampler=None,
              num_samples=50000, batch_size=8):
    """PPL, w-space endpoints (metric_main.py:112-115 + perceptual_path_length.py)."""
    return {"ppl2_wend": compute_ppl(mapping_fn, synth_fn, lpips_fn, z_dim, c_sampler,
                                     num_samples=num_samples, epsilon=1e-4, space="w",
                                     sampling="end", batch_size=batch_size)}


def _eq(**flags):
    def metric(synthesis_fn=None, mapping_fn=None, z_dim=512, c_sampler=None,
               img_resolution=512, num_samples=50000, batch_size=4):
        from .equivariance import compute_equivariance_metrics

        return compute_equivariance_metrics(synthesis_fn, mapping_fn, z_dim, c_sampler,
                                            img_resolution, num_samples=num_samples,
                                            batch_size=batch_size, **flags)
    return metric


@register_metric
def eqt50k_int(**kw):
    """EQ-T integer-translation PSNR (reference metric_main.py:117-120)."""
    return {"eqt50k_int": _eq(compute_eqt_int=True)(**kw)}


@register_metric
def eqt50k_frac(**kw):
    """EQ-T fractional-translation PSNR (metric_main.py:122-126)."""
    return {"eqt50k_frac": _eq(compute_eqt_frac=True)(**kw)}


@register_metric
def eqr50k(**kw):
    """EQ-R rotation PSNR (metric_main.py:128-132)."""
    return {"eqr50k": _eq(compute_eqr=True)(**kw)}
