"""The port's GAN evaluation metrics against the JAX package on the same
inputs: the feature statistics, FID, KID, IS, precision/recall, PPL, the
registry, the real statistics' cache, the equivariance operators and
metric, and the vert-conditioned sampler's draws.

Inputs are numpy-seeded; both packages run the same host hooks. Tolerances:
1e-6 relative on the metric math (float64 on both sides; the same numpy
calls), 1e-5 on the equivariance operators (float32 filters and samples).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from invertavatar_torch import metrics as pm
from invertavatar_torch.metrics import equivariance as peq
from invertavatar_torch.metrics import extra as pextra
from invertavatar_torch.metrics import fid as pfid
from invertavatar_tpu import metrics as jm
from invertavatar_tpu.metrics import equivariance as jeq
from invertavatar_tpu.metrics import extra as jextra
from invertavatar_tpu.metrics import fid as jfid

torch.set_num_threads(1)


def _close(a, b, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rtol,
                               atol=0)


def test_feature_stats_and_fid_match_jax():
    """Batched accumulation with a mid-batch `max_items` cut, the mean and
    covariance, `frechet_distance` and `compute_fid`."""
    rng = np.random.RandomState(7)
    batches = [rng.randn(n, 16).astype(np.float32) * 3 + 0.5 for n in (37, 64, 50, 80)]
    stats = []
    for mod in (pfid, jfid):
        real, gen = mod.FeatureStats(max_items=150), mod.FeatureStats(max_items=150)
        for b in batches:
            real.append(b)
            gen.append(b[::-1] * 1.1 + 0.2)
        stats.append((real, gen))
    (pr, pg), (jr, jg) = stats
    assert pr.num_items == jr.num_items == 150 and pr.is_full
    for a, b in zip(pr.get_mean_cov() + pg.get_mean_cov(), jr.get_mean_cov() + jg.get_mean_cov()):
        np.testing.assert_array_equal(a, b)
    _close(pfid.compute_fid(pr, pg), jfid.compute_fid(jr, jg))
    m1, c1 = pr.get_mean_cov()
    m2, c2 = pg.get_mean_cov()
    _close(pfid.frechet_distance(m1, c1, m2, c2), jfid.frechet_distance(m1, c1, m2, c2))
    assert abs(pfid.frechet_distance(m1, c1, m1, c1)) < 1e-8


def test_kid_is_pr_match_jax():
    rng = np.random.RandomState(2)
    real, gen = rng.randn(120, 16), rng.randn(100, 16) * 1.2 + 0.1
    _close(pfid.compute_kid(real, gen, num_subsets=10, max_subset_size=50),
           jfid.compute_kid(real, gen, num_subsets=10, max_subset_size=50))
    logits = rng.randn(60, 10) * 2
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    for a, b in zip(pextra.compute_is(probs, 5), jextra.compute_is(probs, 5)):
        _close(a, b)
    # small row / column batches run the blocked distance loops
    for kw in ({}, {"row_batch_size": 32, "col_batch_size": 48}):
        p, j = pextra.compute_pr(real, gen, 3, **kw), jextra.compute_pr(real, gen, 3, **kw)
        assert p == j and 0 < p["precision"] < 1, (p, j)


def test_ppl_linear_generator_matches_jax():
    """PPL on a linear generator: numpy hooks on both sides, and the port
    again with torch hooks (images and distances as tensors)."""
    W = np.random.RandomState(2).randn(16, 48).astype(np.float32)

    def mapping(z, c):
        return np.tile(np.asarray(z, np.float32)[:, None], (1, 3, 1))

    def synth(w, c):
        return (np.asarray(w)[:, 0] @ W).reshape(-1, 4, 4, 3)

    def lpips(a, b):
        return np.mean(np.square(a - b), axis=(1, 2, 3))

    kw = dict(z_dim=16, c_sampler=lambda n, r: np.zeros((n, 1)), num_samples=64, batch_size=8)
    val_j = jextra.compute_ppl(mapping, synth, lpips, **kw)
    val_p = pextra.compute_ppl(mapping, synth, lpips, **kw)
    _close(val_p, val_j)
    Wt = torch.from_numpy(W).double()
    val_t = pextra.compute_ppl(
        lambda z, c: torch.from_numpy(mapping(z, c)),
        lambda w, c: (torch.from_numpy(np.asarray(w))[:, 0] @ Wt).reshape(-1, 3, 4, 4),
        lambda a, b: torch.square(a - b).mean(dim=(1, 2, 3)), **kw)
    _close(val_t, val_j)
    assert np.isfinite(val_p) and val_p > 0
    for t in (0.0, 0.3):
        a, b = np.random.RandomState(3).randn(2, 4, 16)
        _close(pextra.slerp(a, b, t), jextra.slerp(a, b, t))


def test_registry_lists_the_same_metrics():
    assert pm.list_metrics() == jm.list_metrics()
    assert len(pm.list_metrics()) == 10
    with pytest.raises(ValueError, match="unknown metric"):
        pm.calc_metric("fid1")


class _DS:
    path = "synthetic"

    def __len__(self):
        return 64

    def __getitem__(self, i):
        return {"image": np.random.RandomState(i).randint(0, 255, (8, 8, 3), np.uint8)}


def _hooks():
    W = np.random.RandomState(1).randn(192, 16) * 0.1

    def detector(imgs_u8):
        return imgs_u8.reshape(imgs_u8.shape[0], -1).astype(np.float64) @ W

    def sample_fn(batch, r):
        return np.stack([np.random.RandomState(1000 + r.randint(64)).randint(0, 255, (8, 8, 3))
                         / 127.5 - 1 for _ in range(batch)])

    return detector, sample_fn


def test_calc_metric_fid64_writes_its_line_and_matches_jax(tmp_path):
    detector, sample_fn = _hooks()
    run_dir = str(tmp_path / "run")
    out = pm.calc_metric("fid64", run_dir=run_dir, dataset=_DS(), sample_fn=sample_fn,
                         detector_fn=detector)
    ref = jm.calc_metric("fid64", dataset=_DS(), sample_fn=sample_fn, detector_fn=detector)
    _close(out["results"]["fid64"], ref["results"]["fid64"])
    with open(os.path.join(run_dir, "metric-fid64.jsonl")) as f:
        lines = f.read().strip().splitlines()
    entry = json.loads(lines[-1])
    assert len(lines) == 1 and entry["metric"] == "fid64"
    assert entry["results"]["fid64"] == out["results"]["fid64"]
    assert entry["total_time"] >= 0 and entry["timestamp"] > 0


@pytest.mark.parametrize("name", ["kid50k_full", "pr50k3_full", "is50k"])
def test_feature_metrics_match_jax(name):
    """KID, precision/recall and IS through the registry, at 40 generated
    items, on the same hooks."""
    detector, sample_fn = _hooks()
    if name == "is50k":
        def prob(u8):
            e = np.exp(np.tanh(detector(u8)[:, :10]))
            return e / e.sum(1, keepdims=True)
        kw = dict(sample_fn=sample_fn, prob_detector_fn=prob, num_gen=40, num_splits=4)
    else:
        kw = dict(dataset=_DS(), sample_fn=sample_fn, detector_fn=detector, num_gen=40)
    p, j = pm.calc_metric(name, **kw)["results"], jm.calc_metric(name, **kw)["results"]
    assert p.keys() == j.keys()
    for k in p:
        _close(p[k], j[k])


def test_dataset_stats_cache_roundtrip(tmp_path):
    """The second call reads the cache and never runs the detector; another
    tag (detector) does not collide; the cached statistics equal JAX's."""
    rng = np.random.RandomState(3)
    images = [{"image": rng.rand(8, 8, 3).astype(np.float32) * 2 - 1} for _ in range(20)]

    class DS(list):
        path = "fake-ds"

    calls = []

    def detector(u8):
        calls.append(u8.shape[0])
        return u8.reshape(u8.shape[0], -1).astype(np.float64) / 255.0

    kw = dict(max_items=12, batch_size=5, cache_dir=str(tmp_path), cache_tag="t")
    s1 = pfid.dataset_feature_stats(DS(images), detector, **kw)
    assert sum(calls) == 12
    n_calls = len(calls)
    s2 = pfid.dataset_feature_stats(DS(images), detector, **kw)
    assert len(calls) == n_calls, "the second call must be served from the cache"
    assert s2.num_items == s1.num_items == 12 and s2.max_items == 12
    for a, b in zip(s1.get_mean_cov(), s2.get_mean_cov()):
        np.testing.assert_array_equal(a, b)
    pfid.dataset_feature_stats(DS(images), detector, **dict(kw, cache_tag="other"))
    assert len(calls) > n_calls
    ref = jfid.dataset_feature_stats(DS(images), detector, max_items=12, batch_size=5)
    for a, b in zip(s2.get_mean_cov(), ref.get_mean_cov()):
        np.testing.assert_array_equal(a, b)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2))))


def _check(port, jax_out, atol=1e-5):
    for p, j in zip(port, jax_out):
        np.testing.assert_allclose(p.numpy(), np.transpose(np.asarray(j), (0, 3, 1, 2)),
                                   atol=atol, rtol=0)


@pytest.mark.parametrize("tx,ty", [(0.07, -0.11), (0.0, 0.25), (-0.3, 0.02)])
def test_translations_match_jax(tx, ty):
    x = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    _check(peq.apply_integer_translation(_nchw(x), tx, ty),
           jeq.apply_integer_translation(jnp.asarray(x), tx, ty), atol=0)
    _check(peq.apply_fractional_translation(_nchw(x), tx, ty),
           jeq.apply_fractional_translation(jnp.asarray(x), tx, ty))


@pytest.mark.parametrize("angle", [0.3, -1.1])
def test_rotations_and_filter_match_jax(angle):
    x = np.random.RandomState(1).rand(2, 32, 32, 3).astype(np.float32)
    mat = peq.rotation_matrix(angle)
    np.testing.assert_allclose(peq.construct_affine_bandlimit_filter(mat, a=3, amax=6).numpy(),
                               np.asarray(jeq.construct_affine_bandlimit_filter(mat, a=3, amax=6)),
                               atol=1e-7, rtol=0)
    _check(peq.apply_fractional_rotation(_nchw(x), angle),
           jeq.apply_fractional_rotation(jnp.asarray(x), angle))
    _check(peq.apply_fractional_pseudo_rotation(_nchw(x), angle),
           jeq.apply_fractional_pseudo_rotation(jnp.asarray(x), angle))


def _toy_synthesis(res):
    """A toy `synthesis_fn(ws, M)`: smooth sinusoids (frequencies from ws) at
    the transformed pixel coordinates -> numpy [N, 3, res, res]."""
    def toy(ws, M):
        ws = np.asarray(ws, np.float64)
        lin = (np.arange(res) + 0.5) / res * 2 - 1
        gy, gx = np.meshgrid(lin, lin, indexing="ij")
        pts = np.stack([gx, gy, np.ones_like(gx)], -1) @ np.asarray(M, np.float64).T
        fx, fy = ws[:, :3, None, None], ws[:, 3:6, None, None]
        img = np.sin(9 * fx * pts[None, None, ..., 0] + 7 * fy * pts[None, None, ..., 1])
        img = img + 0.1 * np.sin(5 * gx)  # not equivariant: keeps every PSNR finite
        return img.astype(np.float32)
    return toy


def _equivariance_pair(res=32):
    """(port's EQ-T, EQ-T_frac and EQ-R PSNRs on the toy synthesis, a
    function computing JAX's), the same numpy images on both sides."""
    toy = _toy_synthesis(res)
    kw = dict(z_dim=8, c_sampler=lambda n, r: np.zeros((n, 1), np.float32),
              img_resolution=res, num_samples=8, batch_size=4, compute_eqt_int=True,
              compute_eqt_frac=True, compute_eqr=True)
    mapping = lambda z, c: np.tanh(z)  # noqa: E731
    got = peq.compute_equivariance_metrics(lambda ws, M: torch.from_numpy(toy(ws, M)),
                                           mapping, **kw)

    def ref():
        return jeq.compute_equivariance_metrics(
            lambda ws, M: jnp.asarray(np.transpose(toy(ws, M), (0, 2, 3, 1))), mapping, **kw)
    return got, ref


def test_equivariance_metrics_on_a_toy_synthesis_match_jax():
    """The metric loop against JAX, 1e-5 relative. The toy's fixed-frame term
    keeps every PSNR under 50 dB: near 90 dB the squared errors would be the
    float32 rounding of the filters on each side."""
    got, ref = _equivariance_pair()
    want = ref()
    assert len(got) == 3 and all(np.isfinite(got)) and max(got) < 50, got
    np.testing.assert_allclose(got, want, rtol=1e-5)




class _StubG(torch.nn.Module):
    """Encodes its draws in the image: z, c and the vertex image's mean."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(()))
        self.calls = []

    def forward(self, z, c, mesh, evaluation=False, noise_mode="random", generator=None):
        self.calls.append((evaluation, noise_mode, generator.initial_seed()))
        code = torch.cat([z, c, mesh["uvcoords_image"].mean(dim=(1, 2))], dim=1)
        return {"image": code[:, None, None, :].expand(-1, 3, 1, -1) + self.w}


class _StubJaxG:
    def apply(self, v, z, c, mesh, noise_mode="random", evaluation=False, rngs=None):
        code = jnp.concatenate([z, c, mesh["uvcoords_image"].mean(axis=(1, 2))], axis=1)
        return {"image": jnp.broadcast_to(code[:, None, :, None], (*code.shape[:1], 1,
                                                                     code.shape[1], 3))}


def test_vert_conditioned_sampler_draws_as_jax():
    """For one RandomState, the port's sampler draws the same z and dataset
    indices as JAX's, takes one more draw for its generator seed as JAX does
    for its key (the second batch agrees too), and renders in evaluation
    mode with constant noise."""
    class DS:
        def __len__(self):
            return 11

        def __getitem__(self, i):
            r = np.random.RandomState(i)
            return {"c": r.randn(25).astype(np.float32),
                    "v": {"uvcoords_image": r.rand(4, 4, 3).astype(np.float32)}}

    G = _StubG()
    sp = pfid.make_vert_conditioned_sample_fn(G, z_dim=6, dataset=DS())
    sj = jfid.make_vert_conditioned_sample_fn(_StubJaxG(), {}, z_dim=6, dataset=DS())
    rp, rj = np.random.RandomState(5), np.random.RandomState(5)
    for batch in (3, 4):
        a, b = sp(batch, rp), sj(batch, rj)
        assert a.shape == (batch, 1, 6 + 25 + 3, 3) and a.dtype == np.float32
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6)
    assert all(ev and mode == "const" for ev, mode, _ in G.calls)
    assert rp.randint(1 << 30) == rj.randint(1 << 30)
