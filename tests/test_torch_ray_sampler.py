"""The port's camera rays (`invertavatar_torch/render/ray_sampler.py`)
against the JAX package's on the same cameras: batches of 1, 4 and 10 at two
resolutions, with random intrinsics that carry a skew term, at the
tolerance of `tests/test_render_parity.py::test_ray_sampler_parity`; and a
singular K, for which neither package raises and both give non-finite rays
in the same places."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from invertavatar_torch.render.ray_sampler import sample_rays
from invertavatar_tpu.render.ray_sampler import sample_rays as sample_rays_jax

ATOL = 1e-5


def _cameras(B, seed):
    """[B, 4, 4] cam2world (a random rotation, a camera ~2.7 from the
    origin) and [B, 3, 3] normalized intrinsics with skew."""
    rng = np.random.RandomState(seed)
    q, r = np.linalg.qr(rng.randn(B, 3, 3))
    rot = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    c2w = np.tile(np.eye(4), (B, 1, 1))
    c2w[:, :3, :3] = rot
    c2w[:, :3, 3] = rng.randn(B, 3) * 0.3 + np.array([0.0, 0.0, 2.7])
    K = np.tile(np.eye(3), (B, 1, 1))
    K[:, 0, 0] = rng.uniform(3.0, 5.0, B)  # focal lengths, in units of the image size
    K[:, 1, 1] = rng.uniform(3.0, 5.0, B)
    K[:, 0, 1] = rng.uniform(-0.3, 0.3, B)  # skew
    K[:, :2, 2] = rng.uniform(0.4, 0.6, (B, 2))  # principal point
    return c2w.astype(np.float32), K.astype(np.float32)


def _both(c2w, K, res):
    ro, rd = sample_rays(torch.from_numpy(c2w), torch.from_numpy(K), res)
    ro_j, rd_j = sample_rays_jax(jnp.asarray(c2w), jnp.asarray(K), res)
    return ro.numpy(), rd.numpy(), np.asarray(ro_j), np.asarray(rd_j)


@pytest.mark.parametrize("res", [8, 64])
@pytest.mark.parametrize("B", [1, 4, 10])
def test_sample_rays_matches_jax(B, res):
    c2w, K = _cameras(B, seed=B * 100 + res)
    ro, rd, ro_j, rd_j = _both(c2w, K, res)
    assert ro.shape == rd.shape == (B, res * res, 3)
    np.testing.assert_allclose(ro, ro_j, atol=ATOL)
    np.testing.assert_allclose(rd, rd_j, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(rd, axis=-1), 1.0, atol=ATOL)


def test_sample_rays_singular_intrinsics_give_non_finite_rays_as_in_jax():
    """Item 1's K has no first column (zero focal length and skew): no
    error is raised, its rays are non-finite where JAX's are, and item 0's
    rays are untouched by it."""
    c2w, K = _cameras(2, seed=5)
    K[1, :, 0] = 0.0
    ro, rd, ro_j, rd_j = _both(c2w, K, 8)
    finite = np.isfinite(rd)
    np.testing.assert_array_equal(finite, np.isfinite(rd_j))
    assert finite[0].all() and not finite[1].all()
    np.testing.assert_allclose(rd[finite], rd_j[finite], atol=ATOL)
    np.testing.assert_allclose(ro, ro_j, atol=ATOL)
