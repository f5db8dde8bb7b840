"""The port's ADA pipe against the JAX package's on the CPU.

Deterministic parts are held against JAX: `_execute_geom` on fixed inverse
homographies (rotation, scaling, translation, flips), the colour transforms
(the 4×4 matrix at a fixed percentile, on 3-, 6- and 1-channel images), and
the whole pipe at a fixed `debug_percentile`, which replaces every draw but
the noise image. The random draws, which come from a `torch.Generator` and
not JAX's keys, are held to their statistics.

Tolerances: the geometric warp (a sym6 up/down-sampling around one bilinear
sample) and the whole pipe to 1e-4 of the images' largest entry; the colour
transforms to 1e-5; the draws' gating fraction within 4 binomial standard
deviations of p·strength.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from invertavatar_torch.train.augment import AugmentConfig, AugmentPipe
from tests.test_torch_unet_encoders import _assert_rel, _nchw

# one intra-op thread: the suite runs test files in parallel worker processes
torch.set_num_threads(1)

# the CLI's "bgc" pipe with cutout; the JAX pipe splits 32 keys, fewer than
# these and the image-space filter's 8 draws together, so that filter runs
# in a pipe of its own
BGC = dict(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1, xfrac=1, brightness=1,
           contrast=1, lumaflip=1, hue=1, saturation=1, cutout=1)
FILTER = dict(imgfilter=1, imgfilter_bands=(1.0, 0.5, 1.0, 0.0), cutout=1)
COLOR = dict(brightness=1, contrast=1, lumaflip=1, hue=1, saturation=1)


def _jax_pipe(**cfg):
    from invertavatar_tpu.train import augment as ja

    return ja.AugmentPipe(ja.AugmentConfig(**cfg))


def _images(seed, B=2, C=6, R=32):
    return np.random.RandomState(seed).uniform(-1, 1, (B, R, R, C)).astype(np.float32)


def test_execute_geom_matches_jax():
    """Rotation by 0.3 rad with a 1.2 scale and a (3.5, −2) px shift, and an
    x-flip with a 90° turn, on a [2, 6, 32, 32] pair."""
    x = _images(0)
    th = np.array([0.3, np.pi / 2], np.float32)
    c, s = np.cos(th), np.sin(th)
    G = np.zeros((2, 3, 3), np.float32)
    G[:, 0, 0], G[:, 0, 1], G[:, 1, 0], G[:, 1, 1], G[:, 2, 2] = c, -s, s, c, 1
    G[0, :2, :2] /= 1.2
    G[0, :2, 2] = (3.5, -2.0)
    G[1, 0, :2] *= -1
    ref = jax.jit(lambda x, G: _jax_pipe()._execute_geom(x, G))(jnp.asarray(x), jnp.asarray(G))
    got = AugmentPipe(AugmentConfig())._execute_geom(_nchw(x), torch.from_numpy(G))
    _assert_rel(got, _nchw(ref), 1e-4)
    assert not np.allclose(got.numpy(), _nchw(x).numpy(), atol=1e-2)


@pytest.mark.parametrize("C", [3, 6, 1])
def test_color_transforms_match_jax(C):
    """Brightness, contrast, luma flip, hue and saturation at percentile 0.8
    (every transform taken, p = 1)."""
    x = _images(1, C=C)
    ref = jax.jit(lambda x: _jax_pipe(**COLOR)(x, jnp.float32(1.0), jax.random.PRNGKey(0),
                                               debug_percentile=0.8))(jnp.asarray(x))
    got = AugmentPipe(AugmentConfig(**COLOR))(_nchw(x), 1.0, torch.Generator().manual_seed(0),
                                             debug_percentile=0.8)
    _assert_rel(got, _nchw(ref), 1e-5)
    assert not np.allclose(got.numpy(), _nchw(x).numpy(), atol=1e-2)


@pytest.mark.parametrize("cfg", [BGC, FILTER], ids=["bgc", "imgfilter"])
@pytest.mark.parametrize("percentile", [0.3, 0.8])
def test_pipe_at_fixed_percentile_matches_jax(cfg, percentile):
    """Every transform but the noise at a fixed percentile, on a [2, 6, 32,
    32] pair: the blits, warps and colour transforms with cutout, and the
    image-space filter with cutout."""
    x = _images(2)
    ref = jax.jit(lambda x: _jax_pipe(**cfg)(x, jnp.float32(1.0), jax.random.PRNGKey(1),
                                             debug_percentile=percentile))(jnp.asarray(x))
    got = AugmentPipe(AugmentConfig(**cfg))(_nchw(x), 1.0, torch.Generator().manual_seed(1),
                                           debug_percentile=percentile)
    _assert_rel(got, _nchw(ref), 1e-4)


def test_draws_follow_their_probabilities():
    """The gates take a transform with probability p·strength: brightness at
    p = 0.5 shifts ≈ half of 4,000 items, by offsets of std 0.2; p = 0 leaves
    every item as it was; the same generator seed gives the same images, and
    the noise's sigma is |N(0, 1)|·0.1."""
    x = torch.from_numpy(np.random.RandomState(3).uniform(-1, 1, (4000, 3, 2, 2))
                         .astype(np.float32))
    pipe = AugmentPipe(AugmentConfig(brightness=1))
    out = pipe(x, 0.5, torch.Generator().manual_seed(4))
    shift = (out - x).mean(dim=(1, 2, 3))
    taken = shift.abs() > 0
    n = x.shape[0]
    assert abs(taken.float().mean().item() - 0.5) < 4 * np.sqrt(0.25 / n)
    assert abs(shift[taken].std().item() - 0.2) < 0.02
    assert torch.equal(pipe(x, 0.0, torch.Generator().manual_seed(4)), x)
    assert torch.equal(pipe(x, 0.5, torch.Generator().manual_seed(4)), out)
    noisy = AugmentPipe(AugmentConfig(noise=1))(torch.zeros(4000, 1, 8, 8), 1.0,
                                                torch.Generator().manual_seed(5))
    sigma = noisy.std(dim=(1, 2, 3))
    assert abs(sigma.mean().item() - 0.1 * np.sqrt(2 / np.pi)) < 0.005
    flips = AugmentPipe(AugmentConfig(xflip=1))(x[:400, :, :, :].repeat(1, 1, 16, 16) * 0 +
                                                torch.linspace(-1, 1, 32).reshape(1, 1, 1, 32),
                                                0.5, torch.Generator().manual_seed(6))
    flipped = (flips[:, 0, 0, 0] > 0).float().mean().item()
    assert abs(flipped - 0.25) < 4 * np.sqrt(0.25 * 0.75 / 400)
