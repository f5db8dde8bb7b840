"""The port's discriminators against the JAX package on the same weights.

The dual discriminator follows `tests/test_sr_disc_parity.py`'s shapes (64²
image, 32² raw render, channel_base 4096, channel_max 128, B=4, a 25-dim
camera), with its 1-D parameters randomised, in float32 and with the top two
resolutions' blocks in bf16 (`num_fp16_res=2`), and once more with
`force_fp32`. The single and fading-raw discriminators at 32². The "skip"
and "orig" block architectures on the single-image discriminator at 32²,
and the video discriminators (`VideoDiscriminator`, at 32² and from 16²
frames; `FusionVideoDiscriminator` fused at 16²) on B=2 videos of T=2
frames, with `disc_c_noise` 0.

Tolerances: float32 on both sides, 1e-4 of the logits' largest magnitude;
bf16 blocks (both sides round each layer to bf16, in other orders), 3e-2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from invertavatar_torch.models import discriminator as pd
from invertavatar_torch.utils.weights import jax_to_state_dict
from tests.test_torch_encoders import _randomize
from tests.test_torch_unet_encoders import _assert_rel, _nchw

# one intra-op thread: the suite runs test files in parallel worker processes
torch.set_num_threads(1)


def _inputs(seed, res, raw_res, batch=4):
    rng = np.random.RandomState(seed)
    return (rng.randn(batch, res, res, 3).astype(np.float32),
            rng.randn(batch, raw_res, raw_res, 3).astype(np.float32),
            rng.randn(batch, 25).astype(np.float32))


def _port(cls, variables, **kw):
    d = cls(**kw)
    d.load_state_dict(jax_to_state_dict(variables), strict=True)
    return d


@pytest.mark.parametrize("num_fp16_res,force_fp32,tol", [(0, False, 1e-4), (2, False, 3e-2),
                                                          (2, True, 1e-4)])
def test_dual_discriminator_matches_jax(num_fp16_res, force_fp32, tol):
    from invertavatar_tpu.models.discriminator import DualDiscriminator

    kw = dict(c_dim=25, img_resolution=64, img_channels=6, channel_base=4096, channel_max=128,
              num_fp16_res=num_fp16_res)
    image, raw, c = _inputs(1, 64, 32)
    d_j = DualDiscriminator(**kw)
    img_j = {"image": jnp.asarray(image), "image_raw": jnp.asarray(raw)}
    variables = _randomize(d_j.init(jax.random.PRNGKey(0), img_j, jnp.asarray(c)), 2)
    ref = jax.jit(lambda v, i, c: d_j.apply(v, i, c, force_fp32=force_fp32))(
        variables, img_j, jnp.asarray(c))
    d = _port(pd.DualDiscriminator, variables, **kw)
    with torch.no_grad():
        got = d({"image": _nchw(image), "image_raw": _nchw(raw)}, torch.from_numpy(c),
                force_fp32=force_fp32)
    assert got.shape == (4, 1) and got.dtype == torch.float32
    _assert_rel(got, ref, tol)
    if num_fp16_res and not force_fp32:
        assert d.b64.use_fp16 and d.b32.use_fp16 and not d.b16.use_fp16


def test_single_and_dummy_discriminators_match_jax():
    from invertavatar_tpu.models.discriminator import DummyDualDiscriminator, SingleDiscriminator

    image, raw, c = _inputs(5, 32, 16, batch=2)
    kw = dict(c_dim=25, img_resolution=32, channel_base=1024, channel_max=64, num_fp16_res=0)
    img_j = {"image": jnp.asarray(image), "image_raw": jnp.asarray(raw)}
    img_t = {"image": _nchw(image), "image_raw": _nchw(raw)}
    s_j = SingleDiscriminator(img_channels=3, **kw)
    variables = _randomize(s_j.init(jax.random.PRNGKey(1), img_j, jnp.asarray(c)), 3)
    ref = jax.jit(s_j.apply)(variables, img_j, jnp.asarray(c))
    with torch.no_grad():
        got = _port(pd.SingleDiscriminator, variables, img_channels=3, **kw)(
            img_t, torch.from_numpy(c))
    _assert_rel(got, ref, 1e-4)
    dd_j = DummyDualDiscriminator(img_channels=6, **kw)
    variables = _randomize(dd_j.init(jax.random.PRNGKey(2), img_j, jnp.asarray(c)), 4)
    ref = jax.jit(lambda v, i, c: dd_j.apply(v, i, c, raw_fade=0.5))(variables, img_j,
                                                                     jnp.asarray(c))
    with torch.no_grad():
        got = _port(pd.DummyDualDiscriminator, variables, img_channels=6, **kw)(
            img_t, torch.from_numpy(c), raw_fade=0.5)
    _assert_rel(got, ref, 1e-4)


def test_filtered_resizing_matches_jax():
    from invertavatar_tpu.models.discriminator import filtered_resizing

    x = np.random.RandomState(6).randn(2, 32, 32, 3).astype(np.float32)
    for mode in ("antialiased", "none", 0.3):
        ref = filtered_resizing(jnp.asarray(x), 16, mode)
        _assert_rel(pd.filtered_resizing(_nchw(x), 16, mode), _nchw(ref), 1e-5)


@pytest.mark.parametrize("architecture,c_dim,num_fp16_res,tol", [
    ("skip", 25, 0, 1e-4), ("orig", 25, 0, 1e-4), ("skip", 0, 2, 3e-2), ("orig", 0, 2, 3e-2)])
def test_skip_and_orig_blocks_match_jax(architecture, c_dim, num_fp16_res, tol):
    """The "skip" blocks (each block and the epilogue read the FIR-downsampled
    image through their own `fromrgb`) and the "orig" ones (no residual
    branch), in float32 and with the top two resolutions in bf16."""
    from invertavatar_tpu.models.discriminator import Discriminator

    image, _, c = _inputs(7, 32, 16, batch=2)
    kw = dict(c_dim=c_dim, img_resolution=32, img_channels=3, architecture=architecture,
              channel_base=1024, channel_max=64, num_fp16_res=num_fp16_res)
    d_j = Discriminator(**kw)
    variables = _randomize(d_j.init(jax.random.PRNGKey(3), jnp.asarray(image),
                                    jnp.asarray(c)), 5)
    ref = jax.jit(d_j.apply)(variables, jnp.asarray(image), jnp.asarray(c))
    d = _port(pd.Discriminator, variables, **kw)
    assert hasattr(d.b16, "fromrgb") == (architecture == "skip")
    assert hasattr(d.b4, "fromrgb") == (architecture == "skip")
    assert not hasattr(d.b32, "skip")
    with torch.no_grad():
        got = d(_nchw(image), torch.from_numpy(c))
    _assert_rel(got, ref, tol)


def _video_inputs(seed, res, B=2, T=2):
    rng = np.random.RandomState(seed)
    frames = rng.randn(B * T, res, res, 3).astype(np.float32)
    Ts = np.sort(rng.randint(0, 30, (B, T)), axis=1).astype(np.float32)
    cams = rng.randn(B, T, 25).astype(np.float32)
    return frames, Ts, cams


def _video_state(variables):
    """The JAX `VideoDiscriminator` nests its pyramid under `core`; the
    port's, as the reference's, has `b{res}`, `mapping` and `b4` at the top."""
    return {k.removeprefix("core."): v for k, v in jax_to_state_dict(variables).items()}


@pytest.mark.parametrize("res", [32, 16])
def test_video_discriminator_matches_jax(res):
    """A frame pair beside its time gap at 32² (and from 16² frames, resized
    to 32²), with `disc_c_noise` 0."""
    from invertavatar_tpu.models.discriminator import VideoDiscriminator

    frames, Ts, cams = _video_inputs(8, res)
    kw = dict(c_dim=25, img_resolution=32, img_channels=3, channel_base=1024, channel_max=64,
              num_fp16_res=0)
    d_j = VideoDiscriminator(**kw)
    args = ({"image": jnp.asarray(frames)}, jnp.asarray(Ts), jnp.asarray(cams))
    variables = _randomize(d_j.init(jax.random.PRNGKey(4), *args), 6)
    ref = jax.jit(d_j.apply)(variables, *args)
    d = pd.VideoDiscriminator(**kw, device="cpu")
    d.load_state_dict(_video_state(variables), strict=True)
    with torch.no_grad():
        got = d({"image": _nchw(frames)}, torch.from_numpy(Ts), torch.from_numpy(cams))
    assert got.shape == (2, 1)
    _assert_rel(got, ref, 1e-4)


def test_fusion_video_discriminator_matches_jax():
    """Frames fused at 16² in a 32² pyramid, the gap embedding (learned and
    Fourier) in the camera mapping, `disc_c_noise` 0; the port's own Fourier
    coefficients equal JAX's."""
    from invertavatar_tpu.models.discriminator import (
        FusionVideoDiscriminator, TemporalDifferenceEncoder, construct_log_spaced_freqs)

    frames, Ts, cams = _video_inputs(9, 32)
    kw = dict(c_dim=25, img_resolution=32, img_channels=3, channel_base=1024, channel_max=64,
              num_fp16_res=0, concat_res=16)
    d_j = FusionVideoDiscriminator(**kw)
    args = ({"image": jnp.asarray(frames)}, jnp.asarray(Ts), jnp.asarray(cams))
    init = d_j.init(jax.random.PRNGKey(5), *args)
    d = pd.FusionVideoDiscriminator(**kw, device="cpu")
    np.testing.assert_array_equal(
        d.time_encoder.time_encoder.fourier_coefs.numpy(),
        np.asarray(init["buffers"]["time_encoder"]["time_encoder"]["fourier_coefs"]))
    np.testing.assert_array_equal(pd.construct_log_spaced_freqs(20, 1),
                                  construct_log_spaced_freqs(20, 1))
    assert d.time_encoder.get_dim() == TemporalDifferenceEncoder().dim
    variables = _randomize(init, 7)
    ref = jax.jit(d_j.apply)(variables, *args)
    d.load_state_dict(jax_to_state_dict(variables), strict=True)
    with torch.no_grad():
        got = d({"image": _nchw(frames)}, torch.from_numpy(Ts), torch.from_numpy(cams))
    assert got.shape == (2, 1)
    _assert_rel(got, ref, 1e-4)
