"""The port's MoCo loss and DeepLab models against the JAX package on the
CPU, on JAX-initialised weights with randomised BatchNorm statistics and
1-D parameters, carried over by `jax_to_state_dict`:

  * `Bottleneck` (strided with a projected identity, and dilated) and
    `ResNet50Trunk` at 64²: 1e-4 of the output's largest magnitude;
  * `MocoLoss` on three 64² images (resized to 224²): loss and similarity
    gain to 1e-5 absolute (cosines of float32 features), and each image's
    normalised features to 1e-4 of their largest magnitude;
  * `AtrousSeparableConvolution` (the depthwise `(3, 3, 1, C)` kernel
    through the converter): 1e-5 relative;
  * DeepLabV3 and V3+ on ResNet-50 at 64², output stride 8: the logits and
    the projected low-level feature to 1e-4 of their largest magnitude;
    V3+ once more with `train=True` (batch statistics): the low-level
    feature and the updated running statistics to 1e-4, the logits to 1e-3
    (the image-pooling branch normalises 2 pooled values a channel: see the
    test); `Bottleneck` with `train=True` to 1e-4, with its running
    statistics;
  * the entry points build on CUDA unless `device="cpu"`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from invertavatar_torch.losses import moco as pm
from invertavatar_torch.models import segmentation as pseg
from invertavatar_torch.utils.weights import jax_to_state_dict
from tests.test_torch_encoders import _randomize
from tests.test_torch_unet_encoders import _assert_rel, _nchw

# one intra-op thread: the suite runs test files in parallel worker processes
torch.set_num_threads(1)


def _images(seed, n, res, batch=1):
    rng = np.random.RandomState(seed)
    return [rng.rand(batch, res, res, 3).astype(np.float32) for _ in range(n)]


def _load(module, variables):
    module.load_state_dict(jax_to_state_dict(variables), strict=True)
    return module.eval()


@pytest.mark.parametrize("stride,has_downsample,dilation,train", [
    (2, True, 1, False), (1, False, 2, False), (2, True, 1, True)])
def test_bottleneck_matches_jax(stride, has_downsample, dilation, train):
    from invertavatar_tpu.losses.moco import Bottleneck

    in_ch = 16 if has_downsample else 32
    x = np.random.RandomState(3).randn(2, 12, 12, in_ch).astype(np.float32)
    b_j = Bottleneck(in_ch, 8, stride=stride, has_downsample=has_downsample, dilation=dilation)
    variables = _randomize(b_j.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    ref, new = b_j.apply(variables, jnp.asarray(x), train=train, mutable=["batch_stats"])
    b = _load(pm.Bottleneck(in_ch, 8, stride=stride, has_downsample=has_downsample,
                            dilation=dilation), variables)
    with torch.no_grad():
        _assert_rel(b(_nchw(x), train=train), _nchw(ref), 1e-4)
    mine = b.state_dict()
    for k, v in jax_to_state_dict({"batch_stats": new["batch_stats"]}).items():
        np.testing.assert_allclose(mine[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


def test_resnet50_trunk_and_moco_loss_match_jax():
    from invertavatar_tpu.losses.moco import MocoLoss, ResNet50Trunk

    (x,) = _images(4, 1, 64, batch=2)
    t_j = ResNet50Trunk()
    variables = _randomize(t_j.init(jax.random.PRNGKey(1), jnp.asarray(x)), 2)
    ref = jax.jit(t_j.apply)(variables, jnp.asarray(x))
    trunk = _load(pm.ResNet50Trunk(), variables)
    with torch.no_grad():
        got = trunk(_nchw(x))
    assert got.shape == (2, 2048)
    _assert_rel(got, ref, 1e-4)

    imgs = _images(5, 3, 64)
    m_j = MocoLoss()
    variables = _randomize(m_j.init(jax.random.PRNGKey(2), *map(jnp.asarray, imgs)), 3)
    loss_j, sim_j = jax.jit(m_j.apply)(variables, *map(jnp.asarray, imgs))
    loss = _load(pm.MocoLoss(device="cpu"), variables)
    with torch.no_grad():
        got_loss, got_sim = loss(*map(_nchw, imgs))
    assert abs(float(got_loss) - float(loss_j)) < 1e-5, (float(got_loss), float(loss_j))
    assert abs(float(got_sim) - float(sim_j)) < 1e-5, (float(got_sim), float(sim_j))
    # a random trunk embeds every image nearly alike (1 - cos ~1e-7), so
    # the normalised features themselves are held against JAX's too
    feats_j = jax.jit(lambda v, x_: m_j.apply(v, x_, method=lambda m, y: m.extract_feats(y)))
    for img in imgs:
        with torch.no_grad():
            _assert_rel(loss.extract_feats(_nchw(img)), feats_j(variables, jnp.asarray(img)),
                        1e-4)


def test_atrous_separable_convolution_matches_jax():
    from invertavatar_tpu.models.segmentation import AtrousSeparableConvolution

    x = np.random.RandomState(6).randn(2, 10, 10, 8).astype(np.float32)
    kw = dict(in_ch=8, out_ch=5, kernel=3, padding=2, dilation=2)
    a_j = AtrousSeparableConvolution(**kw)
    variables = _randomize(a_j.init(jax.random.PRNGKey(3), jnp.asarray(x)), 4)
    assert variables["params"]["body"]["0"]["weight"].shape == (3, 3, 1, 8)
    ref = a_j.apply(variables, jnp.asarray(x))
    a = _load(pseg.AtrousSeparableConvolution(8, 5, 3, padding=2, dilation=2), variables)
    assert a.body[0].weight.shape == (8, 1, 3, 3)
    with torch.no_grad():
        _assert_rel(a(_nchw(x)), _nchw(ref), 1e-5)


@pytest.mark.parametrize("name,train", [("deeplabv3_resnet50", False),
                                        ("deeplabv3plus_resnet50", False),
                                        ("deeplabv3plus_resnet50", True)])
def test_deeplab_resnet50_matches_jax(name, train):
    from invertavatar_tpu.models import segmentation as jseg

    (x,) = _images(7, 1, 64, batch=2)
    m_j = getattr(jseg, name)(num_classes=7, output_stride=8)
    variables = _randomize(m_j.init(jax.random.PRNGKey(4), jnp.asarray(x)), 5)
    if train:
        ref, new = jax.jit(lambda v, x_: m_j.apply(v, x_, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(x))
    else:
        ref = jax.jit(m_j.apply)(variables, jnp.asarray(x))
    m = _load(getattr(pseg, name)(num_classes=7, output_stride=8, device="cpu"), variables)
    with torch.no_grad():
        got = m(_nchw(x), train=train)
    assert got["out"].shape == (2, 7, 64, 64)
    # with batch statistics the ASPP's image-pooling branch normalises 2
    # pooled values a channel, which a random trunk pools nearly alike: a
    # difference of near-equal numbers, where float32 rounding on either
    # side moves the logits by ~2e-4 of their largest magnitude
    _assert_rel(got["out"], _nchw(ref["out"]), 1e-3 if train else 1e-4)
    _assert_rel(got["low_level"], _nchw(ref["low_level"]), 1e-4)
    if train:
        state = jax_to_state_dict({"batch_stats": new["batch_stats"]})
        mine = m.state_dict()
        for k, v in state.items():
            np.testing.assert_allclose(mine[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)


def test_entry_points_build_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from invertavatar_torch.losses.contextual import CXLoss
    from invertavatar_torch.models.discriminator import (FusionVideoDiscriminator,
                                                          VideoDiscriminator)

    for build in (pm.MocoLoss, CXLoss, lambda: pseg.deeplabv3_resnet50(num_classes=3),
                  lambda: pseg.deeplabv3plus_resnet50(num_classes=3),
                  lambda: VideoDiscriminator(c_dim=25, img_resolution=32, img_channels=3),
                  lambda: FusionVideoDiscriminator(c_dim=25, img_resolution=32,
                                                   img_channels=3)):
        with pytest.raises(RuntimeError):
            build()
