"""The port's contextual losses against the JAX package on the CPU, on the
same numpy-seeded feature maps:

  * `contextual_loss` with the cosine, L1 and L2 distances, clamped and
    unclamped: the loss and the distances to 1e-5 relative (float32 on
    both sides), the relative distances to 1e-4 of their largest magnitude
    (each is divided by its row's least distance, which scales up the
    distances' rounding: 1.1e-5 seen with L1);
  * `contextual_bilateral_loss`: 1e-5 relative;
  * `CXLoss` with its VGG19 slice (JAX-initialised weights through
    `jax_to_state_dict`) on a 64² pair, and on a 288² pair that it resizes
    to 256² first: 1e-4 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from invertavatar_torch.losses import contextual as pc
from invertavatar_torch.utils.weights import jax_to_state_dict
from tests.test_torch_unet_encoders import _assert_rel, _nchw

# one intra-op thread: the suite runs test files in parallel worker processes
torch.set_num_threads(1)


def _pair(seed, C=8, H=6, W=7, N=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(N, H, W, C).astype(np.float32),
            rng.randn(N, H, W, C).astype(np.float32))


def _close(got, ref, rel):
    got, ref = float(got), float(ref)
    assert np.isfinite(got) and abs(got - ref) <= rel * abs(ref), (got, ref)


@pytest.mark.parametrize("loss_type", ["cosine", "l1", "l2"])
@pytest.mark.parametrize("clamp", [True, False])
def test_contextual_loss_matches_jax(loss_type, clamp):
    from invertavatar_tpu.losses import contextual as jc

    x, y = _pair(0)
    xj, yj, xt, yt = jnp.asarray(x), jnp.asarray(y), _nchw(x), _nchw(y)
    dist = getattr(pc, f"compute_{loss_type}_distance")(xt, yt)
    dist_j = getattr(jc, f"compute_{loss_type}_distance")(xj, yj)
    _assert_rel(dist, dist_j, 1e-5)
    # over each row's least distance: its rounding grows by 1 / that least
    _assert_rel(pc.compute_relative_distance(dist, clamp),
                jc.compute_relative_distance(dist_j, clamp), 1e-4)
    _close(pc.contextual_loss(xt, yt, loss_type=loss_type, clamp_relative=clamp),
           jc.contextual_loss(xj, yj, loss_type=loss_type, clamp_relative=clamp), 1e-5)


@pytest.mark.parametrize("loss_type", ["cosine", "l2"])
def test_contextual_bilateral_loss_matches_jax(loss_type):
    from invertavatar_tpu.losses import contextual as jc

    x, y = _pair(1, C=4, H=8, W=8, N=1)
    _assert_rel(pc.compute_meshgrid((1, 4, 8, 8)),
                np.moveaxis(np.asarray(jc.compute_meshgrid((1, 8, 8, 4))), -1, 1), 1e-7)
    _close(pc.contextual_bilateral_loss(_nchw(x), _nchw(y), loss_type=loss_type),
           jc.contextual_bilateral_loss(jnp.asarray(x), jnp.asarray(y), loss_type=loss_type),
           1e-5)
    assert float(pc.contextual_bilateral_loss(_nchw(x), _nchw(x))) < \
        float(pc.contextual_bilateral_loss(_nchw(x), _nchw(y)))


@pytest.mark.parametrize("res", [64, 288])
def test_cxloss_with_its_vgg_slice_matches_jax(res):
    from invertavatar_tpu.losses.contextual import CXLoss

    rng = np.random.RandomState(2)
    x, y = (rng.rand(1, res, res, 3).astype(np.float32) for _ in range(2))
    cx_j = CXLoss()
    variables = cx_j.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y))
    ref = jax.jit(cx_j.apply)(variables, jnp.asarray(x), jnp.asarray(y))
    cx = pc.CXLoss(device="cpu")
    cx.load_state_dict(jax_to_state_dict(variables), strict=True)
    assert sorted(cx.state_dict())[:2] == ["vgg_model.slice1.0.bias",
                                           "vgg_model.slice1.0.weight"]
    with torch.no_grad():
        _close(cx(_nchw(x), _nchw(y)), ref, 1e-4)
