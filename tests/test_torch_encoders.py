"""The port's inversion encoders against the JAX package on the same weights.

JAX modules are initialised with flax, their BatchNorm running statistics,
BatchNorm/PReLU parameters and `latent_avg` are replaced by seeded random
values (so that `batch_stats` and the buffers matter), and the weight bridge
carries everything into the port. Both sides run float32 on the CPU (JAX
convolutions at HIGHEST precision, TF32 does not exist here).
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from invertavatar_torch.models.encoders import (
    E4E,
    Encoder4Editing,
    InversionNet,
    IRSETrunk,
    LatentCodesDiscriminator,
)
from invertavatar_torch.models.encoders.e4e import upsample_add
from invertavatar_torch.utils.weights import jax_to_state_dict

# one intra-op thread: the suite runs test files in parallel worker processes
torch.set_num_threads(1)

TAPS = (2, 6, 20, 23)


def _randomize(variables, seed):
    """numpy copy of a flax variable tree with random BN statistics, 1-D
    parameters (BN scale/shift, PReLU slopes) and buffers."""
    rng = np.random.RandomState(seed)

    def walk(tree, coll):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(v, coll)
                continue
            a = np.asarray(v, np.float32)
            if k == "running_var":
                a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            elif k == "running_mean" or coll == "buffers":
                a = (rng.randn(*a.shape) * 0.1).astype(np.float32)
            elif a.ndim == 1:
                a = (a + rng.randn(*a.shape) * 0.1).astype(np.float32)
            out[k] = a
        return out

    return {coll: walk(tree, coll) for coll, tree in variables.items()}


def _image(seed, res, batch=1):
    return np.random.RandomState(seed).randn(batch, res, res, 3).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(x), (0, 3, 1, 2))))


class _JaxTrunk(fnn.Module):
    """The JAX `trunk_layers` (input layer + body, tap remap for the tiny
    layout) as a module of its own."""

    num_layers: int

    @fnn.compact
    def __call__(self, x):
        from invertavatar_tpu.models.encoders.e4e import trunk_layers

        return trunk_layers(3, TAPS, x, False, num_layers=self.num_layers)


@pytest.mark.parametrize("num_layers,res", [(8, 64), (50, 32)])
def test_irse_trunk_matches_jax(num_layers, res):
    x = _image(0, res)
    jm = _JaxTrunk(num_layers)
    variables = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    final_j, feats_j = jax.jit(jm.apply)(variables, jnp.asarray(x))

    port = IRSETrunk(3, num_layers, TAPS)
    port.load_state_dict(jax_to_state_dict(variables), strict=True)
    with torch.no_grad():
        final, feats = port(_nchw(x))
    np.testing.assert_allclose(final.numpy(), _nchw(final_j).numpy(), rtol=1e-4, atol=1e-4)
    for t in TAPS:
        np.testing.assert_allclose(feats[t].numpy(), _nchw(feats_j[t]).numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_upsample_add_matches_jax():
    """The JAX upsample (not torch's align_corners=True, see e4e.py) at the
    encoder's 16→32 and 32→64 steps."""
    from invertavatar_tpu.models.encoders.e4e import upsample_add as jax_upsample_add

    rng = np.random.RandomState(2)
    for h, H in ((16, 32), (32, 64)):
        x = rng.randn(2, h, h, 5).astype(np.float32)
        y = rng.randn(2, H, H, 5).astype(np.float32)
        ref = jax.jit(jax_upsample_add)(jnp.asarray(x), jnp.asarray(y))
        out = upsample_add(_nchw(x), _nchw(y))
        np.testing.assert_allclose(out.numpy(), _nchw(ref).numpy(), atol=2e-5)


def test_encoder4editing_tiny_matches_jax():
    from invertavatar_tpu.models.encoders.e4e import Encoder4Editing as JaxE4E

    x = _image(3, 256)
    jm = JaxE4E(trunk_layers_n=8)
    variables = _randomize(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)), 4)
    ref = jax.jit(jm.apply)(variables, jnp.asarray(x))

    port = Encoder4Editing(trunk_layers_n=8)
    port.load_state_dict(jax_to_state_dict(variables), strict=True)
    with torch.no_grad():
        ws = port(_nchw(x))
    assert tuple(ws.shape) == (1, 14, 512)
    np.testing.assert_allclose(ws.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    # a module-level train() leaves the BatchNorms on their running statistics
    port.train()
    with torch.no_grad():
        assert torch.equal(port(_nchw(x)), ws)


def test_e4e_wrapper_matches_jax():
    """`E4E` with the full IR-SE-50 trunk on a 512² image (2×2 mean pool,
    encoder, + latent_avg)."""
    from invertavatar_tpu.models.encoders.e4e import E4E as JaxE4E

    x = _image(9, 512)
    jm = JaxE4E()
    variables = _randomize(jm.init(jax.random.PRNGKey(4), jnp.asarray(x)), 10)
    ref = jax.jit(jm.apply)(variables, jnp.asarray(x))
    port = E4E()
    port.load_state_dict(jax_to_state_dict(variables), strict=True)
    with torch.no_grad():
        ws = port(_nchw(x))
    np.testing.assert_allclose(ws.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_inversion_net_encode_matches_jax():
    """`InversionNet.encode` on a 512² image: 2×2 mean pool to 256², the tiny
    encoder, + latent_avg; the bridge carries `batch_stats` and the buffers."""
    from invertavatar_tpu.models.encoders.uvnet import InversionNet as JaxNet
    from tests.test_torch_inversion import TINY_GEN_CFG

    x = _image(5, 512)
    jm = JaxNet(generator_cfg=TINY_GEN_CFG, trunk_layers_n=8)
    variables = jm.init(jax.random.PRNGKey(2), jnp.asarray(x), method=lambda m, x: m.encode(x))
    variables = _randomize(variables, 6)
    assert set(variables) == {"params", "buffers", "batch_stats"}
    ref = jax.jit(lambda v, x: jm.apply(v, x, method=lambda m, x: m.encode(x)))(
        variables, jnp.asarray(x))

    port = InversionNet(TINY_GEN_CFG, trunk_layers_n=8)
    missing, unexpected = port.load_state_dict(jax_to_state_dict(variables), strict=False)
    assert unexpected == []
    assert all(k.startswith("generator.") or k == "black_uv_bg" for k in missing), missing
    with torch.no_grad():
        ws = port.encode(_nchw(x))
    np.testing.assert_allclose(ws.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_latent_discriminator_matches_jax():
    from invertavatar_tpu.models.encoders.e4e import LatentCodesDiscriminator as JaxWD

    w = np.random.RandomState(7).randn(6, 512).astype(np.float32)
    jm = JaxWD()
    variables = _randomize(jm.init(jax.random.PRNGKey(3), jnp.asarray(w)), 8)
    ref = jax.jit(jm.apply)(variables, jnp.asarray(w))
    port = LatentCodesDiscriminator()
    port.load_state_dict(jax_to_state_dict(variables), strict=True)
    with torch.no_grad():
        out = port(torch.from_numpy(w))
    assert tuple(out.shape) == (6, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
