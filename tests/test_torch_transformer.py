"""The port's SegFormer blocks, cross-attention and one-shot SegFormer
decoders against the JAX package on the same weights.

JAX modules are initialised with flax, their BatchNorm statistics and 1-D
parameters randomised (`tests/test_torch_encoders.py::_randomize`), and the
weight bridge carries them into the port. The blocks follow the shapes of
`tests/test_transformer_parity.py`; the decoders, whose widths and IR-SE-50
trunks are fixed, run at a 32² input (`res=None`).

Tolerances (float32 on both sides, JAX at HIGHEST precision): the blocks
and the cross-attention to 1e-5 of each output's largest entry; the
decoders, ~70 convolution, attention and norm layers deep, to 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from invertavatar_torch.models.encoders import attention as pa
from invertavatar_torch.models.encoders import transformer as pt
from invertavatar_torch.utils.weights import jax_to_state_dict
from tests.test_torch_encoders import _randomize
from tests.test_torch_unet_encoders import _assert_rel, _nchw

# one intra-op thread: the suite runs test files in parallel worker processes
torch.set_num_threads(1)


def _port(module, variables):
    module.load_state_dict(jax_to_state_dict(variables), strict=True)
    return module.eval()


@pytest.mark.parametrize("sr_ratio,qkv_bias", [(1, False), (2, True)])
def test_vit_block_matches_jax(sr_ratio, qkv_bias):
    """A pre-norm block on [2, 64, 64] tokens of an 8×8 grid, with and
    without spatial reduction."""
    from invertavatar_tpu.models.encoders import transformer as jt

    x = np.random.RandomState(0).randn(2, 64, 64).astype(np.float32)
    m = jt.Block(64, num_heads=4, mlp_ratio=2, qkv_bias=qkv_bias, sr_ratio=sr_ratio)
    variables = _randomize(m.init(jax.random.PRNGKey(0), jnp.asarray(x), 8, 8), 1)
    ref = jax.jit(lambda v, x: m.apply(v, x, 8, 8))(variables, jnp.asarray(x))
    blk = _port(pt.Block(64, 4, mlp_ratio=2, qkv_bias=qkv_bias, sr_ratio=sr_ratio), variables)
    with torch.no_grad():
        got = blk(torch.from_numpy(x), 8, 8)
    _assert_rel(got, ref, 1e-5)


def test_transformer_block_and_uplayer_match_jax():
    """`TransformerBlock` (patch embedding, 2 ViT blocks, pixel shuffle, 1×1
    conv) and an `UpLayer` with one ViT block, on 8×8 maps."""
    from invertavatar_tpu.models.encoders import transformer as jt

    rng = np.random.RandomState(1)
    f = rng.randn(2, 8, 8, 32).astype(np.float32)
    m = jt.TransformerBlock(32, embed_dim=64, num_vit=2)
    variables = _randomize(m.init(jax.random.PRNGKey(1), jnp.asarray(f)), 2)
    ref = jax.jit(m.apply)(variables, jnp.asarray(f))
    with torch.no_grad():
        got = _port(pt.TransformerBlock(32, embed_dim=64, num_vit=2), variables)(_nchw(f))
    _assert_rel(got, _nchw(ref), 1e-5)

    x1 = rng.randn(1, 4, 4, 64).astype(np.float32)
    x2 = rng.randn(1, 8, 8, 32).astype(np.float32)
    m = jt.UpLayer(48, 24, upscale=2, num_vit=1)
    variables = _randomize(m.init(jax.random.PRNGKey(2), jnp.asarray(x1), jnp.asarray(x2)), 3)
    ref = jax.jit(m.apply)(variables, jnp.asarray(x1), jnp.asarray(x2))
    with torch.no_grad():
        got = _port(pt.UpLayer(48, 24, upscale=2, num_vit=1), variables)(_nchw(x1), _nchw(x2))
    _assert_rel(got, _nchw(ref), 1e-5)


@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_cross_attention_matches_jax(activation):
    """Cross-attention of 5 queries over 7 memory tokens, d_model 32, 4 heads."""
    from invertavatar_tpu.models.encoders.attention import CrossAttention

    rng = np.random.RandomState(2)
    tgt = rng.randn(2, 5, 32).astype(np.float32)
    mem = rng.randn(2, 7, 32).astype(np.float32)
    m = CrossAttention(32, 4, dim_feedforward=64, activation=activation)
    variables = _randomize(m.init(jax.random.PRNGKey(3), jnp.asarray(tgt), jnp.asarray(mem)), 4)
    ref = jax.jit(m.apply)(variables, jnp.asarray(tgt), jnp.asarray(mem))
    port = _port(pa.CrossAttention(32, 4, dim_feedforward=64, activation=activation), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(tgt), torch.from_numpy(mem))
    _assert_rel(got, ref, 1e-5)


def _flat(out):
    if isinstance(out, dict):
        return [a for r in sorted(out) for a in out[r]]
    return list(out)


@pytest.mark.parametrize("kind", ["texture", "sft"])
def test_segformer_decoders_match_jax(kind):
    """Both one-shot decoders (IR-SE-50 trunk, 14 or 13 ViT blocks) on a
    [1, C, 32, 32] input with a tiny generator's output widths."""
    from invertavatar_tpu.models.encoders import transformer as jt

    if kind == "texture":
        m = jt.TriPlanefeatSegformerDecoder(inp_ch=7, res=None, out_channels=(32, 32, 16, 8))
        port = pt.TriPlanefeatSegformerDecoder(7, res=None, out_channels=(32, 32, 16, 8))
    else:
        m = jt.TriPlaneSFTfeatSegformerDecoder(inp_ch=6, res=None, channel_base=1024,
                                               channel_max=64)
        port = pt.TriPlaneSFTfeatSegformerDecoder(6, res=None, channel_base=1024, channel_max=64)
    ch = 7 if kind == "texture" else 6
    x = np.random.RandomState(5).randn(1, 32, 32, ch).astype(np.float32)
    variables = _randomize(m.init(jax.random.PRNGKey(5), jnp.zeros((1, 32, 32, ch))), 6)
    ref = _flat(jax.jit(m.apply)(variables, jnp.asarray(x)))
    _port(port, variables)
    del variables
    with torch.no_grad():
        got = _flat(port(_nchw(x)))
    assert len(got) == len(ref) == (4 if kind == "texture" else 10)
    for a, b in zip(got, ref):
        _assert_rel(a, _nchw(b), 1e-4)
