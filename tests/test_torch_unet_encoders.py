"""The port's ConvGRU U-Nets against the JAX package on the same weights.

JAX modules are initialised with flax, their BatchNorm statistics and 1-D
parameters randomised (`tests/test_torch_encoders.py::_randomize`), and the
weight bridge carries them into the port. The U-Nets run the tiny trunk
(`trunk_layers_n=8`) at 64² (`res=None`): the decoder's widths are the
flagship's whatever the input size.

Tolerances: float32 on both sides (JAX convolutions at HIGHEST), 1e-4 of each
output's largest entry; the bfloat16 eval dtype against JAX's bfloat16, 5% of
the largest entry (the bar of tests/test_loop_inversion.py's bf16 absorb
test: both round every layer to bf16, in other orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from invertavatar_torch.models.encoders import ConvGRU, TriPlanefeatEncoder, TriPlaneSFTfeatEncoder
from invertavatar_torch.utils.weights import jax_to_state_dict
from tests.test_torch_encoders import _randomize

# one intra-op thread: the suite runs test files in parallel worker processes
torch.set_num_threads(1)

OUT_CH = (32, 32, 16, 8)  # a tiny generator's texture taps
CB, CM = 1024, 64  # a tiny generator's channel scheme


def _nchw(x):
    """[..., H, W, C] numpy/JAX -> [..., C, H, W] torch."""
    x = np.array(x, np.float32)  # a writable copy (JAX arrays read as read-only)
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


def _assert_rel(got, ref, rel):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.isfinite(got).all()
    scale = np.abs(ref).max() + 1e-6
    err = np.abs(got - ref).max() / scale
    assert err < rel, err


@pytest.mark.parametrize("seq2seq", [False, True])
def test_conv_gru_matches_jax(seq2seq):
    """A time series [B, T, C, H, W] from a given state (and one frame from a
    zero state): outputs and the final state to 1e-5 of their scale."""
    from invertavatar_tpu.models.encoders.unet_encoders import ConvGRU as JaxGRU

    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 12, 12, 8).astype(np.float32)
    h = rng.randn(2, 12, 12, 8).astype(np.float32)
    jg = JaxGRU(8)
    variables = jg.init(jax.random.PRNGKey(0), jnp.asarray(x[:, 0]))
    out_j, h_j = jg.apply(variables, jnp.asarray(x), jnp.asarray(h), seq2seq)
    one_j, _ = jg.apply(variables, jnp.asarray(x[:, 0]))
    g = ConvGRU(8)
    g.load_state_dict(jax_to_state_dict(variables), strict=True)
    with torch.no_grad():
        out, h_t = g(_nchw(x), _nchw(h), seq2seq)
        one, _ = g(_nchw(x[:, 0]))
    _assert_rel(out, _nchw(out_j), 1e-5)
    _assert_rel(h_t, _nchw(h_j), 1e-5)
    _assert_rel(one, _nchw(one_j), 1e-5)


def _jax_unet(kind, use_gru, seed):
    from invertavatar_tpu.models.encoders import unet_encoders as ju

    if kind == "texture":
        m = ju.TriPlanefeatEncoder(inp_ch=7, res=None, use_gru=use_gru, out_channels=OUT_CH,
                                   trunk_layers_n=8)
        port = TriPlanefeatEncoder(7, res=None, use_gru=use_gru, out_channels=OUT_CH,
                                   trunk_layers_n=8)
    else:
        m = ju.TriPlaneSFTfeatEncoder(inp_ch=6, res=None, use_gru=use_gru, channel_base=CB,
                                      channel_max=CM, trunk_layers_n=8)
        port = TriPlaneSFTfeatEncoder(6, res=None, use_gru=use_gru, channel_base=CB,
                                      channel_max=CM, trunk_layers_n=8)
    ch = 7 if kind == "texture" else 6
    variables = m.init(jax.random.PRNGKey(seed), jnp.zeros((1, 2, 64, 64, ch)))
    variables = _randomize(variables, seed + 1)
    port.load_state_dict(jax_to_state_dict(variables), strict=True)
    return m, variables, port.eval()


def _flat(out):
    """Offsets list or {res: (scale, shift)} -> list of arrays."""
    if isinstance(out, dict):
        return [a for r in sorted(out) for a in out[r]]
    return list(out)


def _run_both(kind, use_gru, dtype, chunks=2, seed=0):
    """Both sides over `chunks` chunks of T=2 (the states carried), in
    float32 or bfloat16 (inputs and states cast, as `ar_forward` does);
    returns [(port outputs, JAX outputs, port states, JAX states)]."""
    m, variables, port = _jax_unet(kind, use_gru, seed)
    ch = 7 if kind == "texture" else 6
    rng = np.random.RandomState(seed + 7)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    apply = jax.jit(lambda v, x, r: m.apply(v, x, r))
    r_j = r_t = None
    res = []
    for _ in range(chunks):
        x = rng.randn(1, 2, 64, 64, ch).astype(np.float32)
        out_j, r_j = apply(variables, jnp.asarray(x).astype(jdt), r_j)
        with torch.no_grad():
            out_t, r_t = port(_nchw(x).to(dtype), r_t)
        res.append((_flat(out_t), [_nchw(np.asarray(a, np.float32)) for a in _flat(out_j)],
                    r_t, None if r_j is None else [_nchw(np.asarray(a, np.float32)) for a in r_j]))
    return res


@pytest.mark.parametrize("kind", ["texture", "sft"])
def test_gru_unets_carry_match_jax(kind):
    """Two chunks of T=2 (fresh states, then the carried ones): every offset
    or (scale, shift) map and every GRU state to 1e-4 of its scale."""
    for outs_t, outs_j, r_t, r_j in _run_both(kind, True, torch.float32):
        assert len(outs_t) == len(outs_j) and len(r_t) == 4
        for a, b in zip(outs_t, outs_j):
            _assert_rel(a, b, 1e-4)
        for a, b in zip(r_t, r_j):
            _assert_rel(a, b, 1e-4)


@pytest.mark.parametrize("kind", ["texture", "sft"])
def test_plain_unets_match_jax(kind):
    """`use_gru=False` (the `Up` decoder, no states), one chunk, 1e-4."""
    ((outs_t, outs_j, r_t, r_j),) = _run_both(kind, False, torch.float32, chunks=1, seed=3)
    assert r_t is None and r_j is None
    for a, b in zip(outs_t, outs_j):
        _assert_rel(a, b, 1e-4)


@pytest.mark.parametrize("kind", ["texture", "sft"])
def test_gru_unets_bf16_match_jax(kind):
    """The bfloat16 eval dtype: weights cast per op, BatchNorm in float32,
    bf16 states carried into a second chunk; outputs and states within 5%
    of their scale of JAX's bfloat16 run, and the states stay bf16."""
    for outs_t, outs_j, r_t, r_j in _run_both(kind, True, torch.bfloat16, seed=5):
        assert all(r.dtype == torch.bfloat16 for r in r_t)
        for a, b in zip(outs_t, outs_j):
            assert a.dtype == torch.bfloat16
            _assert_rel(a, b, 0.05)
        for a, b in zip(r_t, r_j):
            _assert_rel(a, b, 0.05)


def _assert_stored_bf16(module):
    """Conv and PReLU weights in bf16, BatchNorm parameters and statistics in
    float32."""
    from invertavatar_torch.models.encoders.irse import BatchNorm, Conv2d, PReLU

    for m in module.modules():
        if isinstance(m, (Conv2d, PReLU)):
            assert all(p.dtype == torch.bfloat16 for p in m.parameters())
        elif isinstance(m, BatchNorm):
            assert all(t.dtype == torch.float32 for t in (*m.parameters(), *m.buffers()))


@pytest.mark.parametrize("kind", ["texture", "sft"])
def test_stored_bf16_weights_match_cast_per_op(kind):
    """`store_weights_in(bfloat16)` rounds the conv and PReLU weights once
    and leaves BatchNorm in float32: over two chunks of T=2 the outputs and
    states equal, bit for bit, those of the float32 module casting per op."""
    import copy

    from invertavatar_torch.models.encoders.irse import store_weights_in

    torch.manual_seed(4)
    if kind == "texture":
        per_op = TriPlanefeatEncoder(7, res=None, use_gru=True, out_channels=OUT_CH,
                                     trunk_layers_n=8).eval()
    else:
        per_op = TriPlaneSFTfeatEncoder(6, res=None, use_gru=True, channel_base=CB,
                                        channel_max=CM, trunk_layers_n=8).eval()
    stored = store_weights_in(copy.deepcopy(per_op), torch.bfloat16)
    _assert_stored_bf16(stored)
    rng = np.random.RandomState(6)
    r_a = r_b = None
    for _ in range(2):
        x = torch.from_numpy(rng.randn(1, 2, 7 if kind == "texture" else 6, 64, 64)
                             .astype(np.float32)).to(torch.bfloat16)
        with torch.no_grad():
            out_a, r_a = per_op(x, r_a)
            out_b, r_b = stored(x, r_b)
        for a, b in zip(_flat(out_a) + list(r_a), _flat(out_b) + list(r_b)):
            assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b)


def test_inversion_net_stores_unet_weights_in_eval_dtype():
    """`InversionNet(unet_eval_dtype=bfloat16)` holds both U-Nets' conv and
    PReLU weights in bf16, their BatchNorms and everything else in float32."""
    from invertavatar_torch.models.encoders import InversionNet
    from tests.test_torch_fewshot import FS_GEN_CFG

    net = InversionNet(FS_GEN_CFG, encoding_texture=True, encoding_triplane=True,
                       texture_out_channels=OUT_CH, unet_eval_dtype=torch.bfloat16,
                       trunk_layers_n=8)
    _assert_stored_bf16(net.unet_encoder)
    assert all(t.dtype == torch.float32 for n, t in net.state_dict().items()
               if not n.startswith("unet_encoder.") and t.is_floating_point())
