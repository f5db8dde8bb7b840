"""The port's style-U-Net family (`invertavatar_torch/models/encoders/styleunet.py`)
against the JAX package on the same weights and inputs.

JAX modules are initialised with flax from fixed keys, their 1-D parameters
(the biases, zero at init) randomised (`tests/test_torch_encoders.py::_randomize`),
and `jax_to_state_dict` carries them into the port with a strict
`load_state_dict`. Tiny widths throughout (channel_base 512, channel_max 64,
img_resolution 64, in_size 16 or 32, final_size 4). Tolerance: 1e-4 absolute
(float32 on both sides; the outputs are O(1)-O(10)); where a tolerance is
relative to an output's largest entry the case says so and why.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from invertavatar_tpu.models.encoders import styleunet as ju
from invertavatar_torch.models.encoders import styleunet as tu
from invertavatar_torch.utils.weights import jax_to_state_dict
from tests.test_torch_encoders import _randomize

# one intra-op thread: the suite runs test files in parallel worker processes
torch.set_num_threads(1)

ATOL = 1e-4
TINY = dict(img_resolution=64, img_channels=8, cond_channels=3, in_size=16, final_size=4,
            channel_base=512, channel_max=64, num_cond_res=16)


def _nchw(x):
    """[..., H, W, C] numpy/JAX -> [..., C, H, W] torch."""
    x = np.array(x, np.float32)
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


def _close(got, ref, atol=ATOL):
    ref = _nchw(ref)
    assert tuple(got.shape) == tuple(ref.shape), (tuple(got.shape), tuple(ref.shape))
    assert torch.isfinite(got).all()
    err = (got.detach().float() - ref).abs().max().item()
    assert err < atol, err


def _pair(jax_module, port_module, *init_args, seed=0, **init_kw):
    """JAX variables from `init` at a fixed key, 1-D parameters randomised,
    and the port module with them loaded strictly."""
    variables = _randomize(jax_module.init(jax.random.PRNGKey(seed), *init_args, **init_kw),
                           seed)
    port_module.load_state_dict(jax_to_state_dict(variables), strict=True)
    return variables, port_module.eval()


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("downsample,skip", [(True, True), (True, False), (False, True),
                                             (False, False)])
def test_encoder_res_block(downsample, skip):
    res = 32 if downsample else 16
    x = _rand(0, 2, res, res, 3)
    s = _rand(1, 2, 16, 16, 16) if skip else None
    jm = ju.EncoderResBlock(3, 16, 32, downsample=downsample)
    variables, pm = _pair(jm, tu.EncoderResBlock(3, 16, 32, downsample=downsample),
                          jnp.asarray(x), None if s is None else jnp.asarray(s))
    inp_j, out_j = jm.apply(variables, jnp.asarray(x), None if s is None else jnp.asarray(s))
    with torch.no_grad():
        inp, out = pm(_nchw(x), None if s is None else _nchw(s))
    _close(inp, inp_j)
    _close(out, out_j)


@pytest.mark.parametrize("case", ["clip_with_h", "clip_without_h", "one_frame"])
def test_style_conv_gru(case):
    """T=3 steps from a given state or zeros (the final state), and one
    4-D step."""
    x = _rand(0, 2, 3, 8, 8, 6) if case != "one_frame" else _rand(0, 2, 8, 8, 6)
    h = _rand(1, 2, 8, 8, 6) if case == "clip_with_h" else None
    jm = ju.StyleConvGRU(6)
    variables, pm = _pair(jm, tu.StyleConvGRU(6), jnp.asarray(x))
    out_j, h_j = jm.apply(variables, jnp.asarray(x), None if h is None else jnp.asarray(h))
    with torch.no_grad():
        out, h_t = pm(_nchw(x), None if h is None else _nchw(h))
    _close(out, out_j)
    _close(h_t, h_j)


def _close_list(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("variant", ["plain", "residual_same_size", "residual_other_size"])
@pytest.mark.parametrize("return_list", [False, True])
def test_cond_synthesis_network(variant, return_list):
    """The plain style-U-Net; `residual_arch` with the condition at the
    output size (64², no resize) and at 32² (antialiased up to 64²)."""
    kw = dict(TINY, img_channels=3)
    if variant != "plain":
        kw.update(residual_arch=True, in_size=64 if variant == "residual_same_size" else 32,
                  num_cond_res=32)
    x = _rand(2, 2, kw["in_size"], kw["in_size"], 3)
    jm = ju.CondSynthesisNetwork(**kw)
    variables, pm = _pair(jm, tu.CondSynthesisNetwork(device="cpu", **kw), jnp.asarray(x))
    ref = jm.apply(variables, jnp.asarray(x), return_list=return_list)
    with torch.no_grad():
        got = pm(_nchw(x), return_list=return_list)
    if return_list:
        _close_list(got, ref)
    else:
        _close(got, ref)


@pytest.mark.parametrize("return_list", [False, True])
def test_cond_synthesis_network_new(return_list):
    kw = dict(TINY, cond_channels=5, in_size=64, num_cond_res=64)
    x = _rand(3, 2, 64, 64, 5)
    jm = ju.CondSynthesisNetworkNew(**kw)
    variables, pm = _pair(jm, tu.CondSynthesisNetworkNew(device="cpu", **kw), jnp.asarray(x))
    ref = jm.apply(variables, jnp.asarray(x), return_list=return_list)
    with torch.no_grad():
        got = pm(_nchw(x), return_list=return_list)
    if return_list:
        _close_list(got, ref)
    else:
        _close(got, ref)


@pytest.mark.parametrize("final_size", [4, 32])
@pytest.mark.parametrize("return_list", [False, True])
def test_plain_synthesis_network(final_size, return_list):
    """Seeded at 4² and at 32² (the branch that taps the seed features)."""
    kw = dict(img_resolution=64, img_channels=4, final_size=final_size, channel_base=512,
              channel_max=64)
    ch = min(512 // final_size, 64)
    x = _rand(6, 1, final_size, final_size, ch)
    img = _rand(7, 1, final_size, final_size, 4)
    jm = ju.PlainSynthesisNetwork(**kw)
    variables, pm = _pair(jm, tu.PlainSynthesisNetwork(device="cpu", **kw), jnp.asarray(x),
                          jnp.asarray(img))
    ref = jm.apply(variables, jnp.asarray(x), jnp.asarray(img), return_list=return_list)
    with torch.no_grad():
        got = pm(_nchw(x), _nchw(img), return_list=return_list)
    if return_list:
        _close_list(got, ref)
    else:
        _close(got, ref)


# the block options no network above takes: DecoderBlockNew's GRU and the
# SFT block's ToRGB skip / GRU-free path (B=2, T=2, from 8² to 16²)
BLOCKS = {
    "new_skip": ("DecoderBlockNew", dict(cond_channel=8, architecture="skip")),
    "new_gru": ("DecoderBlockNew", dict(cond_channel=8, architecture="orig", use_gru=True)),
    "sft_skip": ("DecoderBlockSFT", dict(architecture="skip", out_sft=True)),
    "sft_gru": ("DecoderBlockSFT", dict(architecture="orig", use_gru=True)),
}


@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_decoder_block_options(case):
    name, kw = BLOCKS[case]
    gru = kw.get("use_gru", False)
    x = _rand(9, 4, 8, 8, 12)
    img = _rand(10, 2 if gru else 4, 8, 8, 3)
    cond = _rand(11, 4, 16, 16, 8)
    args_j = [jnp.asarray(x), jnp.asarray(img)]
    args_t = [_nchw(x), _nchw(img)]
    if name == "DecoderBlockNew":
        args_j.append(jnp.asarray(cond))
        args_t.append(_nchw(cond))
    jm = getattr(ju, name)(3, 12, 16, **kw)
    call_kw = {"T": 2} if gru else {}
    variables, pm = _pair(jm, getattr(tu, name)(3, 12, 16, **kw), *args_j, **call_kw)
    ref = jm.apply(variables, *args_j, **call_kw)
    with torch.no_grad():
        got = pm(*args_t, **call_kw)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if isinstance(r, tuple):  # the SFT (scale, shift)
            for gg, rr in zip(g, r):
                _close(gg, rr)
        elif r is None:
            assert g is None
        else:
            _close(g, r)


_RECURRENT = {"with_gru": (ju.CondSynthesisNetworkWithGRU, tu.CondSynthesisNetworkWithGRU),
              "with_conv_fusion": (ju.CondSynthesisNetworkWithConvFusion,
                                   tu.CondSynthesisNetworkWithConvFusion)}
B, T = 2, 3


def _recurrent_pair(variant):
    jcls, tcls = _RECURRENT[variant]
    extra = {"T": T} if variant == "with_conv_fusion" else {}
    x = _rand(4, B, T, 16, 16, 3)
    jm = jcls(**TINY)
    variables, pm = _pair(jm, tcls(device="cpu", **TINY, **extra), jnp.asarray(x))
    return jm, variables, pm, x


@pytest.mark.parametrize("variant", ["with_gru", "with_conv_fusion"])
def test_recurrent_networks_carry_r_list(variant):
    """B=2, T=3: one call from no states, then a second clip fed the
    returned states (the image), and the feature list of that call."""
    jm, variables, pm, x = _recurrent_pair(variant)
    x2 = _rand(5, B, T, 16, 16, 3)
    img_j, r_j = jm.apply(variables, jnp.asarray(x))
    lst_j, r2_j = jm.apply(variables, jnp.asarray(x2), r_j, return_list=True)
    with torch.no_grad():
        img, r = pm(_nchw(x))
        lst, r2 = pm(_nchw(x2), r, return_list=True)
    _close(img, img_j)
    _close_list(lst, lst_j)
    for got, ref in ((r, r_j), (r2, r2_j)):
        assert len(got) == len(ref)
        for g, rr in zip(got, ref):
            if rr is None:  # the conv-fusion blocks pass r_list through
                assert g is None
            else:
                _close(g, rr)


@pytest.mark.parametrize("variant", ["with_gru", "with_conv_fusion"])
def test_recurrent_networks_fix_encoder(variant):
    """`fix_encoder` leaves the output as it is and stops the encoder's
    gradient: none in the port (`detach`), zeros in JAX (`stop_gradient`)."""
    jm, variables, pm, x = _recurrent_pair(variant)
    out_j, _ = jm.apply(variables, jnp.asarray(x), fix_encoder=True)

    def loss(params):
        img, _ = jm.apply({**variables, "params": params}, jnp.asarray(x), fix_encoder=True)
        return jnp.sum(img)

    g_j = jax.grad(loss)(variables["params"])
    assert all(float(jnp.abs(a).max()) == 0.0 for a in jax.tree_util.tree_leaves(g_j["encoder"]))
    img, _ = pm(_nchw(x), fix_encoder=True)
    _close(img, out_j)
    img.sum().backward()
    grads = {k: p.grad for k, p in pm.named_parameters()}
    assert all(g is None or g.abs().max() == 0 for k, g in grads.items() if k.startswith("encoder."))
    assert any(g is not None and g.abs().max() > 0 for k, g in grads.items()
               if k.startswith("fusion."))


def test_cond_synthesis_sft():
    """{res: (scale, shift)} for res >= out_start_res, from no states and
    then fed the returned ones."""
    x = _rand(8, 1, 2, 16, 16, 3)
    jm = ju.CondSynthesisNetworkSFT(**TINY)
    variables, pm = _pair(jm, tu.CondSynthesisNetworkSFT(device="cpu", **TINY), jnp.asarray(x))
    out_j, r_j = jm.apply(variables, jnp.asarray(x))
    out2_j, _ = jm.apply(variables, jnp.asarray(x), r_j)
    with torch.no_grad():
        out, r = pm(_nchw(x))
        out2, _ = pm(_nchw(x), r)
    assert sorted(out) == sorted(out_j) == [16, 32, 64]
    for got, ref in ((out, out_j), (out2, out2_j)):
        for res in ref:
            _close(got[res][0], ref[res][0])
            _close(got[res][1], ref[res][1])


def test_networks_default_to_the_card(monkeypatch):
    """Built without a device the style-U-Nets go to CUDA, and raise where
    there is none rather than stay on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (tu.CondSynthesisNetworkWithGRU, tu.CondSynthesisNetwork,
                tu.CondSynthesisNetworkNew, tu.CondSynthesisNetworkWithConvFusion,
                tu.CondSynthesisNetworkSFT):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(**TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        tu.PlainSynthesisNetwork(img_resolution=64, img_channels=4)
