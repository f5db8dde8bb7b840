"""The port's few-shot absorb (`InversionNet.ar_forward`) against the JAX
package on the same weights, then one driven frame from the absorbed avatar.

A tiny generator (the e4e tests' config with deterministic strata), tiny
IR-SE trunks (`trunk_layers_n=8`) in the e4e encoder and both GRU U-Nets,
`texture_out_channels=(32, 32, 16, 8)`. Two chunks of T=2 source frames: the
first with fresh GRU states from the e4e codes of its first frame, the second
refining the first's features with the carried states. The weight bridge
fills every key of the port's network that JAX creates.

Tolerances (float32 on both sides; renders, trunks and backbones sum in other
orders): the updated texture and static features and the GRU states to 1e-3
of each tensor's largest entry, the driven frame to 2e-3 (max) and 2e-4
(mean) absolute, within the golden frame bands of tests/test_torch_triplane.py.

Slow (about 90 s in one process, most of it JAX compiling one `ar_forward`
chunk program): `python -m pytest -m slow tests/test_torch_fewshot.py`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from invertavatar_torch.models.encoders import InversionNet
from invertavatar_torch.utils.weights import jax_to_state_dict
from tests.test_torch_encoders import _randomize
from tests.test_torch_inversion import _NEVER_RUN, TINY_GEN_CFG

# one intra-op thread: the suite runs test files in parallel worker processes
torch.set_num_threads(1)

OUT_CH = (32, 32, 16, 8)
FS_GEN_CFG = dict(TINY_GEN_CFG, rendering_kwargs=dict(TINY_GEN_CFG["rendering_kwargs"],
                                                     det_stratified=True))
T = 2


def _jax_variables(seed=0):
    """A JAX few-shot `InversionNet` and its variable tree: the encoder (flax
    init, with the latent_avg / black_uv_bg buffers) and both U-Nets (flax
    init of the same modules at 64², whose weights do not depend on the input
    size) with randomised BatchNorm statistics and 1-D parameters; the
    generator N(0, 1)·0.1 by shape."""
    from invertavatar_tpu.models.encoders import unet_encoders as ju
    from invertavatar_tpu.models.encoders.uvnet import InversionNet as JaxNet

    net = JaxNet(generator_cfg=FS_GEN_CFG, texture_out_channels=OUT_CH, trunk_layers_n=8)
    key = jax.random.PRNGKey(seed)
    enc = net.init({"params": key}, jnp.zeros((1, 256, 256, 3)), method=lambda m, x: m.encode(x))
    tex_u = ju.TriPlanefeatEncoder(inp_ch=7, res=None, out_channels=OUT_CH, trunk_layers_n=8)
    tri_u = ju.TriPlaneSFTfeatEncoder(inp_ch=6, res=None, channel_base=FS_GEN_CFG["channel_base"],
                                      channel_max=FS_GEN_CFG["channel_max"], trunk_layers_n=8)
    tex_v = tex_u.init(jax.random.fold_in(key, 1), jnp.zeros((1, 1, 64, 64, 7)))
    tri_v = tri_u.init(jax.random.fold_in(key, 2), jnp.zeros((1, 1, 64, 64, 6)))
    learned = _randomize({
        "params": {**enc["params"], "unet_encoder": {"texture_unet": tex_v["params"],
                                                     "triplane_unet": tri_v["params"]}},
        "buffers": enc["buffers"],
        "batch_stats": {**enc["batch_stats"],
                        "unet_encoder": {"texture_unet": tex_v["batch_stats"],
                                         "triplane_unet": tri_v["batch_stats"]}},
    }, seed + 3)
    shapes = jax.eval_shape(lambda: net.init(
        {"params": key, "buffers": key, "noise": key, "ray": key}, jnp.zeros((1, 32)),
        jnp.zeros((1, 25)), {"uvcoords_image": jnp.zeros((1, 256, 256, 3))},
        method=lambda m, z, c, v: m.generator(z, c, v)))
    npr = np.random.RandomState(seed + 4)
    gen = jax.tree_util.tree_map(
        lambda s: (npr.standard_normal(s.shape) * 0.1).astype(np.float32), shapes)
    learned["params"]["generator"] = gen["params"]["generator"]
    learned["buffers"]["generator"] = gen["buffers"]["generator"]
    return net, learned


def _inputs(seed):
    from invertavatar_tpu.train.dryrun import _fake_batch

    rng = np.random.RandomState(seed)
    raw = _fake_batch(rng, batch=T, res=256, z_dim=32)
    uvc = raw["v"]["uvcoords_image"]
    uv = np.concatenate([rng.uniform(-1, 1, (T, 256, 256, 3)), uvc], axis=-1).astype(np.float32)
    image = (raw["image"] * 0.5).astype(np.float32)
    return image, uv, raw["c"], uvc


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x, np.float32), -1, 1)))


def _assert_rel(got, ref, rel, what):
    got, ref = got.numpy(), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6)
    assert err < rel, (what, err)


@pytest.mark.slow
def test_ar_forward_two_chunks_then_driven_frame_match_jax():
    from invertavatar_tpu.faceverse.synthetic import synthetic_manager

    jnet, variables = _jax_variables()
    port = InversionNet(FS_GEN_CFG, encoding_texture=True, encoding_triplane=True,
                        texture_out_channels=OUT_CH, trunk_layers_n=8).eval()
    missing, unexpected = port.load_state_dict(jax_to_state_dict(variables), strict=False)
    assert unexpected == [] and all(k.startswith(_NEVER_RUN) for k in missing), missing
    assert any(k.startswith("unet_encoder.triplane_unet.up4.conv_gru.ih.0") for k in
               port.state_dict()) and not any(k.startswith("unet_encoder") for k in missing)

    rngs = {"ray": jax.random.PRNGKey(9), "noise": jax.random.PRNGKey(10)}

    def jax_chunk(x, c, v, ws, r_list, e4e_results):
        return jnet.apply(variables, x, c, v, ws, r_list, e4e_results, rngs=rngs,
                          method=lambda m, *a: m.ar_forward(*a))

    # JAX runs both chunks through one compiled program: the first chunk's
    # e4e codes and features come from their own calls, and its GRU states
    # are zeros (what a missing state means); the port takes the None path
    image0 = jnp.asarray(_inputs(seed=0)[0][:1])
    ws_j = jax.jit(lambda v, x: jnet.apply(v, x, method=lambda m, x: m.encode(x)))(
        variables, image0)
    e4e_j = dict(zip(("texture", "static"), jax.jit(lambda v, ws: jnet.apply(
        v, ws, method=lambda m, ws: (
            m.generator.texture_backbone.synthesis(ws, return_list=True, noise_mode="const"),
            m.generator.backbone.synthesis(ws, return_list=True, noise_mode="const"))))(
        variables, ws_j)))
    chunk_j = jax.jit(jax_chunk)
    ws_t = e4e_t = None
    r_t = [None, None]
    r_j = None
    for chunk in range(2):
        image, uv, c, uvc = _inputs(seed=chunk)
        if r_j is None:
            r_j = [[jnp.zeros(s.shape, s.dtype) for s in states] for states in jax.eval_shape(
                jax_chunk, {"image": jnp.asarray(image), "uv": jnp.asarray(uv)}, jnp.asarray(c),
                {"uvcoords_image": jnp.asarray(uvc)}, ws_j, [None, None], e4e_j)[1]]
        upd_j, r_j = chunk_j({"image": jnp.asarray(image), "uv": jnp.asarray(uv)}, jnp.asarray(c),
                             {"uvcoords_image": jnp.asarray(uvc)}, ws_j, r_j, e4e_j)
        with torch.no_grad():
            upd_t, r_t = port.ar_forward({"image": _nchw(image), "uv": _nchw(uv)},
                                         torch.from_numpy(c),
                                         {"uvcoords_image": torch.from_numpy(uvc)}, ws_t, r_t,
                                         e4e_results=e4e_t)
        _assert_rel(upd_t["w"], upd_j["w"], 1e-4, "w")
        for kind in ("texture", "static"):
            assert len(upd_t[kind]) == len(upd_j[kind])
            for i, (a, b) in enumerate(zip(upd_t[kind], upd_j[kind])):
                _assert_rel(a, np.moveaxis(np.asarray(b), -1, 1), 1e-3,
                            f"{kind}[{i}] chunk {chunk}")
        for u, (states_t, states_j) in enumerate(zip(r_t, r_j)):
            for i, (a, b) in enumerate(zip(states_t, states_j)):
                _assert_rel(a, np.moveaxis(np.asarray(b), -1, 1), 1e-3, f"state {u}.{i}")
        ws_j, ws_t = upd_j["w"], upd_t["w"]
        e4e_j = {"texture": upd_j["texture"], "static": upd_j["static"]}
        e4e_t = {"texture": upd_t["texture"], "static": upd_t["static"]}

    # one driven frame from the absorbed features (the JAX manager's signal,
    # fed to both sides)
    mgr, bank = synthetic_manager(n_grid=40, seed=1)
    uvc = np.array(mgr.make_driven_rendering(bank[2]))
    c = _inputs(seed=0)[2][:1]

    def jax_frame(v, ws, tex, static, c, uvc):
        return jnet.apply(v, ws, tex, static, c, uvc, rngs=rngs, method=lambda m, ws, t, s, c, u: (
            m.generator.synthesis_withTexture(ws, t, c, {"uvcoords_image": u}, static_feats=s,
                                              noise_mode="const", evaluation=True)["image"]))

    ref = jax.jit(jax_frame)(variables, ws_j, e4e_j["texture"], e4e_j["static"], jnp.asarray(c),
                             jnp.asarray(uvc))
    with torch.no_grad():
        img = port.generator.synthesis_withTexture(
            ws_t, e4e_t["texture"], torch.from_numpy(c), {"uvcoords_image": torch.from_numpy(uvc)},
            static_feats=e4e_t["static"], noise_mode="const", evaluation=True)["image"]
    err = np.abs(img.numpy() - np.moveaxis(np.asarray(ref), -1, 1))
    assert img.shape == (1, 3, 128, 128) and np.isfinite(img.numpy()).all()
    assert err.max() < 2e-3 and err.mean() < 2e-4, (err.max(), err.mean())
