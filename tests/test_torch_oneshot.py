"""The port's one-shot inversion (`InversionNet.prefix` and the single-frame
`forward`) against the JAX package on the same weights, the one-shot
checkpoint import, and `cli/eval_os.py` end to end on the CPU.

A tiny generator (the few-shot tests' config), the tiny e4e trunk
(`trunk_layers_n=8`), `texture_out_channels=(32, 32, 16, 8)`, and either the
ConvGRU U-Nets (tiny trunks) or the SegFormer decoders (IR-SE-50 trunks and
full-width ViT blocks: the JAX package has no smaller option). One 256²
source frame. JAX runs `prefix` and `__call__` in one `jax.jit` program.

Tolerances (float32 on both sides; renders, trunks and backbones sum in other
orders): the W+ codes to 1e-4 and every feature, the e4e render and the
inversion's images to 1e-3 of each tensor's largest entry.

Slow (`-m slow`): the SegFormer case of `test_prefix_and_call_match_jax`
(~90 s in one process; the decoders alone are `tests/test_torch_transformer.py`'s)
and the one-shot pickle (2.7 GB on disk).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from invertavatar_torch.cli import eval_os
from invertavatar_torch.flagship import example_inputs, init_flagship
from invertavatar_torch.models.encoders import InversionNet
from invertavatar_torch.utils import checkpoint as ckpt
from invertavatar_torch.utils.weights import jax_to_state_dict
from tests.test_torch_checkpoint import (  # noqa: F401  (a fixture)
    _assert_bitwise,
    _expected_state,
    reference_pickler,
    write_inversion_pkl,
)
from tests.test_torch_cli import _video_folder
from tests.test_torch_encoders import _randomize
from tests.test_torch_fewshot import FS_GEN_CFG, OUT_CH, _assert_rel, _inputs, _nchw
from tests.test_torch_inversion import _NEVER_RUN

# one intra-op thread: the suite runs test files in parallel worker processes
torch.set_num_threads(1)


def _jax_unets(unet_type, key):
    """{"params", "batch_stats"} of both U-Nets of `unet_type`, from flax
    inits at 32² or 64² (their weights do not depend on the input size)."""
    if unet_type == "gru":
        from invertavatar_tpu.models.encoders import unet_encoders as ju

        tex = ju.TriPlanefeatEncoder(inp_ch=7, res=None, out_channels=OUT_CH, trunk_layers_n=8)
        tri = ju.TriPlaneSFTfeatEncoder(inp_ch=6, res=None, channel_base=FS_GEN_CFG["channel_base"],
                                        channel_max=FS_GEN_CFG["channel_max"], trunk_layers_n=8)
        shape = (1, 1, 64, 64)
    else:
        from invertavatar_tpu.models.encoders import transformer as jt

        tex = jt.TriPlanefeatSegformerDecoder(inp_ch=7, res=None, out_channels=OUT_CH)
        tri = jt.TriPlaneSFTfeatSegformerDecoder(inp_ch=6, res=None,
                                                 channel_base=FS_GEN_CFG["channel_base"],
                                                 channel_max=FS_GEN_CFG["channel_max"])
        shape = (1, 32, 32)
    tex_v = tex.init(jax.random.fold_in(key, 1), jnp.zeros(shape + (7,)))
    tri_v = tri.init(jax.random.fold_in(key, 2), jnp.zeros(shape + (6,)))
    return {coll: {"unet_encoder": {"texture_unet": tex_v[coll], "triplane_unet": tri_v[coll]}}
            for coll in ("params", "batch_stats")}


def _jax_net(unet_type, seed=0):
    """A JAX one-frame `InversionNet` and its variables: the encoder (flax
    init, with the buffers) and the U-Nets (`_jax_unets`) with randomised
    BatchNorm statistics and 1-D parameters, the generator N(0, 1)·0.1."""
    from invertavatar_tpu.models.encoders.uvnet import InversionNet as JaxNet

    net = JaxNet(generator_cfg=FS_GEN_CFG, texture_out_channels=OUT_CH, trunk_layers_n=8,
                 unet_type=unet_type)
    key = jax.random.PRNGKey(seed)
    enc = net.init({"params": key}, jnp.zeros((1, 256, 256, 3)), method=lambda m, x: m.encode(x))
    unets = _jax_unets(unet_type, key)
    learned = _randomize({"params": {**enc["params"], **unets["params"]},
                          "buffers": enc["buffers"],
                          "batch_stats": {**enc["batch_stats"], **unets["batch_stats"]}},
                         seed + 3)
    del unets
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


def _port_net(unet_type, variables):
    port = InversionNet(FS_GEN_CFG, encoding_texture=True, encoding_triplane=True,
                        unet_type=unet_type, texture_out_channels=OUT_CH, trunk_layers_n=8)
    missing, unexpected = port.load_state_dict(jax_to_state_dict(variables), strict=False)
    assert unexpected == [] and all(k.startswith(_NEVER_RUN) for k in missing), missing
    return port.eval()


@pytest.mark.parametrize("unet_type", [
    "gru", pytest.param("segformer", marks=pytest.mark.slow)])  # ~90 s: JAX compiles 2 decoders
def test_prefix_and_call_match_jax(unet_type):
    """`prefix` (e4e codes, texture pyramid, the e4e render resized to the
    frame) and `forward(return_feats=True, evaluation=True)` (refined
    texture and static features, the render) on one source frame."""
    jnet, variables = _jax_net(unet_type)
    port = _port_net(unet_type, variables)
    image, uv, c, uvc = (a[:1] for a in _inputs(seed=3))
    rngs = {"ray": jax.random.PRNGKey(9), "noise": jax.random.PRNGKey(10)}

    def run(m, x, c, v):
        return (m.prefix(x, c, v, evaluation=True),
                m(x, c, v, return_feats=True, evaluation=True))

    pre_j, out_j = jax.jit(lambda v, x, c, u: jnet.apply(v, x, c, u, rngs=rngs, method=run))(
        variables, {"image": jnp.asarray(image), "uv": jnp.asarray(uv)}, jnp.asarray(c),
        {"uvcoords_image": jnp.asarray(uvc)})
    del variables
    x = {"image": _nchw(image), "uv": _nchw(uv)}
    v = {"uvcoords_image": torch.from_numpy(uvc)}
    pre_t = port.prefix(x, torch.from_numpy(c), v, evaluation=True)
    with torch.no_grad():
        out_t = port(x, torch.from_numpy(c), v, return_feats=True, evaluation=True)

    def nchw(a):
        return np.moveaxis(np.asarray(a), -1, 1)

    for got, ref, what in ((pre_t, pre_j, "prefix"), (out_t, out_j, "call")):
        _assert_rel(got["w"], ref["w"], 1e-4, f"{what} w")
        _assert_rel(got["e4e_image"], nchw(ref["e4e_image"]), 1e-3, f"{what} e4e_image")
        assert len(got["texture"]) == len(ref["texture"])
        for i, (a, b) in enumerate(zip(got["texture"], ref["texture"])):
            _assert_rel(a, nchw(b), 1e-3, f"{what} texture[{i}]")
    assert out_t["e4e_image"].shape == (1, 3, 256, 256)
    for i, (a, b) in enumerate(zip(out_t["static"], out_j["static"])):
        _assert_rel(a, nchw(b), 1e-3, f"static[{i}]")
    for key in ("image", "image_raw", "image_depth"):
        _assert_rel(out_t[key], nchw(out_j[key]), 1e-3, key)
    # the U-Nets moved the features off the e4e pyramid
    assert not torch.allclose(out_t["texture"][1], pre_t["texture"][1])


def tiny_oneshot_net(seed=0):
    """A port one-shot network: the tiny generator and e4e trunk, the
    full-width SegFormer decoders."""
    torch.manual_seed(seed)
    net = InversionNet(FS_GEN_CFG, encoding_texture=True, encoding_triplane=True,
                       unet_type="segformer", texture_out_channels=OUT_CH, trunk_layers_n=8)
    init_flagship(net.generator, seed=seed)
    with torch.no_grad():
        net.latent_avg.normal_(0.0, 0.1)
    return net.eval()


def test_inversion_config_reads_the_unet_kind():
    """The options `load_inversion_from_pkl` reads off a state dict: the
    U-Nets' kind (SegFormer ViT blocks or ConvGRUs), the texture widths and
    the trunk depth (shapes only, on the meta device)."""
    with torch.device("meta"):
        for unet_type in ("segformer", "gru"):
            net = InversionNet(FS_GEN_CFG, encoding_texture=True, encoding_triplane=True,
                               unet_type=unet_type, texture_out_channels=OUT_CH,
                               trunk_layers_n=8)
            cfg = ckpt._inversion_config(net.state_dict())
            assert cfg == dict(encoding_texture=True, encoding_triplane=True,
                               unet_type=unet_type, trunk_layers_n=8, texture_out_channels=OUT_CH)
        cfg = ckpt._inversion_config(InversionNet(FS_GEN_CFG).state_dict())
        assert cfg == dict(encoding_texture=False, encoding_triplane=False, unet_type="gru",
                           trunk_layers_n=50)


@pytest.mark.slow
def test_oneshot_pkl_loads_alike(tmp_path, reference_pickler):
    """A forged one-shot pickle (tiny generator and e4e trunk, full-width
    SegFormer decoders: 2.7 GB) loads to the same numbers in both packages,
    bit for bit, and the port builds SegFormer U-Nets from it."""
    from invertavatar_tpu.utils.checkpoint import load_inversion_from_pkl as jax_load

    src = tiny_oneshot_net()
    path = tmp_path / "os.pkl"
    write_inversion_pkl(path, src)
    expected = _expected_state(src)
    del src
    try:
        net = ckpt.load_inversion_from_pkl(str(path), device="cpu")
        assert net.unet_type == "segformer"
        _, variables = jax_load(str(path))
    finally:
        os.remove(path)
    _assert_bitwise(net.state_dict(), variables, expected)


def test_eval_os_cli_writes_videos(tmp_path, monkeypatch):
    """`eval_os.main` on the CPU: one 512² source (image, camera json, UV
    inputs, uvcoords), a two-frame drive and a two-frame orbit. The network
    comes from `tiny_oneshot_net` in place of a pickle (the import is
    `test_oneshot_pkl_loads_alike`'s); inversion and drive are spied."""
    import json

    import PIL.Image

    net = tiny_oneshot_net()
    monkeypatch.setattr(ckpt, "load_inversion_from_pkl", lambda path, device: net)
    src = tmp_path / "src"
    _video_folder(src, 1, seed=4, images=True, source_uv=True)
    _video_folder(tmp_path / "drive", 2, seed=5)
    _, c, _ = example_inputs(1)
    with open(tmp_path / "cam.json", "w") as f:
        json.dump(c[0].tolist(), f)
    calls = {"invert": 0, "frames": 0}
    invert, render = eval_os.invert_source, eval_os.render_drive_frame

    def spy_invert(*a, **k):
        calls["invert"] += 1
        out = invert(*a, **k)
        assert out["image"].shape == (1, 3, 128, 128) and torch.isfinite(out["image"]).all()
        return out

    def spy_render(*a, **k):
        calls["frames"] += 1
        return render(*a, **k)

    monkeypatch.setattr(eval_os, "invert_source", spy_invert)
    monkeypatch.setattr(eval_os, "render_drive_frame", spy_render)
    eval_os.main(["--network", "unused.pkl", "--source_image",
                  str(src / "images512x512" / "00000000.png"), "--source_camera",
                  str(tmp_path / "cam.json"), "--source_uv",
                  str(src / "uvRender256x256" / "00000000"), "--source_uvcoords",
                  str(src / "orthRender256x256_face_eye" / "00000000.npy"), "--drive_root",
                  str(tmp_path / "drive"), "--orbit_frames", "2", "--outdir",
                  str(tmp_path / "out"), "--device", "cpu"])
    assert calls == {"invert": 1, "frames": 4}
    for name in ("oneshot_reenact.mp4", "oneshot_orbit.mp4"):
        assert os.path.getsize(tmp_path / "out" / name) > 1000
    assert PIL.Image.open(src / "images512x512" / "00000000.png").size == (512, 512)


def test_eval_os_defaults_to_the_card(tmp_path):
    """Without `--device cpu` the CLI builds on CUDA, and raises where there
    is none, before reading anything."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_os.main(["--network", str(tmp_path / "no.pkl")] + [
            a for flag in ("source_image", "source_camera", "source_uv", "source_uvcoords",
                           "drive_root") for a in (f"--{flag}", str(tmp_path))])
