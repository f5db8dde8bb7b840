"""The port's shape checks (`invertavatar_torch/utils/misc.py:assert_shape`)
against the JAX package's (`invertavatar_tpu/utils/misc.py:assert_shape`).

`assert_shape` itself: `None` entries, a dimension-count mismatch, and the
same messages as JAX's for the same shapes. Then every site where a JAX
module calls it (13 of them: `ws` of the synthesis block, the synthesis
network, the StyleGAN3 network and the Next3D `CondSynthesisNetwork`;
`styles` in `modulated_conv2d`; `x` and `img` of the synthesis block; `x` of
the synthesis layer; the StyleGAN3 layer's output; `x` and `img` of the
discriminator block; `x` and `cmap` of the discriminator epilogue): a tiny
module of each package is fed a shape that JAX's check rejects (NHWC there,
NCHW in the port), and both must raise `AssertionError`. JAX's check fires
while tracing, so its side is `jax.eval_shape` of `init`: nothing compiles.
Each site's well-shaped input passes on both sides first, so that the
wrong-shaped one is the only cause.
"""

import numpy as np
import pytest
import torch

from invertavatar_torch.utils.misc import assert_shape

torch.set_num_threads(1)


# ------------------------------------------------------------- assert_shape


@pytest.mark.parametrize("shape, ref, ok", [
    ((2, 3, 4), (2, 3, 4), True),
    ((2, 3, 4), (None, 3, None), True),
    ((5, 3, 4), (None, None, None), True),
    ((), (), True),
    ((2, 3, 4), (2, 3), False),
    ((2, 3), (2, 3, None), False),
    ((2, 3, 4), (2, 5, 4), False),
    ((2, 3, 4), (None, 3, 5), False),
])
def test_assert_shape_matches_jax(shape, ref, ok):
    """The same verdict and, where it raises, the same message as JAX's
    `assert_shape` on an array of the same shape."""
    from invertavatar_tpu.utils.misc import assert_shape as jax_assert_shape

    msgs = []
    for check, x in ((assert_shape, torch.zeros(shape)),
                     (jax_assert_shape, np.zeros(shape, np.float32))):
        try:
            check(x, list(ref))
            msgs.append(None)
        except AssertionError as e:
            msgs.append(str(e))
    assert (msgs[0] is None) == ok and msgs[0] == msgs[1], msgs
    if not ok and len(shape) != len(ref):
        assert msgs[0].startswith("Wrong number of dimensions: got ")
    elif not ok:
        assert msgs[0].startswith("Wrong size for dimension ")


def test_assert_shape_reads_only_the_shape():
    """The check reads `x.shape` and nothing else: no tensor op, so an object
    that has only a shape will do (as a meta tensor does)."""

    class ShapeOnly:
        shape = torch.Size([4, 3])

    assert_shape(ShapeOnly(), [None, 3])
    assert_shape(torch.empty((4, 3), device="meta"), [4, None])
    with pytest.raises(AssertionError, match="Wrong size for dimension 1: got 3, expected 2"):
        assert_shape(ShapeOnly(), [4, 2])


# ------------------------------------------------------------------- sites


def _rngs():
    import jax

    k = jax.random.PRNGKey(0)
    return {"params": k, "buffers": jax.random.fold_in(k, 1), "noise": jax.random.fold_in(k, 2)}


def _nhwc(shape):
    """NCHW -> NHWC for a 4-D shape; others unchanged."""
    return (shape[0], *shape[2:], shape[1]) if len(shape) == 4 else shape


def _synthesis_block(x, img, ws):
    from invertavatar_torch.models.synthesis import SynthesisBlock
    from invertavatar_tpu.models import synthesis as js

    kw = dict(in_channels=8, out_channels=8, w_dim=16, resolution=8, img_channels=3)
    return (js.SynthesisBlock(is_last=False, **kw), SynthesisBlock(**kw),
            dict(x=(1, 8, 4, 4), img=(1, 3, 4, 4), ws=(1, 3, 16)), dict(x=x, img=img, ws=ws),
            dict(noise_mode="const"))


def _synthesis_network(ws):
    from invertavatar_torch.models.synthesis import SynthesisNetwork
    from invertavatar_tpu.models import synthesis as js

    kw = dict(w_dim=16, img_resolution=16, img_channels=3, channel_base=64, channel_max=8,
              num_fp16_res=0)
    p = SynthesisNetwork(**kw)
    return (js.SynthesisNetwork(**kw), p, dict(ws=(1, p.num_ws, 16)), dict(ws=ws),
            dict(noise_mode="const"))


def _synthesis_layer(x, w):
    from invertavatar_torch.models.layers import SynthesisLayer
    from invertavatar_tpu.models import layers as jl

    kw = dict(in_channels=8, out_channels=8, w_dim=16, resolution=8)
    return (jl.SynthesisLayer(**kw), SynthesisLayer(**kw), dict(x=(2, 8, 8, 8), w=(2, 16)),
            dict(x=x, w=w), dict(noise_mode="const"))


def _sg3_kw():
    """The keyword arguments of layer 1 of a tiny StyleGAN3 network (the
    tests' 32² configuration), from the JAX network's own schedule."""
    from invertavatar_tpu.models import stylegan3 as j3

    net = j3.SG3SynthesisNetwork(w_dim=32, img_resolution=32, img_channels=3, num_layers=6,
                                 channel_base=1024, channel_max=32)
    cutoffs, rates, half_widths, sizes, channels = net._schedule()
    return dict(w_dim=32, is_torgb=False, is_critically_sampled=False,
                in_channels=int(channels[0]), out_channels=int(channels[1]),
                in_size=int(sizes[0]), out_size=int(sizes[1]),
                in_sampling_rate=float(rates[0]), out_sampling_rate=float(rates[1]),
                in_cutoff=float(cutoffs[0]), out_cutoff=float(cutoffs[1]),
                in_half_width=float(half_widths[0]), out_half_width=float(half_widths[1]))


def _sg3_layer(grow):
    from invertavatar_torch.models.stylegan3 import SG3SynthesisLayer
    from invertavatar_tpu.models import stylegan3 as j3

    kw = _sg3_kw()
    size, c = kw["in_size"], kw["in_channels"]
    return (j3.SG3SynthesisLayer(**kw), SG3SynthesisLayer(**kw),
            dict(x=(1, c, size, size), w=(1, 32)), dict(x=(1, c, size + grow, size + grow)), {})


def _sg3_network(ws):
    from invertavatar_torch.models.stylegan3 import SG3SynthesisNetwork
    from invertavatar_tpu.models import stylegan3 as j3

    kw = dict(w_dim=32, img_resolution=32, img_channels=3, num_layers=6, channel_base=1024,
              channel_max=32)
    p = SG3SynthesisNetwork(**kw)
    return j3.SG3SynthesisNetwork(**kw), p, dict(ws=(1, p.num_ws, 32)), dict(ws=ws), {}


def _cond_synthesis(ws):
    from invertavatar_torch.models import next3d as tn
    from invertavatar_tpu.models import next3d as jn

    kw = dict(w_dim=64, img_resolution=64, img_channels=8, cond_channels=6, in_size=16,
              final_size=4, channel_base=512, channel_max=64, num_fp16_res=0, num_cond_res=16)
    p = tn.CondSynthesisNetwork(device="cpu", **kw)
    return (jn.CondSynthesisNetwork(**kw), p, dict(x_in=(1, 6, 16, 16), ws=(1, p.num_ws, 64)),
            dict(ws=ws), dict(noise_mode="const"))


def _disc_block(x, img, in_channels=8):
    from invertavatar_torch.models.discriminator import DiscriminatorBlock
    from invertavatar_tpu.models import discriminator as jd

    kw = dict(in_channels=in_channels, tmp_channels=8, out_channels=8, resolution=8,
              img_channels=3)
    good = dict(x=(1, 8, 8, 8) if in_channels else None, img=(1, 3, 8, 8))
    return jd.DiscriminatorBlock(**kw), DiscriminatorBlock(**kw), good, dict(x=x, img=img), {}


def _epilogue(x, cmap):
    from invertavatar_torch.models.discriminator import DiscriminatorEpilogue
    from invertavatar_tpu.models import discriminator as jd

    kw = dict(in_channels=8, cmap_dim=4, resolution=4, img_channels=3)
    return (jd.DiscriminatorEpilogue(**kw), DiscriminatorEpilogue(**kw),
            dict(x=(2, 8, 4, 4), img=None, cmap=(2, 4)), dict(x=x, cmap=cmap), {})


# site -> (JAX file:line of its assert_shape, builder of (JAX module, port
# module, well-shaped NCHW inputs, the wrong ones, call options))
SITES = {
    "synthesis_block.ws": ("models/synthesis.py:68",
                           lambda: _synthesis_block(None, None, (1, 3, 17))),
    "synthesis_block.x": ("models/synthesis.py:102",
                          lambda: _synthesis_block((1, 6, 4, 4), None, None)),
    "synthesis_block.img": ("models/synthesis.py:154",
                            lambda: _synthesis_block(None, (1, 1, 4, 4), None)),
    "synthesis_network.ws": ("models/synthesis.py:217", lambda: _synthesis_network((1, 7, 16))),
    "modulated_conv2d.styles": ("models/layers.py:146", lambda: _synthesis_layer(None, (1, 16))),
    "synthesis_layer.x": ("models/layers.py:197", lambda: _synthesis_layer((2, 8, 6, 6), None)),
    "sg3_layer.out": ("models/stylegan3.py:211", lambda: _sg3_layer(4)),
    "sg3_network.ws": ("models/stylegan3.py:254", lambda: _sg3_network((1, 9, 32))),
    "cond_synthesis.ws": ("models/next3d.py:147", lambda: _cond_synthesis((1, 11, 64))),
    "disc_block.x": ("models/discriminator.py:49", lambda: _disc_block((1, 8, 4, 4), None)),
    "disc_block.img": ("models/discriminator.py:53",
                       lambda: _disc_block(None, (1, 1, 8, 8), in_channels=0)),
    "epilogue.x": ("models/discriminator.py:124", lambda: _epilogue((2, 6, 4, 4), None)),
    "epilogue.cmap": ("models/discriminator.py:147", lambda: _epilogue(None, (2, 1))),
}


def _inputs(good, wrong):
    """Ordered NCHW shapes: the well-shaped ones with `wrong`'s non-None
    entries in their place."""
    return {k: wrong[k] if wrong.get(k) is not None else v for k, v in good.items()}


def _jax_error(module, shapes, opts):
    """The message of the `AssertionError` that JAX's `init` raises while
    tracing, or None."""
    import jax
    import jax.numpy as jnp

    args = [None if s is None else jnp.zeros(_nhwc(s), jnp.float32) for s in shapes.values()]
    try:
        jax.eval_shape(lambda: module.init(_rngs(), *args, **opts))
    except AssertionError as e:
        return str(e)
    return None


def _port_error(module, shapes, opts):
    """The message of the `AssertionError` that the port's forward raises,
    or None."""
    args = [None if s is None else torch.zeros(s) for s in shapes.values()]
    try:
        with torch.no_grad():
            module(*args, **opts)
    except AssertionError as e:
        return str(e)
    return None


@pytest.mark.parametrize("site", list(SITES))
def test_shape_site_raises_as_in_jax(site):
    """The site's wrong shape raises `AssertionError` from `assert_shape` in
    JAX and in the port; its well-shaped inputs raise in neither."""
    jax_line, build = SITES[site]
    jm, pm, good, wrong, opts = build()
    pm.eval()
    assert _jax_error(jm, good, opts) is None, f"JAX rejects the well-shaped inputs ({jax_line})"
    assert _port_error(pm, good, opts) is None, "the port rejects the well-shaped inputs"
    bad = _inputs(good, wrong)
    assert bad != good
    errors = {"JAX": _jax_error(jm, bad, opts), "port": _port_error(pm, bad, opts)}
    for side, msg in errors.items():
        assert msg is not None, f"{side} accepts {bad} (JAX {jax_line} rejects it)"
        assert msg.startswith(("Wrong size for dimension ", "Wrong number of dimensions")), \
            (side, msg)
