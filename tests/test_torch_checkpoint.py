"""Checkpoint import: a pickle in the reference's format, read by the JAX
package's `load_*_from_pkl` and by the port's.

The reference pickles each persistent network as
`torch_utils.persistence._reconstruct_persistent_obj(meta)`, with the module
state (`_parameters`, `_buffers`, `_modules`, `_init_kwargs`) inside `meta`.
The tests forge such pickles with a stand-in for that function from a tiny
generator and a tiny GRU `InversionNet` of the port, with every buffer the
reference also pickles (`resample_filter`, BatchNorm's `num_batches_tracked`)
and some tensors stored in float16 and bfloat16. Neither reader executes
anything from the pickle.

Both packages must load the same numbers: the JAX variables, carried back by
the weight bridge, equal the port's state dict bit for bit. Frames and e4e
codes then agree within the float32 bands of the port's other JAX tests.
"""

import collections
import io
import pickle
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from invertavatar_torch.flagship import example_inputs, init_flagship
from invertavatar_torch.models.encoders import InversionNet
from invertavatar_torch.models.triplane import TriPlaneGenerator
from invertavatar_torch.utils import checkpoint as ckpt
from invertavatar_torch.utils.weights import jax_to_state_dict
from tests.test_torch_fewshot import FS_GEN_CFG, OUT_CH

# one intra-op thread: the suite runs test files in parallel worker processes
torch.set_num_threads(1)

# tensors the forged pickles store in half precision
HALF = {"backbone.synthesis.b8.conv0.noise_const": torch.float16,
        "texture_backbone.mapping.w_avg": torch.bfloat16,
        "latent_avg": torch.bfloat16}


def _reconstruct_persistent_obj(meta):  # the reference's name; never called here
    raise AssertionError("the readers must not call the pickled reconstructor")


class _Persistent:
    """Pickles as the reference's persistent objects do."""

    def __init__(self, meta):
        self.meta = meta

    def __reduce__(self):
        return _reconstruct_persistent_obj, (self.meta,)


@pytest.fixture
def reference_pickler(monkeypatch):
    """Make the stand-in reconstructor picklable under the reference's module
    path, `torch_utils.persistence`."""
    pkg, mod = types.ModuleType("torch_utils"), types.ModuleType("torch_utils.persistence")
    mod._reconstruct_persistent_obj = _reconstruct_persistent_obj
    pkg.persistence = mod
    monkeypatch.setattr(_reconstruct_persistent_obj, "__module__", "torch_utils.persistence")
    monkeypatch.setitem(sys.modules, "torch_utils", pkg)
    monkeypatch.setitem(sys.modules, "torch_utils.persistence", mod)


def _module_state(m: torch.nn.Module, prefix: str = ""):
    """A module's pickled `__dict__` state: parameters, every buffer (the
    non-persistent `resample_filter` too), `num_batches_tracked` beside
    BatchNorm statistics, submodules."""
    params = collections.OrderedDict(
        (n, p.detach().clone().to(HALF.get(prefix + n, p.dtype)))
        for n, p in m.named_parameters(recurse=False))
    bufs = collections.OrderedDict(
        (n, b.detach().clone().to(HALF.get(prefix + n, b.dtype)))
        for n, b in m.named_buffers(recurse=False))
    if "running_mean" in bufs:
        bufs["num_batches_tracked"] = torch.tensor(7)
    return {"_parameters": params, "_buffers": bufs, "training": False,
            "_modules": collections.OrderedDict((n, _module_state(c, f"{prefix}{n}."))
                                                for n, c in m.named_children())}


def _persistent(m, init_kwargs, prefix="", nested=()):
    state = _module_state(m, prefix)
    for name in nested:  # children pickled as persistent objects of their own
        state["_modules"][name] = _persistent(getattr(m, name), nested[name],
                                              f"{prefix}{name}.")
    state["_init_kwargs"] = dict(init_kwargs)
    state["_init_args"] = ()
    return _Persistent({"type": "class", "version": 6, "module_src": "# not executed",
                        "class_name": type(m).__name__, "state": state})


def generator_init_kwargs(cfg):
    """The reference `TriPlaneGenerator` init kwargs of a port config."""
    kw = {k: cfg[k] for k in ("z_dim", "c_dim", "w_dim", "img_resolution", "img_channels",
                              "channel_base", "channel_max")}
    return dict(kw, sr_num_fp16_res=0, num_fp16_res=0, conv_clamp=None,
                rendering_kwargs=dict(cfg["rendering_kwargs"]),
                mapping_kwargs={"num_layers": cfg["map_num_layers"]}, sr_kwargs={})


def tiny_generator(seed=0):
    torch.manual_seed(seed)
    return init_flagship(TriPlaneGenerator(**FS_GEN_CFG), seed=seed).eval()


def tiny_inversion_net(seed=0):
    torch.manual_seed(seed)
    net = InversionNet(FS_GEN_CFG, encoding_texture=True, encoding_triplane=True,
                       texture_out_channels=OUT_CH, trunk_layers_n=8)
    init_flagship(net.generator, seed=seed)
    with torch.no_grad():
        net.latent_avg.normal_(0.0, 0.1)
    return net.eval()


def write_gan_pkl(path, G):
    with open(path, "wb") as f:
        pickle.dump({"G_ema": _persistent(G, generator_init_kwargs(FS_GEN_CFG)),
                     "training_set_kwargs": {"resolution": 512}}, f)


def write_inversion_pkl(path, net):
    with open(path, "wb") as f:
        pickle.dump({"G": _persistent(net, {"n_styles": 14}, nested={
            "generator": generator_init_kwargs(FS_GEN_CFG)})}, f)


def _expected_state(m):
    """The source module's state as the pickle holds it (half rounded)."""
    return {k: v.to(HALF[k]).float() if k in HALF else v for k, v in m.state_dict().items()}


def _assert_bitwise(port_sd, jax_variables, expected):
    jsd = jax_to_state_dict(jax_variables)
    assert set(jsd) <= set(port_sd) and len(jsd) > 100
    for k, v in jsd.items():
        assert torch.equal(port_sd[k], v), k
    for k, v in expected.items():
        assert torch.equal(port_sd[k], v), k


def _assert_rounded(src, keys):
    """The half-precision entries did round: the pickle's values are not the
    source module's."""
    sd, expected = src.state_dict(), _expected_state(src)
    for k in keys:
        assert not torch.equal(sd[k], expected[k]), k


def test_gan_pkl_loads_alike(tmp_path, reference_pickler):
    """`load_triplane_from_pkl`: the same config and weights in both packages
    (bitwise, fp16 and bf16 entries included); the mapping's ws to 1e-5 and a
    frame within the golden bands (image_raw 3e-3, image 8e-3)."""
    from invertavatar_tpu.utils.checkpoint import load_triplane_from_pkl as jax_load

    src = tiny_generator()
    path = tmp_path / "gan.pkl"
    write_gan_pkl(path, src)
    G = ckpt.load_triplane_from_pkl(str(path), device="cpu")
    Gj, variables = jax_load(str(path))
    assert (Gj.z_dim, Gj.map_num_layers, Gj.channel_max) == (32, 2, 64)
    sd = G.state_dict()
    assert sd["backbone.synthesis.b8.conv0.noise_const"].dtype == torch.float32
    _assert_bitwise(sd, variables, _expected_state(src))
    _assert_rounded(src, ("backbone.synthesis.b8.conv0.noise_const",
                          "texture_backbone.mapping.w_avg"))

    G.neural_rendering_resolution = 32  # an attribute in the reference, as here
    Gj = Gj.clone(neural_rendering_resolution=32)
    z, c, uvc = example_inputs(1)
    z = z[:, :32]
    ws_j, out_j = jax.jit(lambda v, z, c, u: Gj.apply(v, z, c, u, method=lambda m, z, c, u: (
        lambda ws: (ws, m.synthesis(ws, c, {"uvcoords_image": u}, noise_mode="const",
                                    evaluation=True)))(m.mapping(z, c))),
        )(variables, jnp.asarray(z), jnp.asarray(c), jnp.asarray(uvc))
    with torch.no_grad():
        ws = G.mapping(torch.from_numpy(z), torch.from_numpy(c))
        out = G.synthesis(ws, torch.from_numpy(c), {"uvcoords_image": torch.from_numpy(uvc)},
                          noise_mode="const", evaluation=True)
    np.testing.assert_allclose(ws.numpy(), np.asarray(ws_j), atol=1e-5)
    for key, tol in (("image_raw", 3e-3), ("image", 8e-3)):
        err = np.abs(out[key].numpy() - np.moveaxis(np.asarray(out_j[key]), -1, 1)).max()
        assert err < tol, (key, err)


@pytest.mark.parametrize("module,name,arg", [
    ("numpy.lib.npyio", "os.system", "exit 0"),  # a dotted name through numpy's `import os`
    ("numpy", "load", "missing.npy"),
    ("numpy.ctypeslib", "load_library", "missing"),
    ("torch_utils.persistence", "os.system", "exit 0"),
])
def test_unpickler_refuses_code_globals(module, name, arg):
    """A forged protocol-4 pickle that calls a global able to run code is
    refused when the global is looked up, before anything is called."""
    from invertavatar_torch.utils.pkl_import import safe_load_pickle

    def text(s):
        b = s.encode()
        return b"\x8c" + bytes([len(b)]) + b  # SHORT_BINUNICODE

    # PROTO 4, STACK_GLOBAL, (arg,) TUPLE1, REDUCE, STOP
    forged = b"\x80\x04" + text(module) + text(name) + b"\x93" + text(arg) + b"\x85R."
    with pytest.raises(pickle.UnpicklingError, match="not allowed"):
        safe_load_pickle(io.BytesIO(forged))


@pytest.mark.parametrize("protocol", [4, 5])
def test_unpickler_reads_numpy_values(protocol):
    """Arrays (contiguous and strided), numpy scalars and dtypes, as a
    checkpoint's kwargs may hold them, read back equal."""
    from invertavatar_torch.utils.pkl_import import safe_load_pickle

    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    value = {"a": a, "t": a.T, "s": np.float32(1.5), "i": np.int64(3), "d": np.dtype("f2"),
             "o": collections.OrderedDict(x=[1, 2])}
    got = safe_load_pickle(io.BytesIO(pickle.dumps(value, protocol=protocol)))
    for k in ("a", "t"):
        np.testing.assert_array_equal(got[k], value[k])
        assert got[k].dtype == value[k].dtype
    assert got["s"] == value["s"] and type(got["s"]) is np.float32
    assert got["i"] == value["i"] and got["d"] == value["d"] and got["o"] == value["o"]


def test_inversion_pkl_loads_alike(tmp_path, reference_pickler):
    """`load_inversion_from_pkl`: the GRU U-Nets and tiny trunks found from
    the state dict, the same weights in both packages (bitwise), and the
    same e4e codes (1e-4 of their scale). JAX builds its network with the
    default options; the test gives it the tiny trunk."""
    from invertavatar_tpu.utils.checkpoint import load_inversion_from_pkl as jax_load

    src = tiny_inversion_net()
    path = tmp_path / "fs.pkl"
    write_inversion_pkl(path, src)
    try:  # 1.1 GB: the e4e style heads are full width whatever the trunk
        net = ckpt.load_inversion_from_pkl(str(path), device="cpu")
        jnet, variables = jax_load(str(path))
    finally:
        path.unlink()
    assert net.unet_encoder.texture_unet is not None and net.unet_encoder.triplane_unet is not None
    assert len(net.encoder.body) == 4
    _assert_bitwise(net.state_dict(), variables, _expected_state(src))
    _assert_rounded(src, ("latent_avg",))

    jnet = jnet.clone(trunk_layers_n=8, texture_out_channels=OUT_CH)
    img = np.random.RandomState(3).uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32)
    ref = jax.jit(lambda v, x: jnet.apply(v, x, method=lambda m, x: m.encode(x)))(
        variables, jnp.asarray(img))
    with torch.no_grad():
        got = net.encode(torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2))))
    ref = np.asarray(ref)
    assert np.abs(got.numpy() - ref).max() < 1e-4 * np.abs(ref).max()
