"""The port's StyleGAN3 pieces against the JAX package on the CPU.

  * `filtered_lrelu` (bias, up-FIR, leaky ReLU with gain and clamp,
    down-FIR) at up/down 1 and 2, with a separable Kaiser filter, the
    [1, 3, 3, 1] outer product and a radial filter: 1e-5 of the output's
    largest magnitude (float32 on both sides, the same taps in other
    summation orders);
  * `design_lowpass_filter`, separable and radial: 1e-6 absolute (scipy and
    numpy on both sides, the same code);
  * `sg3_modulated_conv2d` with and without demodulation: 1e-5 relative;
  * the tiny `SG3Generator` of tests/test_stylegan3.py (32², 6 layers,
    channel_base 1024, channel_max 32), its JAX-initialised weights carried
    over by `jax_to_state_dict`, with and without `update_emas` (then the
    magnitude EMAs too): 1e-4 of the image's largest magnitude;
  * the converter: `synthesis.input.affine.bias` gains the reference's
    [1, 0, 0, 0] and `synthesis.input.weight` keeps its [C, C] layout, and
    the converted keys and shapes are the reference layout's;
  * `SG3Generator` builds on CUDA unless `device="cpu"`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from invertavatar_torch.models import stylegan3 as ps
from invertavatar_torch.ops.filtered_lrelu import filtered_lrelu
from invertavatar_torch.utils.weights import jax_to_state_dict

# one intra-op thread: the suite runs test files in parallel worker processes
torch.set_num_threads(1)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.array(x, np.float32), -1, 1)))


def _rel(got, ref, rel, what=""):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12)
    assert err < rel, (what, err)


def _filters():
    kaiser = ps.design_lowpass_filter(12, cutoff=2.0, width=2.5, fs=16.0)
    outer = np.outer([1, 3, 3, 1], [1, 3, 3, 1]).astype(np.float32)
    radial = ps.design_lowpass_filter(8, cutoff=2.0, width=2.5, fs=16.0, radial=True)
    return {"kaiser": kaiser, "outer": outer / outer.sum(), "radial": radial}


@pytest.mark.parametrize("up,down,fu,fd,clamp", [
    (1, 1, None, None, None), (2, 2, "kaiser", "kaiser", 1.5), (2, 1, "outer", None, 2.0),
    (1, 2, None, "radial", None), (2, 2, "outer", "radial", 0.8)])
def test_filtered_lrelu_matches_jax(up, down, fu, fd, clamp):
    from invertavatar_tpu.ops.filtered_lrelu import filtered_lrelu as j_flrelu

    rng = np.random.RandomState(up * 10 + down)
    x = rng.randn(2, 11, 11, 4).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    filters = _filters()
    taps = [filters[n] if n else None for n in (fu, fd)]
    pad = [3, 2, 3, 2] if up > 1 else [1, 1, 1, 1]
    kw = dict(up=up, down=down, padding=pad, gain=np.sqrt(2.0), slope=0.2, clamp=clamp)
    ref = j_flrelu(jnp.asarray(x), *[None if t is None else jnp.asarray(t) for t in taps],
                   jnp.asarray(b), **kw)
    got = filtered_lrelu(_nchw(x), *[None if t is None else torch.from_numpy(t) for t in taps],
                         torch.from_numpy(b), **kw)
    _rel(got, np.moveaxis(np.asarray(ref), -1, 1), 1e-5)


def test_design_lowpass_filter_matches_jax():
    from invertavatar_tpu.models.stylegan3 import design_lowpass_filter as j_design

    for args, kw in [((12, 2.0, 2.5, 16.0), {}), ((12, 2.0, 2.5, 16.0), {"radial": True}),
                     ((24, 11.3, 9.0, 64.0), {}), ((6, 4.0, 3.1, 32.0), {"radial": True})]:
        np.testing.assert_allclose(ps.design_lowpass_filter(*args, **kw), j_design(*args, **kw),
                                   rtol=0, atol=1e-6)
    assert ps.design_lowpass_filter(1, 2.0, 2.5, 16.0) is None


@pytest.mark.parametrize("demodulate", [True, False])
def test_sg3_modulated_conv2d_matches_jax(demodulate):
    from invertavatar_tpu.models.stylegan3 import sg3_modulated_conv2d as j_modconv

    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 8, 6).astype(np.float32)
    w = rng.randn(3, 3, 6, 5).astype(np.float32)  # HWIO
    s = (rng.rand(2, 6) + 0.5).astype(np.float32)
    ref = j_modconv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                    input_gain=jnp.float32(0.7), demodulate=demodulate, padding=2)
    got = ps.sg3_modulated_conv2d(_nchw(x), torch.from_numpy(np.transpose(w, (3, 2, 0, 1))),
                                  torch.from_numpy(s), input_gain=torch.tensor(0.7),
                                  demodulate=demodulate, padding=2)
    _rel(got, np.moveaxis(np.asarray(ref), -1, 1), 1e-5)


TINY = dict(z_dim=16, c_dim=0, w_dim=32, img_resolution=32, img_channels=3, num_layers=6,
            channel_base=1024, channel_max=32)


@pytest.fixture(scope="module")
def tiny_jax():
    from invertavatar_tpu.models.stylegan3 import SG3Generator as JG

    g_j = JG(**TINY)
    rng = jax.random.PRNGKey(0)
    z = jax.random.normal(rng, (2, 16))
    variables = g_j.init({"params": rng, "buffers": jax.random.fold_in(rng, 1)}, z, None)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    # nonzero biases, so that a bias the converter misplaces shows
    brng = np.random.RandomState(3)
    for layer in variables["params"]["synthesis"].values():
        if "bias" in layer:
            layer["bias"] = (0.1 * brng.randn(*layer["bias"].shape)).astype(np.float32)
    return g_j, variables, np.array(z)


@pytest.mark.parametrize("update_emas", [False, True])
def test_tiny_sg3_generator_matches_jax(tiny_jax, update_emas):
    g_j, variables, z = tiny_jax
    if update_emas:
        ref, new = g_j.apply(variables, jnp.asarray(z), None, update_emas=True,
                             mutable=["buffers"])
    else:
        ref = g_j.apply(variables, jnp.asarray(z), None)
    G = ps.SG3Generator(**TINY, device="cpu")
    G.load_state_dict(jax_to_state_dict(variables), strict=True)
    with torch.no_grad():
        got = G(torch.from_numpy(z), None, update_emas=update_emas)
    assert got.shape == (2, 3, 32, 32)
    _rel(got, np.moveaxis(np.asarray(ref), -1, 1), 1e-4, "image")
    if update_emas:
        for name, buf in G.named_buffers():
            if name.endswith("magnitude_ema"):
                layer = name.split(".")[1]
                np.testing.assert_allclose(
                    buf.numpy(), new["buffers"]["synthesis"][layer]["magnitude_ema"],
                    rtol=1e-5, err_msg=name)


def test_converted_input_is_the_reference_layout(tiny_jax):
    _, variables, _ = tiny_jax
    state = jax_to_state_dict(variables)
    inp = variables["params"]["synthesis"]["input"]
    np.testing.assert_array_equal(state["synthesis.input.affine.bias"].numpy(),
                                  inp["affine"]["bias"] + np.float32([1, 0, 0, 0]))
    np.testing.assert_array_equal(state["synthesis.input.weight"].numpy(), inp["weight"])
    np.testing.assert_array_equal(state["synthesis.input.affine.weight"].numpy(),
                                  inp["affine"]["weight"].T)
    reference = ps.SG3Generator(**TINY, device="cpu").state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in reference.items()}
    # a fresh generator starts from the reference's identity transform
    np.testing.assert_array_equal(reference["synthesis.input.affine.bias"].numpy(),
                                  np.float32([1, 0, 0, 0]))
    assert not reference["synthesis.input.affine.weight"].any()


def test_sg3_generator_builds_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError):
        ps.SG3Generator(**TINY)


def test_equivariance_metrics_on_the_tiny_sg3_generator_match_jax(tiny_jax):
    """`metrics/equivariance.py` on a real StyleGAN3 generator: the input's
    `transform` takes each probe's matrix. EQ-T, EQ-T_frac and EQ-R over 4
    samples against JAX's metric on the JAX generator: 1e-3 relative (the
    images agree to 1e-4 of their largest magnitude)."""
    from invertavatar_tpu.metrics import equivariance as jeq
    from invertavatar_torch.metrics import equivariance as peq

    g_j, variables, _ = tiny_jax
    G = ps.SG3Generator(**TINY, device="cpu").eval()
    G.load_state_dict(jax_to_state_dict(variables), strict=True)
    kw = dict(z_dim=16, c_sampler=lambda n, r: np.zeros((n, 0), np.float32), img_resolution=32,
              num_samples=4, batch_size=2, compute_eqt_int=True, compute_eqt_frac=True,
              compute_eqr=True)

    @torch.no_grad()
    def synthesis(ws, M):
        G.synthesis.input.transform.copy_(torch.from_numpy(np.asarray(M, np.float32)))
        return G.synthesis(ws)

    got = peq.compute_equivariance_metrics(
        synthesis, lambda z, c: G.mapping(torch.from_numpy(z), None).detach(), **kw)
    syn_j = jax.jit(lambda v, ws: g_j.apply(v, ws, method=lambda m, w: m.synthesis(w)))
    map_j = jax.jit(lambda v, z: g_j.apply(v, z, None, method=lambda m, z_, c_: m.mapping(z_, c_)))

    def synthesis_j(ws, M):
        v = jax.tree_util.tree_map(lambda a: a, variables)
        v["buffers"]["synthesis"]["input"]["transform"] = np.asarray(M, np.float32)
        return syn_j(v, ws)

    want = jeq.compute_equivariance_metrics(synthesis_j, lambda z, c: map_j(variables, z), **kw)
    assert len(got) == 3 and all(np.isfinite(got)), got
    np.testing.assert_allclose(got, want, rtol=1e-3)
