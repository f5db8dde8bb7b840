"""The port's tri-plane generator end to end on the CPU.

  * `synthesis` / `synthesis_withTexture` on `golden_triplane.npz` against its
    torch-oracle frames, at the tolerances of tests/test_goldens.py
    (image_raw 3e-3, image 8e-3, depth 3e-3). This is the exact render path.
  * The port against the JAX package on the same weights with the flagship
    fast path switched on (pallas_coarse + pooled_importance + a rect
    tile_shape; JAX in Pallas interpret mode, the port through the kernels'
    plain versions) at a neural resolution of 32.
  * `synthesis_withCondition` with nonzero CS-SFT conditions against JAX
    on the exact path (1e-4 of each output's largest magnitude), and with
    none, bit for bit `synthesis`.
  * `remat_stages` on and off: the same bits in the loss and every
    gradient of a grad-carrying render with random draws.
  * `FLAGSHIP_RENDERING_KWARGS` equals the JAX dict.
  * Importing the port (and `chip_smoke.py`) leaves neither `jax` nor
    `invertavatar_tpu` loaded.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from invertavatar_torch.utils.weights import jax_to_state_dict
from tests.test_torch_weights import TRIPLANE_RENDER_KWARGS, load_golden, triplane_port

# one intra-op thread: the suite runs test files in parallel worker processes
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(data_vars, **kw):
    G = triplane_port(**kw)
    G.load_state_dict(jax_to_state_dict(data_vars))
    return G.eval()


@pytest.fixture(scope="module")
def golden():
    variables, data = load_golden("golden_triplane")
    return variables, data


def _inputs(data):
    return (torch.from_numpy(data["ws"]), torch.from_numpy(data["c"]),
            {"uvcoords_image": torch.from_numpy(data["uvc"])})


def test_golden_synthesis(golden):
    variables, data = golden
    G = _port(variables)
    ws, c, mesh = _inputs(data)
    with torch.no_grad():
        out = G.synthesis(ws, c, mesh, noise_mode="const", evaluation=True)
    for key, tol in [("image_raw", 3e-3), ("image", 8e-3), ("image_depth", 3e-3)]:
        err = np.abs(data[f"syn_{key}_ref"] - out[key].numpy()).max()
        assert err < tol, f"{key}: max abs err {err}"


def test_golden_synthesis_with_texture(golden):
    """The frame-loop entry point, with both precomputed caches."""
    variables, data = golden
    G = _port(variables)
    ws, c, mesh = _inputs(data)
    with torch.no_grad():
        tex = G.texture_backbone.synthesis(ws, return_list=True, noise_mode="const")
        static = G.backbone.synthesis(ws, return_list=True, noise_mode="const")
        out = G.synthesis_withTexture(
            ws, tex, c, mesh, static_feats=static, noise_mode="const", evaluation=True,
            raster_static_cache=G.precompute_raster_static(static),
            texture_concat_cache=G.precompute_texture_concat(tex))
    for key, tol in [("image_raw", 3e-3), ("image", 8e-3)]:
        err = np.abs(data[f"wt_{key}_ref"] - out[key].numpy()).max()
        assert err < tol, f"{key}: max abs err {err}"


FAST_KWARGS = dict(TRIPLANE_RENDER_KWARGS, pallas_coarse=True, pooled_importance=True,
                   tile_shape=(16, 4))


def test_fast_path_matches_jax_interpret(golden):
    """Port (plain kernel versions) vs JAX (Pallas interpret) on the flagship
    fast path. Both read the same bf16 payload; the TPU tent matmul also
    rounds its weights and partial sums to bf16, the port sums in fp32. The
    difference (about 3e-4 max) is held to the golden tolerances: image_raw
    and depth 3e-3, image 8e-3 max, and a tenth of each as the mean."""
    from invertavatar_tpu.models.triplane import TriPlaneGenerator as JaxG

    variables, data = golden
    nrr = 32
    g_j = JaxG(z_dim=32, c_dim=25, w_dim=512, img_resolution=512, img_channels=3,
               sr_num_fp16_res=0, rendering_kwargs=dict(FAST_KWARGS, pallas_interpret=True),
               neural_rendering_resolution=nrr, channel_base=2048, channel_max=128,
               num_fp16_res=0, conv_clamp=256.0, map_num_layers=2)
    # one jitted dispatch that the test then waits on: an eager op dispatched
    # while an interpret-mode kernel is still running can deadlock with the
    # kernel's own callbacks
    ref = jax.jit(lambda v, ws, c, uvc: g_j.apply(
        v, ws, c, {"uvcoords_image": uvc},
        method=lambda m, ws_, c_, v_: m.synthesis(ws_, c_, v_, noise_mode="const",
                                                  evaluation=True)))(
        variables, jnp.asarray(data["ws"]), jnp.asarray(data["c"]), jnp.asarray(data["uvc"]))

    G = _port(variables, neural_rendering_resolution=nrr, rendering_kwargs=FAST_KWARGS)
    ws, c, mesh = _inputs(data)
    with torch.no_grad():
        out = G.synthesis(ws, c, mesh, noise_mode="const", evaluation=True)

    def nchw(x):
        return np.transpose(np.asarray(x), (0, 3, 1, 2))

    for key, max_tol, mean_tol in [("image_raw", 3e-3, 3e-4), ("image_depth", 3e-3, 3e-4),
                                   ("image", 8e-3, 8e-4)]:
        err = np.abs(nchw(ref[key]) - out[key].numpy())
        assert np.isfinite(out[key].numpy()).all()
        assert err.max() < max_tol, f"{key}: max abs err {err.max()}"
        assert err.mean() < mean_tol, f"{key}: mean abs err {err.mean()}"


def test_flagship_rendering_kwargs_equal_jax():
    from invertavatar_tpu.flagship import FLAGSHIP_RENDERING_KWARGS as jax_kwargs
    from invertavatar_torch.flagship import FLAGSHIP_RENDERING_KWARGS as port_kwargs

    assert port_kwargs == jax_kwargs


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import invertavatar_torch\n"
        "for m in pkgutil.walk_packages(invertavatar_torch.__path__, 'invertavatar_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "sys.path.insert(0, '.')\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'invertavatar_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_flagship_generator_requires_cuda_unless_asked():
    from invertavatar_torch.flagship import flagship_generator

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError):
        flagship_generator(device="cuda")


def _sft_conditions(seed, backbone, B=1):
    """Seeded nonzero CS-SFT (scale, shift) pairs at every resolution of a
    backbone past 4² (NHWC numpy, for both sides), on half of each block's
    channels."""
    rng = np.random.RandomState(seed)
    out = {}
    for res in backbone.block_resolutions[1:]:
        half = getattr(backbone, f"b{res}").conv1.weight.shape[1] // 2
        out[res] = tuple((1.0 + s * rng.randn(B, res, res, half)).astype(np.float32)
                         if s else (0.1 * rng.randn(B, res, res, half)).astype(np.float32)
                         for s in (0.2, 0))
    return out


def _conditions_nchw(conds):
    return {r: tuple(torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1))) for a in sc)
            for r, sc in conds.items()}


def test_synthesis_with_condition_matches_jax(golden):
    """`synthesis_withCondition` with seeded nonzero CS-SFT conditions on both
    backbones against JAX on the same weights (the exact render path at a
    neural resolution of 16, both float32): image_raw, depth and image to
    1e-4 of their largest magnitude; the backbones' feature lists
    (`return_feats`) likewise; `only_image` returns the image alone."""
    from invertavatar_tpu.models.triplane import TriPlaneGenerator as JaxG

    variables, data = golden
    nrr = 16
    G = _port(variables, neural_rendering_resolution=nrr)
    tex_c = _sft_conditions(11, G.texture_backbone.synthesis)
    sta_c = _sft_conditions(12, G.backbone.synthesis)
    g_j = JaxG(z_dim=32, c_dim=25, w_dim=512, img_resolution=512, img_channels=3,
               sr_num_fp16_res=0, rendering_kwargs=TRIPLANE_RENDER_KWARGS,
               neural_rendering_resolution=nrr, channel_base=2048, channel_max=128,
               num_fp16_res=0, conv_clamp=256.0, map_num_layers=2)
    ref = jax.jit(lambda v, ws, c, uvc, tc, sc: g_j.apply(
        v, ws, c, {"uvcoords_image": uvc},
        method=lambda m, ws_, c_, mc: m.synthesis_withCondition(
            ws_, c_, mc, texture_feats_conditions=tc, static_feats_conditions=sc,
            noise_mode="const", evaluation=True, return_feats=True)))(
        variables, jnp.asarray(data["ws"]), jnp.asarray(data["c"]), jnp.asarray(data["uvc"]),
        tex_c, sta_c)
    ws, c, mesh = _inputs(data)
    with torch.no_grad():
        out = G.synthesis_withCondition(
            ws, c, mesh, texture_feats_conditions=_conditions_nchw(tex_c),
            static_feats_conditions=_conditions_nchw(sta_c), noise_mode="const",
            evaluation=True, return_feats=True)
        only = G.synthesis_withCondition(
            ws, c, mesh, texture_feats_conditions=_conditions_nchw(tex_c),
            static_feats_conditions=_conditions_nchw(sta_c), noise_mode="const",
            evaluation=True, only_image=True)
    assert sorted(out) == ["feature_image", "image", "image_depth", "image_raw", "static",
                           "texture", "triplane"]
    assert list(only) == ["image"]
    torch.testing.assert_close(only["image"], out["image"], rtol=0, atol=0)
    for key in ("image_raw", "image_depth", "image", "feature_image"):
        _assert_rel_nhwc(out[key], ref[key], 1e-4, key)
    for key in ("static", "texture"):
        assert len(out[key]) == len(ref[key])
        for i, (a, b) in enumerate(zip(out[key], ref[key])):
            _assert_rel_nhwc(a, b, 1e-4, f"{key}[{i}]")


def _assert_rel_nhwc(got, ref, rel, what):
    got = got.float().numpy()
    ref = np.moveaxis(np.asarray(ref, np.float32), -1, 1)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6)
    assert err < rel, (what, err)


def test_synthesis_with_no_conditions_is_synthesis(golden):
    variables, data = golden
    G = _port(variables, neural_rendering_resolution=16)
    ws, c, mesh = _inputs(data)
    with torch.no_grad():
        cond = G.synthesis_withCondition(ws, c, mesh, noise_mode="const", evaluation=True)
        ref = G.synthesis(ws, c, mesh, noise_mode="const", evaluation=True,
                          return_featmap=True)
    for key in ("image", "image_raw", "image_depth", "feature_image", "triplane"):
        torch.testing.assert_close(cond[key], ref[key], rtol=0, atol=0)


def _remat_step(G, data, remat, entry):
    """One grad-carrying render from `entry` (`synthesis_withTexture`, which
    checkpoints all three stages, or `synthesis`) with stratified samples,
    random backbone and SR noise drawn from a seeded generator; the loss,
    the gradients of ws and of every parameter, and the generator's state
    after the forward and after the backward."""
    ws, c, mesh = _inputs(data)
    ws = ws.clone().requires_grad_(True)
    G.zero_grad(set_to_none=True)
    gen = torch.Generator().manual_seed(3)
    over = {"remat_stages": remat}
    if entry == "withTexture":
        tex = G.texture_backbone.synthesis(ws, return_list=True, generator=gen)
        out = G.synthesis_withTexture(ws, tex, c, mesh, rendering_overrides=over, generator=gen)
    else:
        G.rendering_kwargs["remat_stages"] = remat
        out = G.synthesis(ws, c, mesh, generator=gen)
    after_forward = gen.get_state()
    w = torch.linspace(-1, 1, out["image"].numel()).reshape(out["image"].shape)
    loss = (out["image"] * w).sum() + out["image_raw"].square().mean() \
        + out["image_depth"].mean()
    loss.backward()
    grads = {"ws": ws.grad}
    grads.update({n: p.grad for n, p in G.named_parameters() if p.grad is not None})
    return loss.detach(), grads, after_forward, gen.get_state()


@pytest.mark.parametrize("entry", ["withTexture", "synthesis"])
def test_remat_stages_is_bitwise_the_plain_render(golden, entry):
    """`remat_stages` on and off give the same bits in the loss and in every
    gradient, with stratified samples and the backbones' and SR's noise
    drawn from an explicit generator, whose state the recompute leaves where
    the forward left it. A seeded 1024/64-wide generator with SR 2X to 128²
    (12+12 samples at 16²), on the golden's ws, camera and UV image."""
    from invertavatar_torch.flagship import init_flagship
    from invertavatar_torch.models import TriPlaneGenerator

    _, data = golden
    rk = dict(TRIPLANE_RENDER_KWARGS, det_stratified=False, superresolution_noise_mode="random",
              superresolution_module="x.SuperresolutionHybrid2X")
    G = init_flagship(TriPlaneGenerator(
        z_dim=32, c_dim=25, w_dim=512, img_resolution=128, img_channels=3, rendering_kwargs=rk,
        neural_rendering_resolution=16, channel_base=1024, channel_max=64, map_num_layers=2),
        seed=4).train()
    off = _remat_step(G, data, False, entry)
    on = _remat_step(G, data, True, entry)
    assert torch.equal(off[0], on[0]), (off[0], on[0])
    assert sorted(off[1]) == sorted(on[1])
    assert len(off[1]) > 100
    for name in off[1]:
        assert torch.equal(off[1][name], on[1][name]), name
    assert torch.equal(off[2], on[2]) and torch.equal(on[2], on[3])
