"""The port's e4e inversion stage on the CPU, held against the JAX package.

  * the renderer's kernel routes of the training step: `pallas_grad` (value
    and plane gradient against JAX `value_and_grad`, Pallas interpret mode),
    and the no-grad `pallas_exact` and unfused bf16 eval routes;
  * the e4e losses and `wd_losses` (with R1) on mock callables, values and
    gradients;
  * the weight bridge fills every key of the port's `InversionNet`;
  * one tiny e4e step of the port: `fast_grad="pallas"` matches
    `"structured"`, the generator stays fixed, the encoder and the latent
    discriminator move; `train_e4e` snapshots and resumes;
  * (slow) one tiny e4e step of the port against JAX
    `make_e4e_grad_programs(fast_igen_target="exact", fast_grad="pallas")`.

JAX references that reach a Pallas kernel run as one jitted dispatch that the
test then waits on (an eager op dispatched while an interpret kernel runs can
deadlock).
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from invertavatar_torch.models.encoders import InversionNet, LatentCodesDiscriminator
from invertavatar_torch.ops import plane_sample as ps
from invertavatar_torch.render.renderer import ImportanceRenderer
from invertavatar_torch.train import fast_render as port_fast
from invertavatar_torch.train import inversion as port_inv
from invertavatar_torch.train.loop_inversion import (
    InversionTrainConfig,
    e4e_trainable,
    make_e4e_grad_programs,
    masked_adam,
    train_e4e,
)
from invertavatar_torch.train.state import TrainState
from invertavatar_torch.utils.weights import jax_to_state_dict

# one intra-op thread: the suite runs test files in parallel worker processes
torch.set_num_threads(1)

# a tiny generator (as the JAX package's e4e tests use) with the flagship's
# deterministic SR noise, so that both frameworks render the same image
TINY_GEN_CFG = dict(
    z_dim=32, c_dim=25, w_dim=512, img_resolution=128, img_channels=3,
    rendering_kwargs={
        "superresolution_module": "invertavatar_tpu.models.superresolution.SuperresolutionHybrid2X",
        "c_gen_conditioning_zero": False, "c_scale": 1.0, "superresolution_noise_mode": "none",
        "decoder_lr_mul": 1.0, "sr_antialias": True, "depth_resolution": 6,
        "depth_resolution_importance": 6, "box_warp": 1.0,
    },
    neural_rendering_resolution=32, channel_base=1024, channel_max=64, map_num_layers=2,
)
# the validation run's loss weights (train_e4e_real.yaml with LPIPS and ID off)
E4E_WEIGHTS = port_inv.InversionLossWeights(l1=1.0, lpips=0.0, id=0.0, w_delta=0.001,
                                            w_regular=0.0, w_discriminator=0.01, raw_l1=1.0,
                                            tri=0.001)


def _l1(a, b):
    return (a - b).abs().mean()


# ------------------------------------------------------------------ renderer


def _render_setup(seed):
    from tests.test_pallas_interpret import _renderer_setup
    from tests.test_torch_fused_render import _port_setup

    rng = np.random.RandomState(seed)
    planes, decoder_j, params, ro, rd, opts = _renderer_setup(rng)
    _, decoder, t_params, ro_t, rd_t = _port_setup(planes, params, ro, rd)
    R = ro.shape[1]
    w_rgb = rng.randn(1, R, 8).astype(np.float32)
    w_dep = rng.randn(1, R, 1).astype(np.float32)
    return (np.asarray(planes), decoder_j, params, ro, rd, opts, decoder, t_params, ro_t, rd_t,
            w_rgb, w_dep)


def test_renderer_pallas_grad_matches_jax():
    """The student render route (`grad_overrides("pallas")`, evaluation off):
    B3 forward and the transpose backward, port plain versions against JAX
    interpret. Loss = Σ rgb·a + Σ depth·b; value 1e-4 relative, plane
    gradient 1e-4 (float32 sums in another order)."""
    from invertavatar_tpu.render.renderer import ImportanceRenderer as JaxRenderer
    from invertavatar_tpu.train.fast_render import grad_overrides

    (planes, decoder_j, params, ro, rd, opts, decoder, t_params, ro_t, rd_t, w_rgb,
     w_dep) = _render_setup(11)
    jopts = dict(opts, **grad_overrides("pallas", interpret=True))

    def loss_j(p):
        rgb, dep, _ = JaxRenderer()(p, decoder_j, ro, rd, jopts, evaluation=False,
                                    decoder_params=params)
        return jnp.sum(rgb * w_rgb) + jnp.sum(dep * w_dep)

    val_j, grad_j = jax.jit(jax.value_and_grad(loss_j))(jnp.asarray(planes))

    p = torch.from_numpy(planes.copy()).requires_grad_(True)
    ps.sample_planes_windowed.launches = ps.windowed_sample_transpose.launches = 0
    rgb, dep, _ = ImportanceRenderer()(p.permute(0, 1, 4, 2, 3), decoder, ro_t, rd_t,
                                       dict(opts, **port_fast.grad_overrides("pallas")),
                                       evaluation=False, decoder_params=t_params)
    val = (rgb * torch.from_numpy(w_rgb)).sum() + (dep * torch.from_numpy(w_dep)).sum()
    val.backward()
    assert ps.sample_planes_windowed.launches == 0  # CPU tensors: plain versions
    np.testing.assert_allclose(val.item(), float(val_j), rtol=1e-4)
    g, gj = p.grad.numpy(), np.asarray(grad_j)
    assert np.abs(gj).max() > 0
    np.testing.assert_allclose(g, gj, atol=1e-4 * np.abs(gj).max())


@pytest.mark.parametrize("route", ["exact", "bf16_unfused"])
def test_renderer_eval_b3_routes_match_jax(route):
    """The no-grad routes that run B3 alone: `nograd_overrides("exact")`
    (float32 payload, the Igen target) to float32 rounding (1e-4), and
    `pallas_coarse` with `fused_render=False` (bf16 payload) in the bf16
    fast path's band (rgb 2e-2, depth and weight sum 5e-2)."""
    from invertavatar_tpu.render.renderer import ImportanceRenderer as JaxRenderer

    (planes, decoder_j, params, ro, rd, opts, decoder, t_params, ro_t, rd_t, _,
     _) = _render_setup(12)
    if route == "exact":
        ov = port_fast.nograd_overrides("exact")
        tol = dict(rgb=1e-4, dep=1e-4, ws=1e-4)
    else:
        ov = dict(pallas_coarse=True, fused_render=False, pooled_importance=True)
        tol = dict(rgb=2e-2, dep=5e-2, ws=5e-2)
    jopts = dict(opts, **ov, pallas_interpret=True)
    rgb_j, dep_j, ws_j = jax.jit(lambda p: JaxRenderer()(
        p, decoder_j, ro, rd, jopts, evaluation=True, decoder_params=params))(jnp.asarray(planes))
    with torch.no_grad():
        rgb, dep, ws = ImportanceRenderer()(
            torch.from_numpy(planes.copy()).permute(0, 1, 4, 2, 3), decoder, ro_t, rd_t,
            dict(opts, **ov), evaluation=True, decoder_params=t_params)
    assert np.abs(rgb.numpy() - np.asarray(rgb_j)).max() < tol["rgb"]
    assert np.abs(dep.numpy() - np.asarray(dep_j)).max() < tol["dep"]
    assert np.abs(ws.numpy() - np.asarray(ws_j)).max() < tol["ws"]


# -------------------------------------------------------------------- losses


def _mock_models(rng):
    """Numpy weights of a mock encoder (A), mapping (M), renderer (Wi, Wf, Wt)
    and a latent discriminator (W1, W2), plus JAX and torch closures."""
    W = dict(A=rng.randn(3, 14 * 512) * 0.3, M=rng.randn(32, 14 * 512) * 0.1,
             Wi=rng.randn(512, 64 * 64 * 3) * 0.05, Wf=rng.randn(512, 32 * 32 * 8) * 0.05,
             Wt=rng.randn(512, 3 * 8 * 8 * 4) * 0.05, W1=rng.randn(512, 64) * 0.05,
             W2=rng.randn(64, 1) * 0.2)
    W = {k: v.astype(np.float32) for k, v in W.items()}

    def jax_fns(A, W1):
        def e4e(img):  # NHWC
            return (jnp.tanh(jnp.mean(img, axis=(1, 2))) @ A).reshape(-1, 14, 512)

        def mapping(z, c, truncation_psi=1.0):
            return (z @ W["M"]).reshape(-1, 14, 512) * truncation_psi

        def synth(ws, c, v):
            base = jnp.mean(ws, axis=1)
            B = ws.shape[0]
            return {"image": jnp.tanh(base @ W["Wi"]).reshape(B, 64, 64, 3),
                    "feature_image": (base @ W["Wf"]).reshape(B, 32, 32, 8),
                    "triplane": (base @ W["Wt"]).reshape(B, 3, 8, 8, 4)}

        def wd(w):
            h = w @ W1
            return jnp.where(h >= 0, h, 0.2 * h) @ W["W2"]

        return e4e, mapping, synth, wd

    def torch_fns(A, W1):
        t = {k: torch.from_numpy(v) for k, v in W.items()}

        def e4e(img):  # NCHW
            return (torch.tanh(img.mean(dim=(2, 3))) @ A).reshape(-1, 14, 512)

        def mapping(z, c, truncation_psi=1.0):
            return (z @ t["M"]).reshape(-1, 14, 512) * truncation_psi

        def synth(ws, c, v):
            base = ws.mean(dim=1)
            B = ws.shape[0]
            return {
                "image": torch.tanh(base @ t["Wi"]).reshape(B, 64, 64, 3).permute(0, 3, 1, 2),
                "feature_image": (base @ t["Wf"]).reshape(B, 32, 32, 8).permute(0, 3, 1, 2),
                "triplane": (base @ t["Wt"]).reshape(B, 3, 8, 8, 4).permute(0, 1, 4, 2, 3)}

        def wd(w):
            return torch.nn.functional.leaky_relu(w @ W1, 0.2) @ t["W2"]

        return e4e, mapping, synth, wd

    return W, jax_fns, torch_fns


def test_e4e_losses_match_jax():
    """Ireal, Igen and Ireal_novel with every term on, against JAX: values and
    the gradient with respect to the mock encoder's weight, 1e-4 relative."""
    from invertavatar_tpu.train import inversion as jinv

    rng = np.random.RandomState(13)
    W, jax_fns, torch_fns = _mock_models(rng)
    wkw = dict(l1=1.0, lpips=0.5, id=0.3, w_delta=0.01, w_regular=0.1, w_discriminator=0.05,
               raw_l1=1.0, tri=0.1, lr_lpips=0.2, multiview_id=0.4)
    jw, tw = jinv.InversionLossWeights(**wkw), port_inv.InversionLossWeights(**wkw)
    real = rng.rand(2, 256, 256, 3).astype(np.float32) * 2 - 1
    z = rng.randn(2, 32).astype(np.float32)
    c = rng.randn(2, 25).astype(np.float32)
    lat = (rng.randn(1, 512) * 0.1).astype(np.float32)

    def lp(a, b):
        return ((a - b) ** 2).mean()

    def idf(a, b):
        return a.mean() * b.mean()

    def jax_total(A):
        e4e, mapping, synth, wd = jax_fns(A, jnp.asarray(W["W1"]))
        tr, ar = jinv.e4e_ireal_loss(e4e, synth, wd, lp, idf, jw, lat, real, c, None)
        tg, ag = jinv.e4e_igen_loss(e4e, mapping, synth, wd, lp, jw, lat, z, c, None)
        tn, an = jinv.e4e_ireal_novel_loss(e4e, synth, idf, jw, real, c * 0.5, None)
        return tr + tg + tn, (ar, ag, an)

    (tot_j, auxes_j), grad_j = jax.jit(jax.value_and_grad(jax_total, has_aux=True))(
        jnp.asarray(W["A"]))

    A = torch.from_numpy(W["A"]).requires_grad_(True)
    e4e, mapping, synth, wd = torch_fns(A, torch.from_numpy(W["W1"]))
    real_t = torch.from_numpy(real).permute(0, 3, 1, 2)
    z_t, c_t, lat_t = torch.from_numpy(z), torch.from_numpy(c), torch.from_numpy(lat)
    tr, ar = port_inv.e4e_ireal_loss(e4e, synth, wd, lp, idf, tw, lat_t, real_t, c_t, None)
    tg, ag = port_inv.e4e_igen_loss(e4e, mapping, synth, wd, lp, tw, lat_t, z_t, c_t, None)
    tn, an = port_inv.e4e_ireal_novel_loss(e4e, synth, idf, tw, real_t, c_t * 0.5, None)
    total = tr + tg + tn
    total.backward()
    for aux_t, aux_j in zip((ar, ag, an), auxes_j):
        assert sorted(aux_t) == sorted(aux_j)
        for k in aux_t:
            np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]), rtol=1e-4, atol=1e-7,
                                       err_msg=k)
    np.testing.assert_allclose(float(total), float(tot_j), rtol=1e-4)
    gj = np.asarray(grad_j)
    np.testing.assert_allclose(A.grad.numpy(), gj, atol=1e-4 * np.abs(gj).max())


@pytest.mark.parametrize("do_r1", [False, True])
def test_wd_losses_match_jax(do_r1):
    """The latent discriminator's loss (R1 through a double backward) and its
    gradient with respect to the first layer, 1e-4 relative."""
    from invertavatar_tpu.train import inversion as jinv

    rng = np.random.RandomState(14)
    W, jax_fns, torch_fns = _mock_models(rng)
    fake = rng.randn(2, 14, 512).astype(np.float32)
    real = rng.randn(2, 14, 512).astype(np.float32)

    def jax_total(W1):
        wd = jax_fns(jnp.asarray(W["A"]), W1)[3]
        return jinv.wd_losses(wd, fake, real, jinv.InversionLossWeights(), do_r1)

    (tot_j, aux_j), grad_j = jax.jit(jax.value_and_grad(jax_total, has_aux=True))(
        jnp.asarray(W["W1"]))

    W1 = torch.from_numpy(W["W1"]).requires_grad_(True)
    wd = torch_fns(torch.from_numpy(W["A"]), W1)[3]
    total, aux = port_inv.wd_losses(wd, torch.from_numpy(fake), torch.from_numpy(real),
                                    port_inv.InversionLossWeights(), do_r1)
    total.backward()
    assert sorted(aux) == sorted(aux_j) and ("wd_r1" in aux) == do_r1
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(aux_j[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(total), float(tot_j), rtol=1e-4)
    gj = np.asarray(grad_j)
    np.testing.assert_allclose(W1.grad.numpy(), gj, atol=1e-4 * np.abs(gj).max())


# -------------------------------------------------------------- bridge, step


def _jax_e4e_variables(seed=0):
    """A JAX `InversionNet` variable tree (tiny trunk) with seeded values:
    the encoder from flax init with randomised BatchNorm statistics, the
    generator filled with N(0, 1)·0.1 by shape (no generator forward runs)."""
    from invertavatar_tpu.models.encoders.uvnet import InversionNet as JaxNet
    from tests.test_torch_encoders import _randomize

    net = JaxNet(generator_cfg=TINY_GEN_CFG, trunk_layers_n=8)
    rngs = {"params": jax.random.PRNGKey(seed)}
    enc = net.init(rngs, jnp.zeros((1, 256, 256, 3)), method=lambda m, x: m.encode(x))
    enc = _randomize(enc, seed + 1)
    z = jnp.zeros((1, 32))
    c = jnp.zeros((1, 25))
    v = {"uvcoords_image": jnp.zeros((1, 256, 256, 3))}
    shapes = jax.eval_shape(lambda: net.init(
        {"params": jax.random.PRNGKey(0), "buffers": jax.random.PRNGKey(1),
         "noise": jax.random.PRNGKey(2), "ray": jax.random.PRNGKey(3)},
        z, c, v, method=lambda m, z, c, v: m.generator(z, c, v)))
    npr = np.random.RandomState(seed + 2)
    gen = jax.tree_util.tree_map(
        lambda s: (npr.standard_normal(s.shape) * 0.1).astype(np.float32), shapes)
    return net, {
        "params": {**enc["params"], "generator": gen["params"]["generator"]},
        "buffers": {**enc["buffers"], "generator": gen["buffers"]["generator"]},
        "batch_stats": enc["batch_stats"],
    }


# Flax creates a module's variables only when it runs: the texture and face
# backbones' own mapping networks never do (all three share `backbone`'s), so
# the JAX tree has no entry for them while the port's modules hold them.
_NEVER_RUN = ("generator.texture_backbone.mapping.", "generator.face_backbone.mapping.")


def _port_net(variables):
    net = InversionNet(TINY_GEN_CFG, trunk_layers_n=8)
    missing, unexpected = net.load_state_dict(jax_to_state_dict(variables), strict=False)
    assert unexpected == [] and all(k.startswith(_NEVER_RUN) for k in missing), missing
    return net


def test_bridge_fills_inversion_net():
    """Every key of the port's `InversionNet` that JAX creates (generator,
    encoder with its BatchNorm statistics, latent_avg, black_uv_bg) comes from
    the JAX tree with its shape and layout."""
    _, variables = _jax_e4e_variables()
    sd = jax_to_state_dict(variables)
    port = InversionNet(TINY_GEN_CFG, trunk_layers_n=8)
    expected = {k: tuple(v.shape) for k, v in port.state_dict().items()
                if not k.startswith(_NEVER_RUN)}
    assert {k: tuple(v.shape) for k, v in sd.items()} == expected
    assert any(k.endswith("running_var") for k in sd)
    port = _port_net(variables)
    np.testing.assert_array_equal(
        port.black_uv_bg.numpy(), np.transpose(variables["buffers"]["black_uv_bg"], (0, 3, 1, 2)))
    np.testing.assert_array_equal(port.latent_avg.numpy(), variables["buffers"]["latent_avg"])


def _batch(seed=0, res=256):
    from invertavatar_torch.flagship import example_inputs

    rng = np.random.RandomState(seed)
    _, c, uvc = example_inputs(1)
    return {"image": rng.randn(1, 3, res, res).astype(np.float32), "c": c,
            "v": {"uvcoords_image": uvc}, "z": rng.randn(1, 32).astype(np.float32)}


def _torch_batch(b):
    return {k: (_torch_batch(v) if isinstance(v, dict) else torch.from_numpy(v))
            for k, v in b.items()}


def _port_step(net_sd, fast_grad, batch):
    net = InversionNet(TINY_GEN_CFG, trunk_layers_n=8)
    net.load_state_dict(net_sd)
    torch.manual_seed(0)
    wd = LatentCodesDiscriminator()
    state = TrainState(net, masked_adam(net, 1e-4, e4e_trainable))
    wd_state = TrainState(wd, torch.optim.Adam(wd.parameters(), lr=2e-5))
    wd0 = {k: v.clone() for k, v in wd.state_dict().items()}
    step = make_e4e_grad_programs(net, _l1, None, E4E_WEIGHTS, fast_igen_target="exact",
                                  fast_grad=fast_grad)
    aux = step(state, wd_state, batch, do_wd_reg=True)
    return aux, net.state_dict(), wd0, wd.state_dict()


def test_e4e_step_pallas_matches_structured():
    """One tiny e4e step through B3 and its transpose (`fast_grad="pallas"`)
    lands where the `F.grid_sample` route (`"structured"`) does: losses to
    1e-5 relative, parameters to 1e-6 (one Adam step of lr 1e-4 moves a
    parameter by at most 1e-4). The generator is unchanged; the encoder and
    the latent discriminator moved."""
    torch.manual_seed(0)
    net = InversionNet(TINY_GEN_CFG, trunk_layers_n=8)
    from invertavatar_torch.flagship import init_flagship

    init_flagship(net.generator, seed=0)
    sd0 = {k: v.clone() for k, v in net.state_dict().items()}
    batch = _torch_batch(_batch())
    ps.sample_planes_windowed.launches = 0
    aux_s, sd_s, _, _ = _port_step(sd0, "structured", batch)
    aux_p, sd_p, wd0, wd1 = _port_step(sd0, "pallas", batch)
    assert sorted(aux_s) == sorted(aux_p)
    for k in aux_s:
        assert torch.isfinite(aux_p[k]), k
        np.testing.assert_allclose(float(aux_p[k]), float(aux_s[k]), rtol=1e-5, atol=1e-8,
                                   err_msg=k)
    for k in sd0:
        assert torch.allclose(sd_p[k], sd_s[k], rtol=0, atol=1e-6), k
        if k.startswith("generator."):
            assert torch.equal(sd_p[k], sd0[k]), k
    assert max((sd_p[k] - sd0[k]).abs().max() for k in sd0 if k.startswith("encoder.")) > 0
    assert max((wd1[k] - wd0[k]).abs().max() for k in wd0) > 0
    assert ps.sample_planes_windowed.launches == 0


@pytest.fixture
def _drop_tmp_path(tmp_path):
    """Removes `tmp_path` after the test: an e4e snapshot holds the encoder
    and its Adam moments, about 2 GB, and a test session keeps its temporary
    directories."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.usefixtures("_drop_tmp_path")
def test_train_e4e_snapshot_and_resume(tmp_path):
    """The driver runs a step on the CPU, writes its snapshot, and a second
    run resumes from it (counters and parameters restored) and takes one more
    step."""
    torch.manual_seed(0)
    net = InversionNet(TINY_GEN_CFG, trunk_layers_n=8)
    from invertavatar_torch.flagship import init_flagship

    init_flagship(net.generator, seed=0)
    b = _batch(res=128)

    def batches():
        while True:
            yield b

    cfg = InversionTrainConfig(run_dir=str(tmp_path), total_kimg=1, batch_size=1,
                               kimg_per_tick=1, weights=dataclasses.replace(E4E_WEIGHTS))
    state, _ = train_e4e(net, LatentCodesDiscriminator(), batches(), cfg, _l1, max_steps=1,
                         device="cpu")
    snap = tmp_path / "snapshot-00000001.pt"
    assert snap.exists() and (tmp_path / "stats.jsonl").exists()
    enc = {k: v.clone() for k, v in state.module.state_dict().items()}

    net2 = InversionNet(TINY_GEN_CFG, trunk_layers_n=8)
    cfg2 = dataclasses.replace(cfg, run_dir=str(tmp_path / "resumed"))
    state2, _ = train_e4e(net2, LatentCodesDiscriminator(), batches(), cfg2, _l1, max_steps=2,
                          resume_path=str(snap), device="cpu")
    assert (tmp_path / "resumed" / "snapshot-00000002.pt").exists()
    # Adam's moments came back with the parameters: the resumed step is its second
    assert all(float(st["step"]) == 2 for st in state2.opt.state.values())
    sd2 = state2.module.state_dict()
    for k in enc:
        if k.startswith("generator."):
            assert torch.equal(sd2[k], enc[k]), k
    assert max((sd2[k] - enc[k]).abs().max() for k in enc if k.startswith("encoder.")) > 0


@pytest.mark.slow
def test_e4e_step_matches_jax():
    """One tiny e4e step of the port against JAX `make_e4e_grad_programs`
    with the same fast paths (Igen target through B3 fp32, students through
    B3 and its transpose; JAX in Pallas interpret mode), from the same
    weights. Losses agree to 1e-3 relative. Adam's first step moves a
    parameter by lr·g/(|g| + ε), about ±lr whatever |g|, so where a gradient
    is float32 noise around zero the two sides may step apart by up to 2·lr:
    the updated encoder parameters agree to 2e-6 on all but 0.1% of them and
    to the learning rate (1e-4) on every one; the latent discriminator to its
    learning rate (2e-5); everything else is unchanged on both sides. Slow:
    the JAX step compiles for about two minutes."""
    import optax

    from invertavatar_tpu.models.encoders.e4e import LatentCodesDiscriminator as JaxWD
    from invertavatar_tpu.train import inversion as jinv
    from invertavatar_tpu.train.loop_inversion import (
        e4e_trainable as j_trainable,
        make_e4e_grad_programs as j_programs,
        masked_adam as j_adam,
    )
    from invertavatar_tpu.train.state import TrainState as JState

    jnet, variables = _jax_e4e_variables(seed=3)
    raw = _batch(seed=4)
    jbatch = {"image": jnp.asarray(np.transpose(raw["image"], (0, 2, 3, 1))),
              "c": jnp.asarray(raw["c"]), "z": jnp.asarray(raw["z"]),
              "v": {"uvcoords_image": jnp.asarray(raw["v"]["uvcoords_image"])}}
    jw = jinv.InversionLossWeights(**dataclasses.asdict(E4E_WEIGHTS))
    params = variables["params"]
    buffers = {"buffers": variables["buffers"], "batch_stats": variables["batch_stats"]}
    tx = j_adam(1e-4, j_trainable)
    wd = JaxWD()
    wd_vars = wd.init(jax.random.PRNGKey(5), jnp.zeros((1, 512)))
    wd_tx = optax.adam(2e-5)
    jstep = j_programs(jnet, wd, lambda a, b: jnp.mean(jnp.abs(a - b)), None, tx, wd_tx, jw,
                       fast_igen_target="exact", fast_grad="pallas", fast_interpret=True)
    jstate = JState(params, tx.init(params), buffers)
    jwd = JState(wd_vars["params"], wd_tx.init(wd_vars["params"]), {})
    new_j, new_jwd, aux_j = jstep(jstate, jwd, jbatch, jax.random.PRNGKey(6), do_wd_reg=True)
    jax.block_until_ready(new_j.params)

    net = _port_net(variables)
    wd_t = LatentCodesDiscriminator()
    wd_t.load_state_dict(jax_to_state_dict(wd_vars), strict=True)
    state = TrainState(net, masked_adam(net, 1e-4, e4e_trainable))
    wd_state = TrainState(wd_t, torch.optim.Adam(wd_t.parameters(), lr=2e-5))
    step = make_e4e_grad_programs(net, _l1, None, E4E_WEIGHTS, fast_igen_target="exact",
                                  fast_grad="pallas")
    aux = step(state, wd_state, _torch_batch(raw), do_wd_reg=True)

    assert sorted(aux) == sorted(aux_j)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(aux_j[k]), rtol=1e-3, atol=1e-7,
                                   err_msg=k)
    new_sd = jax_to_state_dict({"params": new_j.params, **new_j.buffers})
    port_sd = net.state_dict()
    enc = torch.cat([(port_sd[k] - v).abs().flatten() for k, v in new_sd.items()
                     if k.startswith("encoder.")])
    assert enc.max() < 1e-4, enc.max()
    assert (enc > 2e-6).float().mean() < 1e-3, (enc > 2e-6).float().mean()
    for k, v in new_sd.items():
        if not k.startswith("encoder."):
            assert torch.equal(port_sd[k], v), k
    new_wd = jax_to_state_dict({"params": new_jwd.params})
    wd_diff = max((v - new_wd[k]).abs().max() for k, v in wd_t.state_dict().items())
    assert wd_diff < 2e-5, wd_diff
