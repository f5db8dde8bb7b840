"""The port's one-shot inversion training stage on the CPU, held against the
JAX package.

  * the three one-shot losses and their gradients on mock closures (the
    mask composite, R1, `texture > 0`, the ID term on the un-resized fake);
  * `oneshot_phase_schedule`;
  * one Ireal, one Igen and one Dgen (R1) step of a tiny one-shot network
    against JAX `make_oneshot_train_step`, under the deterministic overrides
    (`fast_igen_target="exact"`, `fast_grad="structured"`); the ConvGRU
    U-Nets in Tier-1, the SegFormer decoders (`slow`);
  * one step of the tiny network moves the scheduled U-Net alone;
    `train_oneshot` resumes bit for bit from its snapshot;
  * `cli/train_inversion.py` for the `oneshot` and `e4e` stages on a forged
    generator pickle and a tiny dataset.

The tiny network is the JAX package's one-shot test set-up
(`tests/test_loop_inversion.py::_tiny_oneshot_setup`): the tiny generator
(128² images, 32² neural render, 6+6 samples), tiny IR-SE trunks, 256²
frames, a dual discriminator at 128². Its weights come from JAX through
`utils/weights.py`; the discriminator's 1-D parameters are perturbed, since
with zero biases and the stage's zero cameras its camera map, and so every
logit, is zero.
"""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from invertavatar_torch.models.discriminator import DualDiscriminator
from invertavatar_torch.ops.resize import resize_bilinear
from invertavatar_torch.train import inversion as port_inv
from invertavatar_torch.train.loop_inversion import (
    InversionTrainConfig,
    make_oneshot_train_step,
    masked_adam,
    oneshot_phase_schedule,
    oneshot_tex_trainable,
    oneshot_tri_trainable,
    train_oneshot,
)
from invertavatar_torch.train.state import TrainState
from invertavatar_torch.utils.weights import jax_to_state_dict
from tests.test_torch_checkpoint import reference_pickler  # noqa: F401  (a fixture)
from tests.test_torch_encoders import _randomize
from tests.test_torch_fewshot import _inputs, _nchw
from tests.test_torch_oneshot import _jax_net, _port_net

# one intra-op thread: the suite runs test files in parallel worker processes
torch.set_num_threads(1)

# tests/test_loop_inversion.py:632, the JAX package's one-shot step weights
OS_WEIGHTS = dict(l1=1.0, lpips=0.0, id=0.0, raw_l1=1.0, tri=0.001, texture=0.001, adv=0.01)
D_CFG = dict(c_dim=25, img_resolution=128, img_channels=6, channel_base=1024, channel_max=64,
             num_fp16_res=0)


def _l1(a, b):
    return (a - b).abs().mean()


# -------------------------------------------------------------------- losses


def _mock_world(rng, H):
    """Numpy weights of a mock inverter, generator and dual discriminator,
    and their JAX (NHWC) and torch (NCHW) closures. The inverter adds a
    learned bias to its input; the target render is fixed; D is linear in
    simple statistics of both images and the camera."""
    W = dict(bias=rng.randn(3).astype(np.float32) * 0.1,
             gen=rng.uniform(-1, 1, (1, H, H, 3)).astype(np.float32),
             feat=rng.randn(1, 32, 32, 6).astype(np.float32),
             tri=rng.randn(1, 3, 8, 8, 4).astype(np.float32),
             tex=rng.randn(1, 4, 4, 2).astype(np.float32),
             D=rng.randn(5, 1).astype(np.float32) * 0.3)

    def jax_fns(bias, Dw):
        def inv_forward(x, c, v, return_feats):
            img = x["image"][..., :3] + bias
            return {"image": img,
                    "feature_image": jnp.tile(jax.image.resize(img, (1, 32, 32, 3), "linear"),
                                              (1, 1, 1, 2)) * 0.9,
                    "triplane": W["tri"] + bias[0], "texture": [W["tex"] + bias[1]]}

        def gen_mapping(z, c, truncation_psi=1.0):
            return jnp.zeros((1, 14, 16)) + truncation_psi

        def gen_synth(ws, c, v):
            return {"image": jnp.asarray(W["gen"]), "feature_image": jnp.asarray(W["feat"]),
                    "triplane": jnp.asarray(W["tri"]), "texture": [jnp.asarray(W["tex"])]}

        def d_apply(img, c):
            f = jnp.stack([jnp.mean(img["image"], axis=(1, 2, 3)),
                           jnp.mean(img["image_raw"], axis=(1, 2, 3)),
                           jnp.mean(jnp.square(img["image"]), axis=(1, 2, 3)),
                           jnp.mean(jnp.square(img["image_raw"]), axis=(1, 2, 3)),
                           jnp.mean(c, axis=1) + 1.0], axis=1)
            return f @ Dw

        return inv_forward, gen_mapping, gen_synth, d_apply

    def torch_fns(bias, Dw):
        t = {k: _nchw(W[k]) for k in ("gen", "feat", "tex")}

        def inv_forward(x, c, v, return_feats):
            img = x["image"][:, :3] + bias[None, :, None, None]
            feat = resize_bilinear(img, (32, 32), antialias=True)
            return {"image": img, "feature_image": torch.cat([feat, feat], dim=1) * 0.9,
                    "triplane": torch.from_numpy(W["tri"]).permute(0, 1, 4, 2, 3) + bias[0],
                    "texture": [t["tex"] + bias[1]]}

        def gen_mapping(z, c, truncation_psi=1.0):
            return torch.zeros((1, 14, 16)) + truncation_psi

        def gen_synth(ws, c, v):
            return {"image": t["gen"], "feature_image": t["feat"],
                    "triplane": torch.from_numpy(W["tri"]).permute(0, 1, 4, 2, 3),
                    "texture": [t["tex"]]}

        def d_apply(img, c):
            f = torch.stack([img["image"].mean(dim=(1, 2, 3)), img["image_raw"].mean(dim=(1, 2, 3)),
                             img["image"].square().mean(dim=(1, 2, 3)),
                             img["image_raw"].square().mean(dim=(1, 2, 3)),
                             c.mean(dim=1) + 1.0], dim=1)
            return f @ Dw

        return inv_forward, gen_mapping, gen_synth, d_apply

    return W, jax_fns, torch_fns


def _lp(a, b):
    return ((a - b) ** 2).mean()


def _id(a, b):
    return a.mean() * b.mean() + (a ** 2).mean() * 0.1


@pytest.mark.parametrize("mask", [False, True])
def test_oneshot_losses_match_jax(mask):
    """Igen (every term on, `texture > 0`, the adversarial term) and Ireal
    (with and without a mask channel, which composites the fake onto the
    real background), values and the gradient with respect to the mock
    inverter's bias, 1e-4 relative (the e4e losses' bar: both sides resize
    64² images to 256² and sum them in other orders)."""
    from invertavatar_tpu.train import inversion as jinv

    rng = np.random.RandomState(21)
    W, jax_fns, torch_fns = _mock_world(rng, 64)
    wkw = dict(l1=1.0, lpips=0.5, id=0.3, raw_l1=1.0, tri=0.2, texture=0.4, lr_lpips=0.2,
               adv=0.05)
    jw, tw = jinv.InversionLossWeights(**wkw), port_inv.InversionLossWeights(**wkw)
    real = rng.uniform(-1, 1, (1, 64, 64, 4 if mask else 3)).astype(np.float32)
    if mask:
        real[..., 3] = rng.uniform(0, 1, (1, 64, 64))
    c = rng.randn(1, 25).astype(np.float32)
    uv = np.zeros((1, 256, 256, 6), np.float32)

    def jax_total(bias):
        inv, gm, gs, d = jax_fns(bias, jnp.asarray(W["D"]))
        tg, ag = jinv.oneshot_igen_loss(inv, gm, gs, d, _lp, _id, jw, jnp.zeros((1, 16)), c,
                                        None, uv)
        tr, ar = jinv.oneshot_ireal_loss(inv, d, _lp, _id, jw, {"image": real, "uv": uv}, c,
                                         None)
        return tg + tr, (ag, ar)

    (tot_j, auxes_j), grad_j = jax.jit(jax.value_and_grad(jax_total, has_aux=True))(
        jnp.asarray(W["bias"]))

    bias = torch.from_numpy(W["bias"]).requires_grad_(True)
    inv, gm, gs, d = torch_fns(bias, torch.from_numpy(W["D"]))
    c_t = torch.from_numpy(c)
    tg, ag = port_inv.oneshot_igen_loss(inv, gm, gs, d, _lp, _id, tw, torch.zeros((1, 16)), c_t,
                                        None, _nchw(uv))
    tr, ar = port_inv.oneshot_ireal_loss(inv, d, _lp, _id, tw,
                                         {"image": _nchw(real), "uv": _nchw(uv)}, c_t, None)
    total = tg + tr
    total.backward()
    for aux_t, aux_j in zip((ag, ar), auxes_j):
        assert sorted(aux_t) == sorted(aux_j)
        for k in aux_t:
            np.testing.assert_allclose(float(aux_t[k].detach()), float(aux_j[k]), rtol=1e-4, atol=1e-7,
                                       err_msg=k)
    assert "texture" in ag and "adv" in ar and "id" in ar
    np.testing.assert_allclose(total.item(), float(tot_j), rtol=1e-4)
    gj = np.asarray(grad_j)
    np.testing.assert_allclose(bias.grad.numpy(), gj, atol=1e-4 * np.abs(gj).max())


def test_ireal_id_term_takes_the_unresized_fake_as_jax_does():
    """JAX `train/inversion.py:280` hands `id_fn` the fake at its own
    resolution where the real side is resized to 256² (e4e resizes both);
    the port does the same: at 512² the ID term sees a 256² real and a 512²
    fake, and equals JAX's value."""
    from invertavatar_tpu.train import inversion as jinv

    rng = np.random.RandomState(22)
    W, jax_fns, torch_fns = _mock_world(rng, 512)
    real = rng.uniform(-1, 1, (1, 512, 512, 3)).astype(np.float32)
    c = rng.randn(1, 25).astype(np.float32)
    wkw = dict(l1=0.0, lpips=0.0, id=1.0, raw_l1=0.0)
    seen = {"jax": [], "port": []}

    def id_rec(side):
        def fn(a, b):
            seen[side].append((tuple(a.shape), tuple(b.shape)))
            return _id(a, b)
        return fn

    inv, _, _, _ = jax_fns(jnp.asarray(W["bias"]), jnp.asarray(W["D"]))
    _, aux_j = jinv.oneshot_ireal_loss(inv, None, _lp, id_rec("jax"),
                                       jinv.InversionLossWeights(**wkw),
                                       {"image": jnp.asarray(real), "uv": None}, c, None)
    inv, _, _, _ = torch_fns(torch.from_numpy(W["bias"]), torch.from_numpy(W["D"]))
    _, aux = port_inv.oneshot_ireal_loss(inv, None, _lp, id_rec("port"),
                                         port_inv.InversionLossWeights(**wkw),
                                         {"image": _nchw(real), "uv": None},
                                         torch.from_numpy(c), None)
    assert seen["jax"] == [((1, 256, 256, 3), (1, 512, 512, 3))]
    assert seen["port"] == [((1, 3, 256, 256), (1, 3, 512, 512))]
    np.testing.assert_allclose(float(aux["id"]), float(aux_j["id"]), rtol=1e-5)


@pytest.mark.parametrize("do_r1", [False, True])
def test_oneshot_d_loss_matches_jax(do_r1):
    """The dual discriminator's loss (R1 over both images by double
    backward, weighted adv_r1_gamma / 2) and its gradient with respect to
    the mock D's weights, 1e-5 relative."""
    from invertavatar_tpu.train import inversion as jinv

    rng = np.random.RandomState(23)
    W, jax_fns, torch_fns = _mock_world(rng, 16)
    fake = {"image": rng.rand(2, 16, 16, 3).astype(np.float32),
            "image_raw": rng.rand(2, 8, 8, 3).astype(np.float32)}
    real = {"image": rng.rand(2, 16, 16, 3).astype(np.float32),
            "image_raw": rng.rand(2, 8, 8, 3).astype(np.float32)}
    c = rng.randn(2, 25).astype(np.float32)
    w = dict(adv_r1_gamma=3.0)

    def jax_total(Dw):
        d = jax_fns(jnp.asarray(W["bias"]), Dw)[3]
        return jinv.oneshot_d_loss(d, fake, real, c, jinv.InversionLossWeights(**w), do_r1)

    (tot_j, aux_j), grad_j = jax.jit(jax.value_and_grad(jax_total, has_aux=True))(
        jnp.asarray(W["D"]))
    Dw = torch.from_numpy(W["D"]).requires_grad_(True)
    d = torch_fns(torch.from_numpy(W["bias"]), Dw)[3]
    total, aux = port_inv.oneshot_d_loss(d, {k: _nchw(v) for k, v in fake.items()},
                                         {k: _nchw(v) for k, v in real.items()},
                                         torch.from_numpy(c), port_inv.InversionLossWeights(**w),
                                         do_r1)
    total.backward()
    assert sorted(aux) == sorted(aux_j) and ("d_r1" in aux) == do_r1
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(aux_j[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(total.item(), float(tot_j), rtol=1e-5)
    gj = np.asarray(grad_j)
    np.testing.assert_allclose(Dw.grad.numpy(), gj, atol=1e-5 * np.abs(gj).max())


def test_phase_schedule_matches_jax():
    from invertavatar_tpu.train.loop_inversion import oneshot_phase_schedule as j_schedule

    for interval in (4, 16):
        assert [oneshot_phase_schedule(i, interval) for i in range(40)] == \
            [j_schedule(i, interval) for i in range(40)]


# ------------------------------------------------------------ the step, mocked


# a mock one-shot network, the same algebra in flax (NHWC) and torch (NCHW),
# small enough for the JAX step to compile in seconds: z [B,8] -> ws [B,4,8];
# the "generator" renders 16² images, 8² feature images, tri-planes and a
# texture list from the mean code; the "encoder" codes the frame; the two
# "U-Nets" shift the code (texture: the texture list and the code, tri-plane:
# the code) from the e4e render's residual
MOCK_SHAPES = dict(wm=(8, 32), wi=(8, 768), wf=(8, 256), wt=(8, 96), wx=(8, 32), we=(3, 32),
                   w_tex=(9, 8), w_tri=(6, 8), wo=(8, 32))
MOCK_OWNERS = dict(wm="generator", wi="generator", wf="generator", wt="generator",
                   wx="generator", we="encoder", w_tex="unet_encoder.texture_unet",
                   w_tri="unet_encoder.triplane_unet", wo="unet_encoder.texture_unet")


def _mock_weights(seed):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*shape) / np.sqrt(shape[0])).astype(np.float32)
            for k, shape in MOCK_SHAPES.items()}


def _jax_mock_net():
    import flax.linen as fnn

    class Holder(fnn.Module):
        names: tuple

        def setup(self):
            for k in self.names:
                setattr(self, k, self.param(k, fnn.initializers.zeros, MOCK_SHAPES[k]))

    class Gen(Holder):
        def mapping(self, z, c, truncation_psi=1.0):
            return jnp.tanh(z @ self.wm).reshape(-1, 4, 8) * truncation_psi

        def synthesis(self, ws, c, v, return_featmap=False, **_):
            h = jnp.mean(ws, axis=1)
            B = h.shape[0]
            out = {"image": jnp.tanh(h @ self.wi).reshape(B, 16, 16, 3),
                   "feature_image": (h @ self.wf).reshape(B, 8, 8, 4),
                   "triplane": (h @ self.wt).reshape(B, 3, 4, 4, 2)}
            if return_featmap:
                out["texture"] = [(h @ self.wx).reshape(B, 4, 4, 2)]
            return out

    class Pair(fnn.Module):
        def setup(self):
            self.texture_unet = Holder(("w_tex", "wo"))
            self.triplane_unet = Holder(("w_tri",))

    class Net(fnn.Module):
        def setup(self):
            self.generator = Gen(("wm", "wi", "wf", "wt", "wx"))
            self.encoder = Holder(("we",))
            self.unet_encoder = Pair()

        def __call__(self, x, cam, v, return_feats=False, nograd_render=None,
                     grad_render=None):
            sg = jax.lax.stop_gradient
            img = x["image"][..., :3]
            ws = sg(jnp.tanh(jnp.mean(img, axis=(1, 2)) @ self.encoder.we).reshape(-1, 4, 8))
            pre = sg(self.generator.synthesis(ws, cam, v, return_featmap=True))
            delta = pre["image"] - img
            tex_u, tri_u = self.unet_encoder.texture_unet, self.unet_encoder.triplane_unet
            off_t = jnp.tanh(jnp.concatenate(
                [jnp.mean(delta, axis=(1, 2)), jnp.mean(x["uv"], axis=(1, 2))], -1) @ tex_u.w_tex)
            off_s = jnp.tanh(jnp.concatenate(
                [jnp.mean(img, axis=(1, 2)), jnp.mean(delta, axis=(1, 2))], -1) @ tri_u.w_tri)
            out = self.generator.synthesis(ws + 0.5 * off_t[:, None] + off_s[:, None], cam, v)
            if return_feats:
                out["texture"] = [pre["texture"][0] + (off_t @ tex_u.wo).reshape(-1, 4, 4, 2)]
            return out

    return Net()


class _TorchMockGen(torch.nn.Module):
    def __init__(self, W):
        super().__init__()
        for k in ("wm", "wi", "wf", "wt", "wx"):
            setattr(self, k, torch.nn.Parameter(torch.from_numpy(W[k].copy())))

    def mapping(self, z, c, truncation_psi=1.0):
        return torch.tanh(z @ self.wm).reshape(-1, 4, 8) * truncation_psi

    def synthesis(self, ws, c, v, return_featmap=False, **_):
        h = ws.mean(dim=1)
        B = h.shape[0]
        out = {"image": torch.tanh(h @ self.wi).reshape(B, 16, 16, 3).permute(0, 3, 1, 2),
               "feature_image": (h @ self.wf).reshape(B, 8, 8, 4).permute(0, 3, 1, 2),
               "triplane": (h @ self.wt).reshape(B, 3, 4, 4, 2)}
        if return_featmap:
            out["texture"] = [(h @ self.wx).reshape(B, 4, 4, 2).permute(0, 3, 1, 2)]
        return out


class _TorchMockNet(torch.nn.Module):
    def __init__(self, W):
        super().__init__()
        p = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in W.items()}
        self.generator = _TorchMockGen(W)
        self.encoder = torch.nn.ParameterDict({"we": p["we"]})
        self.unet_encoder = torch.nn.ModuleDict({
            "texture_unet": torch.nn.ParameterDict({"w_tex": p["w_tex"], "wo": p["wo"]}),
            "triplane_unet": torch.nn.ParameterDict({"w_tri": p["w_tri"]})})

    def forward(self, x, cam, v, return_feats=False, nograd_render=None, grad_render=None,
                generator=None):
        img = x["image"][:, :3]
        with torch.no_grad():
            ws = torch.tanh(img.mean(dim=(2, 3)) @ self.encoder["we"]).reshape(-1, 4, 8)
            pre = self.generator.synthesis(ws, cam, v, return_featmap=True)
        delta = pre["image"] - img
        tex_u, tri_u = self.unet_encoder["texture_unet"], self.unet_encoder["triplane_unet"]
        off_t = torch.tanh(torch.cat([delta.mean(dim=(2, 3)), x["uv"].mean(dim=(2, 3))], -1)
                           @ tex_u["w_tex"])
        off_s = torch.tanh(torch.cat([img.mean(dim=(2, 3)), delta.mean(dim=(2, 3))], -1)
                           @ tri_u["w_tri"])
        out = self.generator.synthesis(ws + 0.5 * off_t[:, None] + off_s[:, None], cam, v)
        if return_feats:
            out["texture"] = [pre["texture"][0]
                              + (off_t @ tex_u["wo"]).reshape(-1, 4, 4, 2).permute(0, 3, 1, 2)]
        return out


MOCK_D_CFG = dict(c_dim=25, img_resolution=16, img_channels=6, channel_base=256, channel_max=32,
                  num_fp16_res=0)
# the schedule's first four batches with R1 every 2: (I phase, U-Net, D phase, do_r1)
MOCK_SCHEDULE = [oneshot_phase_schedule(i, 2) for i in range(4)]


def test_oneshot_step_on_a_mock_net_matches_jax():
    """The step's machinery, port against JAX `make_oneshot_train_step`, on
    a mock network and a real `DualDiscriminator` at 16²: four batches of
    the schedule (Ireal/Dreal with R1, Ireal/Dreal, Igen/Dgen with R1,
    Igen/Dgen), batch 2, frames with a mask channel, every loss term the
    step reaches with `texture > 0` and `adv > 0`; one Adam per U-Net. Each
    step's losses agree to 1e-4 relative; the parameters after the four
    batches (four Adam steps of lr 1e-4 / 2e-4 move them by up to 1e-3):
    both U-Nets to 1e-6, D to 2e-6 + 1e-6 of the entry (its mapping weights
    are ~300, where a float32 ulp is 3e-5); the generator and the encoder
    are unchanged. The Adam step counts are optax's per-state counts."""
    import optax

    from invertavatar_tpu.models.discriminator import DualDiscriminator as JaxD
    from invertavatar_tpu.train import inversion as jinv
    from invertavatar_tpu.train.loop_inversion import (
        make_oneshot_train_step as j_step,
        masked_adam as j_adam,
        oneshot_tex_trainable as j_tex,
        oneshot_tri_trainable as j_tri,
    )
    from invertavatar_tpu.train.state import TrainState as JState

    W = _mock_weights(31)
    rng = np.random.RandomState(32)
    image = rng.uniform(-1, 1, (2, 16, 16, 4)).astype(np.float32)
    image[..., 3] = rng.uniform(0, 1, (2, 16, 16))
    raw = {"image": image, "uv": rng.randn(2, 8, 8, 6).astype(np.float32),
           "c": rng.randn(2, 25).astype(np.float32), "v": {},
           "z": rng.randn(2, 8).astype(np.float32)}
    raw["gen_uv"] = raw["uv"]
    wkw = dict(OS_WEIGHTS, lpips=0.3, lr_lpips=0.2, adv=0.05, adv_r1_gamma=2.0)

    jnet, jD = _jax_mock_net(), JaxD(**MOCK_D_CFG)
    params = {"generator": {k: W[k] for k in ("wm", "wi", "wf", "wt", "wx")},
              "encoder": {"we": W["we"]},
              "unet_encoder": {"texture_unet": {"w_tex": W["w_tex"], "wo": W["wo"]},
                               "triplane_unet": {"w_tri": W["w_tri"]}}}
    d_vars = jD.init(jax.random.PRNGKey(33), {"image": jnp.zeros((1, 16, 16, 3)),
                                              "image_raw": jnp.zeros((1, 8, 8, 3))},
                     jnp.zeros((1, 25)))
    d_vars = _randomize({k: dict(v) for k, v in d_vars.items()}, 34)
    txs = {"tex": j_adam(1e-4, j_tex), "tri": j_adam(1e-4, j_tri)}
    d_tx = optax.adam(2e-4)
    steps = {u: jax.jit(j_step(jnet, jD, _lp, None, tx, d_tx, jinv.InversionLossWeights(**wkw)),
                        static_argnames=("phase", "do_r1")) for u, tx in txs.items()}
    opt_states = {u: tx.init(params) for u, tx in txs.items()}
    jd = JState(d_vars["params"], d_tx.init(d_vars["params"]),
                {k: v for k, v in d_vars.items() if k != "params"})
    jbatch = jax.tree_util.tree_map(jnp.asarray, raw)
    auxes_j = []
    for i, (i_phase, unet, d_phase, r1) in enumerate(MOCK_SCHEDULE):
        js = JState(params, opt_states[unet], {})
        js, jd, aux = steps[unet](js, jd, jbatch, jax.random.PRNGKey(i), phase=i_phase)
        params, opt_states[unet] = js.params, js.opt_state
        _, jd, d_aux = steps[unet](js, jd, jbatch, jax.random.PRNGKey(i), phase=d_phase, do_r1=r1)
        auxes_j.append({**aux, **d_aux})

    net = _TorchMockNet(W)
    D = DualDiscriminator(**MOCK_D_CFG)
    D.load_state_dict(jax_to_state_dict(d_vars), strict=True)
    step = make_oneshot_train_step(net, _lp, None, port_inv.InversionLossWeights(**wkw))
    opts = {"tex": masked_adam(net, 1e-4, oneshot_tex_trainable),
            "tri": masked_adam(net, 1e-4, oneshot_tri_trainable)}
    d_state = TrainState(D, torch.optim.Adam(D.parameters(), lr=2e-4))
    batch = {k: (_nchw(v) if k in ("image", "uv", "gen_uv") else
                 {} if k == "v" else torch.from_numpy(v)) for k, v in raw.items()}
    for (i_phase, unet, d_phase, r1), aux_j in zip(MOCK_SCHEDULE, auxes_j):
        state = TrainState(net, opts[unet])
        aux = step(state, d_state, batch, phase=i_phase)
        aux.update(step(state, d_state, batch, phase=d_phase, do_r1=r1))
        assert sorted(aux) == sorted(aux_j)
        for k in aux:
            np.testing.assert_allclose(float(aux[k]), float(aux_j[k]), rtol=1e-4, atol=1e-7,
                                       err_msg=k)
    assert "Dreal/d_r1" in auxes_j[0] and "Igen/texture" in auxes_j[2]

    flat = {"generator." + k: v for k, v in params["generator"].items()}
    flat["encoder.we"] = params["encoder"]["we"]
    for u in ("texture_unet", "triplane_unet"):
        flat.update({f"unet_encoder.{u}.{k}": v for k, v in params["unet_encoder"][u].items()})
    for k, v in net.named_parameters():
        owner = MOCK_OWNERS[k.rsplit(".", 1)[-1]]
        if owner.startswith("unet_encoder"):
            assert not np.array_equal(v.detach().numpy(), W[k.rsplit(".", 1)[-1]]), k
            np.testing.assert_allclose(v.detach().numpy(), np.asarray(flat[k]), rtol=0,
                                       atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(v.detach().numpy(), W[k.rsplit(".", 1)[-1]], err_msg=k)
    new_d = jax_to_state_dict({"params": jd.params})
    for k, v in D.state_dict().items():
        if k in new_d:
            torch.testing.assert_close(v, new_d[k], rtol=1e-6, atol=2e-6, msg=k)
    # optax counts each U-Net's Adam on its own steps (two each), D's on all four
    for u, opt in opts.items():
        count = int(opt_states[u][1].inner_state[0].count)
        assert count == 2 and all(int(st["step"]) == count for st in opt.state.values()), u
    assert all(int(st["step"]) == 4 for st in d_state.opt.state.values())


# ---------------------------------------------------------------------- steps


def _batch(seed=3):
    """One 256² frame (no mask), its UV input, camera and uvcoords, and z."""
    image, uv, c, uvc = (a[:1] for a in _inputs(seed=seed))
    z = np.random.RandomState(seed + 1).randn(1, 32).astype(np.float32)
    return {"image": image, "uv": uv, "c": c, "v": {"uvcoords_image": uvc}, "z": z, "gen_uv": uv}


def _port_batch(b):
    return {"image": _nchw(b["image"]), "uv": _nchw(b["uv"]), "c": torch.from_numpy(b["c"]),
            "v": {"uvcoords_image": torch.from_numpy(b["v"]["uvcoords_image"])},
            "z": torch.from_numpy(b["z"]), "gen_uv": _nchw(b["gen_uv"])}


def _jax_d(seed):
    from invertavatar_tpu.models.discriminator import DualDiscriminator as JaxD

    D = JaxD(**D_CFG)
    d_vars = D.init(jax.random.PRNGKey(seed), {"image": jnp.zeros((1, 128, 128, 3)),
                                               "image_raw": jnp.zeros((1, 32, 32, 3))},
                    jnp.zeros((1, 25)))
    return D, _randomize({k: dict(v) for k, v in d_vars.items()}, seed + 1)


def _port_setup(unet_type, seed=0):
    """The port's tiny one-shot net (from the JAX variables), D, and the
    JAX side's (net, variables, D, D variables)."""
    jnet, variables = _jax_net(unet_type, seed)
    jD, d_vars = _jax_d(seed + 7)
    net = _port_net(unet_type, variables)
    D = DualDiscriminator(**D_CFG)
    D.load_state_dict(jax_to_state_dict(d_vars), strict=True)
    return net, D, (jnet, variables, jD, d_vars)


# (I or D phase, U-Net, do_r1): schedule steps 0 (Ireal, tri) and 2 (Igen,
# tex), then Dgen with R1 (the JAX test's D phase: its real pair is the
# generator's 128² sample, which the 128² D takes; Dreal would need frames at
# D's resolution)
PHASES = (("Ireal", "tri", False), ("Igen", "tex", False), ("Dgen", "tri", True))


@pytest.mark.slow
@pytest.mark.parametrize("unet_type", ["gru", "segformer"])
def test_oneshot_step_matches_jax(unet_type):
    """Ireal (tri U-Net, with the adversarial term), Igen (tex U-Net,
    `texture > 0`) and Dgen with R1, one after another from the same
    weights, port against JAX `make_oneshot_train_step` under the
    deterministic overrides. Losses agree to 1e-4 relative. Adam's first
    step moves a parameter by about ±lr whatever its gradient, so where a
    gradient is float32 noise the two sides may step apart by up to 2·lr:
    the trained U-Nets agree to 2e-6 on all but 0.1% of their parameters
    and to 2·lr (2e-4) on every one, D likewise (lr 2e-4); the generator
    and the encoder are unchanged on both sides. Slow: the JAX side runs
    for ~6 minutes (ConvGRU) op by op."""
    import optax

    from invertavatar_tpu.train import inversion as jinv
    from invertavatar_tpu.train.loop_inversion import (
        make_oneshot_train_step as j_step,
        masked_adam as j_adam,
        oneshot_tex_trainable as j_tex,
        oneshot_tri_trainable as j_tri,
    )
    from invertavatar_tpu.train.state import TrainState as JState

    net, D, (jnet, variables, jD, d_vars) = _port_setup(unet_type)
    raw = _batch()
    jw = jinv.InversionLossWeights(**OS_WEIGHTS)
    jbatch = jax.tree_util.tree_map(jnp.asarray, raw)
    txs = {"tex": j_adam(1e-4, j_tex), "tri": j_adam(1e-4, j_tri)}
    d_tx = optax.adam(2e-4)
    steps = {u: jax.jit(j_step(jnet, jD, lambda a, b: jnp.mean(jnp.abs(a - b)), None, tx, d_tx,
                               jw, fast_igen_target="exact", fast_grad="structured"),
                        static_argnames=("phase", "do_r1")) for u, tx in txs.items()}
    params = variables["params"]
    buffers = {k: v for k, v in variables.items() if k != "params"}
    opt_states = {u: tx.init(params) for u, tx in txs.items()}
    jd = JState(d_vars["params"], d_tx.init(d_vars["params"]),
                {k: v for k, v in d_vars.items() if k != "params"})
    auxes_j = []
    # eager: compiling the three phase programs takes ~10 minutes, running
    # them op by op ~6
    with jax.disable_jit():
        for phase, unet, r1 in PHASES:
            js = JState(params, opt_states[unet], buffers)
            js, jd, aux = steps[unet](js, jd, jbatch, jax.random.PRNGKey(1), phase=phase,
                                      do_r1=r1)
            params, opt_states[unet] = js.params, js.opt_state
            auxes_j.append(aux)
    jax.block_until_ready(params)

    sd0 = {k: v.clone() for k, v in net.state_dict().items()}
    step = make_oneshot_train_step(net, _l1, None, port_inv.InversionLossWeights(**OS_WEIGHTS),
                                   fast_igen_target="exact", fast_grad="structured")
    opts = {"tex": masked_adam(net, 1e-4, oneshot_tex_trainable),
            "tri": masked_adam(net, 1e-4, oneshot_tri_trainable)}
    d_state = TrainState(D, torch.optim.Adam(D.parameters(), lr=2e-4))
    batch = _port_batch(raw)
    for (phase, unet, r1), aux_j in zip(PHASES, auxes_j):
        aux = step(TrainState(net, opts[unet]), d_state, batch, phase=phase, do_r1=r1)
        assert sorted(aux) == sorted(aux_j), phase
        for k in aux:
            assert np.isfinite(float(aux[k])), k
            np.testing.assert_allclose(float(aux[k]), float(aux_j[k]), rtol=1e-4, atol=1e-7,
                                       err_msg=k)
    assert float(auxes_j[2]["Dgen/d_r1"]) > 0

    new_sd = jax_to_state_dict({"params": params, **buffers})
    port_sd = net.state_dict()
    for u in ("texture_unet", "triplane_unet"):
        keys = [k for k in new_sd if k.startswith(f"unet_encoder.{u}.")]
        diff = torch.cat([(port_sd[k] - new_sd[k]).abs().flatten() for k in keys])
        moved = max((port_sd[k] - sd0[k]).abs().max() for k in keys)
        assert moved > 0 and diff.max() < 2e-4, (u, moved, diff.max())
        assert (diff > 2e-6).float().mean() < 1e-3, (u, (diff > 2e-6).float().mean())
    for k, v in new_sd.items():
        if not k.startswith("unet_encoder."):
            assert torch.equal(port_sd[k], v) and torch.equal(v, sd0[k]), k
    new_d = jax_to_state_dict({"params": jd.params})
    d_diff = torch.cat([(v - new_d[k]).abs().flatten() for k, v in D.state_dict().items()
                        if k in new_d])
    assert d_diff.max() < 4e-4 and (d_diff > 2e-6).float().mean() < 1e-3, d_diff.max()


def _biased_d(cfg, state=None):
    """A port `DualDiscriminator` with nonzero 1-D parameters: with zero
    biases and the stage's zero cameras its camera map, and every logit, is
    zero."""
    D = DualDiscriminator(**cfg)
    if state is not None:
        D.load_state_dict(state)
    with torch.no_grad():
        for p in D.parameters():
            if p.ndim == 1:
                p.add_(0.1)
    return D


@pytest.mark.parametrize("unet", ["tri", "tex"])
def test_oneshot_step_trains_only_the_scheduled_unet(unet):
    """One Ireal step of the tiny ConvGRU net (deterministic overrides, D
    with its adversarial term) moves the scheduled U-Net alone: the prefix
    runs under no-grad, so the generator and the e4e encoder keep no
    gradient, the other U-Net keeps none either, and D is left as it was."""
    from tests.test_torch_checkpoint import tiny_inversion_net

    torch.manual_seed(2)
    net, D = tiny_inversion_net(seed=1), _biased_d(D_CFG)
    sd0 = {k: v.clone() for k, v in net.state_dict().items()}
    dsd0 = {k: v.clone() for k, v in D.state_dict().items()}
    step = make_oneshot_train_step(net, _l1, None, port_inv.InversionLossWeights(**OS_WEIGHTS),
                                   fast_igen_target="exact", fast_grad="structured")
    pred = oneshot_tri_trainable if unet == "tri" else oneshot_tex_trainable
    state = TrainState(net, masked_adam(net, 1e-4, pred))
    d_state = TrainState(D, torch.optim.Adam(D.parameters(), lr=2e-4))
    aux = step(state, d_state, _port_batch(_batch()), phase="Ireal")
    assert aux["Ireal/adv"] != np.log(2.0) and all(torch.isfinite(v) for v in aux.values())
    prefix = "unet_encoder.triplane_unet." if unet == "tri" else "unet_encoder.texture_unet."
    moved = {k for k, v in net.state_dict().items() if not torch.equal(v, sd0[k])}
    assert moved and all(k.startswith(prefix) for k in moved)
    assert all(p.grad is None for k, p in net.named_parameters() if not k.startswith(prefix))
    assert all(torch.equal(v, dsd0[k]) for k, v in D.state_dict().items())


class _NoisyMockNet(_TorchMockNet):
    """The mock network whose render draws from the step's generator, as the
    renderer's stochastic strata do without the deterministic overrides."""

    def forward(self, *args, generator=None, **kw):
        out = super().forward(*args, **kw)
        noise = torch.randn(out["image"].shape, generator=generator)
        return dict(out, image=out["image"] + 0.01 * noise)


def _mock_train_batches(n, start=0):
    for i in range(start, n):
        rng = np.random.RandomState(40 + i)
        image = _nchw(rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32))
        uv = _nchw(rng.randn(2, 8, 8, 6).astype(np.float32))
        yield {"image": image, "uv": uv, "gen_uv": uv, "v": {},
               "c": torch.from_numpy(rng.randn(2, 25).astype(np.float32)),
               "z": torch.from_numpy(rng.randn(2, 8).astype(np.float32))}


def test_train_oneshot_resumes_bitwise(tmp_path):
    """Four steps of `train_oneshot` (R1 every 2; the mock network with a
    stochastic render, a dual discriminator) straight through, and two steps
    then a resume from `snapshot-final.pt` for the last two, end on the same
    bits: both U-Nets, both Adam states, D and its Adam, the counters. Every
    phase of the schedule wrote its stats."""
    import json

    W = _mock_weights(35)
    d0 = DualDiscriminator(**MOCK_D_CFG).state_dict()

    def run(run_dir, max_steps, start=0, resume=None):
        net, D = _NoisyMockNet(W), _biased_d(MOCK_D_CFG, d0)
        cfg = InversionTrainConfig(run_dir=str(run_dir), batch_size=2, wd_reg_interval=2,
                                   weights=port_inv.InversionLossWeights(**OS_WEIGHTS))
        state, d_state = train_oneshot(net, D, _mock_train_batches(4, start), cfg, _lp,
                                       max_steps=max_steps, resume_path=resume, device="cpu")
        return torch.load(run_dir / "snapshot-final.pt", weights_only=True)

    straight = run(tmp_path / "a", 4)
    run(tmp_path / "b", 2)
    resumed = run(tmp_path / "c", 4, start=2, resume=str(tmp_path / "b" / "snapshot-final.pt"))
    assert straight["step_idx"] == resumed["step_idx"] == 4
    assert straight["cur_nimg"] == resumed["cur_nimg"] == 8

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        return torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b

    for key in ("net", "opt", "d_state"):
        assert same(straight[key], resumed[key]), key
    assert straight["net"]["unet_encoder.texture_unet.w_tex"].ne(
        torch.from_numpy(W["w_tex"])).any()
    with open(tmp_path / "a" / "stats.jsonl") as f:
        names = set(json.loads(f.readlines()[-1]))
    for prefix in ("Ireal/", "Igen/", "Dreal/", "Dgen/"):
        assert any(n.startswith(prefix) for n in names), prefix
    assert "Dreal/d_r1" in names and "Igen/texture" in names


# ------------------------------------------------------------------------ CLI


def _cli_data(tmp_path):
    from tests.test_torch_checkpoint import tiny_generator, write_gan_pkl
    from tests.test_torch_cli import _video_folder

    _video_folder(tmp_path / "data", 2, seed=5, images=True, source_uv=True)
    write_gan_pkl(tmp_path / "gan.pkl", tiny_generator(seed=4))
    return str(tmp_path / "data" / "images512x512"), str(tmp_path / "gan.pkl")


@pytest.mark.parametrize("stage,steps", [
    ("e4e", 1), pytest.param("oneshot", 3, marks=pytest.mark.slow)])
def test_train_inversion_cli(tmp_path, reference_pickler, stage, steps):
    """`cli/train_inversion.py` on a forged generator pickle and a two-frame
    dataset at 256²: the stage trains for `--max-steps` on the CPU, writes
    `stats.jsonl` with Ireal and Igen losses (one-shot: steps 0-1 Ireal,
    step 2 Igen) and its snapshot. A missing card raises (the `fewshot`
    stage runs in tests/test_torch_fewshot_train.py)."""
    import json

    from invertavatar_torch.cli import train_inversion as cli

    data, pkl = _cli_data(tmp_path)
    out = tmp_path / "run"
    args = ["--outdir", str(out), "--data", data, "--gen_pkl", pkl, "--training_state", stage,
            "--batch", "1", "--res", "256", "--max-steps", str(steps), "--kimg", "1"]
    try:
        cli.main(args + ["--device", "cpu"])
        with open(out / "stats.jsonl") as f:
            names = set().union(*(json.loads(line) for line in f))
        snaps = [p.name for p in out.iterdir() if p.name.startswith("snapshot-")]
    finally:  # the snapshots hold IR-SE-50 or SegFormer nets with their Adam: GBs
        shutil.rmtree(out, ignore_errors=True)
    assert any(n.startswith("Ireal/") for n in names) and any(n.startswith("Igen/") for n in names)
    assert snaps == (["snapshot-final.pt"] if stage == "oneshot" else [f"snapshot-{steps:08d}.pt"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(args)  # the card is the default
