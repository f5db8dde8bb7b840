"""The port's few-shot inversion training stage on the CPU, held against the
JAX package.

  * the six few-shot losses on mock closures, with and without the head-mask
    channel and the adversarial term: values and input gradients to 1e-4
    relative (the e4e and one-shot losses' bar: both sides resize small
    images to 256² and sum them in other orders);
  * the step's per-frame cotangent accumulation against the gradient of the
    literal losses (`fewshot_ireal_loss`, `fewshot_ireal_multiT_loss`,
    `fewshot_igen_loss` over `run_seq` / `run_seq_multiT`) on the same mock
    network, to 1e-5 of the largest entry;
  * `fewshot_phase_schedule` and the Ireal frame draw, equal to JAX's over
    steps 0-79; the trainable predicates, the same parameter sets as JAX's
    through the weight bridge;
  * `multiT_chunk_inputs`, `multiT_chunk_state` and `multiT_final` of the
    tiny network (tiny trunks, the few-shot absorb tests' generator) against
    JAX, each one `jax.jit` dispatch: renders and features to 1e-3 of each
    tensor's largest entry (the absorb tests' bar), the GRU states likewise;
  * the step (Ireal on a frame selection and Igen, multi-T, T=4 in chunks of
    2) and the D step (with and without R1) on a mock network that runs the
    port's and JAX's own rollout blocks, against JAX `make_fewshot_train_step`
    / `make_fewshot_d_step`: losses to 1e-4 relative, both U-Nets to 1e-6
    after the Adam steps, the Adam counts equal to optax's;
  * `train_fewshot`: only the parity-selected decoder moves, a resumed run
    ends on the same bits, a mesh is refused; `VideoDataset` against JAX on
    one seeded on-disk layout; `cli/train_inversion.py --training_state
    fewshot` for one step on the CPU.

Slow (`-m slow`): `run_seq` and `run_seq_multiT` of the tiny network against
JAX run eagerly, and the step of the tiny network against JAX's.
"""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from invertavatar_torch.models.discriminator import DualDiscriminator
from invertavatar_torch.models.encoders.uvnet import InversionNet
from invertavatar_torch.ops.resize import resize_bilinear
from invertavatar_torch.train import inversion as port_inv
from invertavatar_torch.train import loop_inversion as li
from invertavatar_torch.train.state import TrainState
from invertavatar_torch.utils.weights import jax_to_state_dict
from tests.test_torch_checkpoint import reference_pickler  # noqa: F401  (a fixture)
from tests.test_torch_encoders import _randomize
from tests.test_torch_fewshot import OUT_CH, _assert_rel
from tests.test_torch_oneshot_train import MOCK_D_CFG

# one intra-op thread: the suite runs test files in parallel worker processes
torch.set_num_threads(1)

# configs/train_fewshot.yaml's weights with LPIPS as a plain distance
FS_WEIGHTS = dict(l1=1.0, lpips=0.0, id=0.0, raw_l1=1.0, tri=0.001, lr_lpips=0.0, adv=0.1)


def _lp(a, b):
    return ((a - b) ** 2).mean()


def _clip(x):
    """NHWC clip [B, T, H, W, C] (numpy) -> NCHW clip tensor [B, T, C, H, W]."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x, np.float32), -1, 2)))


def _flat(x):
    """NHWC [N, H, W, C] (numpy) -> NCHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x, np.float32), -1, 1)))


# -------------------------------------------------------------------- losses


def _loss_world(rng, B, T, H, h):
    """Numpy weights of a mock rollout (the frames at h² plus a learned bias,
    feature images and tri-planes from it), the generator's target and a
    mock dual discriminator, with their JAX (NHWC) and torch (NCHW)
    closures."""
    W = dict(bias=rng.randn(3).astype(np.float32) * 0.1,
             feat=rng.randn(B * T, 8, 8, 4).astype(np.float32),
             tri=rng.randn(B * T, 3, 4, 4, 2).astype(np.float32),
             D=rng.randn(4, 1).astype(np.float32) * 0.3)

    def jax_fns(bias):
        def run(frames, c, v, uv, *rest):
            flat = frames.reshape(-1, *frames.shape[2:])
            img = jax.image.resize(flat, (flat.shape[0], h, h, 3), "linear") + bias
            if len(rest) == 2:  # the multi-T closure: its selection, [B, Tc, ...]
                return {"image": img.reshape(B, T, h, h, 3)[:, jnp.asarray(rest[0])]}
            return {"image": img, "feature_image": jnp.asarray(W["feat"]) * (1 + bias[1]),
                    "triplane": jnp.asarray(W["tri"]) + bias[2]}

        def d_apply(pair):
            f = jnp.stack([jnp.mean(pair["image"], axis=(1, 2, 3)),
                           jnp.mean(pair["image_raw"], axis=(1, 2, 3)),
                           jnp.mean(jnp.square(pair["image"]), axis=(1, 2, 3)),
                           jnp.ones(pair["image"].shape[0])], axis=1)
            return f @ jnp.asarray(W["D"])

        return run, d_apply

    def torch_fns(bias):
        def run(frames, c, v, uv, *rest):
            flat = frames.reshape(-1, *frames.shape[2:])
            img = resize_bilinear(flat, (h, h), antialias=True) + bias[None, :, None, None]
            if len(rest) == 2:
                return {"image": img.reshape(B, T, 3, h, h)[:, torch.as_tensor(rest[0])]}
            return {"image": img, "feature_image": _flat(W["feat"]) * (1 + bias[1]),
                    "triplane": torch.from_numpy(W["tri"]).permute(0, 1, 4, 2, 3) + bias[2]}

        def d_apply(pair):
            f = torch.stack([pair["image"].mean(dim=(1, 2, 3)),
                             pair["image_raw"].mean(dim=(1, 2, 3)),
                             pair["image"].square().mean(dim=(1, 2, 3)),
                             torch.ones(pair["image"].shape[0])], dim=1)
            return f @ torch.from_numpy(W["D"])

        return run, d_apply

    return W, jax_fns, torch_fns


@pytest.mark.parametrize("mask", [False, True])
def test_fewshot_losses_match_jax(mask):
    """The six few-shot losses on one mock rollout (a 2-frame clip at 64²
    rendered at 32²; with `mask` the frames carry the head mask): Igen's
    feature terms with and without the adversarial term, Igen through its
    closures, Ireal over the whole clip and over a selection, the clip's
    image terms and the per-frame form (masked and not). Each value, and
    the gradient of their sum with respect to the mock's bias, to 1e-4
    relative."""
    from invertavatar_tpu.train import inversion as jinv

    rng = np.random.RandomState(81)
    B, T, H, h = 1, 2, 64, 32
    W, jax_fns, torch_fns = _loss_world(rng, B, T, H, h)
    wkw = dict(l1=1.0, lpips=0.5, raw_l1=1.0, tri=0.2, lr_lpips=0.3, adv=0.05)
    jw, tw = jinv.InversionLossWeights(**wkw), port_inv.InversionLossWeights(**wkw)
    frames = rng.uniform(-1, 1, (B, T, H, H, 4 if mask else 3)).astype(np.float32)
    if mask:
        frames[..., 3] = rng.uniform(0, 1, (B, T, H, H))
    gen_img = rng.uniform(-1, 1, (B * T, h, h, 3)).astype(np.float32)
    gen_out = {"image": gen_img, "feature_image": rng.randn(B * T, 8, 8, 4).astype(np.float32),
               "triplane": rng.randn(B * T, 3, 4, 4, 2).astype(np.float32)}
    c = rng.randn(B, T, 25).astype(np.float32)
    z = rng.randn(B, 8).astype(np.float32)
    idx = np.array([1, 0])

    def gen_closures(lib, conv):
        return (lambda z, c, truncation_psi: z * truncation_psi,
                lambda ws, tex, static, c, v: conv(gen_out),
                lambda ws: None, lambda ws: None)

    def jax_all(bias):
        run, d = jax_fns(bias)
        fl = lambda a: {k: jnp.asarray(v) for k, v in a.items()}  # noqa: E731
        out = run(jnp.asarray(frames[..., :3]), c, None, None)
        res = [jinv.fewshot_feature_losses(out, fl(gen_out), _lp, jw, d),
               jinv.fewshot_feature_losses(out, fl(gen_out), _lp, jw),
               jinv.fewshot_igen_loss(run, *gen_closures(jnp, fl), _lp, jw, z, c, None, None),
               jinv.fewshot_ireal_loss(run, _lp, jw, jnp.asarray(frames), c, None, None),
               jinv.fewshot_ireal_multiT_loss(run, _lp, jw, jnp.asarray(frames), c, None, None,
                                              idx),
               jinv.fewshot_image_losses(out["image"].reshape(B, T, h, h, 3),
                                         jnp.asarray(frames), _lp, jw),
               jinv.fewshot_image_loss_frame(out["image"][1:], jnp.asarray(frames[:, 1]), _lp,
                                             jw, True),
               jinv.fewshot_image_loss_frame(out["image"][:1], jnp.asarray(frames[:, 0]), _lp,
                                             jw, False)]
        return sum(t for t, _ in res), [a for _, a in res]

    (tot_j, auxes_j), grad_j = jax.jit(jax.value_and_grad(jax_all, has_aux=True))(
        jnp.asarray(W["bias"]))

    bias = torch.from_numpy(W["bias"]).requires_grad_(True)
    run, d = torch_fns(bias)

    def conv(a):
        return {"image": _flat(a["image"]), "feature_image": _flat(a["feature_image"]),
                "triplane": torch.from_numpy(a["triplane"]).permute(0, 1, 4, 2, 3)}

    fr_t, c_t = _clip(frames), torch.from_numpy(c)
    out = run(fr_t[:, :, :3], c_t, None, None)
    res = [port_inv.fewshot_feature_losses(out, conv(gen_out), _lp, tw, d),
           port_inv.fewshot_feature_losses(out, conv(gen_out), _lp, tw),
           port_inv.fewshot_igen_loss(run, *gen_closures(torch, conv), _lp, tw,
                                      torch.from_numpy(z), c_t, None, None),
           port_inv.fewshot_ireal_loss(run, _lp, tw, fr_t, c_t, None, None),
           port_inv.fewshot_ireal_multiT_loss(run, _lp, tw, fr_t, c_t, None, None, idx),
           port_inv.fewshot_image_losses(out["image"].reshape(B, T, 3, h, h), fr_t, _lp, tw),
           port_inv.fewshot_image_loss_frame(out["image"][1:], fr_t[:, 1], _lp, tw, True),
           port_inv.fewshot_image_loss_frame(out["image"][:1], fr_t[:, 0], _lp, tw, False)]
    total = sum(t for t, _ in res)
    total.backward()
    for i, ((_, aux_t), aux_j) in enumerate(zip(res, auxes_j)):
        assert sorted(aux_t) == sorted(aux_j), i
        for k in aux_t:
            np.testing.assert_allclose(float(aux_t[k].detach()), float(aux_j[k]), rtol=1e-4,
                                       atol=1e-7, err_msg=f"{i} {k}")
    assert "adv" in res[0][1] and "adv" not in res[1][1] and "tri" in res[2][1]
    np.testing.assert_allclose(total.item(), float(tot_j), rtol=1e-4)
    gj = np.asarray(grad_j)
    np.testing.assert_allclose(bias.grad.numpy(), gj, atol=1e-4 * np.abs(gj).max())


# --------------------------------------------------- a mock few-shot network
#
# The same algebra in flax (NHWC) and torch (NCHW), small enough for the
# JAX programs to compile in seconds: z [B,8] -> ws [B,4,8]; the
# "generator" keeps two texture and two static taps of 4² and renders 16²
# images, 8² feature images and tri-planes from the taps' and the camera's
# means (the render marks `evaluation` and overrides in its image, so that
# a render taking the wrong route shows); the "U-Nets" pool each frame of
# their [B, T, C, H, W] input, run it through a frozen trunk (`input_layer`,
# `body`) and a recurrent decoder (`up`) whose state carries over frames and
# chunks; the texture one offsets the first texture tap, the tri-plane one
# gives (scale, shift) conditions to the static backbone. The rollout blocks
# themselves (`multiT_chunk_inputs`, ...) are each package's own.

MOCK_SHAPES = {
    "generator": dict(wm=(8, 32), wx0=(8, 32), wx1=(8, 32), ws0=(8, 32), ws1=(8, 32),
                      wi=(18, 768), wf=(18, 256), wt=(18, 96)),
    "encoder": dict(we=(3, 32)),
    "texture_unet": {"input_layer": dict(w=(7, 8)), "body": dict(w=(8, 8)),
                     "up": dict(wi=(8, 8), wh=(8, 8), wo=(8, 32))},
    "triplane_unet": {"input_layer": dict(w=(6, 8)), "body": dict(w=(8, 8)),
                      "up": dict(wi=(8, 8), wh=(8, 8), wsc=(8, 32), wsh=(8, 32))},
}
MOCK_H = 16


def _mock_weights(seed):
    rng = np.random.RandomState(seed)

    def draw(tree):
        if isinstance(tree, dict):
            return {k: draw(v) for k, v in tree.items()}
        return (rng.randn(*tree) / np.sqrt(tree[0])).astype(np.float32)

    return draw(MOCK_SHAPES)


def _jax_params(W):
    return {"generator": W["generator"], "encoder": W["encoder"],
            "unet_encoder": {"texture_unet": W["texture_unet"],
                             "triplane_unet": W["triplane_unet"]}}


def _jax_mock_net():
    import flax.linen as fnn

    from invertavatar_tpu.models.encoders.uvnet import InversionNet as JaxNet

    class Holder(fnn.Module):
        shapes: dict

        def setup(self):
            for k, shape in self.shapes.items():
                setattr(self, k, self.param(k, fnn.initializers.zeros, shape))

    class Nest(fnn.Module):
        shapes: dict

        def setup(self):
            for k, sub in self.shapes.items():
                setattr(self, k, Holder(sub))

    def pool(x):  # [B, T, H, W, C] -> [B, T, C]
        return jnp.mean(x, axis=(2, 3))

    class TexUNet(Nest):
        def __call__(self, x, r_list=None, train=False):
            h = jnp.zeros((x.shape[0], 8)) if r_list is None else r_list[0]
            m = pool(x)
            for t in range(x.shape[1]):
                f = jnp.tanh(jnp.tanh(m[:, t] @ self.input_layer.w) @ self.body.w)
                h = jnp.tanh(f @ self.up.wi + h @ self.up.wh)
            return [(h @ self.up.wo).reshape(-1, 4, 4, 2)], [h]

    class TriUNet(Nest):
        def __call__(self, x, r_list=None, train=False):
            h = jnp.zeros((x.shape[0], 8)) if r_list is None else r_list[0]
            m = pool(x)
            for t in range(x.shape[1]):
                f = jnp.tanh(jnp.tanh(m[:, t] @ self.input_layer.w) @ self.body.w)
                h = jnp.tanh(f @ self.up.wi + h @ self.up.wh)
            return {"c": (0.1 * jnp.tanh(h @ self.up.wsc).reshape(-1, 4, 4, 2),
                          (h @ self.up.wsh).reshape(-1, 4, 4, 2))}, [h]

    class Gen(Holder):
        def setup(self):
            super().setup()
            parent = self

            class _Tex:
                def synthesis(self_, ws, return_list=True, noise_mode="const"):
                    h = jnp.mean(ws, axis=1)
                    return [(h @ parent.wx0).reshape(-1, 4, 4, 2),
                            (h @ parent.wx1).reshape(-1, 4, 4, 2)]

            class _Static:
                def synthesis(self_, ws, return_list=True, feat_conditions=None,
                              noise_mode="const"):
                    h = jnp.mean(ws, axis=1)
                    s0 = jnp.tanh((h @ parent.ws0).reshape(-1, 4, 4, 2))
                    s1 = (h @ parent.ws1).reshape(-1, 4, 4, 2)
                    if feat_conditions is not None:
                        scale, shift = feat_conditions["c"]
                        s0 = s0 * (1 + scale) + shift
                        s1 = s1 + 0.5 * jnp.tanh(shift)
                    return [s0, s1]

            self.texture_backbone, self.backbone = _Tex(), _Static()

        def mapping(self, z, c, truncation_psi=1.0):
            return jnp.tanh(z @ self.wm).reshape(-1, 4, 8) * truncation_psi

        def synthesis_withTexture(self, ws, tex, c, v, static_feats=None, noise_mode="const",
                                  evaluation=False, rendering_overrides=None):
            B = ws.shape[0]
            f = jnp.concatenate(
                [jnp.mean(ws, axis=1)] + [jnp.mean(t, axis=(1, 2)) for t in tex]
                + [jnp.mean(s, axis=(1, 2)) for s in static_feats]
                + [jnp.mean(c, axis=1, keepdims=True),
                   jnp.mean(v["uvcoords_image"], axis=(1, 2, 3))[:, None]], axis=1)
            mark = 0.05 * evaluation + 0.03 * (rendering_overrides is not None)
            return {"image": jnp.tanh(f @ self.wi).reshape(B, MOCK_H, MOCK_H, 3) + mark,
                    "feature_image": (f @ self.wf).reshape(B, 8, 8, 4),
                    "triplane": (f @ self.wt).reshape(B, 3, 4, 4, 2)}

    class UPair(fnn.Module):
        def setup(self):
            self.texture_unet = TexUNet(MOCK_SHAPES["texture_unet"])
            self.triplane_unet = TriUNet(MOCK_SHAPES["triplane_unet"])

    class Net(fnn.Module):
        def setup(self):
            self.generator = Gen(MOCK_SHAPES["generator"])
            self.encoder = Holder(MOCK_SHAPES["encoder"])
            self.unet_encoder = UPair()
            self.black_uv_bg = self.variable("buffers", "black_uv_bg",
                                             lambda: -jnp.ones((1, 256, 256, 3)))

        def encode(self, x, train=False):
            return jnp.tanh(jnp.mean(x[..., :3], axis=(1, 2)) @ self.encoder.we).reshape(-1, 4, 8)

        backbone_feats = JaxNet.backbone_feats
        get_unet_uvinput = JaxNet.get_unet_uvinput
        multiT_chunk_inputs = JaxNet.multiT_chunk_inputs
        multiT_chunk_state = JaxNet.multiT_chunk_state

    return Net()


class _Params(torch.nn.Module):
    def __init__(self, W):
        super().__init__()
        for k, v in W.items():
            if isinstance(v, dict):
                setattr(self, k, _Params(v))
            else:
                setattr(self, k, torch.nn.Parameter(torch.from_numpy(v.copy())))


def _pool(x):  # [B, T, C, H, W] -> [B, T, C]
    return x.mean(dim=(3, 4))


class _TexUNet(_Params):
    def forward(self, x, r_list=None):
        h = torch.zeros(x.shape[0], 8) if r_list is None else r_list[0]
        m = _pool(x)
        for t in range(x.shape[1]):
            f = torch.tanh(torch.tanh(m[:, t] @ self.input_layer.w) @ self.body.w)
            h = torch.tanh(f @ self.up.wi + h @ self.up.wh)
        return [(h @ self.up.wo).reshape(-1, 4, 4, 2).permute(0, 3, 1, 2)], [h]


class _TriUNet(_Params):
    def forward(self, x, r_list=None):
        h = torch.zeros(x.shape[0], 8) if r_list is None else r_list[0]
        m = _pool(x)
        for t in range(x.shape[1]):
            f = torch.tanh(torch.tanh(m[:, t] @ self.input_layer.w) @ self.body.w)
            h = torch.tanh(f @ self.up.wi + h @ self.up.wh)
        return {"c": (0.1 * torch.tanh(h @ self.up.wsc).reshape(-1, 4, 4, 2).permute(0, 3, 1, 2),
                      (h @ self.up.wsh).reshape(-1, 4, 4, 2).permute(0, 3, 1, 2))}, [h]


def _nchw4(a):
    return a.reshape(-1, 4, 4, 2).permute(0, 3, 1, 2)


class _Synth:
    def __init__(self, fn):
        self.synthesis = fn


class _MockGen(_Params):
    noise = 0.0

    def __init__(self, W):
        super().__init__(W)
        self.texture_backbone = _Synth(self._tex)
        self.backbone = _Synth(self._static)

    def _tex(self, ws, return_list=True, noise_mode="const"):
        h = ws.mean(dim=1)
        return [_nchw4(h @ self.wx0), _nchw4(h @ self.wx1)]

    def _static(self, ws, return_list=True, feat_conditions=None, noise_mode="const"):
        h = ws.mean(dim=1)
        s0, s1 = torch.tanh(_nchw4(h @ self.ws0)), _nchw4(h @ self.ws1)
        if feat_conditions is not None:
            scale, shift = feat_conditions["c"]
            s0 = s0 * (1 + scale) + shift
            s1 = s1 + 0.5 * torch.tanh(shift)
        return [s0, s1]

    def mapping(self, z, c, truncation_psi=1.0):
        return torch.tanh(z @ self.wm).reshape(-1, 4, 8) * truncation_psi

    def synthesis_withTexture(self, ws, tex, c, v, static_feats=None, noise_mode="const",
                              evaluation=False, rendering_overrides=None, generator=None):
        B = ws.shape[0]
        f = torch.cat([ws.mean(dim=1)] + [t.mean(dim=(2, 3)) for t in tex]
                      + [s.mean(dim=(2, 3)) for s in static_feats]
                      + [c.mean(dim=1, keepdim=True),
                         v["uvcoords_image"].mean(dim=(1, 2, 3))[:, None]], dim=1)
        mark = 0.05 * evaluation + 0.03 * (rendering_overrides is not None)
        image = torch.tanh(f @ self.wi).reshape(B, MOCK_H, MOCK_H, 3).permute(0, 3, 1, 2) + mark
        if self.noise and not evaluation:  # the renderer's stochastic draws
            image = image + self.noise * torch.randn(image.shape, generator=generator)
        return {"image": image,
                "feature_image": (f @ self.wf).reshape(B, 8, 8, 4).permute(0, 3, 1, 2),
                "triplane": (f @ self.wt).reshape(B, 3, 4, 4, 2).permute(0, 1, 4, 2, 3)}


class _MockNet(torch.nn.Module):
    """The torch side of the mock: the port's own rollout blocks."""

    def __init__(self, W, noise=0.0):
        super().__init__()
        self.generator = _MockGen(W["generator"])
        self.generator.noise = noise
        self.encoder = _Params(W["encoder"])
        self.unet_encoder = torch.nn.Module()
        self.unet_encoder.texture_unet = _TexUNet(W["texture_unet"])
        self.unet_encoder.triplane_unet = _TriUNet(W["triplane_unet"])
        self.register_buffer("black_uv_bg", -torch.ones(1, 3, 256, 256))

    def encode(self, x):
        return torch.tanh(x[:, :3].mean(dim=(2, 3)) @ self.encoder.we).reshape(-1, 4, 8)

    backbone_feats = InversionNet.backbone_feats
    render_clip = InversionNet.render_clip
    _clip_inputs = InversionNet._clip_inputs
    _unets = InversionNet._unets
    get_unet_uvinput = InversionNet.get_unet_uvinput
    multiT_chunk_inputs = InversionNet.multiT_chunk_inputs
    multiT_chunk_state = InversionNet.multiT_chunk_state
    multiT_offsets = InversionNet.multiT_offsets
    multiT_final = InversionNet.multiT_final
    run_seq_multiT = InversionNet.run_seq_multiT
    run_seq = InversionNet.run_seq


def _mock_clip(seed, B=1, T=4, mask=True):
    """A seeded NHWC clip for the mock: 16² frames (with a head mask), the UV
    inputs at 256², cameras, uvcoords and z."""
    rng = np.random.RandomState(seed)
    image = rng.uniform(-1, 1, (B, T, MOCK_H, MOCK_H, 4 if mask else 3)).astype(np.float32)
    if mask:
        image[..., 3] = rng.uniform(0, 1, (B, T, MOCK_H, MOCK_H))
    uv = np.concatenate([rng.uniform(-1, 1, (B, T, 256, 256, 3)),
                         rng.uniform(-0.9, 0.9, (B, T, 256, 256, 2)),
                         rng.uniform(0, 1, (B, T, 256, 256, 1)) > 0.3], -1).astype(np.float32)
    return {"image": image, "uv": uv, "c": rng.randn(B, T, 25).astype(np.float32),
            "v": {"uvcoords_image": rng.uniform(-1, 1, (B, T, 256, 256, 3)).astype(np.float32)},
            "z": rng.randn(B, 8).astype(np.float32)}


def _port_clip(raw):
    out = {"image": _clip(raw["image"]), "uv": _clip(raw["uv"]), "c": torch.from_numpy(raw["c"]),
           "v": {"uvcoords_image": torch.from_numpy(raw["v"]["uvcoords_image"])}}
    if "z" in raw:
        out["z"] = torch.from_numpy(raw["z"])
    return out


def _mock_params_of(net):
    """The torch mock's parameters as the JAX tree's leaves: {dotted: array}."""
    return {k: p.detach().numpy() for k, p in net.named_parameters()}


def _flat_jax(params):
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            name = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict) or hasattr(v, "items"):
                walk(v, name)
            else:
                out[name] = np.asarray(v)

    walk(params, "")
    return out


def _biased_d(cfg, state=None):
    """A port `DualDiscriminator` whose 1-D parameters are moved off zero:
    with zero biases and the stage's zero cameras every logit is zero."""
    D = DualDiscriminator(**cfg)
    if state is not None:
        D.load_state_dict(state)
    with torch.no_grad():
        for p in D.parameters():
            if p.ndim == 1:
                p.add_(0.1)
    return D


def _jax_d(seed):
    from invertavatar_tpu.models.discriminator import DualDiscriminator as JaxD

    D = JaxD(**MOCK_D_CFG)
    d_vars = D.init(jax.random.PRNGKey(seed), {"image": jnp.zeros((1, MOCK_H, MOCK_H, 3)),
                                               "image_raw": jnp.zeros((1, 8, 8, 3))},
                    jnp.zeros((1, 25)))
    return D, _randomize({k: dict(v) for k, v in d_vars.items()}, seed + 1)


# (U-Net, Ireal frames, do_r1) of the two steps: schedule steps 0 and 1
MOCK_STEPS = (("tri", [0, 3], True), ("tex", [0, 2], False))


def test_fewshot_step_on_a_mock_net_matches_jax():
    """The step's machinery, port against JAX `make_fewshot_train_step` and
    `make_fewshot_d_step` (`FewshotPrograms`), on the mock network with a
    real `DualDiscriminator` at 16²: a 4-frame clip with the head mask in
    chunks of 2 (one carried GRU state), two scheduled steps (tri-plane
    U-Net, R1; texture U-Net), each Ireal on a frame selection, Igen with
    the adversarial term and the D phase; no-grad renders "exact", the
    grad-carrying ones "structured" (the mock marks the route a render
    took). Each phase's losses to 1e-4 relative; after the steps both U-Nets
    to 1e-6, their trunks, the generator and the encoder unchanged, D to
    2e-6 + 1e-6 of the entry; each Adam's step count is optax's."""
    import optax

    from invertavatar_tpu.train import inversion as jinv
    from invertavatar_tpu.train.loop_inversion import (
        FewshotPrograms,
        fewshot_tex_trainable as j_tex,
        fewshot_tri_trainable as j_tri,
        make_fewshot_d_step as j_dstep,
        make_fewshot_train_step as j_step,
        masked_adam as j_adam,
    )
    from invertavatar_tpu.train.state import TrainState as JState

    W = _mock_weights(41)
    raw = _mock_clip(42)
    wkw = dict(FS_WEIGHTS, lpips=0.3, lr_lpips=0.2, adv=0.05, adv_r1_gamma=2.0)
    jnet, (jD, d_vars) = _jax_mock_net(), _jax_d(43)
    params = _jax_params(W)
    buffers = {"buffers": {"black_uv_bg": -np.ones((1, 256, 256, 3), np.float32)}}
    progs = FewshotPrograms(jnet, _lp, jinv.InversionLossWeights(**wkw), d_module=jD,
                            fast_no_grad="exact", fast_grad="structured")
    txs = {"tex": j_adam(1e-4, j_tex), "tri": j_adam(1e-4, j_tri)}
    steps = {u: j_step(jnet, _lp, tx, jinv.InversionLossWeights(**wkw), frm_per_chunk=2,
                       programs=progs) for u, tx in txs.items()}
    d_tx = optax.adam(2e-4)
    d_step = j_dstep(jnet, jD, d_tx, jinv.InversionLossWeights(**wkw), frm_per_chunk=2,
                     programs=progs)
    opt_states = {u: tx.init(params) for u, tx in txs.items()}
    jd = JState(d_vars["params"], d_tx.init(d_vars["params"]),
                {k: v for k, v in d_vars.items() if k != "params"})
    jbatch = jax.tree_util.tree_map(jnp.asarray, raw)
    auxes_j = []
    for i, (unet, idx, r1) in enumerate(MOCK_STEPS):
        js = JState(params, opt_states[unet], buffers)
        key = jax.random.PRNGKey(i)
        js, aux = steps[unet](js, jbatch, key, do_igen=False, multiT=True,
                              fake_idx=jnp.asarray(idx))
        js, aux_g = steps[unet](js, jbatch, key, do_igen=True, multiT=True, d_params=jd.params)
        jd, aux_d = d_step(js, jd, jbatch, key, do_r1=r1)
        params, opt_states[unet] = js.params, js.opt_state
        auxes_j.append({**aux, **aux_g, **aux_d})

    net, D = _MockNet(W), DualDiscriminator(**MOCK_D_CFG)
    D.load_state_dict(jax_to_state_dict(d_vars), strict=True)
    w = port_inv.InversionLossWeights(**wkw)
    step = li.make_fewshot_train_step(net, _lp, w, frm_per_chunk=2, fast_no_grad="exact",
                                      fast_grad="structured")
    d_step_t = li.make_fewshot_d_step(net, w, frm_per_chunk=2, fast_no_grad="exact")
    opts = {"tex": li.masked_adam(net, 1e-4, li.fewshot_tex_trainable),
            "tri": li.masked_adam(net, 1e-4, li.fewshot_tri_trainable)}
    d_state = TrainState(D, torch.optim.Adam(D.parameters(), lr=2e-4))
    clip = _port_clip(raw)
    for (unet, idx, r1), aux_j in zip(MOCK_STEPS, auxes_j):
        state = TrainState(net, opts[unet])
        aux = step(state, clip, multiT=True, fake_idx=idx)
        aux.update(step(state, clip, do_igen=True, multiT=True, d_module=D))
        aux.update(d_step_t(d_state, clip, do_r1=r1))
        assert sorted(aux) == sorted(aux_j)
        for k in aux:
            np.testing.assert_allclose(float(aux[k]), float(aux_j[k]), rtol=1e-4, atol=1e-7,
                                       err_msg=k)
    assert "D/d_r1" in auxes_j[0] and "D/d_r1" not in auxes_j[1] and "Igen/adv" in auxes_j[1]

    flat_j, W_flat = _flat_jax(params), _flat_jax(_jax_params(W))
    for k, v in net.named_parameters():
        if li.unet_decoder_trainable(k):
            assert not np.array_equal(v.detach().numpy(), W_flat[k]), k
            np.testing.assert_allclose(v.detach().numpy(), flat_j[k], rtol=0, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(v.detach().numpy(), W_flat[k], err_msg=k)
            np.testing.assert_array_equal(flat_j[k], W_flat[k], err_msg=k)
    new_d = jax_to_state_dict({"params": jd.params})
    for k, v in D.state_dict().items():
        if k in new_d:
            torch.testing.assert_close(v, new_d[k], rtol=1e-6, atol=2e-6, msg=k)
    for u, opt in opts.items():
        count = int(opt_states[u][1].inner_state[0].count)
        assert count == 2 and all(int(st["step"]) == count for st in opt.state.values()), u
    assert all(int(st["step"]) == 2 for st in d_state.opt.state.values())


@pytest.mark.parametrize("phase", ["Ireal", "Ireal_multiT", "Igen"])
def test_frame_accumulation_matches_the_literal_loss(phase):
    """The step's gradient, accumulated frame by frame into the cut-off
    offsets and static features and then sent through the U-Nets once,
    equals the gradient of the literal loss over the whole rollout on the
    same mock network: Ireal over every frame (`fewshot_ireal_loss` over
    `run_seq`), Ireal on a selection with two chunks (`fewshot_ireal_multiT_loss`
    over `run_seq_multiT`), Igen (`fewshot_igen_loss` over `run_seq`). Both
    decoders train here (lr 0); their gradients to 1e-5 of the largest
    entry, the losses to 1e-6 relative."""
    W = _mock_weights(51)
    clip = _port_clip(_mock_clip(52))
    w = port_inv.InversionLossWeights(**dict(FS_WEIGHTS, lpips=0.3, lr_lpips=0.2, adv=0.0))
    net = _MockNet(W)
    opt = li.masked_adam(net, 0.0, li.unet_decoder_trainable)
    step = li.make_fewshot_train_step(net, _lp, w, frm_per_chunk=2)
    idx = [0, 3]
    aux = step(TrainState(net, opt), clip, do_igen=phase == "Igen",
               multiT=phase == "Ireal_multiT", fake_idx=idx if phase == "Ireal_multiT" else None)
    got = {k: p.grad.clone() for k, p in net.named_parameters() if p.grad is not None}

    net.zero_grad(set_to_none=True)
    G = net.generator
    args = (clip["c"], clip["v"], clip["uv"])
    if phase == "Ireal":
        total, losses = port_inv.fewshot_ireal_loss(
            lambda f, c, v, uv, ws: net.run_seq(f, c, v, uv, ws=ws), _lp, w, clip["image"], *args)
    elif phase == "Ireal_multiT":
        total, losses = port_inv.fewshot_ireal_multiT_loss(
            lambda f, c, v, uv, i, ws: net.run_seq_multiT(f, c, v, uv, frm_per_chunk=2, ws=ws,
                                                          return_idx=i),
            _lp, w, clip["image"], *args, idx)
    else:
        total, losses = port_inv.fewshot_igen_loss(
            lambda f, c, v, uv, ws: net.run_seq(f, c, v, uv, ws=ws), G.mapping,
            lambda ws, tex, static, c, v: net.render_clip(ws, tex, static, c, v),
            lambda ws: G.texture_backbone.synthesis(ws), lambda ws: G.backbone.synthesis(ws),
            _lp, w, clip["z"], *args)
    total.backward()
    ref = {k: p.grad for k, p in net.named_parameters() if p.grad is not None}
    assert sorted(got) == sorted(ref) and len(ref) == 7
    scale = max(g.abs().max().item() for g in ref.values())
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=1e-5 * scale, msg=k)
    prefix = "Igen/" if phase == "Igen" else "Ireal/"
    assert sorted(aux) == sorted(prefix + k for k in losses)
    for k, v in losses.items():
        np.testing.assert_allclose(float(aux[prefix + k]), float(v.detach()), rtol=1e-6, err_msg=k)


def test_phase_schedule_and_frame_draw_match_jax():
    """`fewshot_phase_schedule` against JAX over steps 0-79 (two curricula,
    two R1 intervals), and `fewshot_fake_idx` against the draw JAX's
    `train_fewshot` makes inline (`train/loop_inversion.py:1269-1276`)."""
    from invertavatar_tpu.train.loop_inversion import fewshot_phase_schedule as j_schedule

    for curriculum, interval in (((6, 12, 18), 16), ((2, 4, 4), 4)):
        assert [li.fewshot_phase_schedule(i, curriculum, interval) for i in range(80)] == \
            [j_schedule(i, curriculum, interval) for i in range(80)]
    for seed in (0, 3):
        for i in range(80):
            T = j_schedule(i)[1]
            Tc = min(6, T)
            npr = np.random.RandomState(seed * 1000003 + i)
            ref = np.concatenate([[0], 1 + npr.permutation(T - 1)[: Tc - 1]]).astype(np.int32)
            np.testing.assert_array_equal(li.fewshot_fake_idx(seed, i, T, Tc), ref)


def test_trainable_predicates_match_jax():
    """`unet_decoder_trainable` and `fewshot_{tex,tri}_trainable` select,
    through the weight bridge, the same parameters of the tiny few-shot
    network as JAX's predicates do of its tree: the U-Nets' decoders, not
    their trunks, the encoder or the generator."""
    from invertavatar_tpu.models.encoders import unet_encoders as ju
    from invertavatar_tpu.models.encoders.uvnet import InversionNet as JaxNet
    from invertavatar_tpu.train import loop_inversion as jli
    from tests.test_torch_fewshot import FS_GEN_CFG

    jnet = JaxNet(generator_cfg=FS_GEN_CFG, texture_out_channels=OUT_CH, trunk_layers_n=8)
    key = jax.random.PRNGKey(0)
    tex_u = ju.TriPlanefeatEncoder(inp_ch=7, res=None, out_channels=OUT_CH, trunk_layers_n=8)
    tri_u = ju.TriPlaneSFTfeatEncoder(inp_ch=6, res=None, channel_base=FS_GEN_CFG["channel_base"],
                                      channel_max=FS_GEN_CFG["channel_max"], trunk_layers_n=8)
    shapes = {
        **jax.eval_shape(lambda: jnet.init({"params": key}, jnp.zeros((1, 256, 256, 3)),
                                           method=lambda m, x: m.encode(x)))["params"],
        **jax.eval_shape(lambda: jnet.init(
            {"params": key, "buffers": key, "noise": key, "ray": key}, jnp.zeros((1, 32)),
            jnp.zeros((1, 25)), {"uvcoords_image": jnp.zeros((1, 256, 256, 3))},
            method=lambda m, z, c, v: m.generator(z, c, v)))["params"],
        "unet_encoder": {
            "texture_unet": jax.eval_shape(
                lambda: tex_u.init(key, jnp.zeros((1, 1, 64, 64, 7))))["params"],
            "triplane_unet": jax.eval_shape(
                lambda: tri_u.init(key, jnp.zeros((1, 1, 64, 64, 6))))["params"]}}
    port = InversionNet(FS_GEN_CFG, encoding_texture=True, encoding_triplane=True,
                        texture_out_channels=OUT_CH, trunk_layers_n=8)
    names = dict(port.named_parameters())
    for j_pred, t_pred in ((jli.unet_decoder_trainable, li.unet_decoder_trainable),
                           (jli.fewshot_tex_trainable, li.fewshot_tex_trainable),
                           (jli.fewshot_tri_trainable, li.fewshot_tri_trainable)):
        mask = jli.mask_params(shapes, j_pred)
        marked = jax.tree_util.tree_map(
            lambda s, m: np.full(s.shape, 1.0 if m else 0.0, np.float32), shapes, mask)
        bridged = jax_to_state_dict({"params": marked})
        assert set(bridged) <= set(names)
        assert {k for k, v in bridged.items() if v.numel() and v.flatten()[0] == 1} == \
            {k for k in names if t_pred(k)}, j_pred.__name__
        assert all(k in bridged for k in names if k.startswith("unet_encoder."))
    sel = {k for k in names if li.unet_decoder_trainable(k)}
    assert sel and not any(".body." in k or ".input_layer." in k for k in sel)
    assert any(k.startswith("unet_encoder.texture_unet.body.") for k in names)


def _mock_clips(n, start=0):
    for i in range(start, n):
        yield _port_clip(_mock_clip(60 + i, T=4))


def test_train_fewshot_trains_the_scheduled_decoder_and_resumes_bitwise(tmp_path):
    """Four steps of `train_fewshot` (curriculum (2, 4, 4) in chunks of 2,
    R1 every 2; the mock network with a stochastic render, a dual
    discriminator): each step moves the parity-selected decoder alone among
    the network's parameters (tri-plane on even steps) and D; four steps
    straight through, and two then a resume from `snapshot-final.pt` for
    the last two, end on the same bits (both decoders, both Adams, D and its
    Adam, the counters); the snapshot every 2 steps is written; every phase
    wrote its stats."""
    import json

    W = _mock_weights(61)
    d0 = DualDiscriminator(**MOCK_D_CFG).state_dict()
    moved = []

    def run(run_dir, max_steps, start=0, resume=None, watch=False):
        net, D = _MockNet(W, noise=0.01), _biased_d(MOCK_D_CFG, d0)
        cfg = li.InversionTrainConfig(run_dir=str(run_dir), batch_size=1, wd_reg_interval=2,
                                      seed=5, weights=port_inv.InversionLossWeights(**FS_WEIGHTS))
        last = {k: p.detach().clone() for k, p in net.named_parameters()}

        def on_step(i, nimg, aux):
            now = {k: p.detach().clone() for k, p in net.named_parameters()}
            moved.append((i, {k for k in now if not torch.equal(now[k], last[k])}))
            last.update(now)

        li.train_fewshot(net, _mock_clips(4, start), cfg, _lp, d_module=D, max_steps=max_steps,
                         multiT=(2, 4, 4), frm_per_chunk=2, resume_path=resume,
                         snapshot_every=2, on_step=on_step if watch else None, device="cpu")
        return torch.load(run_dir / "snapshot-final.pt", weights_only=True)

    straight = run(tmp_path / "a", 4, watch=True)
    run(tmp_path / "b", 2)
    resumed = run(tmp_path / "c", 4, start=2, resume=str(tmp_path / "b" / "snapshot-final.pt"))
    assert [i for i, _ in moved] == [0, 1, 2, 3]
    for i, names in moved:
        prefix = "unet_encoder.triplane_unet.up." if i % 2 == 0 else "unet_encoder.texture_unet.up."
        assert names and all(k.startswith(prefix) for k in names), (i, names)
    assert straight["step_idx"] == resumed["step_idx"] == 4
    assert straight["cur_nimg"] == resumed["cur_nimg"] == 4

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        return torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b

    for key in ("net", "opt", "d_state"):
        assert same(straight[key], resumed[key]), key
    d_start = _biased_d(MOCK_D_CFG, d0).state_dict()
    assert any(not torch.equal(v, d_start[k]) for k, v in straight["d_state"]["module"].items())
    assert sorted(p.name for p in (tmp_path / "a").iterdir() if p.name.startswith("snapshot-")) \
        == ["snapshot-00000002.pt", "snapshot-00000004.pt", "snapshot-final.pt"]
    with open(tmp_path / "a" / "stats.jsonl") as f:
        names = set(json.loads(f.readlines()[-1]))
    for prefix in ("Ireal/", "Igen/", "D/"):
        assert any(n.startswith(prefix) for n in names), prefix
    assert "D/d_r1" in names and "Igen/adv" in names


# ------------------------------------------------ the tiny network's blocks


def _tiny_train_cfg():
    """The few-shot absorb tests' tiny generator whose training renders are
    deterministic: mid-stratum offsets and tile-pooled importance depths
    (the structured sampling of `fast_grad="structured"`), so that the
    rollouts' renders need no overrides to agree."""
    from invertavatar_torch.train.fast_render import FAST_GRAD_STRUCTURED
    from tests.test_torch_fewshot import FS_GEN_CFG

    return dict(FS_GEN_CFG, rendering_kwargs=dict(FS_GEN_CFG["rendering_kwargs"],
                                                  **FAST_GRAD_STRUCTURED))


_TINY = {}


def _tiny_nets():
    """(JAX net, its variables, the port's net from them), built once per
    process."""
    if not _TINY:
        from invertavatar_tpu.models.encoders.uvnet import InversionNet as JaxNet
        from tests.test_torch_fewshot import _jax_variables
        from tests.test_torch_inversion import _NEVER_RUN

        _, variables = _jax_variables(seed=2)
        cfg = _tiny_train_cfg()
        jnet = JaxNet(generator_cfg=cfg, texture_out_channels=OUT_CH, trunk_layers_n=8)
        port = InversionNet(cfg, encoding_texture=True, encoding_triplane=True,
                            texture_out_channels=OUT_CH, trunk_layers_n=8)
        missing, unexpected = port.load_state_dict(jax_to_state_dict(variables), strict=False)
        assert unexpected == [] and all(k.startswith(_NEVER_RUN) for k in missing), missing
        _TINY.update(jnet=jnet, variables=variables, port=port.eval())
    return _TINY["jnet"], _TINY["variables"], _TINY["port"]


def _tiny_clip(seed, T=2):
    """A seeded NHWC clip at 256²: frames, UV inputs, the frontal camera and
    uvcoords of the JAX dry run's batch, per-frame offsets in the frames."""
    from tests.test_torch_fewshot import _inputs

    image, uv, c, uvc = _inputs(seed)
    image = np.stack([image[0] + 0.1 * np.sin(t + 1.0) for t in range(T)])[None]
    return {"image": image.astype(np.float32), "uv": np.repeat(uv[:1, None], T, 1),
            "c": np.repeat(c[:1, None], T, 1),
            "v": {"uvcoords_image": np.repeat(uvc[:1, None], T, 1)}}


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), -3, -1)


@pytest.mark.parametrize("block", ["chunk_inputs", "chunk_state", "final"])
def test_multiT_blocks_match_jax(block):
    """One block of the multi-T rollout of the tiny network (tiny IR-SE
    trunks, both ConvGRU U-Nets, a 2-frame chunk at 256², deterministic
    training renders), port against JAX as one `jax.jit` dispatch:
    `multiT_chunk_inputs` (the e4e render of the chunk and the U-Net
    inputs), `multiT_chunk_state` (both U-Nets' GRU states, carried from a
    state given in), `multiT_final` (the U-Nets from carried states, the SFT
    backbone, one render of the chunk). Every output to 1e-3 of its largest
    entry, the GRU states too (tests/test_torch_fewshot.py's bar)."""
    jnet, variables, port = _tiny_nets()
    raw = _tiny_clip(30)
    rngs = {"ray": jax.random.PRNGKey(9), "noise": jax.random.PRNGKey(10)}
    clip = _port_clip(raw)
    with torch.no_grad():
        ws = port.encode(clip["image"][:, 0])
        tex, static = port.backbone_feats(ws)
    ws_j = jnp.asarray(ws.numpy())
    tex_j = [jnp.asarray(_nhwc(f)) for f in tex]
    static_j = [jnp.asarray(_nhwc(f)) for f in static]
    rng = np.random.RandomState(31)
    uv_in = rng.uniform(-1, 1, (1, 2, 256, 256, 7)).astype(np.float32)
    tri_in = rng.uniform(-1, 1, (1, 2, 256, 256, 6)).astype(np.float32)
    if block != "chunk_inputs":
        # GRU states to carry in: the port's, after another chunk
        r_tex, r_tri = port.multiT_chunk_state(_clip(uv_in[:, ::-1]), _clip(tri_in[:, ::-1]))
        r_j = [[jnp.asarray(_nhwc(s)) for s in r] for r in (r_tex, r_tri)]

    if block == "chunk_inputs":
        ref = jax.jit(lambda v, f, c, vv, uv, w, t, s: jnet.apply(
            v, f, c, vv, uv, w, t, s, rngs=rngs, method=lambda m, *a: m.multiT_chunk_inputs(*a)))(
            variables, jnp.asarray(raw["image"]), jnp.asarray(raw["c"]),
            {"uvcoords_image": jnp.asarray(raw["v"]["uvcoords_image"])}, jnp.asarray(raw["uv"]),
            ws_j, tex_j, static_j)
        got = port.multiT_chunk_inputs(clip["image"], clip["c"], clip["v"], clip["uv"], ws, tex,
                                       static)
        pairs = [(got[0], np.moveaxis(np.asarray(ref[0]), -1, 2), "uv_input"),
                 (got[1], np.moveaxis(np.asarray(ref[1]), -1, 2), "tri_input"),
                 (got[2], np.moveaxis(np.asarray(ref[2]), -1, 1), "e4e_image")]
    elif block == "chunk_state":
        ref = jax.jit(lambda v, u, t, a, b: jnet.apply(
            v, u, t, a, b, method=lambda m, *x: m.multiT_chunk_state(*x)))(
            variables, jnp.asarray(uv_in), jnp.asarray(tri_in), *r_j)
        got = port.multiT_chunk_state(_clip(uv_in), _clip(tri_in), r_tex, r_tri)
        pairs = [(a, np.moveaxis(np.asarray(b), -1, 1), f"state {u}.{i}")
                 for u in range(2) for i, (a, b) in enumerate(zip(got[u], ref[u]))]
    else:
        ref = jax.jit(lambda v, u, t, a, b, w, tx, s, c, vv: jnet.apply(
            v, u, t, a, b, w, tx, s, c, vv, rngs=rngs,
            method=lambda m, *x: m.multiT_final(*x)))(
            variables, jnp.asarray(uv_in), jnp.asarray(tri_in), *r_j, ws_j, tex_j, static_j,
            jnp.asarray(raw["c"]), {"uvcoords_image": jnp.asarray(raw["v"]["uvcoords_image"])})
        with torch.no_grad():
            got = port.multiT_final(_clip(uv_in), _clip(tri_in), r_tex, r_tri, ws, tex, clip["c"],
                                    clip["v"])
        pairs = [(got[k], np.moveaxis(np.asarray(ref[k]), -1, 1), k)
                 for k in ("image", "feature_image")]
        pairs.append((got["triplane"], np.moveaxis(np.asarray(ref["triplane"]), -1, 2),
                      "triplane"))
    for a, b, what in pairs:
        _assert_rel(a.detach(), b, 1e-3, what)


# ------------------------------------------------------------- data and CLI


def _clip_folder(root, videos=2, frames=3, seed=0):
    """A preprocessed folder of `videos` videos of `frames` 512² frames each
    (`<vid>/<frame>.png`, listed out of name order), with camera labels,
    stored uvcoords and the UV inputs of each frame."""
    import json

    import PIL.Image

    from invertavatar_torch.flagship import example_inputs

    rng = np.random.RandomState(seed)
    _, c, uvc = example_inputs(1)
    img_dir = root / "images512x512"
    labels = {}
    for v in range(videos):
        for d in ("images512x512", "orthRender256x256_face_eye", "uvRender256x256"):
            (root / d / f"vid{v}").mkdir(parents=True, exist_ok=True)
        for f in reversed(range(frames)):
            stem = f"vid{v}/{f:04d}"
            labels[stem + ".png"] = (c[0] + 0.01 * (v * frames + f)).tolist()
            PIL.Image.fromarray(rng.randint(0, 255, (512, 512, 3), np.uint8)).save(
                img_dir / f"{stem}.png")
            np.save(root / "orthRender256x256_face_eye" / f"{stem}.npy",
                    uvc[0].astype(np.float16))
            np.save(root / "uvRender256x256" / f"{stem}.npy", uvc[0])
            PIL.Image.fromarray(rng.randint(0, 255, (256, 256, 3), np.uint8)).save(
                root / "uvRender256x256" / f"{stem}_uvgttex.png")
    with open(img_dir / "dataset_realcam.json", "w") as f:
        json.dump({"labels": labels}, f)
    return str(img_dir)


def test_video_dataset_matches_jax(tmp_path):
    """`VideoDataset` on a folder of two 3-frame videos: the same videos in
    frame order and, from equally seeded generators, the same clips (frames,
    cameras, uvcoords, UV inputs) bit for bit."""
    from invertavatar_tpu.data import dataset as jd

    from invertavatar_torch.data import dataset as pd

    path = _clip_folder(tmp_path)
    port = pd.VideoDataset(path, resolution=128, frm_per_vid=3)
    ref = jd.VideoDataset(path, resolution=128, frm_per_vid=3)
    assert port.num_videos == ref.num_videos == 2
    assert [[port.fnames[i] for i in v] for v in port.videos] == \
        [[ref.fnames[i] for i in v] for v in ref.videos]
    r_port, r_ref = np.random.RandomState(7), np.random.RandomState(7)
    for vidx, T in ((0, None), (1, 5), (1, 2)):
        a, b = port.sample_clip(vidx, r_port, T), ref.sample_clip(vidx, r_ref, T)
        assert sorted(a) == sorted(b) and a["image"].shape == (T or 3, 128, 128, 3)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype, k


def test_train_inversion_cli_fewshot(tmp_path, reference_pickler):
    """`cli/train_inversion.py --training_state fewshot` on a forged tiny
    generator pickle and two 2-frame videos at 256², one step on the CPU
    (the IR-SE-50 encoder and GRU U-Nets of the CLI, clips of 2 frames):
    the Ireal and Igen losses land in `stats.jsonl` and `snapshot-final.pt`
    is written; it is deleted (the U-Nets with their Adams are GBs)."""
    import json

    from invertavatar_torch.cli import train_inversion as cli
    from tests.test_torch_checkpoint import tiny_generator, write_gan_pkl

    data = _clip_folder(tmp_path / "data", frames=2, seed=3)
    write_gan_pkl(tmp_path / "gan.pkl", tiny_generator(seed=4))
    out = tmp_path / "run"
    try:
        cli.main(["--outdir", str(out), "--data", data, "--gen_pkl", str(tmp_path / "gan.pkl"),
                  "--training_state", "fewshot", "--batch", "1", "--frm_per_vid", "2", "--res",
                  "256", "--max-steps", "1", "--kimg", "1", "--device", "cpu"])
        with open(out / "stats.jsonl") as f:
            names = set().union(*(json.loads(line) for line in f))
        snaps = [p.name for p in out.iterdir() if p.name.startswith("snapshot-")]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    assert any(n.startswith("Ireal/") for n in names) and any(n.startswith("Igen/") for n in names)
    assert snaps == ["snapshot-final.pt"]


# ------------------------------------------------------------------- slow tier


@pytest.mark.slow
def test_run_seq_and_run_seq_multiT_match_jax():
    """The literal rollout `run_seq` and the chunked `run_seq_multiT` (chunks
    of 2 with a carried GRU state, frames 0 and 3 rendered) of the tiny
    network on a 4-frame clip, port against JAX run eagerly (as
    tests/test_loop_inversion.py::test_run_seq_multiT_rollout does: the
    rollouts hold several generator renders, whose one XLA program takes
    the CPU compiler too long). Renders, e4e renders, feature images and
    tri-planes to 1e-3 of each tensor's largest entry. Slow: ~5 minutes."""
    jnet, variables, port = _tiny_nets()
    raw = _tiny_clip(33, T=4)
    rngs = {"ray": jax.random.PRNGKey(9), "noise": jax.random.PRNGKey(10)}
    args = (jnp.asarray(raw["image"]), jnp.asarray(raw["c"]),
            {"uvcoords_image": jnp.asarray(raw["v"]["uvcoords_image"])}, jnp.asarray(raw["uv"]))
    with jax.disable_jit():
        ref = jnet.apply(variables, *args, rngs=rngs,
                         method=lambda m, f, c, v, uv: m.run_seq(f, c, v, uv))
        ref_m = jnet.apply(variables, *args, rngs=rngs,
                           method=lambda m, f, c, v, uv: m.run_seq_multiT(
                               f, c, v, uv, frm_per_chunk=2, return_idx=jnp.asarray([0, 3])))
    clip = _port_clip(raw)
    with torch.no_grad():
        got = port.run_seq(clip["image"], clip["c"], clip["v"], clip["uv"])
        got_m = port.run_seq_multiT(clip["image"], clip["c"], clip["v"], clip["uv"],
                                    frm_per_chunk=2, return_idx=[0, 3])
    for what, g, r in (("run_seq", got, ref), ("run_seq_multiT", got_m, ref_m)):
        for k in ("image", "e4e_image", "feature_image"):
            _assert_rel(g[k], np.moveaxis(np.asarray(r[k]), -1, -3), 1e-3, f"{what} {k}")
        _assert_rel(g["triplane"], np.moveaxis(np.asarray(r["triplane"]), -1, 2), 1e-3,
                    f"{what} triplane")
    assert got_m["image"].shape[:2] == (1, 2)


@pytest.mark.slow
def test_fewshot_step_tiny_net_matches_jax():
    """One step of the tiny network, port against JAX `make_fewshot_train_step`
    / `make_fewshot_d_step` under the deterministic overrides (no-grad renders
    "exact", grad-carrying ones "structured"): Ireal on frames 0 and 3 and
    Igen (the adversarial term) of a 4-frame clip in chunks of 2, training
    the tri-plane decoder, then D with R1 (a dual discriminator at 128²).
    Losses to 1e-4 relative. Adam's first step moves a parameter by about
    ±lr whatever its gradient, so where a gradient is float32 noise the two
    sides may step apart by up to 2·lr: the decoder agrees to 2e-6 on all but
    0.1% of its parameters and to 2·lr on every one, D likewise; everything
    else is unchanged on both sides. Slow: the JAX side runs op by op (its
    jitted programs compile for tens of minutes on the CPU)."""
    import optax

    from invertavatar_tpu.models.discriminator import DualDiscriminator as JaxD
    from invertavatar_tpu.train import inversion as jinv
    from invertavatar_tpu.train.loop_inversion import (
        FewshotPrograms,
        fewshot_tri_trainable as j_tri,
        make_fewshot_d_step as j_dstep,
        make_fewshot_train_step as j_step,
        masked_adam as j_adam,
    )
    from invertavatar_tpu.train.state import TrainState as JState

    import copy

    jnet, variables, port = _tiny_nets()
    port = copy.deepcopy(port)  # the step trains it
    d_cfg = dict(c_dim=25, img_resolution=128, img_channels=6, channel_base=1024, channel_max=64,
                 num_fp16_res=0)
    jD = JaxD(**d_cfg)
    d_vars = jD.init(jax.random.PRNGKey(40), {"image": jnp.zeros((1, 128, 128, 3)),
                                              "image_raw": jnp.zeros((1, 32, 32, 3))},
                     jnp.zeros((1, 25)))
    d_vars = _randomize({k: dict(v) for k, v in d_vars.items()}, 41)
    raw = dict(_tiny_clip(34, T=4), z=np.random.RandomState(35).randn(1, 32).astype(np.float32))
    wkw = dict(FS_WEIGHTS, lpips=0.5, lr_lpips=0.5)
    jw = jinv.InversionLossWeights(**wkw)
    progs = FewshotPrograms(jnet, lambda a, b: jnp.mean(jnp.abs(a - b)), jw, d_module=jD,
                            fast_no_grad="exact", fast_grad="structured")
    tx, d_tx = j_adam(1e-4, j_tri), optax.adam(2e-4)
    step = j_step(jnet, None, tx, jw, frm_per_chunk=2, programs=progs)
    d_step = j_dstep(jnet, jD, d_tx, jw, frm_per_chunk=2, programs=progs)
    params = variables["params"]
    buffers = {k: v for k, v in variables.items() if k != "params"}
    jbatch = jax.tree_util.tree_map(jnp.asarray, raw)
    jd = JState(d_vars["params"], d_tx.init(d_vars["params"]),
                {k: v for k, v in d_vars.items() if k != "params"})
    key = jax.random.PRNGKey(1)
    with jax.disable_jit():
        js = JState(params, tx.init(params), buffers)
        js, aux_j = step(js, jbatch, key, multiT=True, fake_idx=jnp.asarray([0, 3]))
        js, aux_g = step(js, jbatch, key, do_igen=True, multiT=True, d_params=jd.params)
        jd, aux_d = d_step(js, jd, jbatch, key, do_r1=True)
    aux_j = {**aux_j, **aux_g, **aux_d}

    D = DualDiscriminator(**d_cfg)
    D.load_state_dict(jax_to_state_dict(d_vars), strict=True)
    sd0 = {k: v.clone() for k, v in port.state_dict().items()}
    w = port_inv.InversionLossWeights(**wkw)
    l1 = lambda a, b: (a - b).abs().mean()  # noqa: E731
    step_t = li.make_fewshot_train_step(port, l1, w, 2, "exact", "structured")
    state = TrainState(port, li.masked_adam(port, 1e-4, li.fewshot_tri_trainable))
    clip = _port_clip(raw)
    aux = step_t(state, clip, multiT=True, fake_idx=[0, 3])
    aux.update(step_t(state, clip, do_igen=True, multiT=True, d_module=D))
    aux.update(li.make_fewshot_d_step(port, w, 2, "exact")(
        TrainState(D, torch.optim.Adam(D.parameters(), lr=2e-4)), clip, do_r1=True))
    assert sorted(aux) == sorted(aux_j) and "D/d_r1" in aux and "Igen/adv" in aux
    for k in aux:
        assert np.isfinite(float(aux[k])), k
        np.testing.assert_allclose(float(aux[k]), float(aux_j[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    new_sd = jax_to_state_dict({"params": js.params, **buffers})
    port_sd = port.state_dict()
    keys = [k for k in new_sd if li.fewshot_tri_trainable(k)]
    diff = torch.cat([(port_sd[k] - new_sd[k]).abs().flatten() for k in keys])
    moved = max((port_sd[k] - sd0[k]).abs().max() for k in keys)
    assert moved > 0 and diff.max() < 2e-4 and (diff > 2e-6).float().mean() < 1e-3, diff.max()
    for k, v in new_sd.items():
        if k not in keys:
            assert torch.equal(port_sd[k], v) and torch.equal(v, sd0[k]), k
    new_d = jax_to_state_dict({"params": jd.params})
    d_diff = torch.cat([(v - new_d[k]).abs().flatten() for k, v in D.state_dict().items()
                        if k in new_d])
    assert d_diff.max() < 4e-4 and (d_diff > 2e-6).float().mean() < 1e-3, d_diff.max()


def test_a_clip_off_the_chunk_grid_fails_as_in_jax():
    """A JAX fault the port keeps (ROADMAP C): `train_fewshot` cuts the clip
    to min(curriculum T, clip length) frames and the step takes a whole
    number of chunks, so 8-frame clips fail at step 1 (T = min(12, 8) = 8
    in chunks of 6) on the step's assertion, in JAX and in the port."""
    from invertavatar_tpu.train.loop_inversion import (
        fewshot_phase_schedule as j_schedule,
        make_fewshot_train_step as j_step,
    )
    from invertavatar_tpu.train.state import TrainState as JState

    T = min(j_schedule(1)[1], 8)
    assert T == min(li.fewshot_phase_schedule(1)[1], 8) == 8
    raw = _mock_clip(70, T=T)
    with pytest.raises(AssertionError):
        j_step(None, None, None, None, frm_per_chunk=6, programs=object())(
            JState(None, None, None), jax.tree_util.tree_map(jnp.asarray, raw), None,
            multiT=True)
    net = _MockNet(_mock_weights(70))
    step = li.make_fewshot_train_step(net, _lp, port_inv.InversionLossWeights(), 6)
    with pytest.raises(AssertionError):
        step(TrainState(net, li.masked_adam(net, 1e-4, li.fewshot_tri_trainable)),
             _port_clip(raw), multiT=True)


def test_minibatch_std_groups_a_batch_off_the_group_grid():
    """A JAX fault the port repairs (ROADMAP C): JAX's `MinibatchStdLayer`
    groups min(4, N) items and fails where that does not divide N, as in the
    few-shot D phase at batch 1 (6 or 18 frames). The port's groups the
    largest size up to 4 that divides N: JAX's result where JAX's runs (N =
    2, 8, 12) to 1e-6, groups of 3 at N = 6 (the statistic written out)."""
    from invertavatar_tpu.models.discriminator import MinibatchStdLayer as JaxMbstd

    from invertavatar_torch.models.discriminator import MinibatchStdLayer

    rng = np.random.RandomState(90)
    for N in (2, 8, 12):
        x = rng.randn(N, 4, 4, 8).astype(np.float32)
        ref = np.asarray(JaxMbstd().apply({}, jnp.asarray(x)))
        got = MinibatchStdLayer()(_flat(x))
        np.testing.assert_allclose(got.numpy(), np.moveaxis(ref, -1, 1), rtol=1e-6, atol=1e-6)
    x = rng.randn(6, 4, 4, 8).astype(np.float32)
    with pytest.raises(TypeError):
        JaxMbstd().apply({}, jnp.asarray(x))
    y = x.reshape(3, 2, 4, 4, 8)
    std = np.sqrt(((y - y.mean(axis=0)) ** 2).mean(axis=0) + 1e-8).mean(axis=(1, 2, 3))  # [2]
    got = MinibatchStdLayer()(_flat(x))
    np.testing.assert_allclose(got[:, 8, 0, 0].numpy(), np.tile(std, 3), rtol=1e-6)
    np.testing.assert_array_equal(got[:, :8].numpy(), np.moveaxis(x, -1, 1))
