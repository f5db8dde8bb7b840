"""Inversion-encoder training losses, e4e and one-shot stages (NCHW images).

Counterpart of the e4e and one-shot sections of
`invertavatar_tpu/train/inversion.py`: phases Ireal / Igen / Ireal_novel on
the W+ encoder against the frozen generator, and the latent discriminator's
loss with R1 on w; the one-shot U-Net stage's Ireal / Igen phases and its
dual discriminator's loss with R1 on both images; the few-shot stage's
clip losses (Igen's feature supervision, Ireal on a frame selection with
the head-mask composite, and their per-frame form). Each phase is a
function of callables, so tests can drive it with mocks. Where JAX wraps a
target in `stop_gradient`, the port computes it under `torch.no_grad()`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..ops.resize import resize_bilinear


@dataclasses.dataclass(frozen=True)
class InversionLossWeights:
    """Keys follow the reference YAML configs (encoder_inversion/config/*.yaml)."""

    l1: float = 1.0
    lpips: float = 0.8
    id: float = 0.1
    w_delta: float = 0.0
    w_regular: float = 0.0
    w_discriminator: float = 0.0
    raw_l1: float = 1.0
    tri: float = 1.0
    texture: float = 0.0
    lr_lpips: float = 0.0
    multiview_id: float = 0.0
    mouth: float = 0.0
    adv: float = 0.0
    wd_r1_gamma: float = 10.0
    adv_r1_gamma: float = 10.0


def _to256(img: torch.Tensor) -> torch.Tensor:
    if img.shape[2] != 256:
        return resize_bilinear(img, (256, 256), antialias=True)
    return img


def _total(weights: InversionLossWeights, losses):
    return sum(getattr(weights, k) * v for k, v in losses.items())


def _latent_terms(weights, ws_pred, latent_avg, wd_apply, losses):
    """The W+ code terms shared by Ireal and Igen (w_regular, w_discriminator,
    w_delta)."""
    if weights.w_regular > 0:
        losses["w_regular"] = torch.mean(torch.square(ws_pred - latent_avg[None]))
    if weights.w_discriminator > 0 and wd_apply is not None:
        fake_pred = wd_apply(ws_pred.reshape(-1, ws_pred.shape[-1]))
        losses["w_discriminator"] = torch.mean(F.softplus(-fake_pred))
    if weights.w_delta > 0:
        delta = ws_pred[:, 1:] - ws_pred[:, 0:1]
        losses["w_delta"] = torch.mean(torch.linalg.norm(delta, dim=2))


def e4e_igen_loss(e4e_apply: Callable, gen_mapping: Callable, gen_synthesis: Callable,
                  wd_apply: Optional[Callable], lpips: Callable,
                  weights: InversionLossWeights, latent_avg: torch.Tensor, z, c, v,
                  gen_synthesis_target: Optional[Callable] = None):
    """Igen: invert a generated image with feature-exact supervision.

    `gen_synthesis_target` (optional) renders the no-grad target; the training
    step passes a kernel fast path here while the student render keeps the
    differentiable one."""
    with torch.no_grad():
        ws_gen = gen_mapping(z, c, truncation_psi=0.6)
        gen_out = (gen_synthesis_target or gen_synthesis)(ws_gen, c, v)
    ws_pred = e4e_apply(_to256(gen_out["image"]))
    i_out = gen_synthesis(ws_pred, c, v)

    losses = {}
    _latent_terms(weights, ws_pred, latent_avg, wd_apply, losses)
    gen256, i256 = _to256(gen_out["image"]), _to256(i_out["image"])
    if weights.l1 > 0:
        losses["l1"] = torch.mean(torch.abs(gen256 - i256))
    if weights.lpips > 0:
        losses["lpips"] = lpips(gen256, i256)
    if weights.raw_l1 > 0:
        losses["raw_l1"] = torch.mean(torch.abs(gen_out["feature_image"] - i_out["feature_image"]))
    if weights.tri > 0:
        losses["tri"] = torch.mean(torch.abs(gen_out["triplane"] - i_out["triplane"]))
    if weights.lr_lpips > 0:
        losses["lr_lpips"] = lpips(gen_out["feature_image"][:, :3], i_out["feature_image"][:, :3])
    return _total(weights, losses), losses


def e4e_ireal_loss(e4e_apply: Callable, gen_synthesis: Callable, wd_apply: Optional[Callable],
                   lpips: Callable, id_fn: Optional[Callable], weights: InversionLossWeights,
                   latent_avg: torch.Tensor, real_img, real_c, real_v):
    """Ireal: invert a real image [B, 3(+mask), H, W]."""
    real256 = _to256(real_img[:, :3])
    ws_pred = e4e_apply(real256)
    fake256 = _to256(gen_synthesis(ws_pred, real_c, real_v)["image"])

    losses = {}
    _latent_terms(weights, ws_pred, latent_avg, wd_apply, losses)
    if weights.l1 > 0:
        losses["l1"] = torch.mean(torch.abs(real256 - fake256))
    if weights.lpips > 0:
        losses["lpips"] = lpips(real256, fake256)
    if weights.id > 0 and id_fn is not None:
        losses["id"] = id_fn(real256, fake256)
    return _total(weights, losses), losses


def e4e_ireal_novel_loss(e4e_apply: Callable, gen_synthesis: Callable, id_fn: Callable,
                         weights: InversionLossWeights, real_img, novel_c, real_v):
    """Ireal_novel: render the inverted code under another camera and demand
    ID consistency with the source image."""
    ws = e4e_apply(_to256(real_img[:, :3]))
    multiview = gen_synthesis(ws, novel_c, real_v)["image"]
    losses = {"multiview_id": id_fn(real_img[:, :3], multiview)}
    return weights.multiview_id * losses["multiview_id"], losses


def wd_losses(wd_apply: Callable, ws_fake: torch.Tensor, ws_real: torch.Tensor,
              weights: InversionLossWeights, do_r1: bool):
    """Latent discriminator phases; `ws_fake` / `ws_real` carry no gradient.
    R1 is the mean squared norm of d(Σ scores)/d(w_real), kept in the graph
    so that its gradient reaches the discriminator."""
    fake_flat = ws_fake.reshape(-1, ws_fake.shape[-1])
    real_flat = ws_real.reshape(-1, ws_real.shape[-1])
    loss_dgen = torch.mean(F.softplus(wd_apply(fake_flat)))
    loss_dreal = torch.mean(F.softplus(-wd_apply(real_flat)))
    total = loss_dgen + loss_dreal
    aux = {"wd_gen": loss_dgen, "wd_real": loss_dreal}
    if do_r1:
        w = real_flat.detach().requires_grad_(True)
        (grads,) = torch.autograd.grad(wd_apply(w).sum(), w, create_graph=True)
        r1 = torch.mean(torch.sum(torch.square(grads), dim=1))
        total = total + weights.wd_r1_gamma / 2 * r1
        aux["wd_r1"] = r1
    return total, aux


# ---------------------------------------------------------------- one-shot stage


def _adv_term(d_apply, i_out, c):
    """softplus(−D(fake)) of the inverter's render pair, the camera zeroed."""
    logits = d_apply({"image": i_out["image"], "image_raw": i_out["feature_image"][:, :3]},
                     torch.zeros_like(c))
    return torch.mean(F.softplus(-logits))


def oneshot_igen_loss(inv_forward: Callable, gen_mapping: Callable,
                      gen_synthesis_featmap: Callable, d_apply: Optional[Callable],
                      lpips: Callable, id_fn: Optional[Callable],
                      weights: InversionLossWeights, z, c, v, gen_uv):
    """Igen of the one-shot U-Net stage: invert a frozen-generator sample with
    exact feature supervision (+ the adversarial term when `adv > 0`).

    `inv_forward(x, c, v, return_feats)` is the inverter;
    `gen_synthesis_featmap(ws, c, v)` the target render, whose dict carries
    "image", "feature_image", "triplane" and (for `texture > 0`) "texture"."""
    with torch.no_grad():
        ws = gen_mapping(z, c, truncation_psi=0.8)
        gen_out = gen_synthesis_featmap(ws, c, v)
    i_out = inv_forward({"image": gen_out["image"], "uv": gen_uv}, c, v, weights.texture > 0)

    losses = {}
    if weights.adv > 0 and d_apply is not None:
        losses["adv"] = _adv_term(d_apply, i_out, c)
    gen256, i256 = _to256(gen_out["image"][:, :3]), _to256(i_out["image"])
    if weights.l1 > 0:
        losses["l1"] = torch.mean(torch.abs(gen256 - i256))
    if weights.lpips > 0:
        losses["lpips"] = lpips(gen256, i256)
    if weights.raw_l1 > 0:
        losses["raw_l1"] = torch.mean(torch.abs(gen_out["feature_image"] - i_out["feature_image"]))
    if weights.tri > 0:
        losses["tri"] = torch.mean(torch.abs(gen_out["triplane"] - i_out["triplane"]))
    if weights.texture > 0:
        losses["texture"] = sum(torch.mean(torch.abs(g - i))
                                for g, i in zip(gen_out["texture"], i_out["texture"]))
    if weights.lr_lpips > 0:
        losses["lr_lpips"] = lpips(gen_out["feature_image"][:, :3], i_out["feature_image"][:, :3])
    if weights.id > 0 and id_fn is not None:
        losses["id"] = id_fn(gen256, i256)
    return _total(weights, losses), losses


def oneshot_ireal_loss(inv_forward: Callable, d_apply: Optional[Callable], lpips: Callable,
                       id_fn: Optional[Callable], weights: InversionLossWeights,
                       real_img, real_c, real_v):
    """Ireal: invert a real frame, real_img {"image": [B, 3(+mask), H, W],
    "uv"}. With a mask channel the fake is composited onto the real
    background. The raw supervision works at the generator's neural render
    resolution. As the JAX package does, the ID term embeds the composite at
    its own resolution (not the 256² resize the other terms use): at 512²,
    `extract_feats` crops it with 256² indices."""
    i_out = inv_forward(real_img, real_c, real_v, False)
    image = real_img["image"]
    nrr = i_out["feature_image"].shape[2]
    real_raw = resize_bilinear(image[:, :3], (nrr, nrr), antialias=True)

    losses = {}
    if weights.adv > 0 and d_apply is not None:
        losses["adv"] = _adv_term(d_apply, i_out, real_c)
    fake = i_out["image"]
    if image.shape[1] > 3:
        mask = image[:, -1:]
        fake = fake * mask + image[:, :3] * (1.0 - mask)
    fake256, real256 = _to256(fake), _to256(image[:, :3])
    if weights.l1 > 0:
        losses["l1"] = torch.mean(torch.abs(real256 - fake256))
    if weights.lpips > 0:
        losses["lpips"] = lpips(real256, fake256)
    if weights.raw_l1 > 0:
        losses["raw_l1"] = torch.mean(torch.abs(real_raw - i_out["feature_image"][:, :3]))
    if weights.lr_lpips > 0:
        losses["lr_lpips"] = lpips(real_raw, i_out["feature_image"][:, :3])
    if weights.id > 0 and id_fn is not None:
        losses["id"] = id_fn(real256, fake)
    return _total(weights, losses), losses


def oneshot_d_loss(d_apply: Callable, fake_img, real_img, c, weights: InversionLossWeights,
                   do_r1: bool):
    """Dgen / Dreal (+ R1): the dual discriminator's softplus loss on the
    inverter's pair `fake_img` {"image", "image_raw"} (no gradient) and
    `real_img`; R1 is the mean squared norm of d(Σ scores) over both images
    of the real pair, by double backward, weighted `adv_r1_gamma / 2`."""
    c0 = torch.zeros_like(c)
    loss_dgen = torch.mean(F.softplus(d_apply(fake_img, c0)))
    if do_r1:
        real_img = {k: real_img[k].detach().requires_grad_(True) for k in ("image", "image_raw")}
    real_logits = d_apply(real_img, c0)
    loss_dreal = torch.mean(F.softplus(-real_logits))
    total = loss_dgen + loss_dreal
    aux = {"d_gen": loss_dgen, "d_real": loss_dreal}
    if do_r1:
        g_img, g_raw = torch.autograd.grad(real_logits.sum(),
                                           [real_img["image"], real_img["image_raw"]],
                                           create_graph=True)
        r1 = torch.mean(g_img.square().sum(dim=(1, 2, 3)) + g_raw.square().sum(dim=(1, 2, 3)))
        total = total + weights.adv_r1_gamma / 2 * r1
        aux["d_r1"] = r1
    return total, aux


# ---------------------------------------------------------------- few-shot stage


def fewshot_feature_losses(i_out, gen_out, lpips: Callable, weights: InversionLossWeights,
                           d_apply: Optional[Callable] = None):
    """Igen's terms on flat [B·T, ...] renders: the images' l1 / lpips after
    the 256² resize, raw_l1 / tri / lr_lpips against the frozen generator's
    target `gen_out` (no gradient), and the adversarial term when `adv > 0`
    and `d_apply(pair)` (the dual discriminator, cameras zeroed) is given."""
    losses = {}
    if weights.adv > 0 and d_apply is not None:
        logits = d_apply({"image": i_out["image"], "image_raw": i_out["feature_image"][:, :3]})
        losses["adv"] = torch.mean(F.softplus(-logits))
    gen256, i256 = _to256(gen_out["image"][:, :3]), _to256(i_out["image"])
    if weights.l1 > 0:
        losses["l1"] = torch.mean(torch.abs(gen256 - i256))
    if weights.lpips > 0:
        losses["lpips"] = lpips(gen256, i256)
    if weights.raw_l1 > 0:
        losses["raw_l1"] = torch.mean(torch.abs(gen_out["feature_image"] - i_out["feature_image"]))
    if weights.tri > 0:
        losses["tri"] = torch.mean(torch.abs(gen_out["triplane"] - i_out["triplane"]))
    if weights.lr_lpips > 0:
        losses["lr_lpips"] = lpips(gen_out["feature_image"][:, :3], i_out["feature_image"][:, :3])
    return _total(weights, losses), losses


def fewshot_igen_loss(inv_run_seq: Callable, gen_mapping: Callable, gen_synth_with_feats: Callable,
                      gen_tex_feats: Callable, gen_static_feats: Callable, lpips: Callable,
                      weights: InversionLossWeights, z, vid_c, vid_v, vid_uv):
    """Igen: a synthetic clip of the frozen generator (ψ 0.6, the first
    frame's camera), inverted by `inv_run_seq(frames, c, v, uv, ws)` and
    supervised feature by feature."""
    B, T = vid_c.shape[:2]
    with torch.no_grad():
        ws = gen_mapping(z, vid_c[:, 0], truncation_psi=0.6)
        gen_out = gen_synth_with_feats(ws, gen_tex_feats(ws), gen_static_feats(ws), vid_c, vid_v)
    frames = gen_out["image"].reshape(B, T, *gen_out["image"].shape[1:])
    i_out = inv_run_seq(frames, vid_c, vid_v, vid_uv, None)
    return fewshot_feature_losses(i_out, gen_out, lpips, weights)


def _image_terms(real, fake, lpips, weights):
    real256, fake256 = _to256(real), _to256(fake)
    losses = {}
    if weights.l1 > 0:
        losses["l1"] = torch.mean(torch.abs(real256 - fake256))
    if weights.lpips > 0:
        losses["lpips"] = lpips(real256, fake256)
    return _total(weights, losses), losses


def fewshot_image_losses(fake, real, lpips: Callable, weights: InversionLossWeights):
    """Ireal's terms on a rendered selection fake [B, Tc, 3, h, w] against
    the matching real frames [B, Tc, 3(+mask), H, W]: the first selected
    frame whole, the later ones composited onto the real background through
    the head mask when there is one."""
    B, Tc = fake.shape[:2]
    H, W = real.shape[3:]
    if fake.shape[3] != H:
        fake = resize_bilinear(fake.reshape(B * Tc, *fake.shape[2:]), (H, W)).reshape(
            B, Tc, -1, H, W)
    if real.shape[2] > 3 and Tc > 1:
        mask = real[:, 1:, -1:]
        later = fake[:, 1:] * mask + real[:, 1:, :3] * (1.0 - mask)
        fake = torch.cat([fake[:, :1], later], dim=1)
    return _image_terms(real[:, :, :3].reshape(B * Tc, 3, H, W), fake.reshape(B * Tc, -1, H, W),
                        lpips, weights)


def fewshot_image_loss_frame(fake, real, lpips: Callable, weights: InversionLossWeights,
                             masked: bool):
    """`fewshot_image_losses` of one frame (fake [B, 3, h, w], real [B,
    3(+mask), H, W]); `masked` composites through the head mask (the later
    selected frames). Every term is a mean over equal frames, so the clip's
    loss is the mean of these."""
    if fake.shape[2] != real.shape[2]:
        fake = resize_bilinear(fake, tuple(real.shape[2:]))
    if masked and real.shape[1] > 3:
        mask = real[:, -1:]
        fake = fake * mask + real[:, :3] * (1.0 - mask)
    return _image_terms(real[:, :3], fake, lpips, weights)


def fewshot_ireal_multiT_loss(inv_run_multiT: Callable, lpips: Callable,
                              weights: InversionLossWeights, vid_frames, vid_c, vid_v, vid_uv,
                              fake_idx, ws=None):
    """Ireal under the multi-T curriculum: `inv_run_multiT(frames, c, v, uv,
    fake_idx, ws)` rolls over all T frames and renders the `fake_idx`
    selection (frame 0 first), which the loss compares with those frames."""
    out = inv_run_multiT(vid_frames[:, :, :3], vid_c, vid_v, vid_uv, fake_idx, ws)
    real = vid_frames[:, torch.as_tensor(fake_idx, device=vid_frames.device)]
    return fewshot_image_losses(out["image"], real, lpips, weights)


def fewshot_ireal_loss(inv_run_seq: Callable, lpips: Callable, weights: InversionLossWeights,
                       vid_frames, vid_c, vid_v, vid_uv, ws=None):
    """Ireal on a real clip [B, T, 3(+mask), H, W] through the literal
    rollout `inv_run_seq(frames, c, v, uv, ws)`: the first frame whole, the
    later ones through the head mask."""
    B, T = vid_c.shape[:2]
    i_out = inv_run_seq(vid_frames[:, :, :3], vid_c, vid_v, vid_uv, ws)
    fake = i_out["image"].reshape(B, T, *i_out["image"].shape[1:])
    return fewshot_image_losses(fake, vid_frames, lpips, weights)
