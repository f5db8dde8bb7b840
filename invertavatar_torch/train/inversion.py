"""Inversion-encoder training losses, e4e stage (NCHW images).

Counterpart of the e4e section of `invertavatar_tpu/train/inversion.py`:
phases Ireal / Igen / Ireal_novel on the W+ encoder against the frozen
generator, and the latent discriminator's loss with R1 on w. Each phase is a
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
