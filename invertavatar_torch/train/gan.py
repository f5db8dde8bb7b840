"""3D-GAN training step, plain PyTorch.

Counterpart of `invertavatar_tpu/train/gan.py` (reference
`training_avatar_texture/loss.py` and the phase loop of `training_loop.py`):
one step runs Gmain (with the density-TV Greg fused in on its lazy
interval), then Dmain (with the R1 Dreg fused in on its interval). The G
pass of Dmain updates the mapping's `w_avg` EMA, as the reference does. R1
differentiates the real logits with respect to both the 512² image and the
raw image (`torch.autograd.grad(create_graph=True)`). ADA, when given,
transforms the discriminator's `[image ‖ up(raw)]` pair with one draw.

Schedules that vary per step (blur kernel, conditioning-swap probability,
ADA probability) are computed on the host (`make_schedules`); the neural
rendering resolution of a step (`neural_rendering_resolution`) is set on the
generator for that step. Randomness (noise, ray strata, importance samples,
swaps, density probes, ADA) comes from one `torch.Generator` per step.

With a data mesh (`parallel/mesh.py`) each rank runs the step on its rows of
the global batch inside `use_mesh`: per-item draws are made over the global
batch, the swap's roll and the minibatch std see the global batch, and each
phase's gradients are averaged over ranks (`all_reduce_grads`) before the
optimizer's NaN scrub and step, so N ranks compute the step of one process
on the global batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.resize import resize_bilinear
from ..ops.upfirdn2d import filter2d
from ..parallel.mesh import (DataMesh, all_reduce_grads, batch_rand, gather_rows, take_rows,
                             use_mesh)
from .state import TrainState


@dataclasses.dataclass(frozen=True)
class GANLossConfig:
    r1_gamma: float = 8.0
    blur_init_sigma: float = 0.0
    blur_fade_kimg: float = 0.0
    gpc_reg_fade_kimg: float = 1000.0
    gpc_reg_prob: Optional[float] = None
    neural_rendering_resolution_initial: int = 64
    neural_rendering_resolution_final: Optional[int] = 128
    neural_rendering_resolution_fade_kimg: float = 1000.0
    density_reg: float = 0.25
    density_reg_p_dist: float = 0.004
    reg_type: str = "l1"
    g_reg_interval: int = 4
    d_reg_interval: int = 16
    blur_raw_target: bool = True
    ada_target: Optional[float] = None
    ada_interval: int = 4
    ada_kimg: float = 500.0


class Schedules(NamedTuple):
    """Per-step scheduled inputs (host values)."""

    blur_kernel: np.ndarray  # [K] normalised 1-D gaussian (identity when off)
    swapping_prob: float  # < 0: no swapping, the pose label is zeroed
    augment_p: float  # the ADA probability (0: off)


def make_schedules(cfg: GANLossConfig, cur_nimg: int, max_blur_width: int = 61,
                   augment_p: float = 0.0) -> Schedules:
    """The blur fade (σ from `blur_init_sigma` to 0 over `blur_fade_kimg`, a
    fixed-width kernel), the conditioning-swap ramp and the ADA probability."""
    blur_sigma = (max(1 - cur_nimg / (cfg.blur_fade_kimg * 1e3), 0) * cfg.blur_init_sigma
                  if cfg.blur_fade_kimg > 0 else 0.0)
    blur_size = int(np.floor(blur_sigma * 3))
    f = np.zeros(max_blur_width, np.float32)
    half = max_blur_width // 2
    if blur_size > 0:
        xs = np.arange(-blur_size, blur_size + 1)
        k = np.exp2(-np.square(xs / blur_sigma))
        f[half - blur_size:half + blur_size + 1] = k / k.sum()
    else:
        f[half] = 1.0
    if cfg.gpc_reg_prob is not None:
        alpha = (min(cur_nimg / (cfg.gpc_reg_fade_kimg * 1e3), 1)
                 if cfg.gpc_reg_fade_kimg > 0 else 1)
        swap = (1 - alpha) * 1 + alpha * cfg.gpc_reg_prob
    else:
        swap = -1.0
    return Schedules(f, float(np.float32(swap)), float(np.float32(augment_p)))


def neural_rendering_resolution(cfg: GANLossConfig, cur_nimg: int) -> int:
    """The neural rendering resolution at `cur_nimg`: the linear fade from
    the initial to the final value, rounded."""
    if cfg.neural_rendering_resolution_final is None:
        return cfg.neural_rendering_resolution_initial
    alpha = min(cur_nimg / (cfg.neural_rendering_resolution_fade_kimg * 1e3), 1)
    return int(np.rint(cfg.neural_rendering_resolution_initial * (1 - alpha)
                       + cfg.neural_rendering_resolution_final * alpha))


def _blur(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Separable gaussian blur of NCHW images by the schedule's kernel."""
    return filter2d(img, torch.from_numpy(np.asarray(kernel, np.float32)))


def _swap_conditioning(c: torch.Tensor, swapping_prob: float,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
    """The pose label each item conditions on: its own, or (with
    `swapping_prob`) the previous item's of the global batch; zeros when
    swapping is off."""
    take = batch_rand((c.shape[0], 1), generator, c.device) < swapping_prob
    if swapping_prob < 0:
        return torch.zeros_like(c)
    return torch.where(take, take_rows(torch.roll(gather_rows(c), 1, dims=0)), c)


def _grads(loss: torch.Tensor, params, **kw):
    """d loss / d params, zeros where a parameter does not reach the loss."""
    grads = torch.autograd.grad(loss, params, allow_unused=True, **kw)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def run_discriminator(D, img: Dict[str, torch.Tensor], c: torch.Tensor, sched: Schedules,
                      generator: Optional[torch.Generator] = None,
                      augment_pipe=None) -> torch.Tensor:
    """D's logits of an image pair: the 512² image blurred by the schedule,
    then (with ADA) the `[image ‖ up(raw)]` pair transformed by one draw and
    split, the raw half resized back."""
    image = _blur(img["image"], sched.blur_kernel)
    image_raw = img["image_raw"]
    if augment_pipe is not None:
        H, raw_res = image.shape[2], image_raw.shape[2]
        pair = torch.cat([image, resize_bilinear(image_raw, (H, H), antialias=True)], dim=1)
        pair = augment_pipe(pair, sched.augment_p, generator)
        nch = image.shape[1]
        image = pair[:, :nch]
        image_raw = resize_bilinear(pair[:, nch:], (raw_res, raw_res), antialias=True)
    return D({"image": image, "image_raw": image_raw}, c, generator=generator)


def discriminator_loss(D, gen_img: Dict[str, torch.Tensor], real_image: torch.Tensor, nrr: int,
                       c: torch.Tensor, sched: Schedules, cfg: GANLossConfig, do_dreg: bool,
                       generator: Optional[torch.Generator] = None, augment_pipe=None):
    """Dmain (+ the R1 Dreg, weighted by `d_reg_interval`): softplus(D(fake))
    + softplus(−D(real)) on the real image beside its `nrr`² antialiased
    resize (blurred too with `blur_raw_target`); R1 is the squared norm of
    d D(real) / d (image, raw). Returns (the loss to differentiate, metrics)."""
    real_raw = resize_bilinear(real_image, (nrr, nrr), antialias=True)
    if cfg.blur_raw_target:
        real_raw = _blur(real_raw, sched.blur_kernel)
    loss_dgen = F.softplus(run_discriminator(D, gen_img, c, sched, generator,
                                             augment_pipe)).mean()
    if do_dreg:
        real_image = real_image.detach().requires_grad_(True)
        real_raw = real_raw.detach().requires_grad_(True)
    real_logits = run_discriminator(D, {"image": real_image, "image_raw": real_raw}, c, sched,
                                    generator, augment_pipe)
    loss_dreal = F.softplus(-real_logits).mean()
    total = loss_dgen + loss_dreal
    metrics = {"Loss/D/loss": (loss_dgen + loss_dreal).detach(),
               "Loss/scores/real": real_logits.detach().mean(),
               "Loss/signs/real": real_logits.detach().sign().mean()}
    if do_dreg:
        r1_img, r1_raw = torch.autograd.grad(real_logits.sum(), [real_image, real_raw],
                                             create_graph=True)
        r1_penalty = r1_img.square().sum(dim=(1, 2, 3)) + r1_raw.square().sum(dim=(1, 2, 3))
        total = total + r1_penalty.mean() * (cfg.r1_gamma / 2) * float(cfg.d_reg_interval)
        metrics["Loss/r1_penalty"] = r1_penalty.detach().mean()
    return total, metrics


def make_gan_train_step(G, D, cfg: GANLossConfig, nrr: int, do_greg: bool, do_dreg: bool,
                        augment_pipe=None, mesh: Optional[DataMesh] = None):
    """One GAN step at neural rendering resolution `nrr`, with or without the
    two regularisation phases. Returns

        step(g_state, d_state, batch, sched, generator, apply=True) -> metrics

    batch {"image" [B, 3, R, R] in [-1, 1], "c" [B, 25], "v":
    {"uvcoords_image"}, "z" [B, z_dim]} on the models' device. The step leaves
    each phase's gradients in the parameters' `.grad` (replacing them) and,
    with `apply`, steps each optimizer (G's before the Dmain pass, as JAX
    does); without it no parameter changes, and the gradients can be read.
    With `mesh` the batch is this rank's rows, the step runs inside
    `use_mesh(mesh)` and the gradients are the mean over ranks. `metrics`
    are 0-d tensors, this rank's."""
    g_gain = float(cfg.g_reg_interval) if do_greg else 1.0

    def run_G(z, c, v, sched, gen, update_emas):
        G.neural_rendering_resolution = nrr
        c_cond = _swap_conditioning(c, sched.swapping_prob, gen)
        ws = G.mapping(z, c_cond, update_emas=update_emas)
        return G.synthesis(ws, c, v, noise_mode="random", generator=gen)

    def set_grads(params, grads):
        for p, g in zip(params, grads):
            p.grad = g
        if mesh is not None:
            all_reduce_grads(mesh, params)

    def step(g_state: TrainState, d_state: TrainState, batch: Dict, sched: Schedules,
             generator: Optional[torch.Generator] = None, apply: bool = True):
        with use_mesh(mesh):
            return run_step(g_state, d_state, batch, sched, generator, apply)

    def run_step(g_state, d_state, batch, sched, generator, apply):
        z, c, v = batch["z"], batch["c"], batch["v"]
        g_params = [p for p in G.parameters() if p.requires_grad]
        d_params = [p for p in D.parameters() if p.requires_grad]

        # Gmain (+ the density-TV Greg)
        gen_img = run_G(z, c, v, sched, generator, False)
        gen_logits = run_discriminator(D, gen_img, c, sched, generator, augment_pipe)
        total = loss_gmain = F.softplus(-gen_logits).mean()
        metrics = {"Loss/G/loss": loss_gmain.detach(),
                   "Loss/scores/fake": gen_logits.detach().mean()}
        if do_greg and cfg.density_reg > 0 and cfg.reg_type == "l1":
            tv = density_tv(G, z, c, v, sched, cfg, generator)
            total = total + tv * g_gain
            metrics["Loss/G/reg"] = tv.detach()
        set_grads(g_params, _grads(total, g_params))
        del gen_img, gen_logits, total
        if apply:
            g_state.opt.step()

        # Dmain (+ R1 Dreg); the G pass updates the mapping's w_avg
        with torch.no_grad():
            out = run_G(z, c, v, sched, generator, True)
        total, d_metrics = discriminator_loss(
            D, {"image": out["image"], "image_raw": out["image_raw"]}, batch["image"], nrr, c,
            sched, cfg, do_dreg, generator, augment_pipe)
        metrics.update(d_metrics)
        set_grads(d_params, _grads(total, d_params))
        if apply:
            d_state.opt.step()
        return metrics

    return step


def density_tv(G, z, c, v, sched: Schedules, cfg: GANLossConfig,
               generator: Optional[torch.Generator] = None,
               coords: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The density TV regulariser (×`density_reg`): the mean |σ(x) − σ(x + δ)|
    over 1,000 uniform points x in [−1, 1]³ per item and δ ~ N(0,
    `density_reg_p_dist`²), through `sample_mixed` with a swapped pose label.
    `coords` [B, 2000, 3] (the points, then their perturbed copies) replaces
    the draws of the points."""
    c_cond = _swap_conditioning(c, sched.swapping_prob, generator)
    if coords is None:
        B = z.shape[0]
        init = batch_rand((B, 1000, 3), generator, z.device) * 2 - 1
        pert = init + batch_rand(init.shape, generator, z.device,
                                 normal=True) * cfg.density_reg_p_dist
        coords = torch.cat([init, pert], dim=1)
    ws = G.mapping(z, c_cond)
    sigma = G.sample_mixed(coords, ws, v, noise_mode="random", generator=generator)["sigma"]
    half = sigma.shape[1] // 2
    return (sigma[:, :half] - sigma[:, half:]).abs().mean() * cfg.density_reg
