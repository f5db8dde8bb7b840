"""e4e inversion stage: optimizer, training step and driver.

Counterpart of the e4e part of `invertavatar_tpu/train/loop_inversion.py`:
train `Encoder4Editing` against the frozen generator with the Ireal and Igen
phases, plus the latent discriminator (WD) when `w_discriminator > 0`.

JAX expresses the freeze as an optax mask and returns new states; here
`masked_adam` freezes every parameter outside the trainable subtree
(`requires_grad_(False)`, gradients still flow *through* the generator to the
codes) and a step updates the modules and optimizers in place. The JAX
step's "three programs" (grad Ireal, grad Igen, one update) become two
`backward()` calls accumulating into one Adam step; the WD step then runs on
the updated encoder, in the JAX order.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Iterator, Optional

import torch

from ..utils.checkpoint import restore_checkpoint, save_checkpoint
from ..utils.misc import resolve_device, to_device
from ..utils.stats import Collector, StatsLogger
from .fast_render import grad_overrides, nograd_overrides
from .inversion import (
    InversionLossWeights,
    e4e_igen_loss,
    e4e_ireal_loss,
    e4e_ireal_novel_loss,
    wd_losses,
)
from .state import TrainState


def e4e_trainable(name: str) -> bool:
    """Only the encoder trains in the e4e stage."""
    return name.startswith("encoder.")


def masked_adam(module: torch.nn.Module, lr: float, predicate: Callable[[str], bool],
                b1: float = 0.9, b2: float = 0.999) -> torch.optim.Adam:
    """Adam over the parameters whose dotted names pass `predicate`; all other
    parameters of `module` are frozen. torch's Adam is optax's: ε = 1e-8
    added after the square root of the bias-corrected second moment."""
    trainable = []
    for name, p in module.named_parameters():
        keep = predicate(name)
        p.requires_grad_(keep)
        if keep:
            trainable.append(p)
    return torch.optim.Adam(trainable, lr=lr, betas=(b1, b2), eps=1e-8)


def _e4e_closures(net, fast_igen_target: str, fast_grad: str):
    """(encode, gen_mapping, gen_synthesis, gen_synthesis_target) over `net`."""
    target_ov = nograd_overrides(fast_igen_target)
    grad_ov = grad_overrides(fast_grad)
    G = net.generator

    def synthesis(ws, c, v, overrides, evaluation):
        tex = G.texture_backbone.synthesis(ws, return_list=True, noise_mode="const")
        static = G.backbone.synthesis(ws, return_list=True, noise_mode="const")
        return G.synthesis_withTexture(ws, tex, c, v, static_feats=static, noise_mode="const",
                                       evaluation=evaluation, rendering_overrides=overrides)

    def gen_mapping(z, c, truncation_psi=1.0):
        return G.mapping(z, c, truncation_psi=truncation_psi)

    def gen_synthesis(ws, c, v):
        # the grad-carrying student render: evaluation stays False, so the
        # fused eval kernels (which have no backward) are never taken
        return synthesis(ws, c, v, grad_ov, False)

    gen_target = None
    if target_ov is not None:
        def gen_target(ws, c, v):
            return synthesis(ws, c, v, target_ov, True)

    return net.encode, gen_mapping, gen_synthesis, gen_target


def _wd_step(net, wd_state: TrainState, batch, weights, do_r1: bool):
    """One latent-discriminator update on codes of the (updated) encoder."""
    with torch.no_grad():
        ws_fake = net.encode(batch["image"])
        ws_real = net.generator.mapping(batch["z"], batch["c"], truncation_psi=0.8)
    # the encoder's phases also backpropagate into the WD: drop those grads
    wd_state.opt.zero_grad(set_to_none=True)
    total, aux = wd_losses(wd_state.module, ws_fake, ws_real, weights, do_r1)
    total.backward()
    wd_state.opt.step()
    return aux


def _make_e4e_step(net, lpips_fn, id_fn, weights: InversionLossWeights,
                   fast_igen_target: str, fast_grad: str, split: bool):
    encode, gen_mapping, gen_synthesis, gen_target = _e4e_closures(
        net, fast_igen_target, fast_grad)
    use_wd = weights.w_discriminator > 0

    def step(state: TrainState, wd_state: TrainState, batch: Dict,
             do_wd_reg: bool = False) -> Dict[str, torch.Tensor]:
        wd_apply = wd_state.module if use_wd else None
        state.opt.zero_grad(set_to_none=True)
        total, aux_r = e4e_ireal_loss(encode, gen_synthesis, wd_apply, lpips_fn, id_fn, weights,
                                      net.latent_avg, batch["image"], batch["c"], batch["v"])
        if split:
            total.backward()  # frees this phase's graph before the next render
            total = 0.0
        total_g, aux_g = e4e_igen_loss(encode, gen_mapping, gen_synthesis, wd_apply, lpips_fn,
                                       weights, net.latent_avg, batch["z"], batch["c"],
                                       batch["v"], gen_synthesis_target=gen_target)
        total = total + total_g
        aux = {f"Ireal/{k}": v.detach() for k, v in aux_r.items()}
        aux.update({f"Igen/{k}": v.detach() for k, v in aux_g.items()})
        if not split and weights.multiview_id > 0 and id_fn is not None:
            total_n, aux_n = e4e_ireal_novel_loss(
                encode, gen_synthesis, id_fn, weights, batch["image"],
                batch.get("gen_c", batch["c"]), batch["v"])
            total = total + total_n
            aux.update({f"Ireal_novel/{k}": v.detach() for k, v in aux_n.items()})
        total.backward()
        state.opt.step()
        if use_wd:
            aux.update({k: v.detach() for k, v in
                        _wd_step(net, wd_state, batch, weights, do_wd_reg).items()})
        return aux

    return step


def make_e4e_train_step(net, lpips_fn: Callable, id_fn: Optional[Callable],
                        weights: InversionLossWeights):
    """One step = Ireal + Igen (+ Ireal_novel when `multiview_id > 0` and an
    ID function is given), one backward, one Adam step, then the WD phase.

    Returns `step(state, wd_state, batch, do_wd_reg=False) -> aux`; `state`
    holds `net` and its `masked_adam`, `wd_state` the discriminator and its
    Adam. The batch is `{"image" [B,3,H,W] in [-1,1], "c" [B,25], "v"
    {"uvcoords_image" [B,256,256,3]}, "z" [B,z_dim]}` on the net's device."""
    return _make_e4e_step(net, lpips_fn, id_fn, weights, "off", "off", split=False)


def make_e4e_grad_programs(net, lpips_fn: Callable, id_fn: Optional[Callable],
                           weights: InversionLossWeights, fast_igen_target: str = "off",
                           fast_grad: str = "off", fast_interpret: bool = False):
    """The per-phase variant of `make_e4e_train_step` (same math): Ireal and
    Igen each run their own backward, so at most one render graph is alive,
    and their gradients accumulate into one Adam step.

    `fast_igen_target` / `fast_grad` pick the renderer overrides of the Igen
    target and of the student renders (`train/fast_render.py`);
    `fast_interpret` is accepted for the JAX signature and ignored."""
    if weights.multiview_id > 0 and id_fn is not None:
        raise NotImplementedError(
            "make_e4e_grad_programs does not carry the Ireal_novel phase; "
            "use make_e4e_train_step when multiview_id > 0")
    return _make_e4e_step(net, lpips_fn, id_fn, weights, fast_igen_target, fast_grad,
                          split=True)


@dataclasses.dataclass
class InversionTrainConfig:
    run_dir: str = "runs/inversion"
    total_kimg: int = 5000
    batch_size: int = 8
    lr: float = 1e-4
    wd_lr: float = 2e-5
    kimg_per_tick: int = 4
    snapshot_ticks: int = 20
    wd_reg_interval: int = 16
    seed: int = 0
    weights: InversionLossWeights = dataclasses.field(default_factory=InversionLossWeights)


def train_e4e(net, wd_module: torch.nn.Module, batch_iter: Iterator[Dict],
              cfg: InversionTrainConfig, lpips_fn: Callable, id_fn: Optional[Callable] = None,
              max_steps: Optional[int] = None, resume_path: Optional[str] = None,
              device="cuda"):
    """e4e-stage driver: `make_e4e_train_step` over `batch_iter` (dicts as
    that step takes, NCHW images in [-1, 1], on any device), with stats ticks
    every `kimg_per_tick` and snapshots (`snapshot-<nimg>.pt` in `run_dir`)
    every `snapshot_ticks` ticks and at `max_steps`. `resume_path` restores a
    snapshot. Runs on CUDA unless `device="cpu"` is asked for. Returns the
    (state, wd_state) it trained."""
    device = resolve_device(device)
    torch.manual_seed(cfg.seed)
    net.to(device)
    wd_module.to(device)
    state = TrainState(net, masked_adam(net, cfg.lr, e4e_trainable))
    wd_state = TrainState(wd_module, torch.optim.Adam(wd_module.parameters(), lr=cfg.wd_lr))

    cur_nimg = step_idx = 0
    if resume_path is not None:
        snap = restore_checkpoint(resume_path, map_location=device)
        state.load_state_dict(snap["state"])
        wd_state.load_state_dict(snap["wd_state"])
        cur_nimg, step_idx = int(snap["cur_nimg"]), int(snap["step_idx"])

    step_fn = make_e4e_train_step(net, lpips_fn, id_fn, cfg.weights)
    collector = Collector()
    logger = StatsLogger(cfg.run_dir)
    tick_nimg = cfg.kimg_per_tick * 1000
    next_tick = cur_nimg + tick_nimg
    t0 = time.time()

    def snapshot(tag):
        save_checkpoint(os.path.join(cfg.run_dir, tag), {
            "state": state.state_dict(), "wd_state": wd_state.state_dict(),
            "cur_nimg": cur_nimg, "step_idx": step_idx})

    while cur_nimg < cfg.total_kimg * 1000:
        batch = to_device(next(batch_iter), device)
        do_reg = step_idx % cfg.wd_reg_interval == 0 and cfg.weights.w_discriminator > 0
        aux = step_fn(state, wd_state, batch, do_wd_reg=do_reg)
        cur_nimg += cfg.batch_size
        step_idx += 1
        for k, v in aux.items():
            collector.report(k, v.float().cpu().numpy())
        done = bool(max_steps) and step_idx >= max_steps
        if cur_nimg >= next_tick or done:
            collector.update()
            print(f"kimg {cur_nimg / 1000:.1f} ({time.time() - t0:.0f}s) "
                  + " ".join(f"{n}={collector.mean(n):.4f}" for n in collector.names()))
            logger.write(collector, cur_nimg)
            next_tick = cur_nimg + tick_nimg
            if (cur_nimg // tick_nimg) % cfg.snapshot_ticks == 0 or done:
                snapshot(f"snapshot-{cur_nimg:08d}.pt")
        if done:
            break
    logger.close()
    return state, wd_state
