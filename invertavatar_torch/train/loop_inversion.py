"""Inversion training stages e4e and one-shot: optimizers, steps and drivers.

Counterpart of the e4e and one-shot parts of
`invertavatar_tpu/train/loop_inversion.py`:
  * e4e: train `Encoder4Editing` against the frozen generator with the Ireal
    and Igen phases, plus the latent discriminator (WD) when
    `w_discriminator > 0`;
  * one-shot: train one of the two U-Nets of a (SegFormer) `InversionNet`
    per step, by the reference's interval schedule, with the Ireal / Igen
    phases and the dual discriminator's Dreal / Dgen phases (R1 every
    `wd_reg_interval` steps) when `adv > 0`.

JAX expresses the freeze as an optax mask and returns new states; here
`masked_adam` freezes every parameter outside the trainable subtree
(`requires_grad_(False)`, gradients still flow *through* the generator to the
codes) and a step updates the modules and optimizers in place. The JAX
step's "programs" (grad Ireal, grad Igen, one update) become `backward()`
calls accumulating into one Adam step; no-grad renders run under
`torch.no_grad()`. The JAX options that only steer XLA's memory plan
(`remat`, `donate`, `grad_subtree`, `subtree_tx`) have no counterpart.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Iterator, Optional

import torch

from ..ops.resize import resize_bilinear
from ..utils.checkpoint import restore_checkpoint, save_checkpoint
from ..utils.misc import resolve_device, to_device
from ..utils.stats import Collector, StatsLogger
from .fast_render import grad_overrides, nograd_overrides
from .inversion import (
    InversionLossWeights,
    e4e_igen_loss,
    e4e_ireal_loss,
    e4e_ireal_novel_loss,
    oneshot_d_loss,
    oneshot_igen_loss,
    oneshot_ireal_loss,
    wd_losses,
)
from .loop_gan import step_generator
from .state import TrainState


def e4e_trainable(name: str) -> bool:
    """Only the encoder trains in the e4e stage."""
    return name.startswith("encoder.")


def oneshot_tex_trainable(name: str) -> bool:
    """One-shot stage, the texture U-Net's optimizer."""
    return name.startswith("unet_encoder.texture_unet.")


def oneshot_tri_trainable(name: str) -> bool:
    """One-shot stage, the tri-plane SFT U-Net's optimizer."""
    return name.startswith("unet_encoder.triplane_unet.")


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


def _train_only(net: torch.nn.Module, opt: torch.optim.Optimizer) -> None:
    """Make exactly the parameters `opt` steps trainable in `net` (the
    one-shot stage holds one optimizer per U-Net and trains one per step)."""
    keep = {id(p) for group in opt.param_groups for p in group["params"]}
    for p in net.parameters():
        p.requires_grad_(id(p) in keep)


def _adam_step(opt: torch.optim.Optimizer) -> None:
    """`opt.step()` with a zero gradient for every parameter that got none:
    optax updates (and counts) every leaf of its mask on each step, so
    torch's per-parameter step count stays optax's per-state count."""
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    opt.step()


def _make_oneshot_step(net, lpips_fn, id_fn, weights: InversionLossWeights,
                       fast_igen_target: str, fast_grad: str):
    target_ov = nograd_overrides(fast_igen_target)
    grad_ov = grad_overrides(fast_grad)
    G = net.generator

    def inv_forward(gen):
        def fwd(x, c, v, return_feats):
            return net(x, c, v, return_feats=return_feats, nograd_render=target_ov,
                       grad_render=grad_ov, generator=gen)
        return fwd

    def gen_mapping(z, c, truncation_psi=1.0):
        return G.mapping(z, c, truncation_psi=truncation_psi)

    def gen_synthesis_featmap(gen):
        def synth(ws, c, v):
            return G.synthesis(ws, c, v, return_featmap=True, noise_mode="const",
                               evaluation=target_ov is not None,
                               rendering_overrides=target_ov, generator=gen)
        return synth

    def step(state: TrainState, d_state: Optional[TrainState], batch: Dict,
             phase: str = "Ireal", do_r1: bool = False,
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        fwd = inv_forward(generator)
        if phase in ("Igen", "Ireal"):
            # only the scheduled U-Net trains: the generator, the e4e encoder,
            # the other U-Net and D keep no gradient
            _train_only(net, state.opt)
            d_apply = None
            if weights.adv > 0 and d_state is not None:
                d_state.module.requires_grad_(False)
                d_apply = d_state.module
            net.zero_grad(set_to_none=True)  # the other U-Net's last gradients too
            if phase == "Igen":
                total, losses = oneshot_igen_loss(
                    fwd, gen_mapping, gen_synthesis_featmap(generator), d_apply, lpips_fn, id_fn,
                    weights, batch["z"], batch["c"], batch["v"], batch.get("gen_uv"))
            else:
                total, losses = oneshot_ireal_loss(
                    fwd, d_apply, lpips_fn, id_fn, weights,
                    {"image": batch["image"], "uv": batch["uv"]}, batch["c"], batch["v"])
            total.backward()
            _adam_step(state.opt)
            return {f"{phase}/{k}": v.detach() for k, v in losses.items()}

        assert phase in ("Dgen", "Dreal") and d_state is not None, phase
        with torch.no_grad():
            if phase == "Dgen":
                ws = gen_mapping(batch["z"], batch["c"], truncation_psi=0.8)
                gen_out = gen_synthesis_featmap(generator)(ws, batch["c"], batch["v"])
                i_out = fwd({"image": gen_out["image"], "uv": batch.get("gen_uv")},
                            batch["c"], batch["v"], False)
                real_pair = {"image": gen_out["image"][:, :3],
                             "image_raw": gen_out["feature_image"][:, :3]}
            else:
                i_out = fwd({"image": batch["image"], "uv": batch["uv"]}, batch["c"],
                            batch["v"], False)
                real = batch["image"][:, :3]
                real_pair = {"image": real,
                             "image_raw": resize_bilinear(real, (128, 128), antialias=True)}
            fake_pair = {"image": i_out["image"], "image_raw": i_out["feature_image"][:, :3]}
        d_state.module.requires_grad_(True)
        d_state.opt.zero_grad(set_to_none=True)
        total, aux = oneshot_d_loss(d_state.module, fake_pair, real_pair, batch["c"], weights,
                                    do_r1)
        total.backward()
        _adam_step(d_state.opt)
        return {f"{phase}/{k}": v.detach() for k, v in aux.items()}

    return step


def make_oneshot_train_step(net, lpips_fn: Callable, id_fn: Optional[Callable],
                            weights: InversionLossWeights, fast_igen_target: str = "off",
                            fast_grad: str = "off"):
    """The one-shot U-Net stage's step. Returns `step(state, d_state, batch,
    phase="Ireal", do_r1=False, generator=None) -> aux`:
      * `phase` "Igen" or "Ireal": the inverter's loss (the adversarial term
        through `d_state.module` when `adv > 0`), one backward, one step of
        `state.opt`, whose parameters (one U-Net's, `masked_adam` with
        `oneshot_tex_trainable` / `oneshot_tri_trainable`) are the only ones
        made trainable in `state.module`;
      * `phase` "Dgen" or "Dreal": the student forward without gradient, then
        the dual discriminator's loss (R1 with `do_r1`) and one step of
        `d_state.opt`.
    `d_state` holds the `DualDiscriminator` and its Adam (None when `adv ==
    0`: no adversarial term, no D phase). `fast_igen_target` routes the
    no-grad renders (the Igen target, the e4e prefix render) and `fast_grad`
    the student render (`train/fast_render.py`); `generator` feeds the
    renderer's stochastic strata (none under those overrides). The batch is `{"image" [B,3(+mask),H,W], "c", "v", "uv" [B,6,256,256], "z",
    "gen_uv"}` on the net's device."""
    return _make_oneshot_step(net, lpips_fn, id_fn, weights, fast_igen_target, fast_grad)


def oneshot_phase_schedule(batch_idx: int, d_reg_interval: int = 16):
    """(I-phase, which U-Net trains, D-phase, do_r1) of batch `batch_idx`:
    Ireal twice then Igen twice, tri and tex alternating, R1 every
    `d_reg_interval` batches."""
    i_phase = "Ireal" if batch_idx % 4 < 2 else "Igen"
    unet = "tri" if batch_idx % 2 == 0 else "tex"
    d_phase = "Dreal" if batch_idx % 4 < 2 else "Dgen"
    do_r1 = batch_idx % d_reg_interval == 0
    return i_phase, unet, d_phase, do_r1


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


def train_oneshot(net, d_module: Optional[torch.nn.Module], batch_iter: Iterator[Dict],
                  cfg: InversionTrainConfig, lpips_fn: Callable, id_fn: Optional[Callable] = None,
                  max_steps: Optional[int] = None, resume_path: Optional[str] = None, mesh=None,
                  fast_igen_target: str = "off", fast_grad: str = "off",
                  on_step: Optional[Callable] = None, device="cuda"):
    """One-shot-stage driver: `make_oneshot_train_step` over `batch_iter` by
    `oneshot_phase_schedule`, with one Adam per U-Net (`masked_adam`, lr
    `cfg.lr`) and, when `d_module` is given and `adv > 0`, an Adam for the
    dual discriminator (lr `cfg.lr`) whose phase follows each I phase, with
    R1 every `wd_reg_interval` steps. Step `i` draws from
    `step_generator(seed, i)` (its D phase from `i + 1`, as the JAX package
    folds its key). Stats every 50 steps and at `max_steps`; one snapshot,
    `snapshot-final.pt` in `run_dir`, at the end; `resume_path` restores
    one. `fast_igen_target` / `fast_grad` pick the renders' overrides;
    `on_step(step_idx, cur_nimg, aux)` runs after each step. Runs on CUDA
    unless `device="cpu"` is asked for; `mesh` (data parallelism) is not
    ported (ROADMAP A10). Returns (state, d_state), `state.opt` the last
    trained U-Net's."""
    if mesh is not None:
        raise NotImplementedError("train_oneshot runs on one device: data parallelism over a "
                                  "mesh is ROADMAP A10")
    device = resolve_device(device)
    net.to(device)
    opts = {"tex": masked_adam(net, cfg.lr, oneshot_tex_trainable),
            "tri": masked_adam(net, cfg.lr, oneshot_tri_trainable)}
    d_state = None
    if d_module is not None and cfg.weights.adv > 0:
        d_module.to(device)
        d_state = TrainState(d_module, torch.optim.Adam(d_module.parameters(), lr=cfg.lr,
                                                        eps=1e-8))
    cur_nimg = step_idx = 0
    if resume_path is not None:
        snap = restore_checkpoint(resume_path, map_location=device)
        net.load_state_dict(snap["net"])
        for k, opt in opts.items():
            opt.load_state_dict(snap["opt"][k])
        if d_state is not None:
            d_state.load_state_dict(snap["d_state"])
        cur_nimg, step_idx = int(snap["cur_nimg"]), int(snap["step_idx"])

    step_fn = make_oneshot_train_step(net, lpips_fn, id_fn, cfg.weights, fast_igen_target,
                                      fast_grad)
    collector = Collector()
    logger = StatsLogger(cfg.run_dir)
    state = TrainState(net, opts["tex"])
    t0 = time.time()
    while (max_steps is None or step_idx < max_steps) and cur_nimg < cfg.total_kimg * 1000:
        batch = to_device(next(batch_iter), device)
        i_phase, unet, d_phase, do_r1 = oneshot_phase_schedule(step_idx, cfg.wd_reg_interval)
        state = TrainState(net, opts[unet])
        aux = step_fn(state, d_state, batch, phase=i_phase,
                      generator=step_generator(cfg.seed, step_idx, device))
        if d_state is not None:
            aux.update(step_fn(state, d_state, batch, phase=d_phase, do_r1=do_r1,
                               generator=step_generator(cfg.seed, step_idx + 1, device)))
        cur_nimg += cfg.batch_size
        step_idx += 1
        for k, v in aux.items():
            collector.report(k, v.float().cpu().numpy())
        if on_step is not None:
            on_step(step_idx - 1, cur_nimg, aux)
        if step_idx % 50 == 0 or (max_steps and step_idx >= max_steps):
            collector.update()
            print(f"kimg {cur_nimg / 1000:.1f} ({time.time() - t0:.0f}s) "
                  + " ".join(f"{n}={collector.mean(n):.4f}" for n in collector.names()))
            logger.write(collector, cur_nimg)
    payload = {"net": net.state_dict(), "opt": {k: o.state_dict() for k, o in opts.items()},
               "cur_nimg": cur_nimg, "step_idx": step_idx}
    if d_state is not None:
        payload["d_state"] = d_state.state_dict()
    save_checkpoint(os.path.join(cfg.run_dir, "snapshot-final.pt"), payload)
    logger.close()
    return state, d_state
