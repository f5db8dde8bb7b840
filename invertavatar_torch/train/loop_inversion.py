"""Inversion training stages: optimizers, steps and training loops.

Counterpart of `invertavatar_tpu/train/loop_inversion.py`:
  * e4e: train `Encoder4Editing` against the frozen generator with the Ireal
    and Igen phases, plus the latent discriminator (WD) when
    `w_discriminator > 0`;
  * one-shot: train one of the two U-Nets of a (SegFormer) `InversionNet`
    per step, by the reference's interval schedule, with the Ireal / Igen
    phases and the dual discriminator's Dreal / Dgen phases (R1 every
    `wd_reg_interval` steps) when `adv > 0`;
  * few-shot: train one ConvGRU U-Net's decoder per step (tri-plane on
    even steps, texture on odd; trunks, e4e and generator frozen) over clips
    whose length follows the {6, 12, 18} curriculum, with the Ireal and Igen
    phases through the chunked rollout and carried GRU states, and the dual
    discriminator's phase on a synthetic clip when `adv > 0`.

JAX expresses the freeze as an optax mask and returns new states; here
`masked_adam` freezes every parameter outside the trainable subtree
(`requires_grad_(False)`, gradients still flow *through* the generator to the
codes) and a step updates the modules and optimizers in place. The JAX
step's "programs" (grad Ireal, grad Igen, one update) become `backward()`
calls accumulating into one Adam step; no-grad renders run under
`torch.no_grad()`. The JAX options that only steer XLA's memory plan
(`remat`, `donate`, `grad_subtree`, `subtree_tx`) have no counterpart, nor
has the few-shot stage's split into jitted programs (`FewshotPrograms`); its
memory plan stays: one gradient-carrying render alive at a time.

With a data mesh (`parallel/mesh.py`, one process per card) each trainer
starts every rank from rank 0's state (`replicate`), gives each rank its
rows of the global batch, runs each step inside `use_mesh` (per-item draws
over the global batch, the minibatch std over the global batch; a clip's
[chunk, item, frame] rows name their layout) and averages each optimizer's
gradients over ranks before it steps, so N ranks run the steps of one
process at the global batch. Rank 0 alone writes statistics (summed over
ranks by `Collector.sync`) and snapshots, after a replica check.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..models.encoders.uvnet import offset_feats
from ..ops.resize import resize_bilinear
from ..parallel.mesh import (DataMesh, all_reduce_grads, batch_layout, local_batch, replicate,
                             use_mesh)
from ..parallel.multihost import check_replica_consistency
from ..utils.checkpoint import restore_checkpoint, save_checkpoint
from ..utils.misc import resolve_device, to_device
from ..utils.stats import Collector, StatsLogger
from .fast_render import grad_overrides, nograd_overrides
from .inversion import (
    InversionLossWeights,
    e4e_igen_loss,
    e4e_ireal_loss,
    e4e_ireal_novel_loss,
    fewshot_feature_losses,
    fewshot_image_loss_frame,
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


def unet_decoder_trainable(name: str) -> bool:
    """Few-shot stage: the U-Nets' decoders (ups, heads, GRUs) train; their
    IR-SE trunks (`input_layer`, `body`), the e4e encoder and the generator
    stay frozen."""
    if not name.startswith("unet_encoder."):
        return False
    return not name.split(".", 2)[-1].startswith(("input_layer", "body"))


def fewshot_tex_trainable(name: str) -> bool:
    """Few-shot stage, the texture U-Net's decoder."""
    return unet_decoder_trainable(name) and name.startswith("unet_encoder.texture_unet.")


def fewshot_tri_trainable(name: str) -> bool:
    """Few-shot stage, the tri-plane SFT U-Net's decoder."""
    return unet_decoder_trainable(name) and name.startswith("unet_encoder.triplane_unet.")


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


def _opt_params(opt: torch.optim.Optimizer):
    return [p for group in opt.param_groups for p in group["params"]]


def _wd_step(net, wd_state: TrainState, batch, weights, do_r1: bool, mesh=None):
    """One latent-discriminator update on codes of the (updated) encoder."""
    with torch.no_grad():
        ws_fake = net.encode(batch["image"])
        ws_real = net.generator.mapping(batch["z"], batch["c"], truncation_psi=0.8)
    # the encoder's phases also backpropagate into the WD: drop those grads
    wd_state.opt.zero_grad(set_to_none=True)
    total, aux = wd_losses(wd_state.module, ws_fake, ws_real, weights, do_r1)
    total.backward()
    if mesh is not None:
        all_reduce_grads(mesh, _opt_params(wd_state.opt))
    wd_state.opt.step()
    return aux


def _make_e4e_step(net, lpips_fn, id_fn, weights: InversionLossWeights,
                   fast_igen_target: str, fast_grad: str, split: bool, mesh=None):
    encode, gen_mapping, gen_synthesis, gen_target = _e4e_closures(
        net, fast_igen_target, fast_grad)
    use_wd = weights.w_discriminator > 0

    def step(state: TrainState, wd_state: TrainState, batch: Dict,
             do_wd_reg: bool = False) -> Dict[str, torch.Tensor]:
        with use_mesh(mesh):
            return run_step(state, wd_state, batch, do_wd_reg)

    def run_step(state, wd_state, batch, do_wd_reg):
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
        if mesh is not None:
            all_reduce_grads(mesh, _opt_params(state.opt))
        state.opt.step()
        if use_wd:
            aux.update({k: v.detach() for k, v in
                        _wd_step(net, wd_state, batch, weights, do_wd_reg, mesh).items()})
        return aux

    return step


def make_e4e_train_step(net, lpips_fn: Callable, id_fn: Optional[Callable],
                        weights: InversionLossWeights, mesh: Optional[DataMesh] = None):
    """One step = Ireal + Igen (+ Ireal_novel when `multiview_id > 0` and an
    ID function is given), one backward, one Adam step, then the WD phase.

    Returns `step(state, wd_state, batch, do_wd_reg=False) -> aux`; `state`
    holds `net` and its `masked_adam`, `wd_state` the discriminator and its
    Adam. The batch is `{"image" [B,3,H,W] in [-1,1], "c" [B,25], "v"
    {"uvcoords_image" [B,256,256,3]}, "z" [B,z_dim]}` on the net's device
    (with `mesh`, this rank's rows; the gradients are the mean over
    ranks)."""
    return _make_e4e_step(net, lpips_fn, id_fn, weights, "off", "off", split=False, mesh=mesh)


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


def _adam_step(opt: torch.optim.Optimizer, mesh: Optional[DataMesh] = None) -> None:
    """`opt.step()` with a zero gradient for every parameter that got none:
    optax updates (and counts) every leaf of its mask on each step, so
    torch's per-parameter step count stays optax's per-state count. With
    `mesh` the gradients are averaged over ranks first."""
    params = _opt_params(opt)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if mesh is not None:
        all_reduce_grads(mesh, params)
    opt.step()


def _make_oneshot_step(net, lpips_fn, id_fn, weights: InversionLossWeights,
                       fast_igen_target: str, fast_grad: str, mesh=None):
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
        with use_mesh(mesh):
            return run_step(state, d_state, batch, phase, do_r1, generator)

    def run_step(state, d_state, batch, phase, do_r1, generator):
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
            _adam_step(state.opt, mesh)
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
        _adam_step(d_state.opt, mesh)
        return {f"{phase}/{k}": v.detach() for k, v in aux.items()}

    return step


def make_oneshot_train_step(net, lpips_fn: Callable, id_fn: Optional[Callable],
                            weights: InversionLossWeights, fast_igen_target: str = "off",
                            fast_grad: str = "off", mesh: Optional[DataMesh] = None):
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
    renderer's stochastic strata (none under those overrides). The batch is
    `{"image" [B,3(+mask),H,W], "c", "v", "uv" [B,6,256,256], "z", "gen_uv"}`
    on the net's device (with `mesh`, this rank's rows; each optimizer
    steps on the mean of the ranks' gradients)."""
    return _make_oneshot_step(net, lpips_fn, id_fn, weights, fast_igen_target, fast_grad, mesh)


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
              on_step: Optional[Callable] = None, device="cuda",
              mesh: Optional[DataMesh] = None):
    """e4e-stage driver: `make_e4e_train_step` over `batch_iter` (dicts as
    that step takes, NCHW images in [-1, 1], on any device), with stats ticks
    every `kimg_per_tick` and snapshots (`snapshot-<nimg>.pt` in `run_dir`)
    every `snapshot_ticks` ticks and at `max_steps`. `resume_path` restores a
    snapshot. `on_step(step_idx, cur_nimg, aux)` runs after each step. Runs
    on CUDA unless `device="cpu"` is asked for. With `mesh` (`device` is
    then the mesh's) this process is one rank of a data-parallel run over
    the global batch `cfg.batch_size`: `batch_iter` yields the global batch
    or this rank's rows, and `aux` is the rank's own. Returns the (state,
    wd_state) it trained."""
    device = resolve_device(device if mesh is None else mesh.device)
    writer = mesh is None or mesh.rank == 0
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
    if mesh is not None:
        replicate(mesh, state, wd_state)

    step_fn = make_e4e_train_step(net, lpips_fn, id_fn, cfg.weights, mesh=mesh)
    collector = Collector()
    logger = StatsLogger(cfg.run_dir) if writer else None
    tick_nimg = cfg.kimg_per_tick * 1000
    next_tick = cur_nimg + tick_nimg
    t0 = time.time()

    def snapshot(tag):
        save_checkpoint(os.path.join(cfg.run_dir, tag), {
            "state": state.state_dict(), "wd_state": wd_state.state_dict(),
            "cur_nimg": cur_nimg, "step_idx": step_idx})

    while cur_nimg < cfg.total_kimg * 1000:
        batch = to_device(local_batch(mesh, next(batch_iter), cfg.batch_size), device)
        do_reg = step_idx % cfg.wd_reg_interval == 0 and cfg.weights.w_discriminator > 0
        aux = step_fn(state, wd_state, batch, do_wd_reg=do_reg)
        cur_nimg += cfg.batch_size
        step_idx += 1
        for k, v in aux.items():
            collector.report(k, v.float().cpu().numpy())
        if on_step is not None:
            on_step(step_idx - 1, cur_nimg, aux)
        done = bool(max_steps) and step_idx >= max_steps
        if cur_nimg >= next_tick or done:
            _write_stats(collector, logger, mesh, f"kimg {cur_nimg / 1000:.1f} "
                         f"({time.time() - t0:.0f}s)", cur_nimg)
            next_tick = cur_nimg + tick_nimg
            if (cur_nimg // tick_nimg) % cfg.snapshot_ticks == 0 or done:
                _checked_snapshot(mesh, {"net": net, "wd": wd_module}, writer,
                                  lambda: snapshot(f"snapshot-{cur_nimg:08d}.pt"))
        if done:
            break
    if logger is not None:
        logger.close()
    return state, wd_state


def _write_stats(collector: Collector, logger: Optional[StatsLogger], mesh, head: str,
                 nimg: int) -> None:
    """Close a statistics tick: sum the pending statistics over ranks (with
    `mesh`), then rank 0 prints and appends the `stats.jsonl` line."""
    if mesh is not None:
        collector.sync()
    collector.update()
    if logger is not None:
        print(head + " " + " ".join(f"{n}={collector.mean(n):.4f}" for n in collector.names()))
        logger.write(collector, nimg)


def _checked_snapshot(mesh, modules: Dict, writer: bool, save: Callable) -> None:
    """A snapshot: with `mesh` the replicas are checked bit for bit first;
    rank 0 alone writes."""
    if mesh is not None:
        check_replica_consistency(mesh, {k: m for k, m in modules.items() if m is not None})
    if writer:
        save()


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
    unless `device="cpu"` is asked for. With `mesh` (`device` is then the
    mesh's) this process is one rank of a data-parallel run over the global
    batch `cfg.batch_size`: `batch_iter` yields the global batch or this
    rank's rows, and `aux` is the rank's own. Returns (state, d_state),
    `state.opt` the last trained U-Net's."""
    device = resolve_device(device if mesh is None else mesh.device)
    writer = mesh is None or mesh.rank == 0
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
    if mesh is not None:
        replicate(mesh, net, *opts.values(), d_state)

    step_fn = make_oneshot_train_step(net, lpips_fn, id_fn, cfg.weights, fast_igen_target,
                                      fast_grad, mesh=mesh)
    collector = Collector()
    logger = StatsLogger(cfg.run_dir) if writer else None
    state = TrainState(net, opts["tex"])
    t0 = time.time()
    while (max_steps is None or step_idx < max_steps) and cur_nimg < cfg.total_kimg * 1000:
        batch = to_device(local_batch(mesh, next(batch_iter), cfg.batch_size), device)
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
            _write_stats(collector, logger, mesh, f"kimg {cur_nimg / 1000:.1f} "
                         f"({time.time() - t0:.0f}s)", cur_nimg)

    def save():
        payload = {"net": net.state_dict(), "opt": {k: o.state_dict() for k, o in opts.items()},
                   "cur_nimg": cur_nimg, "step_idx": step_idx}
        if d_state is not None:
            payload["d_state"] = d_state.state_dict()
        save_checkpoint(os.path.join(cfg.run_dir, "snapshot-final.pt"), payload)

    _checked_snapshot(mesh, {"net": net, "D": d_module if d_state is not None else None},
                      writer, save)
    if logger is not None:
        logger.close()
    return state, d_state


# ---------------------------------------------------------------- few-shot stage


def _clip_slicer(batch: Dict, Tc: int):
    """(slice of a [B, T, ...] clip tensor by chunk, the chunk's v dict)."""
    uvi = batch["v"]["uvcoords_image"]

    def sl(x, i):
        return x[:, i * Tc:(i + 1) * Tc]

    return sl, lambda i: {"uvcoords_image": sl(uvi, i)}


@torch.no_grad()
def _fewshot_prefix(net, batch: Dict, Tc: int, nograd_ov, generator, synthetic: bool):
    """The gradient-free prefix of a few-shot phase. With `synthetic`, the
    clip is the frozen generator's render of `batch["z"]` (ψ 0.6, the first
    frame's camera), chunk by chunk, and the codes are the encoder's of its
    first frame; else the clip is the batch's frames and the codes
    `batch["ws"]` (encoded from the first frame when absent). Then the
    feature lists of the codes, every chunk's U-Net inputs and the GRU states
    rolled over chunks 0..n-2. Returns a dict: "ws", "tex", "uv_in",
    "tri_in", "r_tex", "r_tri" (those of the last chunk) and, with
    `synthetic`, "targets" (each chunk's "image", "feature_image" and
    "triplane", [B·Tc, ...]; all kept, ~25 MB a frame at flagship width,
    where the JAX package re-renders each before its gradient to spare a
    TPU's memory). The clip renders' rows are [item, frame]
    (`batch_layout(inner=Tc)` under a data mesh)."""
    G = net.generator
    vid_c = batch["c"]
    B, T = vid_c.shape[:2]
    n = T // Tc
    sl, v_sl = _clip_slicer(batch, Tc)
    out = {}
    if synthetic:
        ws_gen = G.mapping(batch["z"], vid_c[:, 0], truncation_psi=0.6)
        gt_tex, gt_static = net.backbone_feats(ws_gen)
        out["targets"] = []
        for i in range(n):
            with batch_layout(inner=Tc):
                t = net.render_clip(ws_gen, gt_tex, gt_static, sl(vid_c, i), v_sl(i),
                                    evaluation=nograd_ov is not None,
                                    rendering_overrides=nograd_ov, generator=generator)
            out["targets"].append({k: t[k] for k in ("image", "feature_image", "triplane")})
        frames = torch.cat([t["image"].reshape(B, Tc, *t["image"].shape[1:])
                            for t in out["targets"]], dim=1)
        ws = net.encode(frames[:, 0])
    else:
        frames = batch["image"][:, :, :3]
        ws = batch.get("ws")
        if ws is None:
            ws = net.encode(frames[:, 0])
    tex, static = net.backbone_feats(ws)
    r_tex = r_tri = None
    for i in range(n):
        with batch_layout(inner=Tc):
            uv_in, tri_in, _ = net.multiT_chunk_inputs(sl(frames, i), sl(vid_c, i), v_sl(i),
                                                       sl(batch["uv"], i), ws, tex, static,
                                                       nograd_render=nograd_ov,
                                                       generator=generator)
        if i < n - 1:
            r_tex, r_tri = net.multiT_chunk_state(uv_in, tri_in, r_tex, r_tri)
    out.update(ws=ws, tex=tex, uv_in=uv_in, tri_in=tri_in, r_tex=r_tex, r_tri=r_tri)
    return out


def make_fewshot_train_step(net, lpips_fn: Callable, weights: InversionLossWeights,
                            frm_per_chunk: int = 6, fast_no_grad: str = "off",
                            fast_grad: str = "off", mesh: Optional[DataMesh] = None):
    """The few-shot stage's I phase. Returns `step(state, batch,
    do_igen=False, multiT=False, fake_idx=None, d_module=None,
    generator=None) -> aux`; `state` holds the `InversionNet` and one
    decoder's `masked_adam` (`fewshot_tex_trainable` /
    `fewshot_tri_trainable`), the only parameters made trainable.

    The clip is [B, T, ...] (`batch`: "image" [B, T, 3(+mask), H, W], "c",
    "v" {"uvcoords_image"}, "uv" [B, T, 6, 256, 256], "z", optionally "ws");
    with `multiT` it rolls in chunks of `frm_per_chunk` frames. The prefix
    (`_fewshot_prefix`) runs without gradient; the U-Nets and the SFT
    backbone run once with it (`InversionNet.multiT_offsets`). Their outputs,
    the texture offsets and the static features, are cut off as leaves; each
    selected frame is rendered (overrides `fast_grad`), its loss taken and
    backpropagated into the leaves, one render's graph alive at a time; the
    leaves' gradients, divided by the frame count, then go back through the
    backbone and the U-Nets in one `torch.autograd.backward`. Every loss term
    is a mean over equal frames, so this is the clip loss's gradient.
      * Ireal (`do_igen=False`): the real frames `fake_idx` (all when None;
        the first selected frame whole, the later ones through the head mask).
      * Igen: the frozen generator's clip of `batch["z"]` is both input and
        target; every chunk is supervised with the final offsets (its frames
        rendered with the last chunk's U-Net outputs), and the terms are
        averaged over chunks (the adversarial term through `d_module`, frozen
        here, with `adv > 0`).
    No-grad renders take the overrides `fast_no_grad`; `generator` feeds the
    renderer's stochastic draws. With `mesh` the clip is this rank's items
    and the decoder steps on the mean of the ranks' gradients."""
    nograd_ov = nograd_overrides(fast_no_grad)
    grad_ov = grad_overrides(fast_grad)
    G = net.generator

    def step(state: TrainState, batch: Dict, do_igen: bool = False, multiT: bool = False,
             fake_idx=None, d_module: Optional[torch.nn.Module] = None,
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        with use_mesh(mesh):
            return run_step(state, batch, do_igen, multiT, fake_idx, d_module, generator)

    def run_step(state, batch, do_igen, multiT, fake_idx, d_module, generator):
        vid_c = batch["c"]
        B, T = vid_c.shape[:2]
        Tc = min(frm_per_chunk, T) if multiT else T
        assert T % Tc == 0, (T, Tc)
        sl, v_sl = _clip_slicer(batch, Tc)
        _train_only(net, state.opt)
        net.zero_grad(set_to_none=True)
        pre = _fewshot_prefix(net, batch, Tc, nograd_ov, generator, synthetic=do_igen)
        ws, tex = pre["ws"], pre["tex"]

        # (camera [B, 25], uvcoords, target, masked) of each rendered frame,
        # grouped in chunks whose mean losses are averaged
        if do_igen:
            d_apply = None
            if weights.adv > 0 and d_module is not None:
                d_module.requires_grad_(False)

                def d_apply(pair):
                    return d_module(pair, torch.zeros_like(vid_c[:, 0]))

            groups = [[(sl(vid_c, i)[:, t], v_sl(i)["uvcoords_image"][:, t],
                        {k: v.reshape(B, Tc, *v.shape[1:])[:, t] for k, v in target.items()},
                        False) for t in range(Tc)]
                      for i, target in enumerate(pre["targets"])]
        else:
            idx = (torch.arange(T, device=vid_c.device) if fake_idx is None
                   else torch.as_tensor(fake_idx, device=vid_c.device))
            uvi = batch["v"]["uvcoords_image"]
            groups = [[(vid_c[:, j], uvi[:, j], batch["image"][:, j], t > 0)
                       for t, j in enumerate(idx.tolist())]]

        offsets, statics = net.multiT_offsets(pre["uv_in"], pre["tri_in"], pre["r_tex"],
                                              pre["r_tri"], ws)
        del pre
        outs = list(offsets) + list(statics)
        leaves = [o.detach().requires_grad_(o.requires_grad) for o in outs]
        off_l, st_l = leaves[:len(offsets)], leaves[len(offsets):]
        n_frames = sum(len(g) for g in groups)
        aux: Dict[str, torch.Tensor] = {}
        for group in groups:
            chunk_aux: Dict[str, torch.Tensor] = {}
            for c_t, uvc_t, target_t, masked in group:
                out = G.synthesis_withTexture(ws, offset_feats(tex, off_l), c_t,
                                              {"uvcoords_image": uvc_t}, static_feats=st_l,
                                              noise_mode="const", rendering_overrides=grad_ov,
                                              generator=generator)
                if do_igen:
                    total, losses = fewshot_feature_losses(out, target_t, lpips_fn, weights,
                                                           d_apply)
                else:
                    total, losses = fewshot_image_loss_frame(out["image"], target_t, lpips_fn,
                                                             weights, masked)
                total.backward()
                for k, v in losses.items():
                    chunk_aux[k] = chunk_aux.get(k, 0.0) + v.detach()
            for k, v in chunk_aux.items():
                aux[k] = aux.get(k, 0.0) + v / len(group)
        pairs = [(o, leaf.grad / n_frames) for o, leaf in zip(outs, leaves)
                 if o.requires_grad and leaf.grad is not None]
        torch.autograd.backward([o for o, _ in pairs], [g for _, g in pairs])
        _adam_step(state.opt, mesh)
        phase = "Igen" if do_igen else "Ireal"
        return {f"{phase}/{k}": v / len(groups) for k, v in aux.items()}

    return step


def fewshot_phase_schedule(batch_idx: int, curriculum=(6, 12, 18), d_reg_interval: int = 16):
    """(U-Net, clip length T, do_r1) of batch `batch_idx`: the tri-plane
    U-Net on even batches, the texture U-Net on odd; T cycles through the
    curriculum as 6 / 12 12 / 18 18 by `batch_idx % 5`; R1 every
    `d_reg_interval` batches."""
    unet = "tri" if batch_idx % 2 == 0 else "tex"
    m = batch_idx % 5
    T = curriculum[0] if m < 1 else (curriculum[1] if m < 3 else curriculum[2])
    return unet, T, batch_idx % d_reg_interval == 0


def make_fewshot_d_step(net, weights: InversionLossWeights, frm_per_chunk: int = 6,
                        fast_no_grad: str = "off", mesh: Optional[DataMesh] = None):
    """The few-shot stage's D phase. Returns `step(d_state, batch,
    do_r1=False, generator=None) -> aux`: without gradient, the frozen
    generator's clip of `batch["z"]` (the real pairs) and the network's
    rollout over it in chunks of `frm_per_chunk`, every frame rendered with
    the last chunk's U-Net outputs (the fake pairs), all renders with the
    overrides `fast_no_grad`; then the dual discriminator's loss
    (`oneshot_d_loss`, R1 with `do_r1`) and one step of `d_state.opt`. With
    `mesh` the clip is this rank's items, D's [chunk, item, frame] rows group
    their minibatch std over the global clip batch, and D steps on the mean
    of the ranks' gradients."""
    nograd_ov = nograd_overrides(fast_no_grad)

    def step(d_state: TrainState, batch: Dict, do_r1: bool = False,
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        with use_mesh(mesh):
            return run_step(d_state, batch, do_r1, generator)

    def run_step(d_state, batch, do_r1, generator):
        vid_c = batch["c"]
        B, T = vid_c.shape[:2]
        Tc = min(frm_per_chunk, T)
        assert T % Tc == 0, (T, Tc)
        sl, v_sl = _clip_slicer(batch, Tc)
        with torch.no_grad():
            pre = _fewshot_prefix(net, batch, Tc, nograd_ov, generator, synthetic=True)
            offsets, statics = net.multiT_offsets(pre["uv_in"], pre["tri_in"], pre["r_tex"],
                                                  pre["r_tri"], pre["ws"])
            texture = offset_feats(pre["tex"], offsets)
            with batch_layout(inner=Tc):
                fakes = [net.render_clip(pre["ws"], texture, statics, sl(vid_c, i), v_sl(i),
                                         evaluation=nograd_ov is not None,
                                         rendering_overrides=nograd_ov, generator=generator)
                         for i in range(T // Tc)]
        fake_pair = {"image": torch.cat([f["image"] for f in fakes]),
                     "image_raw": torch.cat([f["feature_image"][:, :3] for f in fakes])}
        real_pair = {"image": torch.cat([t["image"][:, :3] for t in pre["targets"]]),
                     "image_raw": torch.cat([t["feature_image"][:, :3] for t in pre["targets"]])}
        del pre, fakes, offsets, statics, texture
        d_state.module.requires_grad_(True)
        d_state.opt.zero_grad(set_to_none=True)
        with batch_layout(outer=T // Tc, inner=Tc):
            total, aux = oneshot_d_loss(d_state.module, fake_pair, real_pair,
                                        vid_c.reshape(B * T, -1), weights, do_r1)
        total.backward()
        _adam_step(d_state.opt, mesh)
        return {f"D/{k}": v.detach() for k, v in aux.items()}

    return step


def fewshot_fake_idx(seed: int, step_idx: int, T: int, Tc: int) -> np.ndarray:
    """Ireal's rendered frames of step `step_idx`: frame 0, then Tc − 1 of
    the others in a draw seeded by (seed, step), so a resumed run draws the
    same."""
    npr = np.random.RandomState(seed * 1000003 + step_idx)
    return np.concatenate([[0], 1 + npr.permutation(T - 1)[:Tc - 1]]).astype(np.int64)


def train_fewshot(net, clip_iter: Iterator[Dict], cfg: InversionTrainConfig, lpips_fn: Callable,
                  d_module: Optional[torch.nn.Module] = None, max_steps: Optional[int] = None,
                  multiT: Optional[tuple] = (6, 12, 18), frm_per_chunk: int = 6,
                  resume_path: Optional[str] = None, mesh=None, fast_no_grad: str = "off",
                  fast_grad: str = "off", snapshot_every: Optional[int] = None,
                  on_step: Optional[Callable] = None, device="cuda"):
    """The few-shot stage's training loop over the clips `clip_iter` yields ({"image" [B,
    T_max, 3(+mask), H, W] in [-1, 1], "c" [B, T_max, 25], "v"
    {"uvcoords_image"}, "uv" [B, T_max, 6, 256, 256], "z"}, on any device).

    Step i (`fewshot_phase_schedule`) trains one U-Net's decoder with its own
    Adam (`masked_adam`, lr `cfg.lr`): the clip cut to T = min(curriculum
    length, clip length) frames (all of them with `multiT=None`), the Ireal
    phase on `fewshot_fake_idx`'s frames, then, when the clip carries "z",
    the Igen phase and, with `d_module` and `adv > 0`, the D phase (its own
    Adam, lr `cfg.lr`, R1 every `wd_reg_interval` steps). Step i draws from
    `step_generator(seed, i)`. Stats every 50 steps and at `max_steps`;
    snapshots `snapshot-<nimg>.pt` every `snapshot_every` steps and
    `snapshot-final.pt` at the end, in `run_dir`; `resume_path` restores
    one. `fast_no_grad` / `fast_grad` pick the renders' overrides;
    `on_step(step_idx, cur_nimg, aux)` runs after each step. Runs on CUDA
    unless `device="cpu"` is asked for. With `mesh` (`device` is then the
    mesh's) this process is one rank of a data-parallel run over the global
    batch `cfg.batch_size`: `clip_iter` yields the global batch of clips or
    this rank's, and `aux` is the rank's own. Returns (state, d_state),
    `state.opt` the last trained decoder's."""
    device = resolve_device(device if mesh is None else mesh.device)
    writer = mesh is None or mesh.rank == 0
    net.to(device)
    opts = {"tex": masked_adam(net, cfg.lr, fewshot_tex_trainable),
            "tri": masked_adam(net, cfg.lr, fewshot_tri_trainable)}
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
    if mesh is not None:
        replicate(mesh, net, *opts.values(), d_state)

    step_fn = make_fewshot_train_step(net, lpips_fn, cfg.weights, frm_per_chunk, fast_no_grad,
                                      fast_grad, mesh=mesh)
    d_step_fn = (make_fewshot_d_step(net, cfg.weights, frm_per_chunk, fast_no_grad, mesh=mesh)
                 if d_state is not None else None)
    collector = Collector()
    logger = StatsLogger(cfg.run_dir) if writer else None

    def snapshot(tag):
        def save():
            payload = {"net": net.state_dict(),
                       "opt": {k: o.state_dict() for k, o in opts.items()},
                       "cur_nimg": cur_nimg, "step_idx": step_idx}
            if d_state is not None:
                payload["d_state"] = d_state.state_dict()
            save_checkpoint(os.path.join(cfg.run_dir, tag), payload)

        _checked_snapshot(mesh, {"net": net, "D": d_module if d_state is not None else None},
                          writer, save)

    state = TrainState(net, opts["tri"])
    t0 = time.time()
    while (max_steps is None or step_idx < max_steps) and cur_nimg < cfg.total_kimg * 1000:
        batch = to_device(local_batch(mesh, next(clip_iter), cfg.batch_size), device)
        T_max = batch["c"].shape[1]
        unet, T, do_r1 = fewshot_phase_schedule(step_idx, multiT or (T_max,) * 3,
                                                cfg.wd_reg_interval)
        T = min(T, T_max)
        clip = {k: v[:, :T] for k, v in batch.items() if k in ("image", "c", "uv")}
        clip["v"] = {"uvcoords_image": batch["v"]["uvcoords_image"][:, :T]}
        if "z" in batch:
            clip["z"] = batch["z"]
        fake_idx = (fewshot_fake_idx(cfg.seed, step_idx, T, min(frm_per_chunk, T))
                    if multiT is not None else None)
        with torch.no_grad():
            clip["ws"] = net.encode(clip["image"][:, 0, :3])
        gen = step_generator(cfg.seed, step_idx, device)
        state = TrainState(net, opts[unet])
        aux = step_fn(state, clip, do_igen=False, multiT=multiT is not None, fake_idx=fake_idx,
                      generator=gen)
        if "z" in batch:
            aux.update(step_fn(state, clip, do_igen=True, multiT=multiT is not None,
                               d_module=d_state.module if d_state is not None else None,
                               generator=gen))
            if d_step_fn is not None:
                aux.update(d_step_fn(d_state, clip, do_r1=do_r1, generator=gen))
        cur_nimg += cfg.batch_size
        step_idx += 1
        for k, v in aux.items():
            collector.report(k, v.float().cpu().numpy())
        if on_step is not None:
            on_step(step_idx - 1, cur_nimg, aux)
        if snapshot_every and step_idx % snapshot_every == 0:
            snapshot(f"snapshot-{cur_nimg:08d}.pt")
        if step_idx % 50 == 0 or (max_steps and step_idx >= max_steps):
            _write_stats(collector, logger, mesh, f"kimg {cur_nimg / 1000:.2f} "
                         f"({time.time() - t0:.0f}s)", cur_nimg)
    snapshot("snapshot-final.pt")
    if logger is not None:
        logger.close()
    return state, d_state
