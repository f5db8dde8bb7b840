"""3D-GAN training loop, plain PyTorch, on one card or data-parallel.

Counterpart of `invertavatar_tpu/train/loop_gan.py` (reference
`training_avatar_texture/training_loop.py`): batches -> `make_gan_train_step`
(one specialisation per neural rendering resolution and lazy-reg phase pair)
-> the G EMA -> the schedules (blur fade, neural rendering resolution fade,
conditioning-swap ramp) and the ADA probability -> ticks with `stats.jsonl`
and snapshots. As in the JAX package, the snapshots hold the optimizers'
moments, the EMA, the counters and the ADA probability (`torch.save`, one
file), and a run resumes from one bit for bit: each step draws from a
`torch.Generator` seeded by (seed, step index). At each snapshot the
`metric_names` metrics (`metrics/metric_main.py`) run on the EMA generator
and land in that tick's `stats.jsonl` line as `Metrics/<name>`.

With a data mesh (`parallel/mesh.py`, one process per card) the ranks start
from rank 0's parameters, buffers and optimizer state (`replicate`; every
rank loads a resumed snapshot), each takes its rows of the global batch and
the step averages the gradients over ranks, draws per item over the global
batch and keeps `w_avg` and the minibatch std global, so N ranks run the
steps of one process at the global batch. `batch_size`, `cur_nimg` and the
EMA's decay count the global batch. ADA's sign statistic and the reported
statistics are summed over ranks (`Collector.sync`) before they are read.
Rank 0 alone writes (`training_options.json`, `stats.jsonl`, snapshots,
fakes) and runs the snapshot metrics while the others wait at a barrier;
every snapshot first checks that the replicas agree bit for bit
(`check_replica_consistency`).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..parallel.mesh import DataMesh, local_batch, replicate
from ..parallel.multihost import check_replica_consistency
from ..utils.checkpoint import restore_checkpoint, save_checkpoint
from ..utils.misc import resolve_device, to_device
from ..utils.stats import Collector, StatsLogger
from .gan import GANLossConfig, make_gan_train_step, make_schedules, neural_rendering_resolution
from .state import LazyRegAdam, MultiSteps, TrainState, ema_beta, ema_update


@dataclasses.dataclass
class GANTrainConfig:
    run_dir: str = "runs/gan"
    total_kimg: int = 25000
    batch_size: int = 32
    g_lr: float = 0.0025
    d_lr: float = 0.002
    beta2: float = 0.99
    ema_kimg: float = 10.0
    ema_rampup: Optional[float] = 0.05
    kimg_per_tick: int = 4
    snapshot_ticks: int = 50
    snapshot_images: bool = True  # render a grid of EMA fakes at snapshots (needs PIL)
    seed: int = 0
    # micro-batch gradient accumulation (`MultiSteps`): batch_iter yields
    # micro-batches of batch_size // grad_accum, and each optimizer update
    # averages the gradients of grad_accum of them; the EMA, the lazy-reg
    # phases and ADA count micro-steps, as in the JAX package
    grad_accum: int = 1
    augment_p: float = 0.0  # the initial ADA probability
    loss: GANLossConfig = dataclasses.field(default_factory=GANLossConfig)


def step_generator(seed: int, step_idx: int, device) -> torch.Generator:
    """The draws of step `step_idx`: a generator seeded by (seed, step)."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + step_idx)


def _save_fakes(G_ema, batch, path: str) -> None:
    """A grid of the EMA generator's images of the batch's first 4 items."""
    import PIL.Image

    from ..cli.common import layout_grid, to_uint8

    with torch.no_grad():
        img = G_ema(batch["z"][:4], batch["c"][:4],
                    {"uvcoords_image": batch["v"]["uvcoords_image"][:4]}, noise_mode="const",
                    generator=torch.Generator(device=batch["z"].device).manual_seed(0))["image"]
    tiles = [to_uint8(img[i:i + 1]) for i in range(img.shape[0])]
    PIL.Image.fromarray(layout_grid(tiles, (len(tiles), 1))).save(path)


def _eval_metrics(G_ema, metric_names, dataset, detector_fn, run_dir: str, collector) -> None:
    """The snapshot tick's metrics (reference training_loop.py:494-503): each
    appends its `metric-<name>.jsonl` line and reports `Metrics/<key>` to
    this tick's statistics. A metric that raises stops the run."""
    from ..metrics import metric_main
    from ..metrics.fid import make_vert_conditioned_sample_fn

    sample_fn = make_vert_conditioned_sample_fn(G_ema, z_dim=G_ema.backbone.mapping.z_dim,
                                                dataset=dataset)
    for name in metric_names:
        entry = metric_main.calc_metric(name, run_dir=run_dir, dataset=dataset,
                                        sample_fn=sample_fn, detector_fn=detector_fn,
                                        cache_dir=os.path.join(run_dir, "metric-cache"))
        for k, v in entry["results"].items():
            print(f"metric {k} = {v:.4f}")
            collector.report(f"Metrics/{k}", v)


def train_gan(G, D, batch_iter: Iterator[Dict], cfg: GANTrainConfig,
              max_steps: Optional[int] = None, resume_path: Optional[str] = None,
              augment_pipe=None, metric_names=(), metric_dataset=None, metric_detector_fn=None,
              on_step: Optional[Callable] = None, device="cuda",
              mesh: Optional[DataMesh] = None):
    """Train G against D on `batch_iter`'s batches ({"image" [B, 3, R, R] in
    [-1, 1], "c" [B, 25], "v": {"uvcoords_image"}, "z" [B, z_dim]}, numpy or
    tensors on any device; micro-batches with `grad_accum`), until
    `total_kimg` or `max_steps` steps. Ticks every `kimg_per_tick` write
    `stats.jsonl`; snapshots (`snapshot-<nimg>.pt` in `run_dir`) every
    `snapshot_ticks` ticks and at `max_steps`. `resume_path` restores a
    snapshot. At each snapshot, each of `metric_names` (e.g. "fid50k_full")
    runs on the EMA generator at the current neural rendering resolution,
    with `metric_dataset` (items {"image", "c", "v"}: the real statistics
    and the sampled labels and vertex images) and `metric_detector_fn`
    (uint8 NHWC -> [N, D] features); its `metric-<name>.jsonl` line goes to
    `run_dir`, the real statistics' cache to `run_dir/metric-cache`.
    `on_step(step_idx, cur_nimg, metrics)` runs after each step. Runs on
    CUDA unless `device="cpu"` is asked for. With `mesh` (`device` is then
    the mesh's) this process is one rank of a data-parallel run: `batch_iter`
    yields the global batch (each rank keeps its rows, as JAX's
    `shard_batch`) or this rank's rows (a loader sharded by rank), and
    `metrics` are the rank's own. Returns (g_state, d_state, G_ema,
    cur_nimg)."""
    if metric_names and (metric_dataset is None or metric_detector_fn is None):
        raise ValueError(f"metric_names {tuple(metric_names)} need metric_dataset and "
                         "metric_detector_fn")
    device = resolve_device(device if mesh is None else mesh.device)
    writer = mesh is None or mesh.rank == 0
    G.to(device).train()
    D.to(device).train()
    if writer:
        os.makedirs(cfg.run_dir, exist_ok=True)
        with open(os.path.join(cfg.run_dir, "training_options.json"), "w") as f:
            json.dump({k: str(v) for k, v in dataclasses.asdict(cfg).items()}, f, indent=2)

    lc = cfg.loss
    g_opt = LazyRegAdam(G.parameters(), cfg.g_lr, 0.0, cfg.beta2, 1e-8, lc.g_reg_interval)
    d_opt = LazyRegAdam(D.parameters(), cfg.d_lr, 0.0, cfg.beta2, 1e-8, lc.d_reg_interval)
    if cfg.grad_accum > 1:
        g_opt, d_opt = MultiSteps(g_opt, cfg.grad_accum), MultiSteps(d_opt, cfg.grad_accum)
    g_state, d_state = TrainState(G, g_opt), TrainState(D, d_opt)
    G_ema = copy.deepcopy(G).eval().requires_grad_(False)
    cur_nimg = step_idx = 0
    augment_p = float(cfg.augment_p)
    if resume_path is not None:
        snap = restore_checkpoint(resume_path, map_location=device)
        g_state.load_state_dict(snap["g_state"])
        d_state.load_state_dict(snap["d_state"])
        G_ema.load_state_dict(snap["G_ema"])
        cur_nimg, step_idx = int(snap["cur_nimg"]), int(snap["step_idx"])
        augment_p = float(snap["augment_p"])
    if mesh is not None:
        replicate(mesh, g_state, d_state, G_ema)

    steps: Dict = {}

    def get_step(nrr, do_greg, do_dreg):
        key = (nrr, do_greg, do_dreg)
        if key not in steps:
            steps[key] = make_gan_train_step(G, D, lc, nrr, do_greg, do_dreg,
                                             augment_pipe=augment_pipe, mesh=mesh)
        return steps[key]

    ada_stats = Collector()
    collector = Collector()
    logger = StatsLogger(cfg.run_dir) if writer else None
    tick_nimg = cfg.kimg_per_tick * 1000
    next_tick = cur_nimg + tick_nimg
    tick_start = time.time()

    while cur_nimg < cfg.total_kimg * 1000:
        batch = to_device(local_batch(mesh, next(batch_iter), cfg.batch_size // cfg.grad_accum),
                          device)
        sched = make_schedules(lc, cur_nimg, augment_p=augment_p)
        nrr = neural_rendering_resolution(lc, cur_nimg)
        do_greg = step_idx % lc.g_reg_interval == 0 and lc.density_reg > 0
        do_dreg = step_idx % lc.d_reg_interval == 0 and lc.r1_gamma > 0
        step = get_step(nrr, do_greg, do_dreg)
        gen = step_generator(cfg.seed, step_idx, device)
        metrics = step(g_state, d_state, batch, sched, gen)
        ema_update(G_ema.parameters(), G.parameters(),
                   ema_beta(cfg.batch_size, cfg.ema_kimg, cur_nimg, cfg.ema_rampup))
        cur_nimg += cfg.batch_size // cfg.grad_accum
        step_idx += 1
        metrics = {k: float(v) for k, v in metrics.items()}
        for k, v in metrics.items():
            collector.report(k, v)
        if on_step is not None:
            on_step(step_idx, cur_nimg, metrics)

        # the ADA heuristic: move p toward the target sign of the real logits
        # (their mean over the interval's steps and, with a mesh, the ranks)
        if augment_pipe is not None and lc.ada_target is not None:
            ada_stats.report("Loss/signs/real", metrics.get("Loss/signs/real", 0.0))
            if step_idx % lc.ada_interval == 0:
                if mesh is not None:
                    ada_stats.sync()
                ada_stats.update()
                adjust = np.sign(ada_stats.mean("Loss/signs/real") - lc.ada_target) * (
                    cfg.batch_size * lc.ada_interval) / (lc.ada_kimg * 1000)
                augment_p = max(augment_p + float(adjust), 0.0)
                collector.report("Progress/augment", augment_p)

        done = bool(max_steps) and step_idx >= max_steps
        if cur_nimg >= next_tick or done:
            dt = time.time() - tick_start
            spk = dt / max((cur_nimg - (next_tick - tick_nimg)) / 1000, 1e-8)
            if mesh is not None:
                collector.sync()
            if (cur_nimg // tick_nimg) % cfg.snapshot_ticks == 0 or done:
                if mesh is not None:
                    check_replica_consistency(mesh, {"G": G, "D": D, "G_ema": G_ema})
                if writer:
                    save_checkpoint(os.path.join(cfg.run_dir, f"snapshot-{cur_nimg:08d}.pt"), {
                        "g_state": g_state.state_dict(), "d_state": d_state.state_dict(),
                        "G_ema": G_ema.state_dict(), "cur_nimg": cur_nimg,
                        "step_idx": step_idx, "augment_p": augment_p})
                if cfg.snapshot_images or metric_names:  # render with the EMA weights
                    G_ema.neural_rendering_resolution = neural_rendering_resolution(lc, cur_nimg)
                    for b_ema, b in zip(G_ema.buffers(), G.buffers()):
                        b_ema.copy_(b)
                if writer and cfg.snapshot_images:
                    _save_fakes(G_ema, batch, os.path.join(cfg.run_dir,
                                                           f"fakes{cur_nimg:08d}.png"))
                if writer and metric_names:
                    _eval_metrics(G_ema, metric_names, metric_dataset, metric_detector_fn,
                                  cfg.run_dir, collector)
                if mesh is not None:  # the others wait for rank 0's metrics
                    torch.distributed.barrier(group=mesh.group)
            collector.update()
            if writer:
                print(f"kimg {cur_nimg / 1000:.1f}  sec/kimg {spk:.1f}  "
                      + "  ".join(f"{n}={collector.mean(n):.4f}" for n in collector.names()))
                logger.write(collector, cur_nimg)
            tick_start = time.time()
            next_tick = cur_nimg + tick_nimg
        if done:
            break
    if logger is not None:
        logger.close()
    return g_state, d_state, G_ema, cur_nimg

