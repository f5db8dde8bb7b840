"""Data-parallel dry runs: one full training step on N spawned ranks.

Counterpart of `invertavatar_tpu/train/dryrun.py`. The models are shrunk
(channel_base 1024, channel_max 64, a 32² neural render with 8+8 samples,
128² output) but each step is whole: the GAN's Gmain with the density TV,
Dmain with R1, the lazy-reg Adams and the EMA (`run_dryrun`); the few-shot
stage's Ireal phase on a tiny `InversionNet` (`run_dryrun_inversion`). Each
rank takes its rows of a global batch of one item per rank and runs the step
over the data mesh. The dry run asserts finite losses, the batch sharded by
rank and the parameters bitwise equal across ranks after the update. The
ranks are spawned processes joined through a `FileStore` in a temporary
directory: on CUDA (the default) rank r on card r over NCCL when there are
at least as many cards as ranks, and every rank on card 0 over gloo
otherwise; over gloo on the CPU with `device="cpu"`. Without CUDA the
default raises.

    python -c "from invertavatar_torch.train.dryrun import run_dryrun; print(run_dryrun(2))"
    python -c "from invertavatar_torch.train.dryrun import run_dryrun; print(run_dryrun(2, device='cpu'))"
"""

from __future__ import annotations

import math
import tempfile
from typing import Dict

import numpy as np
import torch

TINY_RENDERING_KWARGS = {
    "image_resolution": 128,
    "disparity_space_sampling": False,
    "clamp_mode": "softplus",
    "superresolution_module": "invertavatar_torch.models.superresolution.SuperresolutionHybrid2X",
    "c_gen_conditioning_zero": False,
    "c_scale": 1.0,
    "superresolution_noise_mode": "random",
    "density_reg": 0.25,
    "density_reg_p_dist": 0.004,
    "reg_type": "l1",
    "decoder_lr_mul": 1.0,
    "sr_antialias": True,
    "depth_resolution": 8,
    "depth_resolution_importance": 8,
    "box_warp": 1.0,
    "gpc_reg_prob": 0.5,
}


def tiny_gen_cfg(nrr: int = 32, img_res: int = 128, **rendering) -> Dict:
    """The dry run's generator configuration (rendering kwargs overridden by
    `rendering`)."""
    return dict(z_dim=32, c_dim=25, w_dim=512, img_resolution=img_res, img_channels=3,
                rendering_kwargs=dict(TINY_RENDERING_KWARGS, image_resolution=img_res,
                                      **rendering),
                neural_rendering_resolution=nrr, channel_base=1024, channel_max=64,
                map_num_layers=2)


def tiny_models(nrr: int = 32, img_res: int = 128, **rendering):
    """The dry run's generator and dual discriminator (weights from torch's
    global seed)."""
    from ..models.discriminator import DualDiscriminator
    from ..models.triplane import TriPlaneGenerator

    G = TriPlaneGenerator(**tiny_gen_cfg(nrr, img_res, **rendering))
    D = DualDiscriminator(c_dim=25, img_resolution=img_res, img_channels=6, channel_base=1024,
                          channel_max=64, num_fp16_res=0, disc_c_noise=0.0)
    return G, D


def _fake_batch(rng: np.random.RandomState, batch: int, res: int, z_dim: int) -> Dict:
    """A seeded batch (numpy): N(0, 1) NCHW images, the frontal camera looking
    at (0, 0, 0.2) from 2.7, an elliptical UV-coordinate image, z. The same
    numbers as the JAX package's `_fake_batch` of the same `rng`, its images
    NHWC there."""
    from ..camera import fov_to_intrinsics, lookat_camera_pose

    c2w = lookat_camera_pose(None, math.pi / 2, math.pi / 2, [0.0, 0.0, 0.2], radius=2.7,
                             batch_size=batch).numpy()
    K = np.tile(fov_to_intrinsics(18.837).numpy()[None], (batch, 1, 1))
    c = np.concatenate([c2w.reshape(batch, 16), K.reshape(batch, 9)], axis=1).astype(np.float32)
    yy, xx = np.mgrid[0:256, 0:256].astype(np.float32) / 256
    alpha = ((((xx - 0.5) / 0.3) ** 2 + ((yy - 0.47) / 0.38) ** 2) < 1.0).astype(np.float32)
    uvc = np.stack([(xx * 2 - 1) * 0.9, (yy * 2 - 1) * 0.9, alpha], axis=-1)
    image = rng.randn(batch, res, res, 3).astype(np.float32)
    return {"image": np.ascontiguousarray(np.moveaxis(image, -1, 1)), "c": c,
            "v": {"uvcoords_image": np.tile(uvc[None], (batch, 1, 1, 1)).astype(np.float32)},
            "z": rng.randn(batch, z_dim).astype(np.float32)}


def _check_sharded(mesh, local: Dict, global_batch: Dict) -> None:
    """The rank holds rows r, r + N, ... of the global batch."""
    from ..parallel.mesh import shard_batch

    want = shard_batch(mesh, global_batch)
    for key in ("image", "z"):
        got = local[key].cpu().numpy()
        if not np.array_equal(got, np.asarray(want[key])):
            raise AssertionError(f"rank {mesh.rank}: batch[{key!r}] is not its shard")


def _finite(mesh, metrics: Dict) -> Dict[str, float]:
    out = {k: float(v) for k, v in metrics.items()}
    bad = [k for k, v in out.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"rank {mesh.rank}: non-finite metrics {bad}")
    return out


def gan_dryrun_rank(mesh) -> Dict[str, float]:
    """One rank of `run_dryrun`: the step on its rows, then the checks."""
    from ..parallel.mesh import local_batch, replicate
    from ..parallel.multihost import check_replica_consistency
    from ..utils.misc import to_device
    from .gan import GANLossConfig, make_gan_train_step, make_schedules
    from .state import LazyRegAdam, TrainState, ema_update

    nrr, res = 32, 128
    torch.manual_seed(mesh.rank)  # distinct until `replicate`
    G, D = tiny_models(nrr=nrr, img_res=res)
    G.to(mesh.device).train()
    D.to(mesh.device).train()
    cfg = GANLossConfig(r1_gamma=8.0, gpc_reg_prob=0.5, neural_rendering_resolution_initial=nrr,
                        neural_rendering_resolution_final=None, blur_init_sigma=10.0,
                        blur_fade_kimg=8.0)
    g_state = TrainState(G, LazyRegAdam(G.parameters(), 0.0025, 0.0, 0.99, 1e-8,
                                        cfg.g_reg_interval))
    d_state = TrainState(D, LazyRegAdam(D.parameters(), 0.002, 0.0, 0.99, 1e-8,
                                        cfg.d_reg_interval))
    replicate(mesh, g_state, d_state)
    ema = [p.detach().clone() for p in G.parameters()]
    global_batch = _fake_batch(np.random.RandomState(0), mesh.world_size, res, 32)
    batch = to_device(local_batch(mesh, global_batch, mesh.world_size), mesh.device)
    _check_sharded(mesh, batch, global_batch)
    step = make_gan_train_step(G, D, cfg, nrr, do_greg=True, do_dreg=True, mesh=mesh)
    metrics = step(g_state, d_state, batch, make_schedules(cfg, 0),
                   torch.Generator(device=mesh.device).manual_seed(7))
    ema_update(ema, G.parameters(), 0.999)
    check_replica_consistency(mesh, {"G": G, "D": D})
    return _finite(mesh, metrics)


def fewshot_dryrun_rank(mesh) -> Dict[str, float]:
    """One rank of `run_dryrun_inversion`: one Ireal step of the tiny
    network on its clip rows (T = 2), then the checks."""
    from ..models.encoders.uvnet import InversionNet
    from ..parallel.mesh import local_batch, replicate
    from ..parallel.multihost import check_replica_consistency
    from ..utils.misc import to_device
    from .inversion import InversionLossWeights
    from .loop_inversion import make_fewshot_train_step, masked_adam, unet_decoder_trainable
    from .state import TrainState

    # no importance pass, 4 samples: the few-shot step renders every frame
    torch.manual_seed(mesh.rank)
    net = InversionNet(tiny_gen_cfg(depth_resolution=4, depth_resolution_importance=0),
                       encoding_texture=True, encoding_triplane=True,
                       texture_out_channels=(32, 32, 16, 8), trunk_layers_n=8).to(mesh.device)
    state = TrainState(net, masked_adam(net, 1e-4, unet_decoder_trainable))
    replicate(mesh, state)
    B, T = mesh.world_size, 2
    raw = _fake_batch(np.random.RandomState(0), batch=B, res=256, z_dim=32)

    def clip(x):
        return np.repeat(x[:, None], T, axis=1)

    global_batch = {"image": clip(raw["image"]), "c": clip(raw["c"]),
                    "v": {"uvcoords_image": clip(raw["v"]["uvcoords_image"])},
                    "uv": np.zeros((B, T, 6, 256, 256), np.float32), "z": raw["z"]}
    batch = to_device(local_batch(mesh, global_batch, B), mesh.device)
    _check_sharded(mesh, batch, global_batch)
    weights = InversionLossWeights(l1=1.0, lpips=0.0, id=0.0, raw_l1=1.0, tri=0.001,
                                   lr_lpips=0.0, adv=0.0)
    step = make_fewshot_train_step(net, lambda a, b: (a - b).abs().mean(), weights, mesh=mesh)
    aux = step(state, batch, do_igen=False, generator=torch.Generator(
        device=mesh.device).manual_seed(1))
    check_replica_consistency(mesh, net)
    return _finite(mesh, aux)


def _spawn(fn, n_ranks: int, device: str) -> list:
    from ..parallel.multihost import spawn_ranks
    from ..utils.misc import resolve_device

    device = str(resolve_device(device))
    backend = None
    if device.startswith("cuda") and torch.cuda.device_count() < n_ranks:
        device, backend = "cuda:0", "gloo"  # NCCL takes one rank per card
    with tempfile.TemporaryDirectory() as run_dir:
        return spawn_ranks(fn, n_ranks, run_dir, device=device, backend=backend)


def run_dryrun(n_ranks: int, device: str = "cuda") -> list:
    """One full GAN step on `n_ranks` spawned ranks; each rank's metrics."""
    return _spawn(gan_dryrun_rank, n_ranks, device)


def run_dryrun_inversion(n_ranks: int, device: str = "cuda") -> list:
    """One few-shot Ireal step on `n_ranks` spawned ranks; each rank's
    losses."""
    return _spawn(fewshot_dryrun_rank, n_ranks, device)

