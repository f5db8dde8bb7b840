"""3D-GAN training CLI, on one card or data-parallel over several.

Counterpart of `invertavatar_tpu/cli/train_gan.py` (reference
`train_avatar_texture.py`), with the same flags: the flagship generator
geometry with the training render budget (48+48 stochastic samples), the
dual discriminator at 512² (6 channels, bf16 top four resolutions), the
preprocessed dataset, optional ADA. `--dry-run` prints the resolved options
and the number of ranks, and exits. `--gpus N` (default: every visible card)
spawns N ranks over NCCL, one card each, as the reference's launcher does:
`--batch` is the global batch, each rank loads every N-th item of the
sampler's stream (`InfiniteSampler(rank=r, num_replicas=N)`) and draws its
rows of the global z, and the ranks run `train_gan(mesh=...)`. `--device
cpu` runs the ranks over gloo on the CPU.

    python -m invertavatar_torch.cli.train_gan --outdir runs/gan \
        --data DATA/images512x512 [--batch 32] [--gpus 8] [--aug ada] [--device cuda]
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--outdir", required=True)
    p.add_argument("--data", required=True, help="images512x512 dir (preprocessed layout)")
    p.add_argument("--rmesh_path", default=None, help="orthRender256x256_face_eye dir")
    p.add_argument("--gpus", type=int, default=None,
                   help="number of ranks, one card each (default: every visible card)")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--gamma", type=float, default=8.0, help="R1 gamma")
    p.add_argument("--glr", type=float, default=0.0025)
    p.add_argument("--dlr", type=float, default=0.002)
    p.add_argument("--kimg", type=int, default=25000)
    p.add_argument("--neural_rendering_resolution_initial", type=int, default=64)
    p.add_argument("--neural_rendering_resolution_final", type=int, default=128)
    p.add_argument("--neural_rendering_resolution_fade_kimg", type=int, default=1000)
    p.add_argument("--gen_pose_cond", action="store_true")
    p.add_argument("--gpc_reg_prob", type=float, default=0.5)
    p.add_argument("--density_reg", type=float, default=0.25)
    p.add_argument("--blur_fade_kimg", type=float, default=200.0)
    p.add_argument("--cbase", type=int, default=32768)
    p.add_argument("--cmax", type=int, default=512)
    p.add_argument("--map_depth", type=int, default=2)
    p.add_argument("--snap", type=int, default=50)
    p.add_argument("--aug", choices=["noaug", "ada", "fixed"], default="noaug")
    p.add_argument("--p", type=float, default=0.2, help="probability for --aug=fixed")
    p.add_argument("--target", type=float, default=0.6, help="target for --aug=ada")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", default=None, help="a snapshot-*.pt of this trainer")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--dry-run", action="store_true")
    args = p.parse_args(argv)
    if args.gpus is None:
        import torch

        args.gpus = max(torch.cuda.device_count(), 1) if args.device.startswith("cuda") else 1
    if args.gpus < 1 or args.batch % args.gpus:
        raise ValueError(f"--batch {args.batch} must split evenly over --gpus {args.gpus}")
    rendering_kwargs = _resolve(args)[0]
    if args.dry_run:
        print(json.dumps({**vars(args), "ranks": args.gpus, "rendering_kwargs": rendering_kwargs},
                         indent=2, default=str))
        return
    if args.gpus == 1:
        _train(None, args)
        return
    import os

    from ..parallel.multihost import spawn_ranks

    spawn_ranks(_train, args.gpus, args.outdir, args=(args,),
                device="cpu" if args.device == "cpu" else "cuda", timeout_s=1800,
                threads=max(1, (os.cpu_count() or 1) // args.gpus))


def _resolve(args):
    """(rendering kwargs, `GANTrainConfig`, (augment pipe or None)) of the
    flags."""
    from ..flagship import FLAGSHIP_RENDERING_KWARGS
    from ..train.gan import GANLossConfig
    from ..train.loop_gan import GANTrainConfig

    rendering_kwargs = dict(FLAGSHIP_RENDERING_KWARGS)
    rendering_kwargs.update(
        c_gen_conditioning_zero=not args.gen_pose_cond,
        gpc_reg_prob=args.gpc_reg_prob if args.gen_pose_cond else None,
        density_reg=args.density_reg, superresolution_noise_mode="random",
        det_stratified=False,
        # the reference's training budget: 48+48 stochastic samples (the
        # flagship dict carries the 40+24 eval budget)
        depth_resolution=48, depth_resolution_importance=48)

    augment_pipe, augment_p0, ada_target = None, 0.0, None
    if args.aug != "noaug":
        from ..train.augment import AugmentConfig, AugmentPipe

        augment_pipe = AugmentPipe(AugmentConfig(
            xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1, xfrac=1, brightness=1,
            contrast=1, lumaflip=1, hue=1, saturation=1))
        if args.aug == "ada":
            ada_target = args.target
        else:
            augment_p0 = args.p

    loss_cfg = GANLossConfig(
        r1_gamma=args.gamma, gpc_reg_prob=args.gpc_reg_prob if args.gen_pose_cond else None,
        neural_rendering_resolution_initial=args.neural_rendering_resolution_initial,
        neural_rendering_resolution_final=args.neural_rendering_resolution_final,
        neural_rendering_resolution_fade_kimg=args.neural_rendering_resolution_fade_kimg,
        blur_init_sigma=10.0, blur_fade_kimg=args.blur_fade_kimg, density_reg=args.density_reg,
        ada_target=ada_target)
    cfg = GANTrainConfig(run_dir=args.outdir, total_kimg=args.kimg, batch_size=args.batch,
                         g_lr=args.glr, d_lr=args.dlr, snapshot_ticks=args.snap, seed=args.seed,
                         augment_p=augment_p0, loss=loss_cfg)
    return rendering_kwargs, cfg, augment_pipe


def _train(mesh, args) -> None:
    """Build the models and the data stream and train, as one process
    (`mesh` None) or as rank `mesh.rank` of `mesh.world_size`."""
    import numpy as np
    import torch

    from ..data.dataset import AvatarDataset, InfiniteSampler, normalize_image, prefetch_batches
    from ..models.discriminator import DualDiscriminator
    from ..models.triplane import TriPlaneGenerator
    from ..train.loop_gan import train_gan
    from ..utils.misc import resolve_device

    rendering_kwargs, cfg, augment_pipe = _resolve(args)
    device = resolve_device(args.device) if mesh is None else mesh.device
    rank, n_ranks = (0, 1) if mesh is None else (mesh.rank, mesh.world_size)
    dataset = AvatarDataset(args.data, mesh_path=args.rmesh_path, resolution=512)
    torch.manual_seed(args.seed)
    with torch.device(device):
        G = TriPlaneGenerator(
            z_dim=512, c_dim=25, w_dim=512, img_resolution=512, img_channels=3,
            rendering_kwargs=rendering_kwargs,
            neural_rendering_resolution=args.neural_rendering_resolution_initial,
            channel_base=args.cbase, channel_max=args.cmax, map_num_layers=args.map_depth)
        D = DualDiscriminator(c_dim=25, img_resolution=512, img_channels=6,
                              channel_base=args.cbase, channel_max=args.cmax, num_fp16_res=4)
    rng = np.random.RandomState(args.seed)

    def collate(items):
        # this rank's rows of the global batch's z: every rank draws all of it
        z = rng.randn(len(items) * n_ranks, 512).astype(np.float32)[rank::n_ranks]
        return {"image": np.stack([np.transpose(normalize_image(i["image"]), (2, 0, 1))
                                   for i in items]),
                "c": np.stack([i["c"] for i in items]),
                "v": {"uvcoords_image": np.stack([i["uvcoords_image"] for i in items])},
                "z": z}

    sampler = InfiniteSampler(len(dataset), rank=rank, num_replicas=n_ranks, seed=args.seed)
    batches = prefetch_batches(dataset, sampler, args.batch // n_ranks, collate=collate)
    train_gan(G, D, batches, cfg, resume_path=args.resume, augment_pipe=augment_pipe,
              device=device, mesh=mesh)


if __name__ == "__main__":
    main()
