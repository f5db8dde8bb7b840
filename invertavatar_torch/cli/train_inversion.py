"""Inversion-encoder training CLI on one card.

Counterpart of `invertavatar_tpu/cli/train_inversion.py` (reference
`encoder_inversion/train.py`), with the same flags. `--training_state`
selects the stage: `e4e` trains the W+ encoder against the frozen generator
of `--gen_pkl`; `oneshot` trains the SegFormer U-Nets (with a dual
discriminator when the adversarial weight is on); `fewshot` trains the
ConvGRU U-Nets' decoders on clips of `--frm_per_vid` frames of one video
(`<vid>/<frame>.png` under `--data`), over the {6, 12, 18} curriculum cut to
the clip length, with the Igen phase on each batch's `z`. LPIPS falls back
to the mean L1 distance without `--lpips_weights`; the ID loss runs only
with `--irse50`; both read torch state dicts by path (not in the
repository). `--dry-run` prints the options and exits. Training runs on
CUDA unless `--device cpu` is given.

    python -m invertavatar_torch.cli.train_inversion --outdir runs/fewshot \
        --data DATA/images512x512 --gen_pkl ani3dgan512.pkl \
        --training_state fewshot [--batch 1] [--frm_per_vid 4] [--device cuda]
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--outdir", required=True)
    p.add_argument("--data", required=True)
    p.add_argument("--gen_pkl", required=True, help="frozen 3D-GAN checkpoint (ani3dgan512-style)")
    p.add_argument("--training_state", choices=["e4e", "oneshot", "fewshot"], default="e4e")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--frm_per_vid", type=int, default=4)
    p.add_argument("--res", type=int, default=512, help="training image resolution")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--kimg", type=int, default=5000)
    p.add_argument("--snap_ticks", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-steps", type=int, default=None,
                   help="stop after N optimizer steps (smoke/CI runs)")
    p.add_argument("--lpips_weights", default=None,
                   help="LPIPS (AlexNet) torch state dict: net.<i>.*, lin.<i>.1.weight")
    p.add_argument("--irse50", default=None, help="ArcFace ir_se50 torch checkpoint for ID loss")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--dry-run", action="store_true")
    args = p.parse_args(argv)

    if args.dry_run:
        print(json.dumps(vars(args), indent=2))
        return
    import numpy as np
    import torch

    from ..data.dataset import (AvatarDataset, InfiniteSampler, VideoDataset, normalize_image,
                                prefetch_batches)
    from ..models.encoders import InversionNet, LatentCodesDiscriminator, texture_out_channels_for
    from ..train.loop_inversion import (InversionTrainConfig, train_e4e, train_fewshot,
                                        train_oneshot)
    from ..utils.checkpoint import load_reference_state, triplane_config_from_init_kwargs
    from ..utils.misc import resolve_device
    from ..utils.pkl_import import load_network_pkl

    device = resolve_device(args.device)
    entry = load_network_pkl(args.gen_pkl)["G_ema"]
    gen_cfg = triplane_config_from_init_kwargs(entry["init_kwargs"])
    oneshot = args.training_state == "oneshot"
    unets = args.training_state != "e4e"
    torch.manual_seed(args.seed)
    with torch.device(device):
        net = InversionNet(gen_cfg, encoding_texture=unets, encoding_triplane=unets,
                           unet_type="segformer" if oneshot else "gru",
                           texture_out_channels=texture_out_channels_for(
                               gen_cfg["channel_base"], gen_cfg["channel_max"]))
    load_reference_state(net.generator, entry["state_dict"])
    del entry

    def lpips_fn(a, b):  # the fallback when no LPIPS weights are given
        return torch.mean(torch.abs(a - b))

    if args.lpips_weights:
        from ..losses.lpips import load_lpips

        lpips_fn = load_lpips(args.lpips_weights, device=device)

    id_fn = None
    if args.irse50:
        from ..losses import id_loss
        from ..losses.id_loss import load_arcface

        backbone = load_arcface(args.irse50, device=device)

        def id_fn(a, b):
            return id_loss(backbone, a, b)

    cfg = InversionTrainConfig(run_dir=args.outdir, total_kimg=args.kimg, batch_size=args.batch,
                               lr=args.lr, snapshot_ticks=args.snap_ticks, seed=args.seed)
    nprng = np.random.RandomState(args.seed)
    if args.training_state == "fewshot":
        # clips of one video each; `z` drives the Igen phase
        videos = VideoDataset(args.data, resolution=args.res, frm_per_vid=args.frm_per_vid)

        def clips():
            while True:
                items = [videos.sample_clip(int(i), nprng)
                         for i in nprng.randint(videos.num_videos, size=args.batch)]
                yield {"image": np.stack([np.transpose(i["image"], (0, 3, 1, 2)) for i in items]),
                       "c": np.stack([i["c"] for i in items]),
                       "v": {"uvcoords_image": np.stack([i["uvcoords_image"] for i in items])},
                       "uv": np.stack([np.transpose(i["uv"], (0, 3, 1, 2)) for i in items]),
                       "z": nprng.randn(args.batch, gen_cfg["z_dim"]).astype(np.float32)}

        train_fewshot(net, clips(), cfg, lpips_fn, max_steps=args.max_steps, device=device)
        return
    dataset = AvatarDataset(args.data, resolution=args.res, load_uv=oneshot)
    sampler = InfiniteSampler(len(dataset), seed=args.seed)

    def collate(items):
        batch = {"image": np.stack([np.transpose(normalize_image(i["image"]), (2, 0, 1))
                                    for i in items]),
                 "c": np.stack([i["c"] for i in items]),
                 "v": {"uvcoords_image": np.stack([i["uvcoords_image"] for i in items])},
                 "z": nprng.randn(len(items), gen_cfg["z_dim"]).astype(np.float32)}
        if oneshot:
            batch["uv"] = np.stack([np.transpose(i["uv"], (2, 0, 1)) for i in items])
            batch["gen_uv"] = batch["uv"]
        return batch

    batches = prefetch_batches(dataset, sampler, args.batch, collate=collate)
    if not oneshot:
        train_e4e(net, LatentCodesDiscriminator(), batches, cfg, lpips_fn, id_fn,
                  max_steps=args.max_steps, device=device)
        return
    # the interval-phase stage: single-frame batches, one optimizer per U-Net,
    # the dual discriminator only with the adversarial weight on
    D = None
    if cfg.weights.adv > 0:
        from ..models.discriminator import DualDiscriminator

        with torch.device(device):
            D = DualDiscriminator(c_dim=gen_cfg["c_dim"], img_resolution=gen_cfg["img_resolution"],
                                  img_channels=6)
    train_oneshot(net, D, batches, cfg, lpips_fn, id_fn, max_steps=args.max_steps, device=device)


if __name__ == "__main__":
    main()
