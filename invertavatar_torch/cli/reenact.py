"""GAN avatar reenactment CLI.

Counterpart of `invertavatar_tpu/cli/reenact.py` (reference
reenact_avatar_next3d.py): avatars from seeds, driven by a preprocessed
video's cameras and `uvcoords_image`s, written as an (optionally grid-tiled)
mp4. `main` parses arguments and does the I/O; `make_avatar` and
`render_frame` take tensors, so other drivers call them directly.

    python -m invertavatar_torch.cli.reenact --network gan.pkl --drive_root DIR \
        [--seeds 100-102] [--grid 3x1] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def parse_range(s: str):
    out = []
    for part in s.split(","):
        if "-" in part:
            a, b = part.split("-")
            out.extend(range(int(a), int(b) + 1))
        else:
            out.append(int(part))
    return out


@torch.no_grad()
def make_avatar(G, z, c, truncation_psi=1.0, truncation_cutoff=None):
    """An avatar from latent `z` [1, z_dim] and conditioning camera `c`:
    (ws, texture feats, static feats, raster_static_cache,
    texture_concat_cache), the frame-independent half of every frame."""
    ws = G.mapping(z, c, truncation_psi=truncation_psi, truncation_cutoff=truncation_cutoff)
    tex = G.texture_backbone.synthesis(ws, return_list=True, noise_mode="const")
    static = G.backbone.synthesis(ws, return_list=True, noise_mode="const")
    return ws, tex, static, G.precompute_raster_static(static), G.precompute_texture_concat(tex)


@torch.no_grad()
def render_frame(G, avatar, c, uvcoords_image):
    """One 512² frame [1, 3, H, W] of `avatar` (`make_avatar`) at camera `c`
    [1, 25] driven by `uvcoords_image` [1, 256, 256, 3]."""
    ws, tex, static, cache, tex_cat = avatar
    return G.synthesis_withTexture(ws, tex, c, {"uvcoords_image": uvcoords_image},
                                   static_feats=static, noise_mode="const", evaluation=True,
                                   raster_static_cache=cache,
                                   texture_concat_cache=tex_cat)["image"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--network", required=True, help="reference .pkl with G_ema")
    p.add_argument("--drive_root", required=True, help="preprocessed drive video root")
    p.add_argument("--seeds", type=parse_range, default=[100])
    p.add_argument("--outdir", default="out")
    p.add_argument("--grid", default=None, help="WxH grid, e.g. 5x2")
    p.add_argument("--trunc", type=float, default=0.7)
    p.add_argument("--trunc_cutoff", type=int, default=14)
    p.add_argument("--max_frames", type=int, default=50)
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..utils.checkpoint import load_triplane_from_pkl
    from .common import VideoWriter, layout_grid, load_drive_sequence, to_uint8

    G = load_triplane_from_pkl(args.network, key="G_ema", device=args.device)
    dev = next(G.parameters()).device
    frames = load_drive_sequence(args.drive_root, args.max_frames)
    if not frames or "uvcoords_image" not in frames[0]:
        raise ValueError("the drive data must include the uvcoords .npy files")

    # the mapping's conditioning label is the first drive frame's camera
    cond_c = torch.from_numpy(frames[0]["c"]).to(dev)
    avatars = []
    for seed in args.seeds:
        z = torch.from_numpy(np.random.RandomState(seed).randn(1, G.backbone.mapping.z_dim)
                             .astype(np.float32)).to(dev)
        avatars.append(make_avatar(G, z, cond_c, args.trunc, args.trunc_cutoff))

    os.makedirs(args.outdir, exist_ok=True)
    path = os.path.join(args.outdir, f"reenact_seeds{args.seeds[0]}-{args.seeds[-1]}.mp4")
    gw, gh = (int(x) for x in args.grid.split("x")) if args.grid else (len(avatars), 1)
    writer = VideoWriter(path, fps=args.fps)
    try:
        for k, frame in enumerate(frames):
            c = torch.from_numpy(frame["c"]).to(dev)
            uvc = torch.from_numpy(frame["uvcoords_image"]).to(dev)
            writer.append(layout_grid([to_uint8(render_frame(G, a, c, uvc)) for a in avatars],
                                      (gw, gh)))
            if (k + 1) % 10 == 0:
                print(f"frame {k + 1}/{len(frames)}", flush=True)
    finally:
        writer.close()
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
