"""Few-shot inversion and reenactment CLI.

Counterpart of `invertavatar_tpu/cli/eval_seq.py` (reference eval_seq.py):
the avatar is built from a source clip (e4e codes of the first frame, then
the ConvGRU U-Nets refine the texture and static features chunk by chunk,
their states carried across chunks), then a drive video renders it frame by
frame, from its stored `uvcoords_image`s or, given the FaceVerse assets,
from its coefficients online.

`main` parses arguments and does the I/O (PIL, cv2 / imageio); the work is in
`absorb_clip` (`build_avatar`, then `absorb_chunk` per chunk), `drive_caches`
and `render_drive_frame`, which take tensors, so other drivers call them
directly.

    python -m invertavatar_torch.cli.eval_seq --network FSInvertAvatar.pkl \
        --source_root SRC --drive_root DRIVE [--faceverse_model faceverse_v3_1.npy \
        --faceverse_assets DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..utils import trace


@torch.no_grad()
def build_avatar(net, first_image: torch.Tensor) -> Dict:
    """The e4e avatar of the first source frame [1, 3, H, W]: {"w",
    "texture", "static"}."""
    ws = net.encode(first_image)
    G = net.generator
    return {"w": ws,
            "texture": G.texture_backbone.synthesis(ws, return_list=True, noise_mode="const"),
            "static": G.backbone.synthesis(ws, return_list=True, noise_mode="const")}


@torch.no_grad()
def e4e_render_caches(net, avatar: Dict, T: int):
    """The render caches of a chunk of T frames of `avatar`'s feature lists
    (valid while those lists are unchanged: the first chunk)."""
    G = net.generator
    rep = [f.repeat_interleave(T, dim=0) for f in avatar["static"]]
    return (G.precompute_raster_static(rep),
            G.precompute_texture_concat([f.repeat_interleave(T, dim=0) for f in avatar["texture"]]))


@torch.no_grad()
@trace.spanned("absorb.chunk")
def absorb_chunk(net, avatar: Dict, images: torch.Tensor, uvs: torch.Tensor, cs: torch.Tensor,
                 uvcoords: torch.Tensor, r_list: Optional[List] = None, render_caches=None):
    """Refine `avatar` with a chunk of T source frames: images [T, 3, H, W],
    uvs [T, 6, 256, 256] (UV texture ‖ UV vertex image), cameras [T, 25],
    uvcoords [T, 256, 256, 3]. `r_list` None starts fresh GRU states;
    returns (the refined avatar, the states to carry)."""
    updated, r_list = net.ar_forward({"image": images, "uv": uvs}, cs, {"uvcoords_image": uvcoords},
                                     avatar["w"], r_list or [None, None], e4e_results=avatar,
                                     e4e_render_caches=render_caches)
    return updated, r_list


@torch.no_grad()
def absorb_clip(net, images: torch.Tensor, uvs: torch.Tensor, cs: torch.Tensor,
                uvcoords: torch.Tensor, T: int):
    """The avatar of a source clip (`absorb_chunk`'s shapes, n frames): the
    e4e avatar of its first frame refined by its chunks of T frames (a tail
    shorter than T is left out), the first chunk's render from the e4e
    render caches. Returns (avatar, the GRU states). The whole absorb is one
    span, `absorb`, so that the tracer counts every host synchronisation
    inside it."""
    with trace.span("absorb"):
        avatar = build_avatar(net, images[0:1])
        caches = e4e_render_caches(net, avatar, T)
        r_list = None
        for start in range(0, images.shape[0] - T + 1, T):
            s = slice(start, start + T)
            avatar, r_list = absorb_chunk(net, avatar, images[s], uvs[s], cs[s], uvcoords[s],
                                          r_list, render_caches=caches if start == 0 else None)
    return avatar, r_list


@torch.no_grad()
def drive_caches(net, avatar: Dict):
    """The frame-independent half of every drive frame of the absorbed avatar."""
    G = net.generator
    return (G.precompute_raster_static(avatar["static"]),
            G.precompute_texture_concat(avatar["texture"]))


@torch.no_grad()
def render_drive_frame(net, avatar: Dict, caches, c: torch.Tensor,
                       uvcoords_image: Optional[torch.Tensor] = None, manager=None, coeff=None):
    """One frame [1, 3, H, W] at camera `c` [1, 25]: driven online from
    FaceVerse `coeff` through `manager` (`make_driven_rendering`), or by a
    stored `uvcoords_image` [1, 256, 256, 3]."""
    if manager is not None and coeff is not None:
        uvcoords_image = manager.make_driven_rendering(coeff)
    return net.generator.synthesis_withTexture(
        avatar["w"], avatar["texture"], c, {"uvcoords_image": uvcoords_image},
        static_feats=avatar["static"], noise_mode="const", evaluation=True,
        raster_static_cache=caches[0], texture_concat_cache=caches[1])["image"]


def _load_source_uv(uv_dir: str, stem: str) -> np.ndarray:
    """[1, 6, 256, 256]: the UV texture (`<stem>_uvgttex.png`) and the UV
    vertex image (`<stem>.npy`)."""
    import PIL.Image

    from ..data.dataset import normalize_image

    uv_pverts = np.load(os.path.join(uv_dir, stem + ".npy")).astype(np.float32)[..., :3]
    tex = np.array(PIL.Image.open(os.path.join(uv_dir, stem + "_uvgttex.png")).convert("RGB"))
    uv = np.concatenate([normalize_image(tex), uv_pverts], axis=-1)
    return np.transpose(uv, (2, 0, 1))[None]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--network", required=True, help="FSInvertAvatar-style .pkl")
    p.add_argument("--source_root", required=True, help="preprocessed source video root")
    p.add_argument("--drive_root", required=True, help="preprocessed drive video root")
    p.add_argument("--num_source_frames", type=int, default=8)
    p.add_argument("--chunk", type=int, default=4)
    p.add_argument("--max_frames", type=int, default=100)
    p.add_argument("--outdir", default="out")
    p.add_argument("--fps", type=int, default=40)
    p.add_argument("--faceverse_model", default=None,
                   help="faceverse_v3_1.npy for online identity-corrected driving")
    p.add_argument("--faceverse_assets", default=None,
                   help="dir with fv2fl_30.npy + v31_face_mask_new.npy")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..utils.checkpoint import load_inversion_from_pkl
    from .common import VideoWriter, load_drive_sequence, load_image, to_uint8

    net = load_inversion_from_pkl(args.network, device=args.device)
    dev = next(net.parameters()).device
    src = load_drive_sequence(args.source_root, args.num_source_frames)
    drive = load_drive_sequence(args.drive_root, args.max_frames)
    uv_dir = os.path.join(args.source_root, "uvRender256x256")

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # source frames at the generator's output size (512² for the released
    # networks), so that the e4e render and the frames align
    res = net.generator.img_resolution
    avatar, _ = absorb_clip(
        net, tensor(np.concatenate([load_image(it["image_path"], res) for it in src])),
        tensor(np.concatenate([_load_source_uv(uv_dir, it["name"]) for it in src])),
        tensor(np.concatenate([it["c"] for it in src])),
        tensor(np.concatenate([it["uvcoords_image"] for it in src])), args.chunk)
    print(f"absorbed {len(src) // args.chunk * args.chunk} source frames", flush=True)

    manager = None
    if args.faceverse_model and args.faceverse_assets:
        from ..faceverse.manager import FaceverseManager

        manager = FaceverseManager.from_files(args.faceverse_model, args.faceverse_assets,
                                              device=dev)
        if src[0].get("coeff") is not None:
            manager.set_identity(src[0]["coeff"])

    os.makedirs(args.outdir, exist_ok=True)
    out_path = os.path.join(args.outdir, "fewshot_reenact.mp4")
    caches = drive_caches(net, avatar)
    writer = VideoWriter(out_path, fps=args.fps)
    try:
        for k, frame in enumerate(drive):
            online = manager is not None and frame.get("coeff") is not None
            img = render_drive_frame(
                net, avatar, caches, tensor(frame["c"]),
                uvcoords_image=None if online else tensor(frame["uvcoords_image"]),
                manager=manager if online else None, coeff=frame.get("coeff"))
            writer.append(to_uint8(img))
            if (k + 1) % 20 == 0:
                print(f"drive frame {k + 1}/{len(drive)}", flush=True)
    finally:
        writer.close()
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
