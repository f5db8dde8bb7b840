"""One-shot inversion and reenactment CLI.

Counterpart of `invertavatar_tpu/cli/eval_os.py` (reference
`eval_updated_os.py`): one source image is inverted by the improved one-shot
network (e4e W+ codes, then the SegFormer U-Nets refine the texture pyramid
and condition the static backbone), then a drive video renders the avatar
frame by frame from its stored `uvcoords_image`s, and optionally a free-view
camera orbit around it.

`main` parses arguments and does the I/O (PIL, cv2 / imageio); the work is in
`invert_source`, `orbit_camera` and `cli/eval_seq.py`'s `drive_caches` and
`render_drive_frame`, which take tensors, so other drivers call them
directly.

    python -m invertavatar_torch.cli.eval_os --network updatedOSInvertAvatar.pkl \
        --source_image SRC.png --source_camera SRC.json --source_uv UV/STEM \
        --source_uvcoords ORTH/STEM.npy --drive_root DRIVE [--orbit_frames 60] \
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import Dict

import numpy as np
import torch

from .eval_seq import _load_source_uv, drive_caches, render_drive_frame


@torch.no_grad()
def invert_source(net, image: torch.Tensor, cam: torch.Tensor, uv: torch.Tensor,
                  uvcoords: torch.Tensor) -> Dict:
    """The one-shot avatar of one source frame: image [1, 3, H, W], camera
    [1, 25], uv [1, 6, 256, 256] (UV texture ‖ UV vertex image), uvcoords
    [1, 256, 256, 3]. Returns {"w", "texture", "static"} (the refined feature
    lists) and "image", the inversion's render of the source view."""
    out = net({"image": image, "uv": uv}, cam, {"uvcoords_image": uvcoords}, return_feats=True,
              evaluation=True)
    return {k: out[k] for k in ("w", "texture", "static", "image")}


def orbit_camera(k: int, n: int, device="cpu") -> torch.Tensor:
    """Camera [1, 25] of orbit frame k of n: yaw π/2 + 0.6·sin(2πk/n), pitch
    π/2 − 0.1·cos(2πk/n), radius 2.7 around (0, 0, 0.2), 18.837° field of view."""
    from ..camera import fov_to_intrinsics, lookat_camera_pose

    yaw = math.pi / 2 + 0.6 * math.sin(2 * math.pi * k / n)
    pitch = math.pi / 2 - 0.1 * math.cos(2 * math.pi * k / n)
    c2w = lookat_camera_pose(None, yaw, pitch, [0.0, 0.0, 0.2], radius=2.7, device=device)
    K = fov_to_intrinsics(18.837, device=device)
    return torch.cat([c2w.reshape(1, 16), K.reshape(1, 9)], dim=1)


def _load_camera(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        c = np.load(path)
    else:
        with open(path) as f:
            c = np.asarray(json.load(f), np.float32)
    return c.reshape(1, -1).astype(np.float32)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--network", required=True, help="updatedOSInvertAvatar-style .pkl")
    p.add_argument("--source_image", required=True, help="aligned source image")
    p.add_argument("--source_camera", required=True, help="25-dim camera .json or .npy")
    p.add_argument("--source_uv", required=True, help="uv prefix (uvRender256x256/<stem>)")
    p.add_argument("--source_uvcoords", required=True, help="orthRender uvcoords .npy")
    p.add_argument("--drive_root", required=True)
    p.add_argument("--max_frames", type=int, default=100)
    p.add_argument("--orbit_frames", type=int, default=0, help="also render a free-view orbit")
    p.add_argument("--outdir", default="out")
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..utils.checkpoint import load_inversion_from_pkl
    from .common import VideoWriter, load_drive_sequence, load_image, to_uint8

    net = load_inversion_from_pkl(args.network, device=args.device)
    if net.unet_type != "segformer":
        raise ValueError(f"{args.network} holds no SegFormer U-Nets: not a one-shot network")
    dev = next(net.parameters()).device

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    uvc = np.load(args.source_uvcoords).astype(np.float32)[..., :3]
    uvc[..., -1] = (uvc[..., -1] >= 0.5).astype(np.float32)
    # the source at the generator's output size (512² for the released
    # networks), so that the e4e render and the frame align
    avatar = invert_source(net, tensor(load_image(args.source_image, net.generator.img_resolution)),
                           tensor(_load_camera(args.source_camera)),
                           tensor(_load_source_uv(*os.path.split(args.source_uv))),
                           tensor(uvc[None]))
    print("one-shot inversion done", flush=True)

    caches = drive_caches(net, avatar)
    os.makedirs(args.outdir, exist_ok=True)
    drive = load_drive_sequence(args.drive_root, args.max_frames)
    out_path = os.path.join(args.outdir, "oneshot_reenact.mp4")
    writer = VideoWriter(out_path, fps=args.fps)
    try:
        for frame in drive:
            writer.append(to_uint8(render_drive_frame(net, avatar, caches, tensor(frame["c"]),
                                                      tensor(frame["uvcoords_image"]))))
    finally:
        writer.close()
    print(f"wrote {out_path}")

    if args.orbit_frames > 0:
        out_path = os.path.join(args.outdir, "oneshot_orbit.mp4")
        writer = VideoWriter(out_path, fps=args.fps)
        try:
            for k in range(args.orbit_frames):
                writer.append(to_uint8(render_drive_frame(
                    net, avatar, caches, orbit_camera(k, args.orbit_frames, dev),
                    tensor(uvc[None]))))
        finally:
            writer.close()
        print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
