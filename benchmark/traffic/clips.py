"""The source clips of an absorb mix: every source frame of a run, made once
in set-up on the device from `--seed`, the mix and the configuration, and
read alike by the program and the reference.

A clip is `identities_per_stream` consecutive frames of the stream's
`cycle_frames`; step t absorbs clip t mod (cycle_frames /
identities_per_stream), each a new user's. A frame is, as the port's
`cli/eval_seq.py` loads a preprocessed one:
  * "frames" [L, 3, R, R] (R the generator's output size): smooth seeded
    images in [-1, 1], uniform noise at `noise_resolution`² upsampled
    bilinearly;
  * "uv" [L, 6, 256, 256]: a seeded UV texture made the same way ‖ the
    frame's `uvcoords_image` (x, y, mask), which stands in for the UV vertex
    image as `faceverse/synthetic.py:synthetic_source_clip` does;
  * "cameras" [L, 25]: the mix's camera path (`generate.make_inputs`);
  * "uvcoords" [L, 256, 256, 3]: the `uvcoords_image` of the frame's
    FaceVerse coefficients (`generate.make_inputs`' trajectory), drawn by
    the reference's `FaceverseManager` (the benchmark's copy of the port's).

Copied from the port, not imported: the clip's layout
(`faceverse/synthetic.py:synthetic_source_clip`)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.traffic.generate import rng


def _smooth(r: np.random.Generator, shape, res: int, device) -> torch.Tensor:
    """Uniform noise in [-1, 1] of `shape` [N, C, n, n] upsampled to res²."""
    x = torch.from_numpy(r.uniform(-1, 1, shape).astype(np.float32)).to(device)
    return F.interpolate(x, size=(res, res), mode="bilinear", align_corners=False)


def make_clips(traffic: dict, config: dict, inputs: dict, seed: int, device) -> dict:
    """The clip tables of a run (see the module's text)."""
    from benchmark.reference.faceverse_manager import FaceverseManager
    from benchmark.reference.faceverse_model import FaceVerseAssets

    if inputs["streams"] != 1:
        raise ValueError("an absorb mix has one stream of source clips")
    L, n = inputs["cycle"], traffic["noise_resolution"]
    res = config["generator"]["img_resolution"]
    fv = inputs["faceverse"]
    assets = FaceVerseAssets(**{k: fv[k] for k in FaceVerseAssets._fields if k in fv})
    manager = FaceverseManager(assets, fv2fl=fv["fv2fl"],
                               face_mask=np.ones(len(fv["uv_per_ver"]), np.float32), device=device)
    manager.set_identity(inputs["identity"][0])
    uvcoords = torch.cat([manager.make_driven_rendering(inputs["coeffs"][0, k]) for k in range(L)])
    tex = _smooth(rng(seed, 7), (L, 3, n, n), 256, device)
    return {"frames": _smooth(rng(seed, 6), (L, 3, n, n), res, device),
            "uv": torch.cat([tex, uvcoords.permute(0, 3, 1, 2)], dim=1),
            "cameras": inputs["cameras"][0], "uvcoords": uvcoords}
