"""The `ani3dgan512` configuration: InvertAvatar's Next3D++
generator driven online by FaceVerse coefficients, one side at a time.

A frame is `cli/reenact.render_frame` over a batch: the avatar's
frame-independent part (`cli/reenact.make_avatar`: mapping with truncation,
both backbones, the raster and texture caches) is made once, and each step
runs every stream's `FaceverseManager.make_driven_rendering` and one
batched `TriPlaneGenerator.synthesis_withTexture` in evaluation."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.lib import weights
from benchmark.lib.cell import OUTPUTS, Frames


def _classes(side: str):
    if side == "program":
        from invertavatar_torch.faceverse.manager import FaceverseManager
        from invertavatar_torch.faceverse.model import FaceVerseAssets
        from invertavatar_torch.models.triplane import TriPlaneGenerator
    else:
        from benchmark.reference.faceverse_manager import FaceverseManager
        from benchmark.reference.faceverse_model import FaceVerseAssets
        from benchmark.reference.triplane import TriPlaneGenerator
    return TriPlaneGenerator, FaceverseManager, FaceVerseAssets


class Build(Frames):
    def __init__(self, side, cfg, traffic, inputs, seed, device):
        super().__init__(side, cfg, traffic, inputs, seed, device)
        gen_cls, manager_cls, assets_cls = _classes(side)
        with torch.device(self.device):
            G = gen_cls(**cfg["generator"], rendering_kwargs=dict(cfg["rendering_kwargs"]))
        self.G = weights.fill(G, cfg["weights"], seed).eval()
        fv = inputs["faceverse"]
        assets = assets_cls(**{k: fv[k] for k in assets_cls._fields if k in fv})
        mask = np.ones(len(fv["uv_per_ver"]), np.float32)
        self.managers = []
        for s in range(inputs["streams"]):
            m = manager_cls(assets, fv2fl=fv["fv2fl"], face_mask=mask, device=self.device)
            m.set_identity(inputs["identity"][s])
            self.managers.append(m)

    def avatar(self, rows):
        G, cfg = self.G, self.cfg
        ws = G.mapping(self.inputs["z"][rows], self.inputs["cond_c"][rows],
                       truncation_psi=cfg["truncation_psi"],
                       truncation_cutoff=cfg["truncation_cutoff"])
        tex = G.texture_backbone.synthesis(ws, return_list=True, noise_mode="const")
        static = G.backbone.synthesis(ws, return_list=True, noise_mode="const")
        return ws, tex, static, G.precompute_raster_static(static), G.precompute_texture_concat(tex)

    def drive(self, t):
        k = t % self.inputs["cycle"]
        coeffs = self.inputs["coeffs"]
        return torch.cat([m.make_driven_rendering(coeffs[s, k])
                          for s, m in enumerate(self.managers)])

    def frame(self, avatar, rows, t, drive):
        ws, tex, static, cache, tex_cat = avatar
        out = self.G.synthesis_withTexture(
            ws, tex, self.camera(rows, t), {"uvcoords_image": self.per_row(drive, rows)},
            static_feats=static, noise_mode="const", evaluation=True,
            raster_static_cache=cache, texture_concat_cache=tex_cat)
        return {k: out[k] for k in OUTPUTS}

    def spans(self):
        G = self.G
        return ([("driving", m, "make_driven_rendering") for m in self.managers]
                + [("backbone", G.face_backbone.synthesis, "forward"),
                   ("render", G, "renderer"), ("sr", G.superresolution, "forward")])
