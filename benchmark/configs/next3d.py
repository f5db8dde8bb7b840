"""The `next3d` configuration: Next3D's generator driven by the
vertices of a mesh of FLAME's size, one side at a time.

The avatar is its mapped latent (`mapping`, once in set-up); each step runs
one `Next3DTriPlaneGenerator.synthesis` in evaluation on the step's
vertices: the texture backbone, four view rasters, the mouth backbone and
neural blending, the static backbone, the render (coarse pass on B3's
bfloat16 payload) and the super-resolution."""

from __future__ import annotations

import torch

from benchmark.lib import weights
from benchmark.lib.cell import OUTPUTS, Frames


def _classes(side: str):
    if side == "program":
        from invertavatar_torch.models.next3d import Next3DTriPlaneGenerator, make_topology
    else:
        from benchmark.reference.next3d import Next3DTriPlaneGenerator, make_topology
    return Next3DTriPlaneGenerator, make_topology


class Build(Frames):
    def __init__(self, side, cfg, traffic, inputs, seed, device):
        super().__init__(side, cfg, traffic, inputs, seed, device)
        gen_cls, make_topology = _classes(side)
        mesh = inputs["mesh"]
        topo = make_topology(mesh["uvs"], mesh["faces"], mesh["faces"], mesh["mask"],
                             n_verts=mesh["n_verts"])
        with torch.device(self.device):
            G = gen_cls(**cfg["generator"], topology=topo,
                        rendering_kwargs=dict(cfg["rendering_kwargs"]), device=self.device)
        self.G = weights.fill(G, cfg["weights"], seed).eval()

    def avatar(self, rows):
        return self.G.mapping(self.inputs["z"][rows], self.inputs["cond_c"][rows],
                              truncation_psi=self.cfg["truncation_psi"],
                              truncation_cutoff=self.cfg["truncation_cutoff"])

    def drive(self, t):
        return self.inputs["vertices"][:, t % self.inputs["cycle"]]

    def frame(self, avatar, rows, t, drive):
        out = self.G.synthesis(avatar, self.camera(rows, t), self.per_row(drive, rows),
                               noise_mode="const", evaluation=True)
        return {k: out[k] for k in OUTPUTS}

    def spans(self):
        G = self.G
        return [("backbone", G.texture_backbone.synthesis, "forward"),
                ("backbone", G.mouth_backbone.synthesis, "forward"),
                ("backbone", G.neural_blending.synthesis, "forward"),
                ("backbone", G.backbone.synthesis, "forward"),
                ("render", G, "renderer"), ("sr", G.superresolution, "forward")]
