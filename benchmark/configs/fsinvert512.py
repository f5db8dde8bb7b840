"""The `fsinvert512` configuration: InvertAvatar's few-shot inversion
network building an avatar from a user's source clip, one side at a time.

A step is the port's `cli/eval_seq.py` chain on one clip of
`source_frames` frames (`traffic/clips.py`): `absorb_clip` (the e4e encode
of the first frame and both backbones, the e4e render caches, then one
`absorb_chunk` per `chunk` frames, each rendering the chunk, running both
ConvGRU U-Nets from the states the last one returned and the static
backbone under their SFT conditions), `drive_caches`, and one batched
`TriPlaneGenerator.synthesis_withTexture` in evaluation of the absorbed
avatar at the clip's cameras and `uvcoords_image`s: the reconstructions the
user previews. Nothing is made once per avatar: `avatar` is empty and
`drive(t)` gives the clip's `uvcoords_image`s.

The outputs the check compares, one row a source frame (a chunk's or the
avatar's tensors repeated over its frames): the reconstructions ("image",
"image_raw", "image_depth"), the e4e codes "w", each chunk's render
("render", "render_raw": what Δimage is taken from) and the absorbed
avatar's feature lists, each flattened into one row ("texture": the texture
pyramid with the U-Net's offsets; "static": the static backbone under the
SFT conditions).

The check's reference takes each chunk's Δimage from the other side's
render of that chunk in the same step (`absorb_clip`'s `delta_from`), not
from its own, and compares the two renders besides. The bfloat16 U-Nets
turn a render's rounding into gaps some thirty times wider at their
outputs, on both sides and on every seed (PERF.md §2), so a free-running
reference could not tell the program from the TF32 control after the first
render; fed the same Δimage, each stage of the absorb is held on its own."""

from __future__ import annotations

import math
import re
import weakref

import torch

from benchmark.lib import weights
from benchmark.lib.cell import OUTPUTS, Frames
from benchmark.traffic.clips import make_clips


def _side(side: str):
    """(the network's constructor, the absorb module) of a side."""
    if side == "program":
        from invertavatar_torch import flagship
        from invertavatar_torch.cli import eval_seq

        def build(generator_cfg, inv, device):
            return flagship.fewshot_inversion_net(
                generator_cfg, trunk_layers_n=inv["trunk_layers_n"],
                unet_eval_dtype=getattr(torch, inv["unet_eval_dtype"]), device=device)

        return build, eval_seq
    from benchmark.reference import inversion

    def build(generator_cfg, inv, device):
        with torch.device(device):
            return inversion.InversionNet(
                generator_cfg, unet_eval_dtype=getattr(torch, inv["unet_eval_dtype"]),
                trunk_layers_n=inv["trunk_layers_n"]).eval()

    return build, inversion


@torch.no_grad()
def fill(module: torch.nn.Module, spec: dict, seed: int, stream: int = 1) -> torch.nn.Module:
    """`weights.fill` (one `torch.randn` on the device over every leaf in
    sorted name order, (scale, mean) by the first matching rule), where a
    convolution weight ([out, in, kh, kw]) whose name matches a pattern of
    `spec["fan_in"]` takes its draw times scale / sqrt(in·kh·kw), so that
    the layer keeps its input's spread (these convolutions have no
    equalised-lr gain of their own). Each leaf is scaled in
    float32 and then stored in its dtype, so a bfloat16 weight is rounded
    once, as its float32 copy would be at each call."""
    rules = [(re.compile(p), float(s), float(m)) for p, s, m in spec["rules"]]
    fan_in = [re.compile(p) for p in spec.get("fan_in", ())]
    named = weights.leaves(module, spec.get("drawn_buffers", ()))
    device = named[0][1].device
    flat = torch.randn(sum(t.numel() for _, t in named), device=device,
                       generator=weights.seeded_generator(device, seed, stream))
    off = 0
    for name, t in named:
        scale, mean = next(((s, m) for p, s, m in rules if p.search(name)), (1.0, 0.0))
        if t.ndim == 4 and any(p.search(name) for p in fan_in):
            scale /= math.sqrt(t[0].numel())
        n = t.numel()
        t.copy_((flat[off:off + n] * scale + mean).view(t.shape))
        off += n
    return module


class _Step(dict):
    """A step's outputs, found again by the step's number (weakly: it lives
    as long as the harness keeps it) by the other side's `frame`."""

    token = None


class _Chunks:
    """Row b of the chunks' [T, ...] tensors: frame b of the clip."""

    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, b):
        T = self.tensors[0].shape[0]
        return self.tensors[b // T][b % T]


class _Flat:
    """One row for every frame: a batch-1 list of tensors flattened and
    joined, made when the check first reads it, not in the step."""

    def __init__(self, tensors):
        self.tensors, self.row = tensors, None

    def __getitem__(self, b):
        if self.row is None:
            self.row = torch.cat([t.reshape(-1) for t in self.tensors])
        return self.row


class Build(Frames):
    def __init__(self, side, cfg, traffic, inputs, seed, device):
        super().__init__(side, cfg, traffic, inputs, seed, device)
        inv = cfg["inversion"]
        self.T, self.n = inv["chunk"], inv["source_frames"]
        if self.batch != self.n or self.n % self.T:
            raise ValueError(f"a step absorbs {self.n} source frames in chunks of {self.T}; "
                             f"the mix's batch is {self.batch}")
        if "clips" not in inputs:
            # made once for the run, so both sides read the same tensors
            inputs["clips"] = make_clips(traffic, cfg, inputs, seed, self.device)
        self.clips = inputs["clips"]
        self.n_clips = inputs["cycle"] // self.n
        build, self.absorb = _side(side)
        generator_cfg = dict(cfg["generator"], rendering_kwargs=dict(cfg["rendering_kwargs"]))
        self.net = fill(build(generator_cfg, inv, self.device), cfg["weights"], seed).eval()
        self.G = self.net.generator
        self.steps = inputs.setdefault("absorb_steps", weakref.WeakValueDictionary())
        self.token = object()
        self.renders = []
        if side == "program":
            # the port's chunk renders, as `ar_forward` hands them to Δimage
            synthesis = self.G.synthesis_withTexture

            def recorded(*args, **kw):
                out = synthesis(*args, **kw)
                self.renders.append({k: out[k] for k in ("image", "image_raw")})
                return out

            self.G.synthesis_withTexture = recorded

    def _clip(self, t):
        s = slice((t % self.n_clips) * self.n, (t % self.n_clips + 1) * self.n)
        return {k: v[s] for k, v in self.clips.items()}

    def avatar(self, rows):
        return None

    def drive(self, t):
        return self._clip(t)["uvcoords"]

    def frame(self, avatar, rows, t, drive):
        clip, B = self._clip(t), len(rows)
        self.renders = renders = []
        kw = {}
        if self.side == "reference":
            kw["renders"] = renders
            other = self.steps.get(t)
            if other is not None and other.token is not self.token:
                kw["delta_from"] = other["render"].tensors
        av, _ = self.absorb.absorb_clip(self.net, clip["frames"], clip["uv"], clip["cameras"],
                                        drive, self.T, **kw)
        chunks = renders[:self.n // self.T]
        raster, tex_cat = self.absorb.drive_caches(self.net, av)

        def rep(x):
            return x.expand(B, *x.shape[1:])

        rec = self.G.synthesis_withTexture(
            rep(av["w"]), [rep(f) for f in av["texture"]], clip["cameras"][rows],
            {"uvcoords_image": drive[rows]}, static_feats=[rep(f) for f in av["static"]],
            noise_mode="const", evaluation=True, raster_static_cache=[rep(x) for x in raster],
            texture_concat_cache={k: rep(v) for k, v in tex_cat.items()})
        out = _Step({k: rec[k] for k in OUTPUTS}, w=rep(av["w"]),
                    render=_Chunks([y["image"] for y in chunks]),
                    render_raw=_Chunks([y["image_raw"] for y in chunks]),
                    texture=_Flat(av["texture"]), static=_Flat(av["static"]))
        out.token = self.token
        self.steps[t], self.renders = out, []
        return out

    def spans(self):
        G = self.G
        return ([("backbone", b.synthesis, "forward")
                 for b in (G.face_backbone, G.texture_backbone, G.backbone)]
                + [("render", G, "renderer"), ("sr", G.superresolution, "forward")])
