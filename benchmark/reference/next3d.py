"""[benchmark reference] A frozen copy of `invertavatar_torch/models/next3d.py`: plain
PyTorch, every kernel route replaced by its plain version, nothing of the
program imported. The text below is the original module's.

Next3D tri-plane avatar generator, plain PyTorch (NCHW): the evaluation
path alone (mapping and `synthesis`).

Counterpart of `invertavatar_tpu/models/next3d.py` (reference
`training_avatar_texture/next3d_triplane.py`, `triplane.py` and
`networks_stylegan2_styleunet_next3d.py`):
  * `CondSynthesisNetwork` / `CondGenerator`: an encoder pyramid over a
    condition image fused into a styled synthesis pyramid that starts at
    `final_size`;
  * `Next3DTriPlaneGenerator`: a neural texture rasterized over the FLAME
    topology into 4 orthographic views, the mouth crop refined by
    `mouth_backbone` and pasted back, `neural_blending` over the front plane,
    alpha-blended with the static tri-plane, volume-rendered on the Next3D
    plane set (`ImportanceRenderer(plane_mode="next3d")`, no fused decoder:
    the render's structured pass reaches B3 under `pallas_coarse`), then
    super-resolved;

As in the JAX package: the mouth boxes stay continuous floats realised with
`grid_sample` (zeros outside), the rasterizer is `render.rasterizer` (the
reference's winding flips cancel, so vertices feed it as they are), and
`fill_mouth` floods on the device. The port rasterizes the views item by
item (JAX vmaps), and `CondSynthesisNetwork` builds only the blocks its
forward runs, as the JAX tree holds them. The generators take an explicit
`torch.Generator` where JAX takes its "ray" and "noise" keys, and build on
CUDA unless `device="cpu"`.

Planes are [B, 3, C, H, W].
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from .grid_sample import grid_sample
from .mouth import fill_mouth
from .rasterizer import interpolate_attributes, rasterize
from .ray_sampler import sample_rays
from .renderer import ImportanceRenderer
from .misc import assert_shape, resolve_device
from . import superresolution as sr_mod
from .styleunet import EncoderResBlock
from .layers import Conv2dLayer
from .mapping import MappingNetwork
from .synthesis import Generator, SynthesisBlock
from .triplane import OSGDecoder, _to_planes

# ---------------------------------------------------------------------------
# conditional StyleGAN2 backbone (networks_stylegan2_styleunet_next3d.py)
# ---------------------------------------------------------------------------


class CondEncoderResBlock(EncoderResBlock):
    """EncoderResBlock with a linear, bias-free `fromrgb` (the style-U-Net's
    is lrelu with a bias)."""

    def __init__(self, img_channel: int, in_channel: int, out_channel: int,
                 downsample: bool = True):
        super().__init__(img_channel, in_channel, out_channel, downsample=downsample,
                         fromrgb_bias=False, fromrgb_activation="linear")


class CondSynthesisNetwork(nn.Module):
    """Styled U-pyramid conditioned on an image: x_in [B, C, in, in], ws
    [B, num_ws, w_dim] -> [B, img_channels, R, R].

    The synthesis pyramid runs only from `final_size`·2 up, seeded by the
    fused deepest encoder feature. `num_ws` counts every block from 4² (the
    reference builds the full pyramid and skips the early blocks), and each
    used block's w slice starts at its index in that full pyramid; only the
    used blocks are built."""

    def __init__(self, w_dim: int, img_resolution: int, img_channels: int,
                 cond_channels: int = 3, in_size: int = 64, final_size: int = 4,
                 channel_base: int = 32768, channel_max: int = 512, num_fp16_res: int = 4,
                 num_cond_res: int = 64, conv_clamp: Optional[float] = 256.0, device="cuda"):
        device = resolve_device(device)
        super().__init__()
        self.w_dim = w_dim
        self.img_resolution = img_resolution
        log2 = int(np.log2(img_resolution))
        self.flog2 = int(np.log2(final_size))
        self.block_resolutions = [2 ** i for i in range(2, log2 + 1)]
        cdict = {res: min(channel_base // res, channel_max) for res in self.block_resolutions}
        self.num_ws = sum(1 if res == 4 else 2 for res in self.block_resolutions) + 1
        fp16_resolution = max(2 ** (log2 + 1 - num_fp16_res), 8)

        # the encoder runs in build order (the reference's loop re-labels
        # `res` backwards but indexes in order)
        encoder_res = [2 ** i for i in range(int(np.log2(in_size)), self.flog2 - 1, -1)]
        self.encoder = nn.ModuleList(
            CondEncoderResBlock(cond_channels, cdict[res], cdict[res // 2],
                                downsample=res < in_size)
            for res in encoder_res[:-1])
        self.used = self.block_resolutions[self.flog2 - 1:]
        self.fused_levels = [i for i in range(len(self.used))
                             if 2 ** (i + self.flog2) < num_cond_res]
        specs = [(cdict[res] * (2 if res > final_size else 1), cdict[res])
                 for res in encoder_res[::-1]]
        self.fusion = nn.ModuleDict({str(i): Conv2dLayer(*specs[i], 3)
                                     for i in self.fused_levels})
        for res in self.used:
            setattr(self, f"b{res}", SynthesisBlock(
                in_channels=cdict[res // 2], out_channels=cdict[res], w_dim=w_dim,
                resolution=res, img_channels=img_channels, conv_clamp=conv_clamp,
                use_fp16=res >= fp16_resolution))
        self.to(device)

    def forward(self, x_in: torch.Tensor, ws: torch.Tensor, noise_mode: str = "random",
                force_fp32: bool = False, generator: Optional[torch.Generator] = None):
        assert_shape(ws, [None, self.num_ws, self.w_dim])
        ws = ws.float()
        conds, cond_out = [], None
        for block in self.encoder:
            x_in, cond_out = block(x_in, cond_out)
            conds.append(cond_out)
        conds = conds[::-1]

        # w slices over the FULL pyramid: a block sees num_conv + 1 ws and
        # the index advances by num_conv
        w_start, w_idx = {}, 0
        for res in self.block_resolutions:
            w_start[res] = w_idx
            w_idx += 1 if res == 4 else 2

        x = img = None
        for index, res in enumerate(self.used):
            if index in self.fused_levels:
                inp = conds[0] if index == 0 else torch.cat([x.float(), conds[index]], dim=1)
                x = self.fusion[str(index)](inp)
            x, img = getattr(self, f"b{res}")(
                x, img, ws[:, w_start[res]:w_start[res] + 3], noise_mode=noise_mode,
                force_fp32=force_fp32, generator=generator)
        return img


class CondGenerator(nn.Module):
    """Mapping + `CondSynthesisNetwork`: (z, c, x_cond) -> image."""

    def __init__(self, z_dim: int, c_dim: int, w_dim: int, img_resolution: int,
                 img_channels: int, cond_channels: int = 3, in_size: int = 64,
                 final_size: int = 4, num_cond_res: int = 64, mapping_ws: int = -1,
                 channel_base: int = 32768, channel_max: int = 512, num_fp16_res: int = 4,
                 conv_clamp: Optional[float] = 256.0, map_num_layers: int = 8,
                 map_lr_multiplier: float = 0.01, map_w_avg_beta: Optional[float] = 0.998,
                 device="cuda"):
        device = resolve_device(device)
        super().__init__()
        self.synthesis = CondSynthesisNetwork(
            w_dim=w_dim, img_resolution=img_resolution, img_channels=img_channels,
            cond_channels=cond_channels, in_size=in_size, final_size=final_size,
            num_cond_res=num_cond_res, channel_base=channel_base, channel_max=channel_max,
            num_fp16_res=num_fp16_res, conv_clamp=conv_clamp, device=device)
        self.num_ws = self.synthesis.num_ws
        self.mapping = MappingNetwork(
            z_dim=z_dim, c_dim=c_dim, w_dim=w_dim,
            num_ws=mapping_ws if mapping_ws != -1 else self.num_ws,
            num_layers=map_num_layers, lr_multiplier=map_lr_multiplier,
            w_avg_beta=map_w_avg_beta)
        self.to(device)


# ---------------------------------------------------------------------------
# FLAME topology
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FlameTopology:
    """Static mesh topology (next3d_triplane.py:84-110 buffers)."""

    faces: np.ndarray  # [F, 3] int32 vertex indices
    face_uvcoords: np.ndarray  # [F, 3, 3] per-face-vertex (u*2-1, -(v*2-1), 1)
    uv_face_mask: np.ndarray  # [1, 256, 256, 1] face+eye UV-space mask
    n_verts: int = 5023  # FLAME vertex count; v[:, n_verts:] are landmarks


def make_topology(uvs: np.ndarray, faces: np.ndarray, uvfaces: np.ndarray,
                  uv_face_mask: np.ndarray, n_verts: int) -> FlameTopology:
    """The raster buffers: uv -> [-1, 1], v flipped, a homogeneous 1
    appended, gathered per uv-face."""
    uvcoords = np.concatenate([uvs, np.ones_like(uvs[:, :1])], axis=-1)
    uvcoords = uvcoords * 2 - 1
    uvcoords[:, 1] = -uvcoords[:, 1]
    face_uvcoords = uvcoords[uvfaces]  # [F, 3, 3]
    mask2d = np.asarray(uv_face_mask, np.float32).squeeze()
    assert mask2d.ndim == 2, mask2d.shape
    return FlameTopology(faces=np.asarray(faces, np.int32),
                         face_uvcoords=face_uvcoords.astype(np.float32),
                         uv_face_mask=mask2d.reshape(1, *mask2d.shape, 1), n_verts=n_verts)


# ---------------------------------------------------------------------------
# ortho-view rasterization + mouth stitch helpers
# ---------------------------------------------------------------------------

_VIEWS_DEG = ((0.0, 0.0, 0.0), (0.0, 90.0, 0.0), (0.0, -90.0, 0.0), (90.0, 0.0, 0.0))
_ORTH_SCALE = 5.0
_ORTH_SHIFT = (0.0, -0.01, -0.01)


def _angle2matrix_np(deg: Sequence[float]) -> np.ndarray:
    """Euler angles in degrees (x, y, z) -> the reference's rotation matrix."""
    x, y, z = (np.deg2rad(a) for a in deg)
    cx, cy, cz = np.cos([x, y, z])
    sx, sy, sz = np.sin([x, y, z])
    return np.array(
        [
            [cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx],
            [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx],
            [-sy, cy * sx, cy * cx],
        ],
        np.float32,
    )


def _vec(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def transform_to_view(v: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """[B, V, 3] vertices -> screen space for one ortho view: pixel x / y grow
    with +x / +y and nearer surfaces have smaller z (all depths positive)."""
    v = v.float() * _vec([1.0, -1.0, 1.0], v)
    tv = (v @ rot + _vec(_ORTH_SHIFT, v)) * _ORTH_SCALE
    return tv * _vec([1.0, -1.0, -1.0], v) + _vec([0.0, 0.0, 10.0], v)


def gen_mouth_mask(lm2d: torch.Tensor) -> torch.Tensor:
    """Square mouth boxes from the outer-lip landmarks: lm2d [B, 68, 2]
    normalized -> [B, 4] (row0, row1, col0, col1) in 256-pixel space, kept
    continuous (the reference floors to ints)."""
    px = lm2d.float() * 128.0 + 128.0
    outer = px[:, 48:60]  # outer lip, left-clockwise
    mouth_avg = (outer[:, 0] + outer[:, 6]) * 0.5  # [B, 2] (x, y)
    span_x = outer[..., 0].amax(dim=1) - outer[..., 0].amin(dim=1)
    span_y = outer[..., 1].amax(dim=1) - outer[..., 1].amin(dim=1)
    r = torch.maximum(span_x, span_y) * 1.2
    cy, cx = mouth_avg[:, 1], mouth_avg[:, 0]
    return torch.stack([cy - r / 2, cy + r / 2, cx - r / 2, cx + r / 2], dim=-1)


def _box_grid(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """gx [B, W'], gy [B, H'] -> the separable sampling grid [B, H', W', 2]."""
    B, Hp, Wp = gy.shape[0], gy.shape[1], gx.shape[1]
    return torch.stack([gx[:, None, :].expand(B, Hp, Wp), gy[:, :, None].expand(B, Hp, Wp)],
                       dim=-1)


def crop_resize_boxes(img: torch.Tensor, boxes: torch.Tensor, out: int = 64) -> torch.Tensor:
    """Bilinear crop → resize of each item's box: img [B, C, H, W], boxes
    [B, 4] -> [B, C, out, out] (zeros outside the image)."""
    H, W = img.shape[-2:]
    boxes = boxes.float()
    k = (torch.arange(out, dtype=torch.float32, device=img.device) + 0.5) / out
    rows = boxes[:, 0:1] + k[None] * (boxes[:, 1:2] - boxes[:, 0:1])  # [B, out]
    cols = boxes[:, 2:3] + k[None] * (boxes[:, 3:4] - boxes[:, 2:3])
    # the pixel-centre coordinate p maps to 2p/H - 1
    return grid_sample(img, _box_grid((2.0 * cols) / W - 1.0, (2.0 * rows) / H - 1.0))


def paste_boxes(img: torch.Tensor, patch: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Paste each item's `patch` [B, C, Ph, Pw], bilinearly resized, into its
    box of img [B, C, H, W]."""
    H, W = img.shape[-2:]
    Ph, Pw = patch.shape[-2:]
    boxes = boxes.float()
    ii = torch.arange(H, dtype=torch.float32, device=img.device) + 0.5
    jj = torch.arange(W, dtype=torch.float32, device=img.device) + 0.5
    m0, m1, m2, m3 = boxes.unbind(dim=1)
    u = (ii[None, :] - m0[:, None]) / (m1 - m0)[:, None]  # [B, H], in [0, 1) inside
    v = (jj[None, :] - m2[:, None]) / (m3 - m2)[:, None]  # [B, W]
    # edge-clamped patch coordinates, like F.interpolate's border replication
    # (grid_sample alone would zero the half-pixel rim)
    gy = (2.0 * u - 1.0).clamp(1.0 / Ph - 1.0, 1.0 - 1.0 / Ph)
    gx = (2.0 * v - 1.0).clamp(1.0 / Pw - 1.0, 1.0 - 1.0 / Pw)
    sampled = grid_sample(patch, _box_grid(gx, gy))
    inside = (((u >= 0) & (u < 1.0))[:, :, None] & ((v >= 0) & (v < 1.0))[:, None, :])[:, None]
    return torch.where(inside, sampled, img.float())


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------


class _OrthoTriPlane(nn.Module):
    """The generator's common parts: the backbones' settings, the
    super-resolution, the decoder, the Next3D-plane renderer, the topology's
    buffers (outside the state dict) and the render."""

    def __init__(self, z_dim, c_dim, w_dim, img_resolution, topology, sr_num_fp16_res,
                 rendering_kwargs, neural_rendering_resolution, channel_base, channel_max,
                 num_fp16_res, conv_clamp, map_num_layers, faces_per_tile):
        super().__init__()
        self.topology = topology
        self.img_resolution = img_resolution
        self.rendering_kwargs = dict(rendering_kwargs or {})
        self.neural_rendering_resolution = neural_rendering_resolution
        self.faces_per_tile = faces_per_tile
        self.common = dict(z_dim=z_dim, c_dim=c_dim, w_dim=w_dim, img_resolution=256,
                           channel_base=channel_base, channel_max=channel_max,
                           num_fp16_res=num_fp16_res, conv_clamp=conv_clamp,
                           map_num_layers=map_num_layers)
        rk = self.rendering_kwargs
        sr_name = rk.get("superresolution_module",
                         "training_avatar_texture.superresolution.SuperresolutionHybrid8XDC")
        self.superresolution = getattr(sr_mod, sr_name.rsplit(".", 1)[-1])(
            channels=32, img_resolution=img_resolution, sr_num_fp16_res=sr_num_fp16_res,
            sr_antialias=rk.get("sr_antialias", True))
        self.decoder = OSGDecoder(32, decoder_lr_mul=rk.get("decoder_lr_mul", 1.0),
                                  decoder_output_dim=32)
        self.renderer = ImportanceRenderer(plane_mode="next3d")
        self.register_buffer("faces", torch.from_numpy(np.asarray(topology.faces, np.int64)),
                             persistent=False)
        self.register_buffer("face_uvcoords", torch.from_numpy(
            np.asarray(topology.face_uvcoords, np.float32)), persistent=False)
        mask = np.asarray(topology.uv_face_mask, np.float32)  # [1, H, W, 1]
        self.register_buffer("uv_face_mask", torch.from_numpy(
            np.ascontiguousarray(mask.transpose(0, 3, 1, 2))), persistent=False)

    def _raster(self, tv: torch.Tensor, faces: torch.Tensor,
                face_attrs: torch.Tensor) -> torch.Tensor:
        """One view of each item: [B, V, 3] screen vertices -> [B, 256, 256, 4]
        (u, v, 1, visibility)."""
        return torch.stack([interpolate_attributes(
            rasterize(t, faces, height=256, width=256, window=(-1.0, 1.0, -1.0, 1.0),
                      faces_per_tile=self.faces_per_tile, cull_backfaces=True), face_attrs)
            for t in tv])

    def mapping(self, z, c, truncation_psi=1.0, truncation_cutoff=None):
        rk = self.rendering_kwargs
        if rk.get("c_gen_conditioning_zero", True):
            c = torch.zeros_like(c)
        return self.backbone.mapping(z, self._mapping_c(c) * rk.get("c_scale", 0.0),
                                     truncation_psi=truncation_psi,
                                     truncation_cutoff=truncation_cutoff)

    def _mapping_c(self, c):
        return c

    def synthesis(self, ws, c, v, evaluation: bool = False, noise_mode: str = "random",
                  generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """ws [B, num_ws, w_dim], camera c [B, 25], vertices v -> {"image",
        "image_raw", "image_depth"}."""
        rk = self.rendering_kwargs
        c = c.float()
        res = self.neural_rendering_resolution
        ray_o, ray_d = sample_rays(c[:, :16].reshape(-1, 4, 4), c[:, 16:25].reshape(-1, 3, 3),
                                   res)
        planes, sr_ws = self._build_planes(ws, v, noise_mode, generator)
        feature_samples, depth_samples, _ = self.renderer(
            planes, self.decoder, ray_o, ray_d, rk, evaluation=evaluation, generator=generator)
        B = ws.shape[0]
        feature_image = feature_samples.permute(0, 2, 1).reshape(B, -1, res, res)
        depth_image = depth_samples.permute(0, 2, 1).reshape(B, 1, res, res)
        rgb_image = feature_image[:, :3]
        sr_image = self.superresolution(
            rgb_image, feature_image, sr_ws,
            noise_mode=rk.get("superresolution_noise_mode", "none"), generator=generator)
        return {"image": sr_image, "image_raw": rgb_image, "image_depth": depth_image}

class Next3DTriPlaneGenerator(_OrthoTriPlane):
    """Next3D's TriPlaneGenerator (reference next3d_triplane.py:41-367).

    v [B, n_verts + 68, 3] holds the FLAME vertices, then the 68 landmarks."""

    def __init__(self, z_dim: int, c_dim: int, w_dim: int, img_resolution: int,
                 img_channels: int, topology: FlameTopology, sr_num_fp16_res: int = 0,
                 rendering_kwargs: Any = None, neural_rendering_resolution: int = 64,
                 channel_base: int = 32768, channel_max: int = 512, num_fp16_res: int = 0,
                 conv_clamp: Optional[float] = 256.0, map_num_layers: int = 8,
                 do_fill_mouth: bool = True, faces_per_tile: int = 1024, device="cuda"):
        device = resolve_device(device)
        super().__init__(z_dim, c_dim, w_dim, img_resolution, topology, sr_num_fp16_res,
                         rendering_kwargs, neural_rendering_resolution, channel_base,
                         channel_max, num_fp16_res, conv_clamp, map_num_layers, faces_per_tile)
        self.do_fill_mouth = do_fill_mouth
        common = self.common
        self.texture_backbone = Generator(img_channels=32, **common)
        self.mouth_backbone = CondGenerator(img_channels=32, cond_channels=32, in_size=64,
                                            final_size=4, num_cond_res=64, device=device,
                                            **common)
        self.backbone = Generator(img_channels=32 * 3,
                                  mapping_ws=self.texture_backbone.synthesis.num_ws * 2, **common)
        self.neural_blending = CondGenerator(img_channels=32, cond_channels=32, in_size=256,
                                             final_size=32, num_cond_res=256, device=device,
                                             **common)
        self.to(device)

    @property
    def num_ws(self) -> int:
        return self.texture_backbone.synthesis.num_ws * 2

    def _mapping_c(self, c):
        return c[:, :25]

    def rasterize_views(self, v: torch.Tensor, lms: torch.Tensor, textures: torch.Tensor):
        """Four ortho views -> (renders [front, side (left + right), up],
        alphas [front, side, up], each [B, ·, 256, 256], and the 2D landmarks
        of each view [4][B, 68, 2])."""
        uv_mask = self.uv_face_mask.expand(v.shape[0], -1, -1, -1)
        renders, alphas, lm2ds = [], [], []
        for view in _VIEWS_DEG:
            rot = torch.from_numpy(_angle2matrix_np(view)).to(v.device)
            tv = transform_to_view(v, rot)
            lm = (lms.float() * _vec([1.0, -1.0, 1.0], lms) @ rot
                  + _vec(_ORTH_SHIFT, lms)) * _ORTH_SCALE
            lm2ds.append(lm[..., :2] * _vec([1.0, -1.0], lms))
            rendering = self._raster(tv, self.faces, self.face_uvcoords).detach()
            grid = rendering[..., :2]
            alpha = grid_sample(uv_mask, grid) * rendering[..., 3:4].permute(0, 3, 1, 2)
            if self.do_fill_mouth:
                alpha, _ = fill_mouth(alpha)
            renders.append(grid_sample(textures, grid))
            alphas.append(alpha)
        # the side alpha: the reference ORs alpha_images[1] with itself
        # (next3d_triplane.py:242), reproduced as it is
        alpha_side = (alphas[1] > 0).float()
        return ([renders[0], renders[1] + renders[2], renders[3]],
                [alphas[0], alpha_side, alphas[3]], lm2ds)

    def _build_planes(self, ws, v, noise_mode, generator):
        """Texture raster, mouth crop → `mouth_backbone` → paste,
        `neural_blending`, then the blend with the static tri-plane."""
        n = self.topology.n_verts
        v, lms = v[:, :n], v[:, n:]
        n_tex = self.texture_backbone.synthesis.num_ws
        eg3d_ws, texture_ws = ws[:, :n_tex], ws[:, n_tex:]
        kw = dict(noise_mode=noise_mode, generator=generator)
        textures = self.texture_backbone.synthesis(texture_ws, **kw)
        renders, alphas, lm2ds = self.rasterize_views(v, lms, textures)

        front = renders[0]
        boxes = gen_mouth_mask(lm2ds[0])
        mouths = self.mouth_backbone.synthesis(crop_resize_boxes(front, boxes, out=64),
                                               eg3d_ws, **kw)
        stitched = paste_boxes(front, mouths, boxes)
        stitched = self.neural_blending.synthesis(stitched, eg3d_ws, **kw)

        static_plane = _to_planes(self.backbone.synthesis(eg3d_ws, **kw))
        plane_stack = torch.stack([stitched.float(), renders[1], renders[2]], dim=1)
        alpha_stack = torch.stack(alphas, dim=1)  # [B, 3, 1, H, W]
        blended = plane_stack * alpha_stack + static_plane.float() * (1 - alpha_stack)
        return blended, eg3d_ws
