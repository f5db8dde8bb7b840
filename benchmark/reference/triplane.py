"""[benchmark reference] A frozen copy of `invertavatar_torch/models/triplane.py`: plain
PyTorch, every kernel route replaced by its plain version, nothing of the
program imported. The text below is the original module's.

Next3D++ tri-plane avatar generator, plain PyTorch (NCHW).

Counterpart of `invertavatar_tpu/models/triplane.py`:

  * three StyleGAN2 backbones sharing one mapping: `texture_backbone` (256²,
    32ch neural texture), `face_backbone` (256², 32ch refinement conditioned
    on the warped texture pyramid), `backbone` (256², 96ch → 3×32 planes)
  * `rasterize` warps the texture pyramid into image space through the
    FaceVerse `uvcoords_image` and alpha-blends with center-cropped static
    features (bbox [57,185,64,192] in 256-space)
  * blended frontal plane → two-pass importance volume rendering at the
    neural resolution → super-resolution

Planes are `[B, 3, C, H, W]`. `uvcoords_image` is `[B, H, W, 3]` (u, v, alpha)
as the driving code produces it.

Only the evaluation path that the benchmark's cells drive is kept: the
mapping, both backbones' feature lists, the raster and texture caches,
and `synthesis_withTexture`.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .grid_sample import grid_sample
from .resize import resize_bilinear
from .mouth import fill_mouth
from .ray_sampler import sample_rays
from .renderer import ImportanceRenderer
from . import superresolution as sr_mod
from .layers import FullyConnectedLayer
from .synthesis import Generator

BBOX_256 = (57, 185, 64, 192)  # face crop of the frontal plane


class OSGDecoder(nn.Module):
    """Tri-plane feature decoder; `net.0` / `net.2` are the two FCs."""

    def __init__(self, n_features: int = 32, hidden_dim: int = 64, decoder_lr_mul: float = 1.0,
                 decoder_output_dim: int = 32):
        super().__init__()
        self.net = nn.Sequential(
            FullyConnectedLayer(n_features, hidden_dim, lr_multiplier=decoder_lr_mul),
            nn.Softplus(),
            FullyConnectedLayer(hidden_dim, 1 + decoder_output_dim, lr_multiplier=decoder_lr_mul),
        )

    def return_params(self):
        """Effective `(w1 [C,HID], b1, w2 [HID,1+out], b2)` for the fused kernels."""
        w1, b1 = self.net[0].effective_params()
        w2, b2 = self.net[2].effective_params()
        return w1, b1, w2, b2

    def forward(self, sampled_features: torch.Tensor) -> Dict[str, torch.Tensor]:
        # [B, 3, M, C] -> mean over planes -> MLP
        x = sampled_features.float().mean(dim=1)
        B, M, C = x.shape
        x = self.net(x.reshape(B * M, C)).reshape(B, M, -1)
        rgb = torch.sigmoid(x[..., 1:]) * (1 + 2 * 0.001) - 0.001  # MipNeRF sigmoid clamp
        return {"rgb": rgb, "sigma": x[..., 0:1]}


def _to_planes(x: torch.Tensor) -> torch.Tensor:
    """[B, 3*C, H, W] -> [B, 3, C, H, W] (channel-major grouping)."""
    B, C3, H, W = x.shape
    return x.reshape(B, 3, C3 // 3, H, W)


def _bbox(res: int, bbox_256) -> List[int]:
    return [round(i * res / 256) for i in bbox_256]


class TriPlaneGenerator(nn.Module):
    def __init__(self, z_dim: int, c_dim: int, w_dim: int, img_resolution: int,
                 img_channels: int, sr_num_fp16_res: int = 0, rendering_kwargs: Any = None,
                 neural_rendering_resolution: int = 128, channel_base: int = 32768,
                 channel_max: int = 512, num_fp16_res: int = 0,
                 conv_clamp: Optional[float] = 256.0, map_num_layers: int = 2):
        super().__init__()
        self.c_dim = c_dim
        self.img_resolution = img_resolution
        self.rendering_kwargs = dict(rendering_kwargs or {})
        self.neural_rendering_resolution = neural_rendering_resolution
        rk = self.rendering_kwargs
        common = dict(z_dim=z_dim, c_dim=c_dim, w_dim=w_dim, img_resolution=256,
                      channel_base=channel_base, channel_max=channel_max,
                      num_fp16_res=num_fp16_res, conv_clamp=conv_clamp,
                      map_num_layers=map_num_layers)
        self.texture_backbone = Generator(img_channels=32, **common)
        self.face_backbone = Generator(img_channels=32, **common)
        self.backbone = Generator(img_channels=32 * 3,
                                  mapping_ws=self.texture_backbone.synthesis.num_ws, **common)
        sr_name = rk.get("superresolution_module",
                         "training_avatar_texture.superresolution.SuperresolutionHybrid8XDC")
        self.superresolution = getattr(sr_mod, sr_name.rsplit(".", 1)[-1])(
            channels=32, img_resolution=img_resolution, sr_num_fp16_res=sr_num_fp16_res,
            sr_antialias=rk.get("sr_antialias", True))
        self.decoder = OSGDecoder(32, decoder_lr_mul=rk.get("decoder_lr_mul", 1.0),
                                  decoder_output_dim=32)
        self.renderer = ImportanceRenderer()

    # ------------------------------------------------------------------ mapping
    def mapping(self, z, c, truncation_psi=1.0, truncation_cutoff=None):
        """Zero/scale the pose conditioning label, then the backbone's mapping."""
        rk = self.rendering_kwargs
        if rk.get("c_gen_conditioning_zero", True):
            c = torch.zeros_like(c)
        c = c[:, : self.c_dim]
        return self.backbone.mapping(z, c * rk.get("c_scale", 0.0), truncation_psi=truncation_psi,
                                     truncation_cutoff=truncation_cutoff)

    # ---------------------------------------------------------------- rasterize
    def precompute_raster_static(self, static_feats: List[torch.Tensor], bbox_256=BBOX_256):
        """Frame-independent half of `rasterize`: the per-level bbox crop and
        antialiased resize of the static features (raw backbone list in)."""
        out = []
        for static in self._static_feats_for_raster(static_feats):
            res = static.shape[-1]
            b = _bbox(res, bbox_256)
            crop = static[:, :, b[0]:b[1], b[2]:b[3]]
            out.append(resize_bilinear(crop.float(), (res, res), antialias=True))
        return out

    def _texture_group_sources(self, texture_feats: List[torch.Tensor], grid_res: int):
        """{(resolution, grid_res): channel-concat of that resolution's levels}.

        The JAX package's `fast_uv_warp` (a downsampled-grid warp and bf16
        sources) is TPU-only there and ignored off the TPU; the port ignores
        it too and always runs the exact warp."""
        by_res: dict = {}
        for idx, texture in enumerate(texture_feats):
            by_res.setdefault(texture.shape[-1], []).append(idx)
        sources = {}
        for res, idxs in by_res.items():
            group = [texture_feats[i] for i in idxs]
            common = functools.reduce(torch.promote_types, [g.dtype for g in group])
            sources[(res, grid_res)] = (group[0] if len(group) == 1
                                        else torch.cat([g.to(common) for g in group], dim=1))
        return sources

    def precompute_texture_concat(self, texture_feats: List[torch.Tensor], grid_res: int = 256):
        """Frame-independent half of the UV warp (per-resolution concat sources)."""
        return self._texture_group_sources(texture_feats, grid_res)

    def rasterize(self, texture_feats: List[torch.Tensor], uvcoords_image: torch.Tensor,
                  static_small: List[torch.Tensor], texture_concat_cache: dict):
        """UV-warp the texture pyramid and blend with the cropped static
        feats (`precompute_raster_static`, `precompute_texture_concat`)."""
        uvc = uvcoords_image.float()
        grid = uvc[..., :2]  # [B, H, W, 2]
        grid_res = grid.shape[1]
        alpha = uvc[..., 2:3].permute(0, 3, 1, 2)  # [B, 1, H, W]
        full_alpha, mouth_masks = fill_mouth(alpha)
        upper = mouth_masks.clone()
        upper[:, :, :87] = 0.0  # upper-mouth mask: zero rows above 87 (256-space)
        upper_alpha = (alpha + upper).clamp(0.0, 1.0)

        # one warp per resolution over the channel-concat of its levels
        # (bilinear lookup is channel-independent, so this is exact)
        by_res: dict = {}
        for idx, texture in enumerate(texture_feats):
            by_res.setdefault(texture.shape[-1], []).append(idx)

        warped_by_idx, alpha_by_res, upper_by_res = {}, {}, {}
        for res, idxs in by_res.items():
            warped = grid_sample(texture_concat_cache[(res, grid_res)], grid)  # [B, ΣC, H, W]
            same = res == grid_res
            if not same:
                warped = resize_bilinear(warped, (res, res), antialias=True)
            off = 0
            for i in idxs:
                c = texture_feats[i].shape[1]
                warped_by_idx[i] = warped[:, off:off + c]
                off += c
            alpha_by_res[res] = alpha if same else resize_bilinear(alpha, (res, res))
            upper_by_res[res] = upper_alpha if same else resize_bilinear(upper_alpha, (res, res))

        rendering_images = []
        for idx, texture in enumerate(texture_feats):
            res = texture.shape[-1]
            alpha_ = alpha_by_res[res]
            rendering_images.append(torch.cat(
                [warped_by_idx[idx] * alpha_ + static_small[idx] * (1 - alpha_),
                 upper_by_res[res]], dim=1))
        return rendering_images, full_alpha, mouth_masks

    # ----------------------------------------------------------- plane blending
    def _blend_planes(self, rendering_stitch, full_alpha, static_plane, bbox_256=BBOX_256):
        """Paste the face-box-resized render/alpha into the frontal plane and
        alpha-blend against the static tri-plane; planes 1 and 2 stay static."""
        y0, y1, x0, x1 = bbox_256
        stitch_small = resize_bilinear(rendering_stitch.float(), (y1 - y0, x1 - x0))
        alpha_small = resize_bilinear(full_alpha, (y1 - y0, x1 - x0))
        stitch_full = F.pad(stitch_small, (x0, static_plane.shape[-1] - x1,
                                           y0, static_plane.shape[-2] - y1))
        alpha_full = F.pad(alpha_small, (x0, static_plane.shape[-1] - x1,
                                         y0, static_plane.shape[-2] - y1))
        planes = static_plane.float()
        plane0 = stitch_full * alpha_full + planes[:, 0] * (1 - alpha_full)
        return torch.cat([plane0[:, None], planes[:, 1:]], dim=1)

    def _static_feats_for_raster(self, static_feats):
        """Plane 0 of the 96-ch taps at both ends of the feature list."""
        out = list(static_feats)
        out[0] = _to_planes(out[0])[:, 0]
        out[-1] = _to_planes(out[-1])[:, 0]
        return out

    def _render_core(self, ws, c, rendering_stitch, full_alpha, static_plane, evaluation):
        rk = dict(self.rendering_kwargs)
        # the shipped renderer ignores the config's numeric ray_start/ray_end
        # and uses the ‖ray_o‖-based bounds
        rk.pop("ray_start", None)
        rk.pop("ray_end", None)
        cam = c[:, -25:].float()
        cam2world = cam[:, :16].reshape(-1, 4, 4)
        intrinsics = cam[:, 16:25].reshape(-1, 3, 3)
        res = self.neural_rendering_resolution
        ray_o, ray_d = sample_rays(cam2world, intrinsics, res)

        blended_planes = self._blend_planes(rendering_stitch, full_alpha, static_plane)
        feature_samples, depth_samples = self.renderer(
            blended_planes, self.decoder, ray_o, ray_d, rk, evaluation=evaluation,
            decoder_params=self.decoder.return_params())[:2]
        B = ws.shape[0]
        feature_image = feature_samples.permute(0, 2, 1).reshape(B, -1, res, res)
        depth_image = depth_samples.permute(0, 2, 1).reshape(B, 1, res, res)
        rgb_image = feature_image[:, :3]
        sr_image = self.superresolution(
            rgb_image, feature_image, ws, noise_mode=rk.get("superresolution_noise_mode", "none"))
        return {"image": sr_image, "image_raw": rgb_image, "image_depth": depth_image}

    # ---------------------------------------------------------------- synthesis
    def synthesis_withTexture(self, ws, texture_feats: List[torch.Tensor], c,
                              mesh_condition: Dict[str, torch.Tensor],
                              static_feats: List[torch.Tensor], evaluation: bool = False,
                              noise_mode: str = "random",
                              raster_static_cache: Optional[List[torch.Tensor]] = None,
                              texture_concat_cache: Optional[dict] = None):
        """The animation entry point: precomputed texture/static features.

        `raster_static_cache` (`precompute_raster_static`) and
        `texture_concat_cache` (`precompute_texture_concat`) hoist the
        frame-independent parts of `rasterize` out of the frame loop."""
        rendering_images, full_alpha, _ = self.rasterize(
            texture_feats, mesh_condition["uvcoords_image"], raster_static_cache,
            texture_concat_cache)
        rendering_stitch = self.face_backbone.synthesis(ws, cond_list=rendering_images,
                                                        noise_mode=noise_mode)
        return self._render_core(ws, c, rendering_stitch, full_alpha,
                                 _to_planes(static_feats[-1]), evaluation)
