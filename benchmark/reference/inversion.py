"""[benchmark reference] A frozen copy of the few-shot inversion path:
`InversionNet` (`invertavatar_torch/models/encoders/uvnet.py`: `encode`,
`get_unet_uvinput`, `ar_forward`) and the absorb of `invertavatar_torch/
cli/eval_seq.py` (`build_avatar`, `e4e_render_caches`, `absorb_chunk`,
`absorb_clip`, `drive_caches`): plain PyTorch, nothing of the program
imported.

Departures from the originals:
  * only the ConvGRU U-Nets of the few-shot stage (`unet_type="gru"`), both
    present; no one-shot path (`prefix`, `forward`) and no training rollouts;
  * `ar_forward` without `return_fake`, always given the avatar's feature
    lists (`e4e_results`) and the codes;
  * a chunk rendered without the e4e render caches takes them from
    `precompute_raster_static` / `precompute_texture_concat` of its own
    T-repeated lists, as the original's `rasterize` crops and concatenates
    them inside (the same operations);
  * no spans;
  * the check's hook (`absorb_clip`'s `delta_from` and `renders`): each
    chunk's render is also handed back, and Δimage may be taken from a
    given image of the chunk in place of that render.

The network holds the tri-plane `generator`, the e4e `encoder`, the U-Nets
`unet_encoder.{texture_unet, triplane_unet}` and the `latent_avg` /
`black_uv_bg` buffers under the program's names (the texture U-Net's offsets
as wide as the texture taps they add to, as `flagship.fewshot_inversion_net`
builds it), so one seeded fill gives both the same weights.
`unet_eval_dtype` is the U-Nets' compute dtype in `ar_forward`: their inputs
and carried GRU states take it, their convolution and PReLU weights are
stored in it, BatchNorm normalises in float32, and the offsets and SFT
return to float32."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from .grid_sample import grid_sample
from .irse import store_weights_in
from .e4e import Encoder4Editing
from .resize import resize_bilinear
from .triplane import TriPlaneGenerator
from .unet_encoders import TriPlanefeatEncoder, TriPlaneSFTfeatEncoder, adaptive_avg_pool


def offset_feats(tex: List[torch.Tensor], offsets: List[torch.Tensor]) -> List[torch.Tensor]:
    """The texture pyramid with the texture U-Net's offsets added to its
    first taps."""
    return [f + o for f, o in zip(tex, offsets)] + list(tex[len(offsets):])


def texture_out_channels_for(channel_base: int, channel_max: int) -> Tuple[int, int, int, int]:
    """Channels of the texture backbone's first four `return_list` taps
    [img (32), x@32, x@64, x@128]: the taps the texture U-Net offsets."""
    return (32, min(channel_base // 32, channel_max), min(channel_base // 64, channel_max),
            min(channel_base // 128, channel_max))


class UnetEncoderPair(nn.Module):
    """`texture_unet` and `triplane_unet`, the ConvGRU U-Nets."""

    def __init__(self, channel_base: int, channel_max: int, trunk_layers_n: int):
        super().__init__()
        self.texture_unet = TriPlanefeatEncoder(
            inp_ch=7, res=256, out_channels=texture_out_channels_for(channel_base, channel_max),
            trunk_layers_n=trunk_layers_n)
        self.triplane_unet = TriPlaneSFTfeatEncoder(inp_ch=6, res=256, channel_base=channel_base,
                                                    channel_max=channel_max,
                                                    trunk_layers_n=trunk_layers_n)


class InversionNet(nn.Module):
    def __init__(self, generator_cfg: Dict[str, Any], n_styles: int = 14,
                 unet_eval_dtype: Optional[torch.dtype] = None, trunk_layers_n: int = 50):
        super().__init__()
        self.generator = TriPlaneGenerator(**generator_cfg)
        self.encoder = Encoder4Editing(n_styles=n_styles, inp_ch=3, trunk_layers_n=trunk_layers_n)
        self.unet_eval_dtype = unet_eval_dtype
        self.unet_encoder = UnetEncoderPair(
            generator_cfg.get("channel_base", 32768),
            generator_cfg.get("channel_max", 512), trunk_layers_n)
        if unet_eval_dtype is not None:
            store_weights_in(self.unet_encoder, unet_eval_dtype)
        self.register_buffer("latent_avg", torch.zeros(1, 512))
        self.register_buffer("black_uv_bg", -torch.ones(1, 3, 256, 256))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """e4e W+ codes + latent_avg: x [B, 3, H, W] -> [B, n_styles, 512]."""
        if x.shape[2] > 256:
            x = adaptive_avg_pool(x, 256)
        elif x.shape[2] < 256:
            # only shrunken test generators render below 256²
            x = resize_bilinear(x, (256, 256))
        return self.encoder(x) + self.latent_avg[None]

    def get_unet_uvinput(self, uv: torch.Tensor, delta_x: torch.Tensor) -> torch.Tensor:
        """uv [B, 6, 256, 256] = (UV texture 3 ‖ UV vertex image 3: x, y,
        mask), delta_x [B, 3, H, W] -> [B, 7, 256, 256] = (UV texture, Δimage
        sampled into UV space with the black background outside the mask,
        mask)."""
        uv_gttex, uv_pverts = uv[:, :3], uv[:, 3:]
        uv_delta = grid_sample(delta_x, uv_pverts[:, :2].permute(0, 2, 3, 1))
        mask = uv_pverts[:, 2:3]
        uv_delta = uv_delta * mask + self.black_uv_bg * (1 - mask)
        return torch.cat([uv_gttex, uv_delta, mask], dim=1)

    def ar_forward(self, x: Dict[str, torch.Tensor], vid_c: torch.Tensor,
                   vid_v: Dict[str, torch.Tensor], ws: torch.Tensor, r_list: List,
                   e4e_results: Dict, e4e_render_caches=None,
                   delta_from: Optional[torch.Tensor] = None):
        """Absorb a chunk of T source frames into the avatar's features:
        x {"image": [T, 3, H, W], "uv": [T, 6, 256, 256]}; vid_c [T, 25];
        vid_v {"uvcoords_image": [T, 256, 256, 3]}; ws [1, n_styles, 512];
        r_list [texture states, triplane states] (None: fresh);
        `e4e_results` {"texture", "static"} the feature lists to refine;
        `delta_from` [T, 3, H', W'] the image Δimage is taken from (None:
        the chunk's own render). Returns (updated {"w", "texture",
        "static"}, new r_list, the chunk's render)."""
        G = self.generator
        T = vid_c.shape[0]
        tex, static = e4e_results["texture"], e4e_results["static"]
        vid_ws = ws.repeat_interleave(T, dim=0)

        def rep(feats):
            return [f.repeat_interleave(T, dim=0) for f in feats]

        if e4e_render_caches is None:
            e4e_render_caches = (G.precompute_raster_static(rep(static)),
                                 G.precompute_texture_concat(rep(tex)))
        y_hat = G.synthesis_withTexture(vid_ws, rep(tex), vid_c, vid_v, static_feats=rep(static),
                                        noise_mode="const", evaluation=True,
                                        raster_static_cache=e4e_render_caches[0],
                                        texture_concat_cache=e4e_render_caches[1])
        delta_x = y_hat["image"] if delta_from is None else delta_from
        if delta_x.shape[2] != x["image"].shape[2]:
            delta_x = resize_bilinear(delta_x, (256, 256), antialias=True)
        delta_x = delta_x - x["image"][:, :3]
        uv_input = self.get_unet_uvinput(x["uv"], delta_x)
        tri_input = torch.cat([x["image"][:, :3], delta_x], dim=1)

        dt = self.unet_eval_dtype
        r_list = list(r_list)
        if dt is not None:
            uv_input, tri_input = uv_input.to(dt), tri_input.to(dt)
            r_list = [None if r is None else [s.to(dt) for s in r] for r in r_list]
        tex_offsets, r_tex = self.unet_encoder.texture_unet(uv_input[None], r_list[0])
        sft, r_tri = self.unet_encoder.triplane_unet(tri_input[None], r_list[1])
        if dt is not None:
            tex_offsets = [o.float() for o in tex_offsets]
            sft = {k: (a.float(), b.float()) for k, (a, b) in sft.items()}
        texture_feats = offset_feats(tex, tex_offsets)
        static_feats = G.backbone.synthesis(ws, return_list=True, feat_conditions=sft,
                                            noise_mode="const")
        return {"w": ws, "texture": texture_feats, "static": static_feats}, [r_tex, r_tri], y_hat


# --------------------------------------------------------- cli/eval_seq.py


def build_avatar(net, first_image: torch.Tensor) -> Dict:
    """The e4e avatar of the first source frame [1, 3, H, W]."""
    ws = net.encode(first_image)
    G = net.generator
    return {"w": ws,
            "texture": G.texture_backbone.synthesis(ws, return_list=True, noise_mode="const"),
            "static": G.backbone.synthesis(ws, return_list=True, noise_mode="const")}


def e4e_render_caches(net, avatar: Dict, T: int):
    """The render caches of a chunk of T frames of `avatar`'s feature lists."""
    G = net.generator
    return (G.precompute_raster_static([f.repeat_interleave(T, dim=0) for f in avatar["static"]]),
            G.precompute_texture_concat([f.repeat_interleave(T, dim=0)
                                         for f in avatar["texture"]]))


def absorb_chunk(net, avatar: Dict, images, uvs, cs, uvcoords, r_list=None, render_caches=None,
                 delta_from=None):
    """Refine `avatar` with a chunk of T source frames; returns (the refined
    avatar, the states to carry, the chunk's render)."""
    return net.ar_forward({"image": images, "uv": uvs}, cs, {"uvcoords_image": uvcoords},
                          avatar["w"], r_list or [None, None], e4e_results=avatar,
                          e4e_render_caches=render_caches, delta_from=delta_from)


def absorb_clip(net, images, uvs, cs, uvcoords, T: int,
                delta_from: Optional[List[torch.Tensor]] = None,
                renders: Optional[List[Dict]] = None):
    """The avatar of a source clip: the e4e avatar of its first frame refined
    by its chunks of T frames (a shorter tail left out), the first chunk's
    render from the e4e render caches. `delta_from`, one image [T, 3, H, W]
    a chunk, gives the images Δimage is taken from in place of the chunks'
    own renders; each chunk's own render is appended to `renders`. Returns
    (avatar, the GRU states)."""
    avatar = build_avatar(net, images[0:1])
    caches = e4e_render_caches(net, avatar, T)
    r_list = None
    for k, start in enumerate(range(0, images.shape[0] - T + 1, T)):
        s = slice(start, start + T)
        avatar, r_list, y_hat = absorb_chunk(
            net, avatar, images[s], uvs[s], cs[s], uvcoords[s], r_list,
            render_caches=caches if start == 0 else None,
            delta_from=None if delta_from is None else delta_from[k])
        if renders is not None:
            renders.append(y_hat)
    return avatar, r_list


def drive_caches(net, avatar: Dict):
    """The frame-independent half of every drive frame of the absorbed avatar."""
    G = net.generator
    return (G.precompute_raster_static(avatar["static"]),
            G.precompute_texture_concat(avatar["texture"]))
