"""Inversion network, plain PyTorch (NCHW).

Counterpart of `invertavatar_tpu/models/encoders/uvnet.py`: `InversionNet`
holds the frozen tri-plane `generator`, the e4e `encoder`, the ConvGRU U-Nets
`unet_encoder.{texture_unet, triplane_unet}` of the few-shot stage and the
`latent_avg` / `black_uv_bg` buffers, with the torch reference's names.
The U-Nets are the ConvGRU ones of the few-shot stage (`unet_type="gru"`) or
the SegFormer decoders of the improved one-shot network
(`unet_type="segformer"`). `encode` gives the W+ codes; `prefix` and the
single-frame `forward` invert one frame (the one-shot path of
`cli/eval_os.py`); `ar_forward` absorbs a chunk of source frames into the
avatar's features, carrying the GRU states across chunks (the streaming
few-shot path of `cli/eval_seq.py`). The few-shot training rollouts are
`run_seq` (every frame at once) and `run_seq_multiT` (chunks whose GRU states
carry forward without gradient), built from the blocks `backbone_feats`,
`multiT_chunk_inputs`, `multiT_chunk_state`, `multiT_offsets` and
`multiT_final`; the few-shot training step (`train/loop_inversion.py`) runs
the blocks itself.

Unlike the JAX package, whose modules make no variables until they run, the
port builds the U-Nets only when `encoding_texture` / `encoding_triplane` ask
for them (the e4e stage holds none). The one-shot training step drives
`prefix` and `forward` with its render overrides. The U-Nets train in
float32: `unet_eval_dtype` is read by `ar_forward` alone.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from ...ops.grid_sample import grid_sample
from ...ops.resize import resize_bilinear
from ..triplane import TriPlaneGenerator
from .e4e import Encoder4Editing
from .irse import store_weights_in
from .unet_encoders import TriPlanefeatEncoder, TriPlaneSFTfeatEncoder, adaptive_avg_pool

__all__ = ["InversionNet", "UnetEncoderPair", "adaptive_avg_pool", "offset_feats",
           "texture_out_channels_for"]


def _flat(x: torch.Tensor) -> torch.Tensor:
    """[B, T, ...] -> [B·T, ...], b-major."""
    return x.reshape(-1, *x.shape[2:])


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
    """The reference's `unet_encoder` container: `texture_unet` and
    `triplane_unet`, each present when asked for; ConvGRU U-Nets (`"gru"`,
    `trunk_layers_n` deep) or SegFormer decoders (`"segformer"`, always the
    IR-SE-50 trunk, as in the JAX package)."""

    def __init__(self, encoding_texture: bool = True, encoding_triplane: bool = True,
                 unet_type: str = "gru",
                 texture_out_channels: Tuple[int, int, int, int] = (32, 512, 512, 256),
                 channel_base: int = 32768, channel_max: int = 512, trunk_layers_n: int = 50):
        super().__init__()
        if unet_type == "segformer":
            from .transformer import TriPlanefeatSegformerDecoder, TriPlaneSFTfeatSegformerDecoder

            self.texture_unet = (TriPlanefeatSegformerDecoder(
                inp_ch=7, res=256, out_channels=texture_out_channels)
                if encoding_texture else None)
            self.triplane_unet = (TriPlaneSFTfeatSegformerDecoder(
                inp_ch=6, res=256, channel_base=channel_base, channel_max=channel_max)
                if encoding_triplane else None)
            return
        if unet_type != "gru":
            raise ValueError(f"unet_type={unet_type!r}: expected 'gru' or 'segformer'")
        self.texture_unet = (TriPlanefeatEncoder(inp_ch=7, res=256, use_gru=True,
                                                 out_channels=texture_out_channels,
                                                 trunk_layers_n=trunk_layers_n)
                             if encoding_texture else None)
        self.triplane_unet = (TriPlaneSFTfeatEncoder(inp_ch=6, res=256, use_gru=True,
                                                     channel_base=channel_base,
                                                     channel_max=channel_max,
                                                     trunk_layers_n=trunk_layers_n)
                              if encoding_triplane else None)


class InversionNet(nn.Module):
    def __init__(self, generator_cfg: Dict[str, Any], n_styles: int = 14,
                 encoding_texture: bool = False, encoding_triplane: bool = False,
                 unet_type: str = "gru",
                 texture_out_channels: Tuple[int, int, int, int] = (32, 512, 512, 256),
                 unet_eval_dtype: Optional[torch.dtype] = None, trunk_layers_n: int = 50):
        """`unet_eval_dtype` (e.g. `torch.bfloat16`) is the U-Nets' compute
        dtype in `ar_forward`: their inputs and carried GRU states take it,
        their convolution and PReLU weights are stored in it, BatchNorm
        normalises in float32, and the offsets and SFT return to float32.
        None keeps float32. `trunk_layers_n=8` builds the tiny test trunks."""
        super().__init__()
        self.generator = TriPlaneGenerator(**generator_cfg)
        self.unet_type = unet_type
        self.encoder = Encoder4Editing(n_styles=n_styles, inp_ch=3, trunk_layers_n=trunk_layers_n)
        self.unet_eval_dtype = unet_eval_dtype
        if encoding_texture or encoding_triplane:
            self.unet_encoder = UnetEncoderPair(
                encoding_texture, encoding_triplane, unet_type=unet_type,
                texture_out_channels=texture_out_channels,
                channel_base=generator_cfg.get("channel_base", 32768),
                channel_max=generator_cfg.get("channel_max", 512), trunk_layers_n=trunk_layers_n)
            if unet_eval_dtype is not None:
                # rounded once, as a cast per op would round them on every call
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
        """The texture U-Net's UV-space input: uv [B, 6, 256, 256] = (UV
        texture 3 ‖ UV vertex image 3: x, y, mask), delta_x [B, 3, H, W] ->
        [B, 7, 256, 256] = (UV texture, Δimage sampled into UV space with the
        black background outside the mask, mask)."""
        uv_gttex, uv_pverts = uv[:, :3], uv[:, 3:]
        uv_delta = grid_sample(delta_x, uv_pverts[:, :2].permute(0, 2, 3, 1))
        mask = uv_pverts[:, 2:3]
        uv_delta = uv_delta * mask + self.black_uv_bg * (1 - mask)
        return torch.cat([uv_gttex, uv_delta, mask], dim=1)

    @torch.no_grad()
    def prefix(self, x: Dict[str, torch.Tensor], cam: torch.Tensor, v: Dict[str, torch.Tensor],
               evaluation: bool = False, nograd_render: Optional[Dict] = None,
               generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """The gradient-free prefix of `forward`: the e4e W+ codes, the
        texture pyramid, and the e4e render aligned to the input frames.

        x {"image": [B, 3, H, W]}; cam [B, 25]; v {"uvcoords_image"}.
        `nograd_render` (a `train/fast_render` override dict)
        makes the render an evaluation render with those overrides;
        `generator` feeds the renderer's stochastic strata.
        Returns {"w", "texture", "e4e_image"}."""
        G = self.generator
        ws = self.encode(x["image"][:, :3])
        tex = G.texture_backbone.synthesis(ws, return_list=True, noise_mode="const")
        static = G.backbone.synthesis(ws, return_list=True, noise_mode="const")
        e4e_image = G.synthesis_withTexture(
            ws, tex, cam, v, static_feats=static, noise_mode="const",
            evaluation=evaluation or nograd_render is not None,
            rendering_overrides=nograd_render, generator=generator)["image"]
        if e4e_image.shape[2] != x["image"].shape[2]:
            # shrunken test generators render at another size than the frames
            e4e_image = resize_bilinear(e4e_image, tuple(x["image"].shape[2:]), antialias=True)
        return {"w": ws, "texture": tex, "e4e_image": e4e_image}

    def forward(self, x: Dict[str, torch.Tensor], cam: torch.Tensor, v: Dict[str, torch.Tensor],
                return_feats: bool = False, evaluation: bool = False,
                nograd_render: Optional[Dict] = None, grad_render: Optional[Dict] = None,
                generator: Optional[torch.Generator] = None):
        """Invert one frame per item: x {"image": [B, 3, H, W], "uv": [B, 6,
        256, 256]}, cam [B, 25], v {"uvcoords_image": [B, 256, 256, 3]}.

        The prefix (`prefix`, given `nograd_render`) carries no gradient;
        the U-Nets refine the texture pyramid and condition the static
        backbone, and the refined avatar is rendered with the overrides
        `grad_render` (the training step's student render). Returns the
        render's dict with "w" and "e4e_image", and with `return_feats` the
        refined "texture" and "static" feature lists."""
        G = self.generator
        pre = self.prefix(x, cam, v, evaluation=evaluation, nograd_render=nograd_render,
                          generator=generator)
        ws, tex, e4e_image = pre["w"], pre["texture"], pre["e4e_image"]
        delta_x = e4e_image - x["image"][:, :3]
        uv_input = self.get_unet_uvinput(x["uv"], delta_x)
        tri_input = torch.cat([x["image"][:, :3], delta_x], dim=1)
        if self.unet_type == "gru":
            tex_offsets, _ = self.unet_encoder.texture_unet(uv_input[:, None])
            sft, _ = self.unet_encoder.triplane_unet(tri_input[:, None])
        else:
            tex_offsets = self.unet_encoder.texture_unet(uv_input)
            sft = self.unet_encoder.triplane_unet(tri_input)
        texture_feats = offset_feats(tex, tex_offsets)
        static_feats = G.backbone.synthesis(ws, return_list=True, feat_conditions=sft,
                                            noise_mode="const")
        out = G.synthesis_withTexture(ws, texture_feats, cam, v, static_feats=static_feats,
                                      noise_mode="const", evaluation=evaluation,
                                      rendering_overrides=grad_render, generator=generator)
        if return_feats:
            out["texture"] = texture_feats
            out["static"] = static_feats
        out["w"] = ws
        out["e4e_image"] = e4e_image
        return out

    # ------------------------------------------------------------ train rollouts
    #
    # The reference's multi-T rollout runs its whole chunk loop without
    # gradient, the last chunk's e4e render and U-Net inputs included; only
    # the last U-Net calls, the backbone pass with the SFT conditions and the
    # render carry gradients. The blocks below are those pieces; frames are
    # [B, T, 3(+mask), H, W], cameras [B, T, 25], uvcoords [B, T, 256, 256,
    # 3] and UV inputs [B, T, 6, 256, 256]. The rollouts take the ConvGRU
    # U-Nets (`unet_type="gru"`).

    def backbone_feats(self, ws: torch.Tensor):
        """The frozen generator's (texture, static) feature lists of `ws`."""
        G = self.generator
        return (G.texture_backbone.synthesis(ws, return_list=True, noise_mode="const"),
                G.backbone.synthesis(ws, return_list=True, noise_mode="const"))

    def render_clip(self, ws, tex, static, c, v, **kw) -> Dict[str, torch.Tensor]:
        """Render every frame of a clip: the item's codes and feature lists
        repeated over its T frames (b-major); c [B, T, 25], v
        {"uvcoords_image": [B, T, ...]}; `kw` goes to
        `synthesis_withTexture`. Returns its dict with [B·T, ...] leaves."""
        T = c.shape[1]

        def rep(x):
            return x.repeat_interleave(T, dim=0)

        return self.generator.synthesis_withTexture(
            rep(ws), [rep(f) for f in tex], _flat(c),
            {"uvcoords_image": _flat(v["uvcoords_image"])}, static_feats=[rep(f) for f in static],
            noise_mode="const", **kw)

    def _clip_inputs(self, frames, uv, e4e_img):
        """The U-Nets' inputs from a clip's frames [B, T, 3(+m), H, W], UV
        inputs and flat e4e render: ([B, T, 7, 256, 256], [B, T, 6, H, W],
        the e4e render at the frames' size)."""
        B, T = frames.shape[:2]
        frames_flat = _flat(frames)
        if e4e_img.shape[2] != frames_flat.shape[2]:
            e4e_img = resize_bilinear(e4e_img, tuple(frames_flat.shape[2:]), antialias=True)
        delta = e4e_img - frames_flat[:, :3]
        uv_input = self.get_unet_uvinput(_flat(uv), delta).reshape(B, T, 7, 256, 256)
        tri_input = torch.cat([frames_flat[:, :3], delta], dim=1).reshape(
            B, T, 6, *frames_flat.shape[2:])
        return uv_input, tri_input, e4e_img

    def _unets(self, uv_input, tri_input, r_tex=None, r_tri=None):
        tex_offsets, r_tex = self.unet_encoder.texture_unet(uv_input, r_tex)
        sft, r_tri = self.unet_encoder.triplane_unet(tri_input, r_tri)
        return tex_offsets, sft, r_tex, r_tri

    @torch.no_grad()
    def multiT_chunk_inputs(self, frames, c, v, uv, ws, tex, static,
                            nograd_render: Optional[Dict] = None,
                            generator: Optional[torch.Generator] = None):
        """One chunk's U-Net inputs, without gradient: the e4e render of the
        chunk's Tc frames, Δx, then (uv_input [B, Tc, 7, 256, 256], tri_input
        [B, Tc, 6, H, W], the e4e render [B·Tc, 3, H, W]). `nograd_render`
        (a `train/fast_render` override dict) makes the render an evaluation
        render with those overrides."""
        e4e = self.render_clip(ws, tex, static, c, v, evaluation=nograd_render is not None,
                               rendering_overrides=nograd_render, generator=generator)["image"]
        return self._clip_inputs(frames, uv, e4e)

    @torch.no_grad()
    def multiT_chunk_state(self, uv_input, tri_input, r_tex=None, r_tri=None):
        """Roll both U-Nets' GRU states over one chunk, without gradient:
        (texture states, triplane states)."""
        return self._unets(uv_input, tri_input, r_tex, r_tri)[2:]

    def multiT_offsets(self, uv_input, tri_input, r_tex, r_tri, ws):
        """The gradient-carrying suffix up to the render: both U-Nets from
        the carried states, then the static backbone under their SFT
        conditions. Returns (texture offsets, static feature list)."""
        tex_offsets, sft, _, _ = self._unets(uv_input, tri_input, r_tex, r_tri)
        static_feats = self.generator.backbone.synthesis(ws, return_list=True,
                                                         feat_conditions=sft, noise_mode="const")
        return tex_offsets, static_feats

    def multiT_final(self, uv_input, tri_input, r_tex, r_tri, ws, tex, c_sel, v_sel,
                     grad_render: Optional[Dict] = None,
                     generator: Optional[torch.Generator] = None):
        """`multiT_offsets`, then one render of the selected frames (c_sel
        [B, T_out, 25], v_sel likewise) with the overrides `grad_render`.
        Returns the render's dict ([B·T_out, ...] leaves)."""
        tex_offsets, static_feats = self.multiT_offsets(uv_input, tri_input, r_tex, r_tri, ws)
        return self.render_clip(ws, offset_feats(tex, tex_offsets), static_feats, c_sel, v_sel,
                                rendering_overrides=grad_render, generator=generator)

    def run_seq_multiT(self, vid_frames, vid_c, vid_v, vid_uv, frm_per_chunk: int = 6,
                       ws: Optional[torch.Tensor] = None, return_idx=None,
                       generator: Optional[torch.Generator] = None):
        """Chunked multi-T rollout: T = n·frm_per_chunk frames; chunks
        0..n-2 roll the GRU states forward without gradient, the last chunk's
        U-Net calls and the render carry gradients. `return_idx` (frame
        indices shared by the batch) renders only those frames; None renders
        all T. Returns {"image" [B, T_out, 3, H', W'], "e4e_image" (the last
        chunk's), "feature_image", "triplane"}."""
        B, T = vid_c.shape[:2]
        assert T % frm_per_chunk == 0, (T, frm_per_chunk)
        n, Tc = T // frm_per_chunk, frm_per_chunk
        uvi = vid_v["uvcoords_image"]
        with torch.no_grad():
            if ws is None:
                ws = self.encode(vid_frames[:, 0, :3])
            tex, static = self.backbone_feats(ws)
        r_tex = r_tri = None
        for i in range(n):
            sl = slice(i * Tc, (i + 1) * Tc)
            uv_input, tri_input, e4e_last = self.multiT_chunk_inputs(
                vid_frames[:, sl], vid_c[:, sl], {"uvcoords_image": uvi[:, sl]}, vid_uv[:, sl],
                ws, tex, static, generator=generator)
            if i < n - 1:
                r_tex, r_tri = self.multiT_chunk_state(uv_input, tri_input, r_tex, r_tri)
        if return_idx is None:
            c_sel, v_sel = vid_c, {"uvcoords_image": uvi}
        else:
            idx = torch.as_tensor(return_idx, device=vid_c.device)
            c_sel, v_sel = vid_c[:, idx], {"uvcoords_image": uvi[:, idx]}
        out = self.multiT_final(uv_input, tri_input, r_tex, r_tri, ws, tex, c_sel, v_sel,
                                generator=generator)
        return {"image": out["image"].reshape(B, c_sel.shape[1], *out["image"].shape[1:]),
                "e4e_image": e4e_last, "feature_image": out["feature_image"],
                "triplane": out["triplane"]}

    def run_seq(self, vid_frames, vid_c, vid_v, vid_uv, ws: Optional[torch.Tensor] = None,
                only_image: bool = False, generator: Optional[torch.Generator] = None):
        """The literal recurrent rollout: the e4e render of all T frames
        without gradient, both U-Nets over the whole clip, one render of
        every frame with the refined features (gradient-carrying). Returns
        the render's dict ([B·T, ...] leaves) with "e4e_image", or with
        `only_image` just {"image", "e4e_image"}."""
        with torch.no_grad():
            if ws is None:
                ws = self.encode(vid_frames[:, 0, :3])
            tex, static = self.backbone_feats(ws)
            e4e = self.render_clip(ws, tex, static, vid_c, vid_v, generator=generator)["image"]
            uv_input, tri_input, e4e = self._clip_inputs(vid_frames, vid_uv, e4e)
        tex_offsets, static_feats = self.multiT_offsets(uv_input, tri_input, None, None, ws)
        out = self.render_clip(ws, offset_feats(tex, tex_offsets), static_feats, vid_c, vid_v,
                               generator=generator)
        if only_image:
            return {"image": out["image"], "e4e_image": e4e}
        out["e4e_image"] = e4e
        return out

    def ar_forward(self, x: Dict[str, torch.Tensor], vid_c: torch.Tensor,
                   vid_v: Dict[str, torch.Tensor], ws: Optional[torch.Tensor], r_list: List,
                   e4e_results: Optional[Dict] = None, return_fake: bool = False,
                   e4e_render_caches=None):
        """Absorb a chunk of T source frames into the avatar's features.

        x: {"image": [T, 3, 256, 256], "uv": [T, 6, 256, 256]}; vid_c [T, 25];
        vid_v {"uvcoords_image": [T, 256, 256, 3]}; `ws` [1, n_styles, 512]
        (None: encode the chunk's first image); r_list [texture states,
        triplane states] (None for a fresh chunk); `e4e_results` {"texture",
        "static"} the feature lists to refine (None: the e4e lists of `ws`).
        `e4e_render_caches` (raster_static_cache, texture_concat_cache) built
        from the same T-repeated lists speed up this chunk's render; they hold
        only while those lists are unchanged (the first chunk).

        Returns (updated {"w", "texture", "static"}, new r_list), or with
        `return_fake` (updated, {"e4e", "image", "x_input"}, new r_list)."""
        G = self.generator
        T = vid_c.shape[0]
        if ws is None:
            ws = self.encode(x["image"][0:1])
        if e4e_results is None:
            tex = G.texture_backbone.synthesis(ws, return_list=True, noise_mode="const")
            static = G.backbone.synthesis(ws, return_list=True, noise_mode="const")
        else:
            tex, static = e4e_results["texture"], e4e_results["static"]
        vid_ws = ws.repeat_interleave(T, dim=0)

        def rep(feats):
            return [f.repeat_interleave(T, dim=0) for f in feats]

        cache_kw = {}
        if e4e_render_caches is not None:
            cache_kw = {"raster_static_cache": e4e_render_caches[0],
                        "texture_concat_cache": e4e_render_caches[1]}
        y_hat = G.synthesis_withTexture(vid_ws, rep(tex), vid_c, vid_v, static_feats=rep(static),
                                        noise_mode="const", evaluation=True, **cache_kw)
        delta_x = y_hat["image"]
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
            # offsets and SFT re-enter the float32 feature path; the GRU
            # states stay in dt (they only feed the next chunk's cells)
            tex_offsets = [o.float() for o in tex_offsets]
            sft = {k: (a.float(), b.float()) for k, (a, b) in sft.items()}
        texture_feats = offset_feats(tex, tex_offsets)
        static_feats = G.backbone.synthesis(ws, return_list=True, feat_conditions=sft,
                                            noise_mode="const")
        updated = {"w": ws, "texture": texture_feats, "static": static_feats}
        if not return_fake:
            return updated, [r_tex, r_tri]
        fakes = G.synthesis_withTexture(vid_ws, rep(texture_feats), vid_c, vid_v,
                                        static_feats=rep(static_feats), noise_mode="const",
                                        evaluation=True)["image"]
        return updated, {"e4e": y_hat["image"], "image": fakes, "x_input": uv_input}, [r_tex, r_tri]
