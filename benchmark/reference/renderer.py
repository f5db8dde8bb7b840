"""[benchmark reference] A frozen copy of `invertavatar_torch/render/renderer.py`: plain
PyTorch, every kernel route replaced by its plain version, nothing of the
program imported. The text below is the original module's.

Two-pass importance volume renderer over tri-planes, plain PyTorch.

Counterpart of `invertavatar_tpu/render/renderer.py`: dynamic near/far from
the camera distance (‖ray_o‖ ± (0.45, 0.6)), stratified + importance samples,
MipNeRF ray marching, deterministic importance sampling in evaluation mode.

Routing follows the `rendering_kwargs` keys as the JAX renderer does
(`invertavatar_tpu/render/renderer.py`), with one difference: the JAX gate "on
a TPU or in Pallas interpret mode" is "always" here. Each kernel route runs
whenever the kwargs ask for it; the kernel wrappers (`ops/fused_render.py`,
`ops/plane_sample.py`) choose between the CUDA kernel and its plain version by
the tensors' device, and nothing else in this module looks at the device.

The structured (ray-tile × stratum) passes route as in JAX:
  * `pallas_coarse` in evaluation: the fused kernels B1/B2, or B3 alone
    (float32 payload with `pallas_exact`, else bfloat16) when `pallas_exact`
    is set or `fused_render` is off;
  * `windowed_coarse` alone (the JAX XLA formulation): an exact bilinear
    sample, `F.grid_sample`.

Planes are `[B, 3, C, H, W]` (the torch reference layout); the kernels take
them channels-last, `[3B, H, W, C]`, copied once per render.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .fused_render import fused_merged_march_reference as fused_merged_march
from .fused_render import fused_render_reference as fused_render
from .fused_render import tile_shape
from .grid_sample import grid_sample
from .mesh import batch_rand
from .plane_sample import coarse_window_for
from .plane_sample import sample_planes_windowed_reference as sample_planes_windowed
from .ray_marcher import mip_ray_march

# The reference's plane bases (generate_planes) and their inverses; a point's
# plane-space xy is the first two components of coords @ inv(P).
_PLANE_BASES = np.array(
    [
        [[1, 0, 0], [0, 1, 0], [0, 0, 1]],
        [[1, 0, 0], [0, 0, 1], [0, 1, 0]],
        [[0, 0, 1], [1, 0, 0], [0, 1, 0]],
    ],
    dtype=np.float64,
)
PLANE_AXES_INV = np.linalg.inv(_PLANE_BASES).astype(np.float32)  # [3, 3, 3]

# The legacy Next3D plane set: the third plane swaps x and z, so it reads
# (z, y) where the v20 set reads (z, x).
_NEXT3D_PLANE_BASES = np.array(
    [
        [[1, 0, 0], [0, 1, 0], [0, 0, 1]],
        [[1, 0, 0], [0, 0, 1], [0, 1, 0]],
        [[0, 0, 1], [0, 1, 0], [1, 0, 0]],
    ],
    dtype=np.float64,
)
NEXT3D_PLANE_AXES_INV = np.linalg.inv(_NEXT3D_PLANE_BASES).astype(np.float32)


def _axis_picks(axes_inv: np.ndarray) -> tuple:
    """The inverses are permutation matrices, so projecting is picking
    coordinates: plane p's component j is coordinate argmax_i inv[p, i, j].
    Picking is exact (a matmul could run in TF32 on the card)."""
    return tuple(int(i) for i in axes_inv[:, :, :2].argmax(axis=1).reshape(-1))


_AXIS_PICKS = _axis_picks(PLANE_AXES_INV)
_PLANE_MODE_PICKS = {"v20": _AXIS_PICKS, "next3d": _axis_picks(NEXT3D_PLANE_AXES_INV)}


def project_onto_planes(coordinates: torch.Tensor, picks: tuple = _AXIS_PICKS) -> torch.Tensor:
    """[B, M, 3] -> [B, 3, M, 2] plane-space xy (the v20 planes unless `picks`
    names another set)."""
    B, M, _ = coordinates.shape
    proj = torch.stack([coordinates[..., i] for i in picks], dim=-1)  # [B, M, 6]
    return proj.reshape(B, M, 3, 2).permute(0, 2, 1, 3)


def _sample(planes: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """planes [B, 3, C, H, W], proj [B, 3, M, 2] -> [B, 3, M, C] (exact bilinear)."""
    B, N, C, H, W = planes.shape
    M = proj.shape[2]
    out = grid_sample(planes.reshape(B * N, C, H, W), proj.reshape(B * N, 1, M, 2))
    return out.reshape(B, N, C, M).permute(0, 1, 3, 2)


def _linspace01(n: int, device) -> torch.Tensor:
    return torch.linspace(0.0, 1.0, n, dtype=torch.float32, device=device)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_importance: int, u: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Inverse-CDF sampling: bins [R, ≥S+1], weights [R, S], u [R, n]."""
    S = weights.shape[-1]
    weights = weights + eps
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)  # [R, S+1]
    inds = (cdf[..., None, :] <= u[..., :, None]).sum(dim=-1)  # searchsorted(right=True)
    below = (inds - 1).clamp_min(0)
    above = inds.clamp_max(S)
    bins = bins[:, : S + 1]
    cdf_lo, cdf_hi = torch.gather(cdf, 1, below), torch.gather(cdf, 1, above)
    bins_lo, bins_hi = torch.gather(bins, 1, below), torch.gather(bins, 1, above)
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bins_lo + (u - cdf_lo) / denom * (bins_hi - bins_lo)


class ImportanceRenderer:
    """Stateless renderer; `decoder` maps sampled features [B, 3, M, C] to
    {"rgb", "sigma"}. `plane_mode="next3d"` projects onto the legacy Next3D
    plane set; the default is the shipped v20 set."""

    def __init__(self, plane_mode: str = "v20"):
        if plane_mode not in _PLANE_MODE_PICKS:
            raise ValueError(f"plane_mode must be 'v20' or 'next3d', not {plane_mode!r}")
        self.picks = _PLANE_MODE_PICKS[plane_mode]

    def __call__(
        self,
        planes: torch.Tensor,  # [B, 3, C, H, W]
        decoder: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
        ray_origins: torch.Tensor,  # [B, R, 3]
        ray_directions: torch.Tensor,  # [B, R, 3]
        options: Dict,
        evaluation: bool = False,
        generator: Optional[torch.Generator] = None,
        decoder_params: Optional[Tuple[torch.Tensor, ...]] = None,
    ):
        device = ray_origins.device
        rs, re = options.get("ray_start", None), options.get("ray_end", None)
        if isinstance(rs, (int, float)) and isinstance(re, (int, float)):
            ray_start, ray_end = float(rs), float(re)
        else:
            # dynamic near/far from the mean camera distance (the shipped
            # renderer)
            dist = torch.linalg.norm(ray_origins, dim=-1).mean()
            ray_start, ray_end = dist - 0.45, dist + 0.6

        B, R, _ = ray_origins.shape
        S = options["depth_resolution"]

        base = _linspace01(S, device).reshape(1, 1, S, 1) * (ray_end - ray_start) + ray_start
        delta = (ray_end - ray_start) / (S - 1)
        if options.get("det_stratified", False):
            offsets = torch.full((B, R, S, 1), 0.5, device=device)
        else:
            offsets = batch_rand((B, R, S, 1), generator, device)
        depths_coarse = base + offsets * delta

        Bp, n_planes, Cp, Hp, Wp = planes.shape
        fast = options.get("fast_sampling", True)
        pallas_exact = options.get("pallas_exact", False)
        # bf16 payload on the eval fast path (the JAX `_bf16_gather` gate)
        bf16_gather = (evaluation and options.get("pallas_coarse", False) and not pallas_exact
                       and options.get("bf16_gather", True))
        res = int(round(R ** 0.5))
        tile = max(8, res // 8)
        window = int(options.get("coarse_window", coarse_window_for(res, tile)))
        pallas_on = evaluation and options.get("pallas_coarse", False)
        windowed_ok = (
            fast
            and (options.get("windowed_coarse", False) or pallas_on)
            and res * res == R
            and res % tile == 0
            and tile >= 8
            and window <= min(Hp, Wp)
        )
        fused_on = (pallas_on and not pallas_exact and decoder_params is not None
                    and options.get("fused_render", True))
        box = 2.0 / options["box_warp"]

        def payload(bf16: bool) -> torch.Tensor:
            return planes.to(torch.bfloat16).float() if bf16 else planes.float()

        def sample_feats(coords_flat):  # [B, M, 3] -> [B, 3, M, C]
            proj = project_onto_planes(box * coords_flat.float(), self.picks)
            return _sample(payload(fast and bf16_gather), proj)

        planes_cl = []  # the channels-last [3B, H, W, C] copy, made at first use

        def channels_last():
            if not planes_cl:
                planes_cl.append(planes.permute(0, 1, 3, 4, 2).reshape(
                    Bp * n_planes, Hp, Wp, Cp).float().contiguous())
            return planes_cl[0]

        def sample_feats_coarse(coords):  # [B, R, S, 3] -> [B, 3, R*S, C]
            S_ = coords.shape[2]
            proj = project_onto_planes(box * coords.reshape(Bp, -1, 3).float(), self.picks)
            if pallas_on:
                out = sample_planes_windowed(
                    channels_last(), proj.reshape(Bp * n_planes, R, S_, 2),
                    torch.float32 if pallas_exact else torch.bfloat16)
            else:
                # the JAX XLA windowed formulation: exact where footprints fit
                return _sample(payload(False), proj)
            return out.reshape(Bp, n_planes, R * S_, Cp)

        def run_fused(coords):  # [B, R, n, 3] -> colors [B,R,n,C], sigma [B,R,n,1]
            n = coords.shape[2]
            proj = project_onto_planes(box * coords.reshape(Bp, -1, 3).float(), self.picks)
            proj = proj.reshape(Bp, n_planes, R, n, 2)
            outs = [fused_render(planes[b].permute(0, 2, 3, 1), proj[b], decoder_params,
                                 res=res, tile=tile) for b in range(Bp)]
            return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])

        def run(depths, structured=False):
            n = depths.shape[2]
            coords = ray_origins[:, :, None, :] + depths * ray_directions[:, :, None, :]
            if options.get("flip_z", False):
                coords = coords * torch.tensor([1.0, 1.0, -1.0], device=device)
            if structured and windowed_ok and fused_on:
                colors, densities = run_fused(coords)
            else:
                if structured and windowed_ok:
                    feats = sample_feats_coarse(coords)
                else:
                    feats = sample_feats(coords.reshape(B, R * n, 3))
                out = decoder(feats)
                colors = out["rgb"].reshape(B, R, n, -1)
                densities = out["sigma"].reshape(B, R, n, 1)
            return colors, densities

        n_imp = options["depth_resolution_importance"]

        # Merged-pass fast path: B1 (raw layout) → pooled CDF → B2 with the
        # march inside. Needs tile-shared depths: pooled + det mid-stratum
        # offsets + scalar near/far.
        scalar_bounds = not (torch.is_tensor(ray_start) and ray_start.ndim > 0)
        if (
            fused_on
            and windowed_ok
            and evaluation
            and n_imp > 0
            and options.get("pooled_importance", False)
            and options.get("march_in_kernel", True)
            and options.get("det_stratified", False)
            and scalar_bounds
            and not options.get("flip_z", False)
        ):
            tile_m = tile
            ts_opt = options.get("tile_shape", None)
            if ts_opt is not None:
                th_, tw_ = int(ts_opt[0]), int(ts_opt[1])
                if res % th_ == 0 and res % tw_ == 0:
                    tile_m = (th_, tw_)
            return self._march_fused_path(planes, decoder_params, ray_origins, ray_directions,
                                          depths_coarse, options, res, tile_m, n_imp)

        colors_coarse, densities_coarse = run(depths_coarse, structured=True)
        white_back = options.get("white_back", False)

        if n_imp > 0:
            _, _, weights = mip_ray_march(colors_coarse, densities_coarse, depths_coarse,
                                          white_back=white_back)
            pooled = options.get("pooled_importance", False) and windowed_ok
            if pooled:
                # tile-pooled importance weights: all rays of a tile share fine
                # depths (an inference option of the JAX package)
                ts = res // tile
                T_ = ts * ts
                w = weights.reshape(B, ts, tile, ts, tile, *weights.shape[2:])
                w_tile = w.mean(dim=(2, 4))  # [B, ts, ts, S-1, 1]
                d_tile = depths_coarse.reshape(B, ts, tile, ts, tile, S, 1)[:, :, 0, :, 0]
                fine_tile = self._sample_importance(
                    d_tile.reshape(B, T_, S, 1), w_tile.reshape(B, T_, *w_tile.shape[3:]),
                    n_imp, det=True, generator=generator)  # [B, T, n_imp, 1]
                depths_fine = fine_tile.reshape(B, ts, 1, ts, 1, n_imp, 1).expand(
                    B, ts, tile, ts, tile, n_imp, 1).reshape(B, R, n_imp, 1)
            else:
                depths_fine = self._sample_importance(depths_coarse, weights, n_imp,
                                                      det=evaluation, generator=generator)
            colors_fine, densities_fine = run(depths_fine, structured=pooled)
            all_depths, all_colors, all_densities = self._unify_samples(
                depths_coarse, colors_coarse, densities_coarse,
                depths_fine, colors_fine, densities_fine)
            rgb, depth, weights = mip_ray_march(all_colors, all_densities, all_depths,
                                                white_back=white_back)
        else:
            rgb, depth, weights = mip_ray_march(colors_coarse, densities_coarse, depths_coarse,
                                                white_back=white_back)
        return rgb, depth, weights.sum(dim=2)

    def _march_fused_path(self, planes, decoder_params, ray_origins, ray_directions,
                          depths_coarse, options, res, tile, n_imp):
        """Two-kernel render: B1 in the raw layout, the tile-pooled importance
        CDF from its raw densities (march weights depend on σ and depths only),
        then B2 over the per-tile merged depth order."""
        B, n_planes = planes.shape[:2]
        R = res * res
        S = depths_coarse.shape[2]
        th, tw = tile_shape(tile)
        tsy, tsx = res // th, res // tw
        T = tsy * tsx
        box = 2.0 / options["box_warp"]
        d_vec = depths_coarse[0, 0, :, 0]  # [S]; depths are globally shared here

        def group_rays(x):  # [B, R, 3] -> [B, T, P, 3] tile-major
            x = x.reshape(B, tsy, th, tsx, tw, 3)
            return x.permute(0, 1, 3, 2, 4, 5).reshape(B, T, th * tw, 3)

        ro_t = group_rays(ray_origins)
        rd_t = group_rays(ray_directions)
        deltas = d_vec[1:] - d_vec[:-1]

        rgbs, deps, wsums = [], [], []
        for b in range(B):
            # one channels-last bf16 copy of the planes feeds both kernels
            planes_b = planes[b].permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()
            coords_c = (ray_origins[b:b + 1, :, None, :]
                        + depths_coarse[b:b + 1] * ray_directions[b:b + 1, :, None, :])
            proj_c = project_onto_planes(box * coords_c.reshape(1, -1, 3), self.picks)
            proj_c = proj_c.reshape(n_planes, R, S, 2).contiguous()
            raw = fused_render(planes_b, proj_c, decoder_params, res=res, tile=tile,
                               return_raw=True)  # [T*S, P, O]
            sigma = raw[:, :, 0].float().reshape(T, S, -1).permute(0, 2, 1)  # [T, P, S]
            dm = F.softplus((sigma[..., :-1] + sigma[..., 1:]) * 0.5 - 1.0)
            alpha = 1.0 - torch.exp(-dm * deltas)
            trans = torch.cumprod(
                torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], dim=-1),
                dim=-1)[..., :-1]
            w_tile = (alpha * trans).mean(dim=1)  # [T, S-1]
            fine_tile = self._sample_importance(
                d_vec.reshape(1, 1, S, 1).expand(1, T, S, 1), w_tile.reshape(1, T, S - 1, 1),
                n_imp, det=True).reshape(T, n_imp)
            # stable merge: coarse first on ties, as _unify_samples
            d_cat = torch.cat([d_vec[None].expand(T, S), fine_tile], dim=1)
            d_m, order = torch.sort(d_cat, dim=1, stable=True)
            is_fine = (order >= S).to(torch.int32)
            src = torch.where(order >= S, order - S, order).to(torch.int32)
            coords_m = ro_t[b][:, None, :, :] + d_m[:, :, None, None] * rd_t[b][:, None, :, :]
            proj_m = project_onto_planes(box * coords_m.reshape(1, -1, 3), self.picks)
            proj_m = proj_m.reshape(n_planes, T, S + n_imp, -1, 2).contiguous()
            rgb, dep, ws = fused_merged_march(planes_b, proj_m, is_fine, src, d_m, raw,
                                              decoder_params, res=res, S=S, tile=tile)
            rgbs.append(rgb)
            deps.append(dep)
            wsums.append(ws)
        return torch.stack(rgbs), torch.stack(deps), torch.stack(wsums)

    @staticmethod
    def _sample_importance(z_vals, weights, n_importance, det, generator=None):
        """Smooth weights (max-blur), then inverse CDF -> [B, R, n_importance, 1]."""
        B, R, S, _ = z_vals.shape
        z_vals = z_vals.reshape(B * R, S)
        w = weights.reshape(B * R, -1)  # [BR, S-1]

        # max_pool1d(k=2, s=1, p=1) then avg_pool1d(k=2, s=1)
        w_pad = F.pad(w, (1, 1), value=float("-inf"))
        w_max = torch.maximum(w_pad[:, :-1], w_pad[:, 1:])  # [BR, S]
        w_smooth = (w_max[:, :-1] + w_max[:, 1:]) * 0.5 + 0.01  # [BR, S-1]

        z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        if det:
            u = _linspace01(n_importance, z_vals.device).expand(B * R, n_importance)
        else:
            # stratified u (one draw per CDF stratum): sorted by construction
            u = (torch.arange(n_importance, dtype=torch.float32, device=z_vals.device)
                 + batch_rand((B, R, n_importance), generator, z_vals.device).reshape(
                     B * R, n_importance)) / n_importance
        samples = sample_pdf(z_mid, w_smooth[:, 1:-1], n_importance, u.contiguous())
        return samples.detach().reshape(B, R, n_importance, 1)

    @staticmethod
    def _unify_samples(d1, c1, s1, d2, c2, s2):
        """Merge two per-ray sample lists by depth; a stable sort keeps coarse
        samples first on ties (the JAX rank merge's order)."""
        depths = torch.cat([d1, d2], dim=-2)
        colors = torch.cat([c1, c2], dim=-2)
        densities = torch.cat([s1, s2], dim=-2)
        _, order = torch.sort(depths[..., 0], dim=-1, stable=True)
        order = order[..., None]
        return (torch.gather(depths, -2, order),
                torch.gather(colors, -2, order.expand(-1, -1, -1, colors.shape[-1])),
                torch.gather(densities, -2, order))
