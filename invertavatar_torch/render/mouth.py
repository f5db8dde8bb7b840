"""Device-side mouth-interior fill (counterpart of `invertavatar_tpu/render/mouth.py`).

A 4-connected flood from the image border through the zero-region of the
alpha mask; what the flood does not reach is the enclosed mouth cavity. Like
the JAX function, the flood runs `n_rounds` rounds of four directional sweeps
(down, up, right, left). One sweep solves s_j = free_j ∧ (s_{j-1} ∨ state_j)
along an axis: a cell is reached iff, within its run of free cells, some
earlier cell is already in the state. That is a comparison of two running
maxima (the last state index vs. the last blocked index), so the sweep is
bit-equal to the JAX associative scan on 0/1 masks.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils import trace


def _border_seed(like: torch.Tensor) -> torch.Tensor:
    seed = torch.zeros_like(like, dtype=torch.bool)
    seed[..., 0, :] = True
    seed[..., -1, :] = True
    seed[..., :, 0] = True
    seed[..., :, -1] = True
    return seed


def _sweep(free: torch.Tensor, state: torch.Tensor, dim: int, reverse: bool) -> torch.Tensor:
    if reverse:
        free, state = free.flip(dim), state.flip(dim)
    shape = [1] * free.ndim
    shape[dim] = free.shape[dim]
    idx = torch.arange(free.shape[dim], device=free.device).reshape(shape)
    last_state = torch.where(state, idx, -1).cummax(dim).values
    last_block = torch.where(free, -1, idx).cummax(dim).values
    res = free & (last_state > last_block)
    return res.flip(dim) if reverse else res


def _flood(free: torch.Tensor, seed: torch.Tensor, n_rounds: int = 4) -> torch.Tensor:
    """Flood of `seed` through `free` (both bool, [..., H, W])."""
    state = seed & free
    for _ in range(n_rounds):
        with trace.span("flood"):
            for dim, rev in ((-2, False), (-2, True), (-1, False), (-1, True)):
                state = state | _sweep(free, state, free.ndim + dim, rev)
    return state


@trace.spanned("fill_mouth")
def fill_mouth(alpha: torch.Tensor, threshold: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fill enclosed zero-regions of a rasterized face alpha `[B, 1, H, W]`.

    Returns (filled_alpha, mouth_mask): `filled = clip(alpha + mouth, 0, 1)`;
    `mouth_mask` is 1 on enclosed interior zeros.
    """
    alpha = alpha.float()
    free = alpha < threshold
    outside = _flood(free, _border_seed(free))
    with trace.span("fill"):
        mouth = (free & ~outside).float()
        return (alpha + mouth).clamp(0.0, 1.0), mouth
