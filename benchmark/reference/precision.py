"""The reference's one precision switch: the control of the output check.

`lower("tf32")` rounds the float32 operands of the reference's convolutions
and matrix products to TF32 (10 mantissa bits, round to nearest even), which
is what the card's tensor cores do with `allow_tf32`, and sets torch's TF32
flags as well, so the control reads the same on the CPU and on the card.
Outside it the reference computes as the configuration states."""

from __future__ import annotations

import contextlib

import torch

_MODE = {"round": None}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """`x` with its float32 values rounded to TF32 inside `lower("tf32")`;
    `x` itself otherwise, and for every other dtype."""
    if _MODE["round"] is None or x.dtype != torch.float32:
        return x
    b = x.contiguous().view(torch.int32)
    b = (b + (0xFFF + ((b >> 13) & 1))) & -0x2000
    return b.view(torch.float32).reshape(x.shape)


@contextlib.contextmanager
def lower(mode):
    """Compute inside the block one precision step below the configuration
    (`mode` "tf32"); `None` leaves everything as it is."""
    if mode is None:
        yield
        return
    if mode != "tf32":
        raise ValueError(f"unknown control precision {mode!r}")
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    _MODE["round"] = mode
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        _MODE["round"] = None
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
