"""The plain draw the modules call for their random paths: the reference
always runs in one process, on one device."""

from __future__ import annotations

from typing import Optional

import torch


def batch_rand(shape, generator: Optional[torch.Generator] = None, device=None,
               normal: bool = False) -> torch.Tensor:
    fn = torch.randn if normal else torch.rand
    return fn(shape, generator=generator, device=device)
