"""Seeded weights, made on the device in one draw and handed alike to the
program and to the reference.

Every parameter, and every buffer whose name ends in one of the
configuration's `drawn_buffers`, takes N(0, 1) · scale + mean, with (scale,
mean) from the first of the configuration's `rules` whose pattern matches
its name. The draws come from one `torch.randn` on the device over all of
them, in sorted name order, so two modules with the same names and shapes
get the same tensors whatever their construction order."""

from __future__ import annotations

import re

import torch


def seeded_generator(device, seed: int, stream: int) -> torch.Generator:
    """A generator on `device` for draw stream `stream` of run `seed`."""
    return torch.Generator(device=device).manual_seed(int(seed) * 1009 + int(stream))


def leaves(module: torch.nn.Module, drawn_buffers) -> list:
    """(name, tensor) of every tensor `fill` draws, in sorted name order."""
    out = dict(module.named_parameters())
    out.update((n, b) for n, b in module.named_buffers()
               if b.is_floating_point() and any(n.endswith(s) for s in drawn_buffers))
    return sorted(out.items())


@torch.no_grad()
def fill(module: torch.nn.Module, spec: dict, seed: int, stream: int = 1) -> torch.nn.Module:
    """Fill `module` in place from (`seed`, `stream`) by `spec`
    ({"rules": [[pattern, scale, mean], ...], "drawn_buffers": [...]})."""
    rules = [(re.compile(p), float(s), float(m)) for p, s, m in spec["rules"]]
    named = leaves(module, spec.get("drawn_buffers", ()))
    device = named[0][1].device
    flat = torch.randn(sum(t.numel() for _, t in named), device=device,
                       generator=seeded_generator(device, seed, stream))
    off = 0
    for name, t in named:
        scale, mean = next(((s, m) for p, s, m in rules if p.search(name)), (1.0, 0.0))
        n = t.numel()
        t.copy_((flat[off:off + n] * scale + mean).view(t.shape))
        off += n
    return module
