"""Sampling and kernel overrides for the inversion stages' training renders.

Counterpart of `invertavatar_tpu/train/fast_render.py` (the rationale is
there): the generator is frozen in every inversion stage, so both sides of a
reconstruction loss render with deterministic mid-stratum offsets and
tile-pooled importance depths. Every render pass is then structured, and
  * no-grad renders ride kernel B3 with a float32 payload ("exact") or the
    fused kernels B1/B2 ("fused");
  * grad-carrying renders ride B3 with its transpose kernel as backward
    ("pallas") or the exact `F.grid_sample` route ("structured").
The mode names are the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Optional

FAST_NOGRAD_EXACT: Dict = {
    "pallas_coarse": True,
    "pallas_exact": True,
    "pooled_importance": True,
    "det_stratified": True,
}

FAST_NOGRAD_FUSED: Dict = {
    "pallas_coarse": True,
    "pooled_importance": True,
    "det_stratified": True,
}

FAST_GRAD_STRUCTURED: Dict = {
    "windowed_coarse": True,
    "pooled_importance": True,
    "det_stratified": True,
}

FAST_GRAD_PALLAS: Dict = dict(FAST_GRAD_STRUCTURED, pallas_grad=True)

_MODES: Dict[str, Optional[Dict]] = {
    "off": None,
    "exact": FAST_NOGRAD_EXACT,
    "fused": FAST_NOGRAD_FUSED,
}

_GRAD_MODES: Dict[str, Optional[Dict]] = {
    "off": None,
    "structured": FAST_GRAD_STRUCTURED,
    "pallas": FAST_GRAD_PALLAS,
}


def nograd_overrides(mode: str, interpret: bool = False) -> Optional[Dict]:
    """Renderer overrides for a `fast_no_grad` mode (off | exact | fused).
    `interpret` (the JAX Pallas interpret switch) is accepted and ignored:
    the kernel wrappers pick the plain versions for CPU tensors."""
    if mode not in _MODES:
        raise ValueError(f"fast_no_grad mode {mode!r} not in {sorted(_MODES)}")
    ov = _MODES[mode]
    return None if ov is None else dict(ov)


def grad_overrides(mode: str, interpret: bool = False) -> Optional[Dict]:
    """Renderer overrides for a `fast_grad` mode (off | structured | pallas)
    of grad-carrying training renders; `interpret` is ignored as above."""
    if mode not in _GRAD_MODES:
        raise ValueError(f"fast_grad mode {mode!r} not in {sorted(_GRAD_MODES)}")
    ov = _GRAD_MODES[mode]
    return None if ov is None else dict(ov)
