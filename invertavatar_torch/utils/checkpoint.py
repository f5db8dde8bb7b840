"""Checkpoint import and training snapshots.

Counterpart of `invertavatar_tpu/utils/checkpoint.py`.

Import: a reference `.pkl` (source-embedding pickle, read by the sandboxed
`pkl_import` without executing its code) gives state dicts in the torch
reference's key space, which the port's modules share: the arrays go to
`load_state_dict` as they are (no layout conversion); only the
`resample_filter` buffers (rebuilt from their taps) and BatchNorm's
`num_batches_tracked` counters are dropped. Keys the port does not have are
ignored, as the JAX package ignores them; a port key the checkpoint lacks is
an error.

Snapshots (the counterpart of `save_orbax` / `restore_orbax`): one
`torch.save` file of a dict of state dicts and counters, written atomically.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from .misc import resolve_device
from .pkl_import import (
    _PersistentObj,
    get_init_kwargs,
    load_network_pkl,
    safe_load_pickle,
    state_dict_from_stub,
)

_DROP_LEAVES = {"resample_filter", "num_batches_tracked"}


def triplane_config_from_init_kwargs(init_kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Reference `TriPlaneGenerator` init kwargs -> the port's generator config."""
    kw = dict(init_kwargs)
    mapping_kwargs = kw.pop("mapping_kwargs", {}) or {}
    return dict(
        z_dim=kw.pop("z_dim"),
        c_dim=kw.pop("c_dim"),
        w_dim=kw.pop("w_dim"),
        img_resolution=kw.pop("img_resolution"),
        img_channels=kw.pop("img_channels"),
        sr_num_fp16_res=kw.pop("sr_num_fp16_res", 0),
        rendering_kwargs=dict(kw.pop("rendering_kwargs", {}) or {}),
        channel_base=kw.pop("channel_base", 32768),
        channel_max=kw.pop("channel_max", 512),
        num_fp16_res=kw.pop("num_fp16_res", 0),
        conv_clamp=float(kw["conv_clamp"]) if kw.get("conv_clamp") is not None else None,
        map_num_layers=mapping_kwargs.get("num_layers", 8),
    )


def load_reference_state(module: torch.nn.Module,
                         state: Dict[str, np.ndarray]) -> torch.nn.Module:
    """Fill `module` from a reference state dict (numpy arrays by name)."""
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()
               if k.rsplit(".", 1)[-1] not in _DROP_LEAVES}
    missing, _ = module.load_state_dict(tensors, strict=False)
    if missing:
        raise KeyError(f"the checkpoint lacks {len(missing)} of the port's entries, e.g. "
                       f"{missing[:5]}")
    return module


def load_triplane_from_pkl(path: str, key: str = "G_ema", device="cuda"):
    """A reference 3D-GAN checkpoint -> the port's `TriPlaneGenerator` in
    eval mode on `device` (CUDA by default)."""
    from ..models.triplane import TriPlaneGenerator

    device = resolve_device(device)
    entry = load_network_pkl(path)[key]
    with torch.device(device):
        G = TriPlaneGenerator(**triplane_config_from_init_kwargs(entry["init_kwargs"]))
    return load_reference_state(G, entry["state_dict"]).eval()


def _stub_children(obj) -> Dict[str, Any]:
    """`_modules` of a stub module or persistent object."""
    if isinstance(obj, _PersistentObj):
        meta = obj.meta
        state = meta.get("state") if isinstance(meta, dict) else getattr(meta, "state", None)
        return (state or {}).get("_modules", {}) or {}
    return getattr(obj, "__dict__", {}).get("_modules", {}) or {}


def _inversion_config(state: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The `InversionNet` options a state dict implies: which U-Nets it holds
    and of which kind (the one-shot SegFormer decoders carry ViT blocks,
    `up1.transformer.*`; the few-shot ones ConvGRUs), the texture offsets'
    widths and the trunk depth (24 IR-SE blocks, or 4 in the tiny test
    trunk)."""
    blocks = {k.split(".")[2] for k in state if k.startswith("encoder.body.")}
    segformer = any(k.startswith(f"unet_encoder.{u}.up1.transformer.") for k in state
                    for u in ("texture_unet", "triplane_unet"))
    cfg = dict(encoding_texture=any(k.startswith("unet_encoder.texture_unet.") for k in state),
               encoding_triplane=any(k.startswith("unet_encoder.triplane_unet.") for k in state),
               unet_type="segformer" if segformer else "gru",
               trunk_layers_n=8 if len(blocks) == 4 else 50)
    if cfg["encoding_texture"]:
        cfg["texture_out_channels"] = tuple(
            int(state[f"unet_encoder.texture_unet.outconv{i}.weight"].shape[0]) for i in range(4))
    return cfg


def load_inversion_from_pkl(path: str, key: str = "G", device="cuda"):
    """A reference inversion checkpoint (the few-shot `FSInvertAvatar.pkl`, or
    a one-shot `updatedOSInvertAvatar`-style pickle) -> the port's
    `InversionNet` in eval mode on `device` (CUDA by default). The nested
    generator's init kwargs give its config; the U-Nets (GRU or SegFormer)
    and the trunk depth follow the state dict (`_inversion_config`), where
    the JAX `cli/eval_os.py` sets `unet_type="segformer"` itself."""
    from ..models.encoders.uvnet import InversionNet

    device = resolve_device(device)
    with open(path, "rb") as f:
        obj = safe_load_pickle(f)[key]
    state = state_dict_from_stub(obj)
    gen_stub = _stub_children(obj).get("generator")
    gen_kwargs = get_init_kwargs(gen_stub) if gen_stub is not None else {}
    if not gen_kwargs:
        raise ValueError("could not recover the generator's init kwargs from the checkpoint")
    with torch.device(device):
        net = InversionNet(triplane_config_from_init_kwargs(gen_kwargs),
                           **_inversion_config(state))
    return load_reference_state(net, state).eval()


def save_checkpoint(path: str, tree: Dict[str, Any]) -> None:
    """Write `tree` to `path`, replacing any snapshot there (snapshot tags
    repeat across resumed runs)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    """Read a snapshot written by `save_checkpoint` (tensors and plain
    containers only)."""
    return torch.load(path, map_location=map_location, weights_only=True)
