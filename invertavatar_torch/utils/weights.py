"""Weight bridge: JAX variable trees -> the port's `state_dict`.

Counterpart (inverse) of `invertavatar_tpu/utils/torch_import.py`
(`convert_array` / `convert_state_dict`): the JAX package keeps
`{"params": ..., "buffers": ...}` nested dicts in its own layouts; the port
uses the torch reference key space and layouts.

  * conv weights  HWIO -> OIHW
  * fc weights    [in, out] -> [out, in]
  * synthesis const [H, W, C] -> [C, H, W]
  * `decoder.fc0` / `decoder.fc1` -> `decoder.net.0` / `decoder.net.2`
  * `noise_const` / `w_avg` / `latent_avg` come from `buffers` under their
    own names; `black_uv_bg` NHWC -> NCHW
  * BatchNorm `running_mean` / `running_var` come from `batch_stats`

An `InversionNet` tree converts whole by these rules: the e4e encoder, the
few-shot ConvGRU U-Nets (`unet_encoder.{texture,triplane}_unet`: trunk and
decoder convs, BatchNorm statistics, PReLU slopes, the GRU gates
`conv_gru.ih.0` / `conv_gru.hh.0`, the `condition_*` and `final_head` heads)
and the one-shot SegFormer decoders (`up*.transformer.*`: the patch
embedding and 1×1 convs and the depthwise `mlp.dwconv.dwconv` HWIO -> OIHW,
the q / kv / proj / fc linears [in, out] -> [out, in], LayerNorm scales and
shifts as they are; `CrossAttention`'s packed `in_proj_weight` is stored in
the torch layout already) keep the JAX module names, which are the torch
reference's.

The loss networks convert whole by the same rules: LPIPS (`net.<i>` convs
HWIO -> OIHW, the `lin.<i>.1` 1×1 heads) and the ArcFace backbone (the IR-SE
trunk, `output_layer.0` BatchNorm and `.4` BatchNorm1d statistics from
`batch_stats`, the `output_layer.3` linear [in, out] -> [out, in]).

The style-U-Net trees (`encoder.{i}.fromrgb`, `fusion.{i}`, `b{res}.conv0`,
the GRU gates `b{res}.gru.ih.0` / `.hh.0`, the SFT heads) and the Next3D
generators' (`mouth_backbone` / `neural_blending` encoders and fusion convs,
the used `b{res}` blocks) are 4-D convs and FCs: the rules above cover them.

The StyleGAN3 input (`...input.weight`, a [C, C] matrix the JAX package
already applies as `x @ weight.T`) keeps its layout, and its `input.affine`
bias gains the reference's [1, 0, 0, 0] start, which JAX adds after a zero
bias instead (`models/stylegan3.py`).

`resample_filter` buffers are not in the trees: the port rebuilds them from
their taps and keeps them out of the state dict.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_RENAMES = [
    (re.compile(r"(^|\.)decoder\.fc0\."), r"\1decoder.net.0."),
    (re.compile(r"(^|\.)decoder\.fc1\."), r"\1decoder.net.2."),
]


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, name))
        else:
            out[name] = v
    return out


_SG3_INPUT_WEIGHT = re.compile(r"(^|\.)input\.weight$")
_SG3_INPUT_AFFINE_BIAS = re.compile(r"(^|\.)input\.affine\.bias$")


def convert_array(name: str, arr: np.ndarray) -> np.ndarray:
    """One JAX-layout array -> the torch reference layout."""
    if _SG3_INPUT_WEIGHT.search(name):
        return arr
    if _SG3_INPUT_AFFINE_BIAS.search(name) and arr.shape == (4,):
        return arr + np.asarray([1.0, 0.0, 0.0, 0.0], arr.dtype)
    if name.endswith(".weight"):
        if arr.ndim == 4:  # HWIO -> OIHW
            return np.transpose(arr, (3, 2, 0, 1))
        if arr.ndim == 2:  # [in, out] -> [out, in]
            return arr.T
        return arr
    if name.endswith(".const") and arr.ndim == 3:  # [H, W, C] -> [C, H, W]
        return np.transpose(arr, (2, 0, 1))
    if name.split(".")[-1] == "black_uv_bg" and arr.ndim == 4:  # NHWC -> NCHW
        return np.transpose(arr, (0, 3, 1, 2))
    return arr


def jax_to_state_dict(variables: Mapping[str, Mapping]) -> Dict[str, torch.Tensor]:
    """`{"params": ..., "buffers": ..., "batch_stats": ...}` nested numpy dicts
    -> flat state dict."""
    state = {}
    for collection in ("params", "buffers", "batch_stats"):
        for name, arr in _flatten(variables.get(collection, {})).items():
            for pat, repl in _RENAMES:
                name = pat.sub(repl, name)
            arr = convert_array(name, np.asarray(arr))
            state[name] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    return state
