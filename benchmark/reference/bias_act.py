"""[benchmark reference] A frozen copy of `invertavatar_torch/ops/bias_act.py`: plain
PyTorch, every kernel route replaced by its plain version, nothing of the
program imported. The text below is the original module's.

Bias + activation (+ gain + clamp), plain PyTorch.

Counterpart of `invertavatar_tpu/ops/bias_act.py`; the bias axis defaults to 1
(NCHW channels).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

_SQRT2 = math.sqrt(2.0)

# name -> (func(x, alpha), default alpha, default gain)
activation_funcs = {
    "linear": (lambda x, alpha: x, 0.0, 1.0),
    "relu": (lambda x, alpha: torch.relu(x), 0.0, _SQRT2),
    "lrelu": (lambda x, alpha: torch.where(x >= 0, x, x * alpha), 0.2, _SQRT2),
    "tanh": (lambda x, alpha: torch.tanh(x), 0.0, 1.0),
    "sigmoid": (lambda x, alpha: torch.sigmoid(x), 0.0, 1.0),
    "elu": (lambda x, alpha: F.elu(x), 0.0, 1.0),
    "selu": (lambda x, alpha: F.selu(x), 0.0, 1.0),
    "softplus": (lambda x, alpha: F.softplus(x), 0.0, 1.0),
    "swish": (lambda x, alpha: torch.sigmoid(x) * x, 0.0, _SQRT2),
}


def def_gain(act: str) -> float:
    return activation_funcs[act][2]


def bias_act(
    x: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    dim: int = 1,
    act: str = "linear",
    alpha: Optional[float] = None,
    gain: Optional[float] = None,
    clamp: Optional[float] = None,
) -> torch.Tensor:
    """Add bias `b` along `dim`, apply `act`, scale by `gain`, clamp to ±`clamp`."""
    func, def_alpha, def_gain_ = activation_funcs[act]
    alpha = float(alpha if alpha is not None else def_alpha)
    gain = float(gain if gain is not None else def_gain_)

    if b is not None:
        assert b.ndim == 1, "bias must be 1D"
        dim_ = dim % x.ndim
        assert b.shape[0] == x.shape[dim_]
        shape = [1] * x.ndim
        shape[dim_] = -1
        x = x + b.to(x.dtype).reshape(shape)

    x = func(x, alpha)
    if gain != 1.0:
        # the gain is rounded to x's dtype first, as the JAX op does
        x = x * float(torch.tensor(gain).to(x.dtype))
    if clamp is not None:
        assert clamp >= 0
        x = x.clamp(-clamp, clamp)
    return x
