"""Cross-attention block, plain PyTorch.

Counterpart of `invertavatar_tpu/models/encoders/attention.py` (reference
`encoder_inversion/models/attention.py`): a DETR-style decoder sub-block,
multi-head cross-attention and an FFN, each with a residual, the attention
followed by an affine-free LayerNorm. Dropout is identity at inference.
Tokens are [B, N, d_model].
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class _MHA(nn.Module):
    """`torch.nn.MultiheadAttention` (batch first) with its packed
    `in_proj_weight` / `in_proj_bias` and `out_proj`, written out as float32
    matmuls and a softmax."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.randn(3 * d_model, d_model) * 0.02)
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        d, h = self.d_model, self.nhead
        w, b = self.in_proj_weight, self.in_proj_bias
        B, Nq, Nk = q.shape[0], q.shape[1], k.shape[1]

        def heads(x, i, n):
            return F.linear(x, w[i * d:(i + 1) * d], b[i * d:(i + 1) * d]).reshape(
                B, n, h, d // h).transpose(1, 2)

        attn = torch.matmul(heads(q, 0, Nq), heads(k, 1, Nk).transpose(-2, -1))
        attn = torch.softmax(attn / math.sqrt(d // h), dim=-1)
        out = torch.matmul(attn, heads(v, 2, Nk)).transpose(1, 2).reshape(B, Nq, d)
        return self.out_proj(out)


class CrossAttention(nn.Module):
    """tgt [B, Nq, d] attends to memory [B, Nk, d]; post-norm, then the FFN
    (`activation` "relu" or "gelu")."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 activation: str = "relu"):
        super().__init__()
        self.d_model = d_model
        self.activation = activation
        self.multihead_attn = _MHA(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        tgt = tgt + self.multihead_attn(tgt, memory, memory)
        tgt = F.layer_norm(tgt, (self.d_model,), eps=1e-5)
        h = self.linear1(tgt)
        h = torch.relu(h) if self.activation == "relu" else F.gelu(h, approximate="tanh")
        return tgt + self.linear2(h)
