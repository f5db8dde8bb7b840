"""Train-state container, the lazy-regularisation Adam and the EMA.

Counterpart of `invertavatar_tpu/train/state.py`. JAX keeps (params,
opt_state, buffers) as immutable trees and a step returns new ones; here the
module holds its parameters and buffers, the optimizer its moments, and a
step updates both in place.

The optimizer policy is the reference's (training_loop.py): Adam whose lr and
betas are scaled by N/(N+1) when a regularisation phase runs every N steps,
with NaN gradients zeroed and ±inf saturated to the float32 extremes first;
`MultiSteps` accumulates micro-batch gradients around it. Under a data mesh
the gradients these optimizers read are already the mean over ranks: the
step all-reduces each phase's gradients once (each micro-step's, with
`MultiSteps`, whose running mean stays local) before calling `step`, so the
scrub follows the all-reduce, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional

import torch


@dataclasses.dataclass
class TrainState:
    module: torch.nn.Module
    opt: torch.optim.Optimizer

    def state_dict(self) -> Dict[str, Any]:
        return {"module": self.module.state_dict(), "opt": self.opt.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.module.load_state_dict(state["module"])
        self.opt.load_state_dict(state["opt"])


@torch.no_grad()
def scrub_nan_grads(params: Iterable[torch.Tensor]) -> None:
    """`torch.nan_to_num` on each gradient in place: NaN -> 0, ±inf -> the
    float32 extremes."""
    fmax = torch.finfo(torch.float32).max
    for p in params:
        if p.grad is not None:
            torch.nan_to_num(p.grad, nan=0.0, posinf=fmax, neginf=-fmax, out=p.grad)


class LazyRegAdam(torch.optim.Adam):
    """Adam for a main phase whose regularisation runs every `reg_interval`
    steps: lr·N/(N+1) and betas^(N/(N+1)) (unscaled for None or 1); each
    `step` scrubs the gradients first (`scrub_nan_grads`). The JAX
    `adam_with_lazy_reg` optax chain."""

    def __init__(self, params, lr: float, beta1: float, beta2: float, eps: float = 1e-8,
                 reg_interval: Optional[int] = None):
        if reg_interval is not None and reg_interval > 1:
            mb_ratio = reg_interval / (reg_interval + 1)
            lr, beta1, beta2 = lr * mb_ratio, beta1 ** mb_ratio, beta2 ** mb_ratio
        super().__init__(params, lr=lr, betas=(beta1, beta2), eps=eps)

    @torch.no_grad()
    def step(self, closure=None):
        scrub_nan_grads(p for group in self.param_groups for p in group["params"])
        return super().step(closure)


class MultiSteps:
    """Gradient accumulation around an optimizer, as `optax.MultiSteps`:
    each `step` folds the parameters' `.grad` into a running mean of the
    micro-batch gradients (acc + (g − acc)/(n + 1)), and every `every_k`-th
    step hands the mean to the inner optimizer and starts a new mean. The
    parameters change only on that step. `state_dict` holds the inner
    optimizer's state and the partial mean, so a run resumes mid-way."""

    def __init__(self, opt: torch.optim.Optimizer, every_k: int):
        self.opt, self.every_k = opt, every_k
        self.mini_step, self.acc = 0, None

    @property
    def param_groups(self):
        return self.opt.param_groups

    @property
    def state(self):
        return self.opt.state

    @torch.no_grad()
    def step(self) -> None:
        params = [p for group in self.opt.param_groups for p in group["params"]
                  if p.requires_grad]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        if self.acc is None:
            self.acc = [torch.zeros_like(p) for p in params]
        n = self.mini_step
        self.acc = [a + (g - a) / (n + 1) for a, g in zip(self.acc, grads)]
        self.mini_step = (n + 1) % self.every_k
        if self.mini_step == 0:
            for p, a in zip(params, self.acc):
                p.grad = a
            self.opt.step()
            self.acc = None

    def state_dict(self) -> Dict[str, Any]:
        return {"opt": self.opt.state_dict(), "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.opt.load_state_dict(state["opt"])
        self.mini_step, self.acc = state["mini_step"], state["acc"]


@torch.no_grad()
def ema_update(ema_params: Iterable[torch.Tensor], params: Iterable[torch.Tensor],
               beta: float) -> None:
    """ema = ema·beta + p·(1 − beta), in place."""
    ema_params, params = list(ema_params), list(params)
    torch._foreach_mul_(ema_params, beta)
    torch._foreach_add_(ema_params, [p.to(e.dtype) for e, p in zip(ema_params, params)],
                        alpha=1.0 - beta)


def ema_beta(batch_size: int, ema_kimg: float, cur_nimg: int,
             ema_rampup: Optional[float] = None) -> float:
    """The EMA's per-step decay: half-life `ema_kimg` thousand images, ramped
    up over the first images by `ema_rampup`."""
    ema_nimg = ema_kimg * 1000
    if ema_rampup is not None:
        ema_nimg = min(ema_nimg, cur_nimg * ema_rampup)
    return 0.5 ** (batch_size / max(ema_nimg, 1e-8))
