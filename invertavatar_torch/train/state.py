"""Train-state container.

Counterpart of `invertavatar_tpu/train/state.py`'s `TrainState`. JAX keeps
(params, opt_state, buffers) as immutable trees and a step returns new ones;
here the module holds its parameters and buffers, the optimizer its moments,
and a step updates both in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

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
