"""Training snapshots.

Counterpart of `save_orbax` / `restore_orbax` in
`invertavatar_tpu/utils/checkpoint.py`: a snapshot is one `torch.save` file of
a dict of state dicts and counters, written atomically. Loading reference
`.pkl` checkpoints (`load_triplane_from_pkl`) waits for ROADMAP A8.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch


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
