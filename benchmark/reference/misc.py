"""[benchmark reference] A frozen copy of `invertavatar_torch/utils/misc.py`: plain
PyTorch, every kernel route replaced by its plain version, nothing of the
program imported. The text below is the original module's.

Small shared helpers (shape checks, padding/scaling parsers, device
resolution)."""

from __future__ import annotations

from typing import Optional, Sequence


def assert_shape(x, ref_shape: Sequence[Optional[int]]) -> None:
    """Raise `AssertionError` unless `x.shape` matches `ref_shape`, where a
    `None` entry matches any size (counterpart of
    `invertavatar_tpu/utils/misc.py:assert_shape`, with its messages). It
    compares Python ints only: no tensor op and no device sync, and unlike
    a bare `assert` it also runs under `python -O`."""
    shape = tuple(x.shape)
    if len(shape) != len(ref_shape):
        raise AssertionError(f"Wrong number of dimensions: got {len(shape)}, "
                             f"expected {len(ref_shape)}")
    for idx, (size, ref_size) in enumerate(zip(shape, ref_shape)):
        if ref_size is not None and size != ref_size:
            raise AssertionError(f"Wrong size for dimension {idx}: got {size}, expected {ref_size}")


def parse_scaling(scaling) -> tuple:
    if isinstance(scaling, int):
        scaling = [scaling, scaling]
    sx, sy = scaling
    assert sx >= 1 and sy >= 1
    return int(sx), int(sy)


def parse_padding(padding) -> tuple:
    if isinstance(padding, int):
        padding = [padding, padding]
    padding = list(padding)
    if len(padding) == 2:
        px, py = padding
        padding = [px, px, py, py]
    px0, px1, py0, py1 = padding
    return int(px0), int(px1), int(py0), int(py1)


def to_device(batch, device):
    """A batch (arrays or tensors, in nested dicts) as tensors on `device`."""
    import torch

    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    return torch.as_tensor(batch).to(device)


def resolve_device(device) -> "torch.device":
    """The device an entry point builds on. CUDA is the default and must exist:
    nothing falls back to the CPU unless the caller asks for it."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() is False")
    return device
