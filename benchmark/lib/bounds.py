"""Peaks of one NVIDIA H100 SXM and the least time of each kernel's work.

The arithmetic is `chip_smoke.py`'s (`bound`, `tap_flops_per_point`,
`mlp_flops_per_point` and the byte counts of phases 3, 4, 8 and 27c), kept
here so that the program cannot change its own yardstick. Bytes count each
input read once and each output written once; operations are the bilinear
taps on the float32 cores and the decoder MLP on the TF32 tensor cores.
Every function takes the shapes of one recorded call."""

from __future__ import annotations

import math

PEAK_BF16_FLOPS = 989e12  # dense, the tensor cores: the step's `mfu`
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3


def bound_ms(nbytes: float, flops: float, tc_flops: float = 0.0) -> float:
    """Least time (ms) of the work: bytes over the memory rate against
    `flops` at the fp32 peak plus `tc_flops` at the TF32 tensor-core peak."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (flops / PEAK_FP32_FLOPS + tc_flops / PEAK_TF32_FLOPS) * 1e3
    return max(t_bytes, t_ops)


def tap_flops_per_point(C: int) -> int:
    return 2 * 12 * C  # 3 planes x 4 taps x C multiply-adds


def mlp_flops_per_point(C: int, HID: int) -> int:
    return 2 * (C * HID + HID * (C + 1))  # the decoder, counted once


def b1_work(planes, grid, w1, return_raw: bool = True):
    """(bytes, fp32 flops, tensor-core flops) of one `fused_render` call:
    planes [3, H, W, C] bf16, grid [3, R, S, 2] float32, w1 [C, HID]; the
    raw output [R·S, 1+C] bf16 (or colours and densities in float32)."""
    C, HID = w1[0], w1[1]
    points = grid[1] * grid[2]
    out_bytes = points * (1 + C) * (2 if return_raw else 4)
    nbytes = math.prod(grid) * 4 + math.prod(planes) * 2 + out_bytes
    return nbytes, points * tap_flops_per_point(C), points * mlp_flops_per_point(C, HID)


def b2_work(planes, proj_m, is_fine, coarse, w1, S: int):
    """(bytes, fp32 flops, tensor-core flops) of one `fused_merged_march`
    call: planes [3, H, W, C] bf16, proj_m [3, T, Sm, P, 2], is_fine [T, Sm]
    with Sm − S fine slots a tile (the merged list of the tile-pooled
    importance pass), the B1 raw rows `coarse` [T·S, P, 1+C] bf16."""
    C, HID = w1[0], w1[1]
    T, Sm = is_fine[0], is_fine[1]
    P = proj_m[3]
    n_fine_pts = T * (Sm - S) * P
    nbytes = (math.prod(coarse) * 2 + 3 * n_fine_pts * 2 * 4 + math.prod(planes) * 2
              + 3 * T * Sm * 4 + T * P * (C + 2) * 4)
    flops = n_fine_pts * tap_flops_per_point(C) + T * Sm * P * (3 * C + 12)
    return nbytes, flops, n_fine_pts * mlp_flops_per_point(C, HID)


def b3_work(planes, grid, payload_bytes: int):
    """(bytes, fp32 flops, tensor-core flops) of one `sample_planes_windowed`
    call: planes [N, H, W, C] sampled in a payload of `payload_bytes` per
    value, grid [N, R, S, 2] float32, output [N, R, S, C] in the payload."""
    N, C = planes[0], planes[3]
    n_pts = N * grid[1] * grid[2]
    nbytes = math.prod(grid) * 4 + math.prod(planes) * payload_bytes + n_pts * C * payload_bytes
    return nbytes, n_pts * 4 * C * 2, 0
