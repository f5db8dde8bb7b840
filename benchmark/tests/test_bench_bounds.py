"""The kernel bound functions reproduce the bounds PERF.md's kernel table
records (chip_smoke.py phases 3 and 27c)."""

import pytest

from benchmark.lib import bounds


def test_b1_coarse_bound():
    nbytes, flops, tc = bounds.b1_work((3, 256, 256, 32), (3, 16384, 40, 2), (32, 64), True)
    assert round(nbytes / 1e6, 1) == 71.6
    assert round(tc / 1e9, 2) == 5.45 and round(flops / 1e9, 2) == 0.50
    assert bounds.bound_ms(nbytes, flops, tc) == pytest.approx(0.0214, abs=5e-5)


def test_b3_next3d_bf16_bound():
    nbytes, flops, tc = bounds.b3_work((3, 256, 256, 32), (3, 16384, 48, 2), 2)
    assert round(nbytes / 1e6, 1) == 182.5
    assert bounds.bound_ms(nbytes, flops, tc) == pytest.approx(0.0545, abs=5e-5)


def test_b2_counts_fine_slots_only():
    # 24 fine slots of 64 in each of 1,024 tiles of 16 rays
    nbytes, flops, tc = bounds.b2_work((3, 256, 256, 32), (3, 1024, 64, 16, 2), (1024, 64),
                                       (1024 * 40, 16, 33), (32, 64), S=40)
    assert tc == 1024 * 24 * 16 * bounds.mlp_flops_per_point(32, 64)
    assert bounds.bound_ms(nbytes, flops, tc) > 0
