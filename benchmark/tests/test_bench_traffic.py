"""The traffic generator repeats exactly by seed, and another seed draws
other inputs of the same sizes."""

import numpy as np
import torch

from benchmark.lib import registry
from benchmark.tests.tiny import TINY_CONFIG
from benchmark.run import _merge
from benchmark.traffic.generate import make_inputs


def _flat(inputs):
    out = {}
    for k, v in inputs.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in _flat(v).items()})
        else:
            out[k] = v
    return out


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return np.array_equal(np.asarray(a), np.asarray(b))


def test_inputs_repeat_by_seed():
    big = 2 ** 31 + 12345  # seeds may pass 32 signed bits
    for cell, conf in (("ani3dgan512-live4", "ani3dgan512"), ("next3d-live1", "next3d")):
        wl = registry.workload(cell)
        cfg = _merge(registry.config(conf), TINY_CONFIG[conf])
        mix = registry.traffic(wl["traffic"])
        a, b = (_flat(make_inputs(mix, cfg, big, "cpu")) for _ in range(2))
        c = _flat(make_inputs(mix, cfg, big + 1, "cpu"))
        assert a.keys() == b.keys() == c.keys()
        assert all(_same(a[k], b[k]) for k in a), cell
        moving = [k for k in a if isinstance(a[k], torch.Tensor) and a[k].is_floating_point()]
        assert all(a[k].shape == c[k].shape for k in moving)
        assert not any(torch.equal(a[k], c[k]) for k in moving if k != "cond_c"), cell


def test_trajectories_move_smoothly():
    cfg = _merge(registry.config("ani3dgan512"), TINY_CONFIG["ani3dgan512"])
    inp = make_inputs(registry.traffic("grid10"), cfg, 3, "cpu")
    cams = inp["cameras"][0]
    assert inp["z"].shape == (10, 512) and cams.shape == (600, 25)
    step = (cams[1:] - cams[:-1]).abs().max()
    assert 0 < step < 0.05
