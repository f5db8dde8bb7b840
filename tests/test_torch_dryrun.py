"""The port's data-parallel dry runs (`invertavatar_torch/train/dryrun.py`) on
the CPU: each spawns 2 gloo ranks (a `FileStore` in a temporary directory,
one intra-op thread a rank) that take their rows of a global batch and run
one whole step, then assert finite losses, the batch sharded by rank and
the parameters bitwise equal across ranks.

Both run with `device="cpu"`: without it they build on CUDA and raise
where there is none (`test_dryruns_default_to_the_card`).

`run_dryrun(2)` (the GAN step with the density TV, R1, the lazy-reg Adams and
the EMA) is in Tier-1 (~20 s); `run_dryrun_inversion(2)` (a tiny few-shot
`InversionNet`, whose U-Nets work at 256² with IR-SE widths) is slow."""

import numpy as np
import pytest
import torch

from invertavatar_torch.train.dryrun import run_dryrun, run_dryrun_inversion

torch.set_num_threads(1)


def test_run_dryrun_two_ranks():
    res = run_dryrun(2, device="cpu")
    assert len(res) == 2
    for metrics in res:
        assert {"Loss/G/loss", "Loss/G/reg", "Loss/D/loss", "Loss/r1_penalty"} <= set(metrics)
        assert all(np.isfinite(v) for v in metrics.values())
    # each rank scored its own item: the ranks' losses differ
    assert res[0]["Loss/G/loss"] != res[1]["Loss/G/loss"]


@pytest.mark.slow
def test_run_dryrun_inversion_two_ranks():
    res = run_dryrun_inversion(2, device="cpu")
    assert len(res) == 2
    for aux in res:
        assert "Ireal/l1" in aux and all(np.isfinite(v) for v in aux.values())


def test_dryruns_default_to_the_card(monkeypatch):
    """Called without a device both dry runs build on CUDA, and raise where
    there is none (before spawning a rank) rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_dryrun(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_dryrun_inversion(2)
