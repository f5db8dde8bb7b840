"""The port's `StatsLogger` sinks (`invertavatar_torch/utils/stats.py`) on
the CPU: after one tick the TensorBoard event file, read back through
`tensorboard.backend.event_processing`, holds the means that `stats.jsonl`
holds (float32 in the event file: 1e-6 relative), and the JAX package's
logger writes the same `stats.jsonl` entry for the same reports."""

import json
import os
import shutil

import numpy as np
import pytest

from invertavatar_torch.utils.stats import Collector, StatsLogger

REPORTS = [("Loss/G/loss", [0.25, 1.5, -2.0]), ("Loss/D/loss", 3.125),
           ("Loss/G/loss", [4.0]), ("Progress/tick", 7)]


@pytest.fixture
def _drop_tmp_path(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _tick(logger_cls, run_dir, step, **kw):
    col = Collector()
    for name, v in REPORTS:
        col.report(name, v)
    col.update()
    logger = logger_cls(str(run_dir), **kw)
    logger.write(col, step)
    logger.close()
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        return logger, [json.loads(line) for line in f]


def test_tensorboard_event_file_holds_the_jsonl_means(_drop_tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    from tensorboard.backend.event_processing import event_accumulator

    logger, lines = _tick(StatsLogger, _drop_tmp_path, 12)
    assert logger.tensorboard is not None
    (entry,) = lines
    assert entry["step"] == 12
    acc = event_accumulator.EventAccumulator(str(_drop_tmp_path))
    acc.Reload()
    tags = acc.Tags()["scalars"]
    names = sorted(k for k in entry if k not in ("step", "timestamp"))
    assert sorted(tags) == names == ["Loss/D/loss", "Loss/G/loss", "Progress/tick"]
    for name in names:
        (ev,) = acc.Scalars(name)
        assert ev.step == 12
        np.testing.assert_allclose(ev.value, entry[name]["mean"], rtol=1e-6, err_msg=name)


def test_without_tensorboard_only_jsonl_is_written_as_in_jax(_drop_tmp_path):
    from invertavatar_tpu.utils.stats import StatsLogger as JStatsLogger

    logger, (entry,) = _tick(StatsLogger, _drop_tmp_path / "port", 3, use_tensorboard=False)
    assert logger.tensorboard is None
    assert os.listdir(_drop_tmp_path / "port") == ["stats.jsonl"]
    _, (ref,) = _tick(JStatsLogger, _drop_tmp_path / "jax", 3, use_tensorboard=False)
    for e in (entry, ref):
        e.pop("timestamp")
    assert entry == ref
