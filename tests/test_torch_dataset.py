"""The port's dataset reader, sampler and batch prefetcher against the JAX
package's on a synthetic preprocessed folder, and `cli/train_gan.py`'s
wiring on the CPU.

The readers must give equal arrays (exact: the same numpy and PIL calls),
and the samplers the same index streams for each rank.
"""

import json
import os

import numpy as np
import torch

from invertavatar_torch.cli import train_gan as cli
from invertavatar_torch.data import dataset as pd
from tests.test_torch_cli import _video_folder

# one intra-op thread: the suite runs test files in parallel worker processes
torch.set_num_threads(1)


def test_avatar_dataset_matches_jax(tmp_path):
    """Items (image, label, uvcoords, coefficients, UV input) of a 3-frame
    folder with class labels and a UV face mask."""
    import PIL.Image

    from invertavatar_tpu.data import dataset as jd

    _video_folder(tmp_path, 3, seed=0, images=True, source_uv=True)
    img_dir = tmp_path / "images512x512"
    with open(img_dir / "dataset.json", "w") as f:
        json.dump({"labels": {f"{i:08d}.png": [float(i), 1.0] for i in range(3)}}, f)
    PIL.Image.fromarray(np.random.RandomState(1).randint(0, 255, (256, 256), np.uint8)).save(
        tmp_path / "mask.png")
    kw = dict(resolution=256, load_uv=True, coeffs_path=str(tmp_path / "coeffs"),
              uv_face_mask_path=str(tmp_path / "mask.png"))
    port, ref = pd.AvatarDataset(str(img_dir), **kw), jd.AvatarDataset(str(img_dir), **kw)
    assert len(port) == len(ref) == 3 and port.label_dim == ref.label_dim == 27
    for i in range(3):
        a, b = port[i], ref[i]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype, k
    np.testing.assert_array_equal(pd.normalize_image(np.arange(256, dtype=np.uint8)),
                                  jd.normalize_image(np.arange(256, dtype=np.uint8)))


def test_sampler_and_prefetch_match_jax():
    """Each rank's index stream of two replicas, shuffled with a window, and
    the prefetched batches."""
    from invertavatar_tpu.data import dataset as jd

    for rank in (0, 1):
        a = iter(pd.InfiniteSampler(10, rank=rank, num_replicas=2, seed=3))
        b = iter(jd.InfiniteSampler(10, rank=rank, num_replicas=2, seed=3))
        assert [next(a) for _ in range(25)] == [next(b) for _ in range(25)]
    data = [{"x": np.full((2,), i, np.float32)} for i in range(7)]
    batches = pd.prefetch_batches(data, pd.InfiniteSampler(7, seed=1), 3)
    order = iter(pd.InfiniteSampler(7, seed=1))
    for _ in range(3):
        np.testing.assert_array_equal(next(batches)["x"][:, 0], [next(order) for _ in range(3)])


def test_train_gan_cli_builds_and_writes_options(tmp_path, capsys):
    """`--dry-run` prints the resolved options (the 48+48 training budget);
    a run of 0 kimg on the CPU builds the models, the dataset and the loop
    and writes `training_options.json`."""
    cli.main(["--outdir", str(tmp_path / "dry"), "--data", str(tmp_path), "--dry-run"])
    opts = json.loads(capsys.readouterr().out)
    assert opts["rendering_kwargs"]["depth_resolution"] == 48
    assert opts["rendering_kwargs"]["depth_resolution_importance"] == 48
    _video_folder(tmp_path / "data", 2, seed=0, images=True)
    cli.main(["--outdir", str(tmp_path / "run"), "--data", str(tmp_path / "data" /
                                                               "images512x512"),
              "--kimg", "0", "--cbase", "1024", "--cmax", "64", "--batch", "2",
              "--device", "cpu"])
    with open(tmp_path / "run" / "training_options.json") as f:
        assert json.load(f)["batch_size"] == "2"
    assert os.path.exists(tmp_path / "run" / "stats.jsonl")
