"""The port's CLIs end to end on the CPU: `reenact` and `eval_seq` read
pickles in the reference's format (forged as in tests/test_torch_checkpoint.py)
and synthetic drive and source folders, and write an mp4.

`eval_seq` absorbs four source frames in two chunks of two and drives the
avatar twice: once online from FaceVerse coefficients (a synthetic model dict
of the published schema) and once from a stored `uvcoords_image`.
"""

import json
import os

import numpy as np
import pytest
import torch

from invertavatar_torch.cli import eval_seq, reenact
from invertavatar_torch.faceverse.synthetic import coeff_trajectory, synthetic_assets
from invertavatar_torch.flagship import example_inputs
from tests.test_torch_checkpoint import (  # noqa: F401  (a fixture)
    reference_pickler,
    tiny_generator,
    tiny_inversion_net,
    write_gan_pkl,
    write_inversion_pkl,
)

# one intra-op thread: the suite runs test files in parallel worker processes
torch.set_num_threads(1)


def _video_folder(root, n, seed, images=False, source_uv=False):
    """A preprocessed video: camera labels, stored uvcoords, FaceVerse
    coefficients and, if asked, 512² frames and the UV inputs of a source."""
    import PIL.Image

    rng = np.random.RandomState(seed)
    _, c, uvc = example_inputs(1)
    img_dir = root / "images512x512"
    mesh_dir = root / "orthRender256x256_face_eye"
    coeff_dir = root / "coeffs"
    uv_dir = root / "uvRender256x256"
    for d in (img_dir, mesh_dir, coeff_dir, uv_dir):
        d.mkdir(parents=True, exist_ok=True)
    coeffs = coeff_trajectory(n, seed=seed)
    labels = {}
    for i in range(n):
        stem = f"{i:08d}"
        labels[stem + ".png"] = c[0].tolist()
        np.save(mesh_dir / f"{stem}.npy", uvc[0].astype(np.float16))
        np.save(coeff_dir / f"{stem}.npy", coeffs[i])
        if images:
            PIL.Image.fromarray(rng.randint(0, 255, (512, 512, 3), np.uint8)).save(
                img_dir / f"{stem}.png")
        if source_uv:
            np.save(uv_dir / f"{stem}.npy", uvc[0])
            PIL.Image.fromarray(rng.randint(0, 255, (256, 256, 3), np.uint8)).save(
                uv_dir / f"{stem}_uvgttex.png")
    with open(img_dir / "dataset_realcam.json", "w") as f:
        json.dump({"labels": labels}, f)


def _faceverse_files(tmp_path):
    """A model dict of the published schema, pre-transform (the loader flips
    y and z, scales by 0.1 and lifts y by 1), and the two asset arrays."""
    a = synthetic_assets(n_grid=40, seed=2)
    ms = a.meanshape.reshape(-1, 3).copy()
    ms[:, 1] -= 1.0
    ms = ms / 0.1
    ms[:, [1, 2]] *= -1

    def raw_basis(b):
        b = (b / 0.1).reshape(-1, 3, b.shape[1])
        b[:, [1, 2]] *= -1
        return b.reshape(-1, b.shape[2])

    d = {"meanshape": ms.reshape(1, -1), "idBase": raw_basis(a.id_base),
         "exBase": raw_basis(a.exp_base), "uv_per_ver": a.uv_per_ver, "tri": a.tri,
         "ver_inds": np.array(a.ver_inds)}
    np.save(tmp_path / "faceverse_v3_1.npy", d, allow_pickle=True)
    assets = tmp_path / "fv_assets"
    assets.mkdir()
    fv2fl = np.eye(4, dtype=np.float32) * 0.6
    fv2fl[3, 3] = 1.0
    np.save(assets / "fv2fl_30.npy", fv2fl)
    np.save(assets / "v31_face_mask_new.npy", np.ones(a.uv_per_ver.shape[0], np.float32))
    return str(tmp_path / "faceverse_v3_1.npy"), str(assets)


def _video_written(outdir):
    vids = [f for f in os.listdir(outdir) if f.endswith(".mp4")]
    assert len(vids) == 1
    assert os.path.getsize(os.path.join(outdir, vids[0])) > 1000


def test_reenact_cli_writes_video(tmp_path, reference_pickler):
    write_gan_pkl(tmp_path / "gan.pkl", tiny_generator())
    _video_folder(tmp_path / "drive", 2, seed=0)
    reenact.main(["--network", str(tmp_path / "gan.pkl"), "--drive_root", str(tmp_path / "drive"),
                  "--seeds", "1,2", "--outdir", str(tmp_path / "out"), "--max_frames", "2",
                  "--device", "cpu"])
    _video_written(tmp_path / "out")


def test_eval_seq_cli_writes_video(tmp_path, reference_pickler, monkeypatch):
    """Two chunks absorbed (fresh, then carried GRU states), the drive frames
    online (FaceVerse coefficients) and stored."""
    write_inversion_pkl(tmp_path / "fs.pkl", tiny_inversion_net())
    _video_folder(tmp_path / "src", 4, seed=1, images=True, source_uv=True)
    _video_folder(tmp_path / "drive", 2, seed=2)
    os.remove(tmp_path / "drive" / "coeffs" / "00000001.npy")  # frame 1: stored uvcoords
    fv_model, fv_assets = _faceverse_files(tmp_path)

    calls = {"absorb": [], "online": 0}
    absorb, render = eval_seq.absorb_chunk, eval_seq.render_drive_frame

    def spy_absorb(net, avatar, images, uvs, cs, uvcoords, r_list=None, render_caches=None):
        calls["absorb"].append((images.shape[0], r_list))
        return absorb(net, avatar, images, uvs, cs, uvcoords, r_list, render_caches)

    def spy_render(*a, manager=None, coeff=None, **k):
        calls["online"] += manager is not None
        return render(*a, manager=manager, coeff=coeff, **k)

    monkeypatch.setattr(eval_seq, "absorb_chunk", spy_absorb)
    monkeypatch.setattr(eval_seq, "render_drive_frame", spy_render)
    try:
        eval_seq.main(["--network", str(tmp_path / "fs.pkl"), "--source_root",
                       str(tmp_path / "src"), "--drive_root", str(tmp_path / "drive"),
                       "--num_source_frames", "4", "--chunk", "2", "--outdir",
                       str(tmp_path / "out"), "--device", "cpu",
                       "--faceverse_model", fv_model, "--faceverse_assets", fv_assets])
    finally:
        os.remove(tmp_path / "fs.pkl")  # 1.1 GB: the e4e style heads are full width
    _video_written(tmp_path / "out")
    assert [n for n, _ in calls["absorb"]] == [2, 2]
    assert calls["absorb"][0][1] is None and len(calls["absorb"][1][1]) == 2
    assert calls["online"] == 1


def test_clis_default_to_the_card(tmp_path):
    """Without `--device cpu` both CLIs build on CUDA, and raise where there
    is none (before reading anything) rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    missing = str(tmp_path / "no.pkl")
    with pytest.raises(RuntimeError, match="CUDA"):
        reenact.main(["--network", missing, "--drive_root", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_seq.main(["--network", missing, "--source_root", str(tmp_path),
                       "--drive_root", str(tmp_path)])
