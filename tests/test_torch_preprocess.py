"""The port's dataset preparation (`data/preprocess.py`) against the JAX
package: the host half bitwise (the same numpy, scipy and json calls), the
device half on a small synthetic FaceVerse grid within the driving-signal
band of `tests/test_torch_faceverse.py`: where either side covers a pixel,
|port − JAX| ≤ 1e-4 on ≥ 99.9% of them and ≤ 1e-3 on all; the uint8
textures equal on ≥ 99.9% of pixels and within one level on all (the
truncation to uint8 may fall either way of an integer).
"""

import json
import os

import numpy as np
import torch

from invertavatar_torch.data import preprocess as pp
from invertavatar_torch.faceverse.model import FaceVerseModel
from invertavatar_torch.faceverse.synthetic import (COEFF_DIM, synthetic_assets,
                                                    synthetic_manager, uv_model_dict)
from invertavatar_tpu.data import preprocess as jp

torch.set_num_threads(1)

N_GRID = 24


def _band(got, ref, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    face = (np.abs(got).max(-1) > 0) | (np.abs(ref).max(-1) > 0)
    assert face.sum() > 100, what
    d = np.abs(got - ref).max(-1)[face]
    assert (d <= 1e-4).mean() >= 0.999 and d.max() <= 1e-3, (what, (d <= 1e-4).mean(), d.max())


def _texture_band(got, ref):
    d = np.abs(np.asarray(got, np.int16) - np.asarray(ref, np.int16))
    assert (d == 0).mean() >= 0.999 and d.max() <= 1, ((d == 0).mean(), d.max())


def test_align_quad_and_smoothing_match_jax_bitwise():
    rng = np.random.RandomState(0)
    for _ in range(3):
        lm = rng.rand(5, 2) * 400 + 50
        np.testing.assert_array_equal(pp.align_quad(lm.copy()), jp.align_quad(lm.copy()))
    seq = rng.rand(12, 5, 2) * 512
    for sigma in (0.0, 3.0):
        np.testing.assert_array_equal(pp.smooth_landmark_sequence(seq, sigma),
                                      jp.smooth_landmark_sequence(seq, sigma))
    uv = rng.rand(200, 2).astype(np.float32)
    for a, b in zip(pp.expand_uv_islands(uv), jp.expand_uv_islands(uv)):
        np.testing.assert_array_equal(a, b)


def test_align_image_matches_jax_bitwise():
    import PIL.Image

    rng = np.random.RandomState(1)
    img = PIL.Image.fromarray(rng.randint(0, 255, (96, 96, 3), np.uint8))
    lm = np.array([[30, 35], [62, 34], [47, 50], [35, 68], [60, 67]], np.float64)
    frames = [img, img.rotate(5)]
    lms = np.stack([lm, lm + 1.5])
    got = pp.align_video_frames(frames, lms, output_size=32, smooth_sigma=1.0)
    ref = jp.align_video_frames(frames, lms, output_size=32, smooth_sigma=1.0)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_write_dataset_json_byte_identical(tmp_path):
    rng = np.random.RandomState(2)
    labels = {f"{i:05d}.png": rng.randn(25).astype(np.float32) for i in range(4)}
    extra = {f"{i:05d}.png": rng.randn(25) for i in range(2)}
    for ex in (None, extra):
        pp.write_dataset_json(str(tmp_path / "p"), labels, ex)
        jp.write_dataset_json(str(tmp_path / "j"), labels, ex)
        for name in ("dataset_realcam.json", "dataset.json"):
            a = (tmp_path / "p" / name).read_bytes()
            assert a == (tmp_path / "j" / name).read_bytes(), name
        assert len(json.loads(a)["labels"]) == (2 if ex else 4)


def _models():
    """The port's and JAX's FaceVerse models over one small synthetic grid,
    its uvRender model dict, and frame coefficients with unit scale (the
    head about 100 pixels across in the 512² frame)."""
    from invertavatar_tpu.faceverse.model import FaceVerseAssets, FaceVerseModel as JaxModel

    assets = synthetic_assets(N_GRID, seed=3)
    rng = np.random.RandomState(3)
    coeffs = (rng.randn(2, COEFF_DIM) * 0.1).astype(np.float32)
    coeffs[:, -1] = 1.0 + rng.randn(2) * 0.05
    return (FaceVerseModel(assets, device="cpu"), JaxModel(FaceVerseAssets(*assets)),
            uv_model_dict(assets), coeffs)


def test_uv_raster_and_maps_match_jax():
    """`build_uv_raster` once, then `uv_pverts_map` (with and without the
    static face/eye mask) and `uv_gttex_image` for two frames."""
    pm_, jm_, md, coeffs = _models()
    V = md["uv_per_ver"].shape[0]
    vert_mask = (np.random.RandomState(4).rand(V) > 0.1).astype(np.float32)
    raster, mask = pp.build_uv_raster(md["uv_per_ver"], md["tri"], vert_mask, device="cpu")
    jraster, jmask = jp.build_uv_raster(md["uv_per_ver"], md["tri"], vert_mask)
    np.testing.assert_array_equal(mask, jmask)
    hit, jhit = raster.face_id.numpy() >= 0, np.asarray(jraster.face_id) >= 0
    np.testing.assert_array_equal(hit, jhit)
    assert (raster.face_id.numpy() == np.asarray(jraster.face_id)).mean() >= 0.999
    K = pp.uv_camera_intrinsics()
    eye_mask = (np.random.RandomState(5).rand(256, 256) > 0.3).astype(np.float32)
    frames = np.random.RandomState(6).rand(2, 512, 512, 3).astype(np.float32)
    for i, static in enumerate((None, eye_mask)):
        with torch.no_grad():
            got = pp.uv_pverts_map(pm_, coeffs[i], raster, md["tri"], mask, md["point_buf"], K,
                                   uv_face_eye_mask=static)
        ref = jp.uv_pverts_map(jm_, coeffs[i], jraster, md["tri"], jmask, md["point_buf"], K,
                               uv_face_eye_mask=static)
        assert got.dtype == torch.float32 and (got[..., 2] > 0.5).sum() > 100
        _band(got, ref, f"uv_pverts frame {i}")
        tex = pp.uv_gttex_image(torch.from_numpy(frames[i].transpose(2, 0, 1).copy()), got)
        assert tex.dtype == torch.uint8 and tex.shape == (256, 256, 3)
        _texture_band(tex.numpy(), jp.uv_gttex_image(frames[i], got.numpy()))


def test_render_uv_for_video_matches_jax(tmp_path):
    """The uvRender directory: fp16 `.npy` maps and `_uvgttex.png` textures,
    the byte layout of the dataset, against JAX's files."""
    import PIL.Image

    pm_, jm_, md, coeffs = _models()
    V = md["uv_per_ver"].shape[0]
    coeff_paths, image_paths = [], []
    for i, c in enumerate(coeffs):
        np.save(tmp_path / f"{i:04d}.npy", c)
        PIL.Image.fromarray(np.random.RandomState(i).randint(0, 255, (512, 512, 3), np.uint8)
                            ).save(tmp_path / f"{i:04d}.png")
        coeff_paths.append(str(tmp_path / f"{i:04d}.npy"))
        image_paths.append(str(tmp_path / f"{i:04d}.png"))
    pp.render_uv_for_video(pm_, md, np.ones(V, np.float32), coeff_paths, image_paths,
                           str(tmp_path / "p"))
    jp.render_uv_for_video(jm_, md, np.ones(V, np.float32), coeff_paths, image_paths,
                           str(tmp_path / "j"))
    for i in range(len(coeffs)):
        got, ref = np.load(tmp_path / "p" / f"{i:04d}.npy"), np.load(tmp_path / "j" / f"{i:04d}.npy")
        assert got.dtype == ref.dtype == np.float16 and got.shape == (256, 256, 3)
        _band(got.astype(np.float32), ref.astype(np.float32), f"npy {i}")
        tex = np.asarray(PIL.Image.open(tmp_path / "p" / f"{i:04d}_uvgttex.png"))
        assert tex.dtype == np.uint8 and tex.shape == (256, 256, 3)
        _texture_band(tex, np.asarray(PIL.Image.open(tmp_path / "j" / f"{i:04d}_uvgttex.png")))


def test_render_uvcoords_for_video_matches_jax(tmp_path):
    """The orthRender256x256_face_eye `.npy` files (fp16) from coefficient
    files, through each package's manager, within the band."""
    from invertavatar_tpu.faceverse.synthetic import synthetic_manager as jax_manager

    mgr, bank = synthetic_manager(n_grid=N_GRID, seed=7, device="cpu")
    jmgr, _ = jax_manager(n_grid=N_GRID, seed=7)
    paths = []
    for i in range(3):
        np.save(tmp_path / f"{i:04d}.npy", bank[i + 1])
        paths.append(str(tmp_path / f"{i:04d}.npy"))
    pp.render_uvcoords_for_video(mgr, paths, str(tmp_path / "p"))
    jp.render_uvcoords_for_video(jmgr, paths, str(tmp_path / "j"))
    for i in range(3):
        got, ref = np.load(tmp_path / "p" / f"{i:04d}.npy"), np.load(tmp_path / "j" / f"{i:04d}.npy")
        assert got.dtype == np.float16 and got.shape == (256, 256, 3)
        _band(got.astype(np.float32), ref.astype(np.float32), f"uvcoords {i}")
