"""The port's native loader binding (`data/native_loader.py`, over
`native/loader.cpp` built into build/): PNG, `.npy` (float32, float16,
uint8) and batch decodes against PIL and numpy, exactly. Skips only where
g++ or libpng is missing, as the JAX package's loader test does."""

import os

import numpy as np
import PIL.Image
import pytest

from invertavatar_torch.data import native_loader


@pytest.fixture(scope="module")
def built():
    if not native_loader.available():
        pytest.skip("the native loader could not be built (no g++ or libpng)")
    return True


def test_library_is_built_outside_the_source_tree(built):
    path = native_loader.library_path()
    assert path.exists() and path.parent.name == "build"
    assert path.parent != native_loader.SRC.parent


def test_png_batch_decode(built, tmp_path):
    rng = np.random.RandomState(0)
    paths, refs = [], []
    for i in range(6):
        arr = rng.randint(0, 255, (32, 24, 3), np.uint8)
        PIL.Image.fromarray(arr).save(tmp_path / f"{i}.png")
        paths.append(str(tmp_path / f"{i}.png"))
        refs.append(arr)
    np.testing.assert_array_equal(native_loader.decode_png_batch(paths, 32, 24, 3, threads=4),
                                  np.stack(refs))
    with pytest.raises(IOError):
        native_loader.decode_png_batch(paths[:1] + [str(tmp_path / "missing.png")], 32, 24)


def test_npy_f32_f16_u8(built, tmp_path):
    rng = np.random.RandomState(1)
    arrays = {"a32": rng.randn(7, 5, 3).astype(np.float32), "a16": rng.randn(4, 6).astype(np.float16),
              "au8": rng.randint(0, 255, (3, 3), np.uint8)}
    for name, a in arrays.items():
        np.save(tmp_path / f"{name}.npy", a)
        got = native_loader.load_npy_f32(str(tmp_path / f"{name}.npy"))
        assert got.dtype == np.float32 and got.shape == a.shape
        np.testing.assert_array_equal(got, a.astype(np.float32))


def test_npy_batch(built, tmp_path):
    rng = np.random.RandomState(2)
    refs, paths = [], []
    for i in range(5):
        a = rng.randn(8, 8, 4).astype(np.float16)
        np.save(tmp_path / f"b{i}.npy", a)
        refs.append(a.astype(np.float32))
        paths.append(os.fspath(tmp_path / f"b{i}.npy"))
    np.testing.assert_array_equal(native_loader.load_npy_f32_batch(paths, (8, 8, 4), threads=3),
                                  np.stack(refs))
