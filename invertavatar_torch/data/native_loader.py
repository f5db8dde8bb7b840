"""ctypes binding of the native C++ batch loader (`native/loader.cpp`).

Counterpart of `invertavatar_tpu/data/native_loader.py`, over the same C
ABI: a thread pool decodes PNG frames and parses `.npy` tensors straight
into numpy buffers. The library is built with g++ on first use into the
repository's `build/` directory (keyed by a hash of the source, as
`utils/cuda_build.py` keys the CUDA kernels), never beside the source. Where
g++ or libpng is missing, `available()` is False and callers keep the
PIL/numpy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

SRC = Path(__file__).resolve().parents[2] / "native" / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
GXX_LIBS = ["-lpng", "-lz", "-lpthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS + GXX_LIBS).encode())
    return BUILD_DIR / f"libiatpu_loader_{digest.hexdigest()[:16]}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp), *GXX_LIBS],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SRC}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: each concurrent build writes its own tmp
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, RuntimeError) as e:  # no g++, no libpng headers, or no loader
            _build_error = str(e)
            return None
        c_char_pp = ctypes.POINTER(ctypes.c_char_p)
        lib.iatpu_decode_png.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte),
                                         ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.iatpu_decode_png.restype = ctypes.c_int
        lib.iatpu_decode_png_batch.argtypes = [c_char_pp, ctypes.c_int,
                                               ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
                                               ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.iatpu_decode_png_batch.restype = ctypes.c_int
        lib.iatpu_load_npy_f32.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                           ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
                                           ctypes.POINTER(ctypes.c_int)]
        lib.iatpu_load_npy_f32.restype = ctypes.c_int
        lib.iatpu_load_npy_f32_batch.argtypes = [c_char_pp, ctypes.c_int,
                                                 ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                                                 ctypes.c_int]
        lib.iatpu_load_npy_f32_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library built and loaded (False without g++ or libpng)."""
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native loader is unavailable: {_build_error}")
    return lib


def _paths(paths: List[str]):
    return (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])


def decode_png_batch(paths: List[str], h: int, w: int, c: int = 3,
                     threads: int = 8) -> np.ndarray:
    """Decode PNGs of h × w in parallel -> [N, h, w, c] uint8."""
    lib = _require()
    out = np.empty((len(paths), h, w, c), np.uint8)
    ret = lib.iatpu_decode_png_batch(_paths(paths), len(paths),
                                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                                     h, w, c, threads)
    if ret != 0:
        raise IOError(f"native PNG batch decode failed ({ret}) for {paths[:2]}...")
    return out


def load_npy_f32(path: str, max_elems: int = 1 << 26) -> np.ndarray:
    """One `.npy` (float32, float16 or uint8) as float32, of at most
    `max_elems` elements."""
    lib = _require()
    buf = np.empty(max_elems, np.float32)
    shape = (ctypes.c_int64 * 8)()
    ndim = ctypes.c_int()
    ret = lib.iatpu_load_npy_f32(os.fsencode(path),
                                 buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_elems,
                                 shape, ctypes.byref(ndim))
    if ret != 0:
        raise IOError(f"native npy load failed ({ret}): {path}")
    shp = tuple(shape[i] for i in range(ndim.value))
    return buf[:int(np.prod(shp))].reshape(shp).copy()


def load_npy_f32_batch(paths: List[str], item_shape, threads: int = 8) -> np.ndarray:
    """`.npy` files of one shape, in parallel -> [N, *item_shape] float32."""
    lib = _require()
    out = np.empty((len(paths),) + tuple(item_shape), np.float32)
    ret = lib.iatpu_load_npy_f32_batch(_paths(paths), len(paths),
                                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                       int(np.prod(item_shape)), threads)
    if ret != 0:
        raise IOError(f"native npy batch load failed ({ret})")
    return out
