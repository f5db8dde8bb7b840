"""Build the package's CUDA sources with `nvcc` and load them with `ctypes`.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on first use
into `<repo>/build/` (listed in .gitignore), keyed by a hash of the source, so
an edited kernel is rebuilt and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# name -> (seconds spent compiling in this process, ptxas report)
BUILD_INFO: Dict[str, Tuple[float, str]] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")
    return nvcc


def library_path(name: str, src: Path | None = None) -> Path:
    src = Path(src) if src is not None else CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str, src: Path | None = None) -> Path:
    """Compile `csrc/<name>.cu` (or the source `src`, built as `name`) unless
    an up-to-date library exists."""
    src = Path(src) if src is not None else CSRC / f"{name}.cu"
    out = library_path(name, src)
    if out.exists():
        BUILD_INFO.setdefault(name, (0.0, "(cached)"))
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_INFO[name] = (time.perf_counter() - t0, proc.stderr.strip())
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu` once per process."""
    with _LOCK:
        if name not in _LOADED:
            _LOADED[name] = ctypes.CDLL(str(build(name)))
        return _LOADED[name]
