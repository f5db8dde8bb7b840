"""Shared CLI helpers: drive-data loading, video writing, image grids.

Counterpart of `invertavatar_tpu/cli/common.py`. The image and video
libraries (PIL, cv2, imageio) are imported inside the functions that use
them: the rest of the CLIs' code runs where they are not installed.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..data.dataset import normalize_image


def load_drive_sequence(drive_root: str, max_frames: Optional[int] = None) -> List[Dict]:
    """The frames of a preprocessed drive (or source) video: the
    `images512x512/dataset_realcam.json` labels, the per-frame
    `orthRender256x256_face_eye/*.npy` uvcoords (mask binarised at 0.5) and,
    where present, `coeffs/*.npy` and the image path."""
    img_dir = os.path.join(drive_root, "images512x512")
    mesh_dir = os.path.join(drive_root, "orthRender256x256_face_eye")
    coeff_dir = os.path.join(drive_root, "coeffs")
    with open(os.path.join(img_dir, "dataset_realcam.json")) as f:
        labels = dict(json.load(f)["labels"])
    fnames = sorted(labels)
    if max_frames:
        fnames = fnames[:max_frames]
    frames = []
    for fname in fnames:
        stem = os.path.splitext(fname)[0]
        item: Dict = {"c": np.asarray(labels[fname], np.float32)[None], "name": stem}
        uv_path = os.path.join(mesh_dir, stem + ".npy")
        if os.path.exists(uv_path):
            uvc = np.load(uv_path).astype(np.float32)[..., :3]
            uvc[..., -1] = (uvc[..., -1] >= 0.5).astype(np.float32)
            item["uvcoords_image"] = uvc[None]
        cpath = os.path.join(coeff_dir, stem + ".npy")
        if os.path.exists(cpath):
            item["coeff"] = np.load(cpath).astype(np.float32)
        img_path = os.path.join(img_dir, fname)
        if os.path.exists(img_path):
            item["image_path"] = img_path
        frames.append(item)
    return frames


def to_uint8(img) -> np.ndarray:
    """[-1, 1] NCHW image (tensor or array) -> uint8 HWC of the first item."""
    arr = img[0].detach().float().cpu().numpy() if hasattr(img, "detach") else np.asarray(img[0])
    return np.clip((np.transpose(arr, (1, 2, 0)) + 1) * 127.5, 0, 255).astype(np.uint8)


def layout_grid(images: List[np.ndarray], grid_wh: Tuple[int, int]) -> np.ndarray:
    """Tile [H, W, 3] uint8 images into a gw × gh grid."""
    gw, gh = grid_wh
    H, W, C = images[0].shape
    grid = np.zeros((gh * H, gw * W, C), np.uint8)
    for i, img in enumerate(images[:gw * gh]):
        r, col = divmod(i, gw)
        grid[r * H:(r + 1) * H, col * W:(col + 1) * W] = img
    return grid


class VideoWriter:
    """mp4 writer: cv2 (mp4v), else imageio."""

    def __init__(self, path: str, fps: int = 25):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._path = path
        self._fps = fps
        self._w = None
        self._backend = None

    def _open(self, frame: np.ndarray):
        h, w = frame.shape[:2]
        try:
            import cv2
        except ImportError:
            cv2 = None
        if cv2 is not None:
            writer = cv2.VideoWriter(self._path, cv2.VideoWriter_fourcc(*"mp4v"), self._fps, (w, h))
            if writer.isOpened():
                self._w, self._backend = writer, "cv2"
                return
        import imageio

        self._w, self._backend = imageio.get_writer(self._path, fps=self._fps), "imageio"

    def append(self, frame: np.ndarray):
        if self._w is None:
            self._open(frame)
        if self._backend == "cv2":
            self._w.write(np.ascontiguousarray(frame[..., ::-1]))  # RGB -> BGR
        else:
            self._w.append_data(frame)

    def close(self):
        if self._w is None:
            return
        if self._backend == "cv2":
            self._w.release()
        else:
            self._w.close()


def load_image(path: str, resolution: int = 512) -> np.ndarray:
    """An RGB image file -> [1, 3, resolution, resolution] float32 in [-1, 1]."""
    import PIL.Image

    img = PIL.Image.open(path).convert("RGB")
    if img.size != (resolution, resolution):
        img = img.resize((resolution, resolution))
    return np.transpose(normalize_image(np.asarray(img)), (2, 0, 1))[None]
