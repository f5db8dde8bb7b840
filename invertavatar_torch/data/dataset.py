"""Dataset readers for the preprocessed-dataset layout.

Counterpart of `invertavatar_tpu/data/dataset.py` (reference
`dataset_new.py`): the same on-disk layout, read with numpy and PIL on the
host (PIL is imported where an image is read):

    images512x512/<vid>/<frame>.png        RGB frames
    images512x512/dataset_realcam.json     {"labels": {fname: 25-dim c}} (16 c2w + 9 K)
    images512x512/dataset.json             {"labels": {fname: label}} (optional)
    orthRender256x256_face_eye/<f>.npy     uvcoords_image [256, 256, 3+]
    uvRender256x256/<f>.npy                uv_pverts [256, 256, 3]
    uvRender256x256/<f>_uvgttex.png        UV-space texture
    coeffs/<f>.npy                         FaceVerse coefficients

Items are HWC numpy arrays (uint8 images, float32 the rest); the training
loops scale images to [-1, 1] (`normalize_image`) and move batches to the
device. `VideoDataset` draws the few-shot stage's clips, frames of one video.
`InfiniteSampler` gives each rank its share of a seeded shuffled stream;
`prefetch_batches` assembles batches on a background thread.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np


def normalize_image(img_u8: np.ndarray) -> np.ndarray:
    """uint8 pixels -> float32 in [-1, 1]."""
    return img_u8.astype(np.float32) / 127.5 - 1.0


class AvatarDataset:
    """Frame-level dataset: image, 25-dim camera label (after any class
    labels), `uvcoords_image` (mask binarised at 0.5) and, with `load_uv`, the
    [256, 256, 6] UV input (texture ‖ UV vertex image)."""

    def __init__(self, path: str, mesh_path: Optional[str] = None, resolution: int = 512,
                 load_uv: bool = False, coeffs_path: Optional[str] = None,
                 uv_face_mask_path: Optional[str] = None):
        self.path = path
        self.mesh_path = mesh_path if mesh_path is not None else os.path.join(
            os.path.dirname(path.rstrip("/")), "orthRender256x256_face_eye")
        self.uv_path = path.replace("images512x512", "uvRender256x256")
        self.coeffs_path = coeffs_path
        self.resolution = resolution
        self.load_uv = load_uv
        with open(os.path.join(path, "dataset_realcam.json")) as f:
            cam_labels = dict(json.load(f)["labels"])
        self.fnames: List[str] = list(cam_labels)
        self.cams = np.asarray([cam_labels[f] for f in self.fnames], np.float32)
        label_path = os.path.join(path, "dataset.json")
        if os.path.exists(label_path):
            with open(label_path) as f:
                labels = dict(json.load(f)["labels"])
            self.labels = np.asarray([labels[f] for f in self.fnames], np.float32)
        else:
            self.labels = np.zeros((len(self.fnames), 0), np.float32)
        self.uv_face_mask = None
        if uv_face_mask_path and os.path.exists(uv_face_mask_path):
            import PIL.Image

            self.uv_face_mask = np.array(PIL.Image.open(uv_face_mask_path).convert("L"),
                                         np.float32) / 255.0

    def __len__(self) -> int:
        return len(self.fnames)

    @property
    def label_dim(self) -> int:
        return self.labels.shape[1] + self.cams.shape[1]

    def _image(self, fname: str) -> np.ndarray:
        import PIL.Image

        with open(os.path.join(self.path, fname), "rb") as f:
            img = PIL.Image.open(f)
            if img.size != (self.resolution, self.resolution):
                img = img.resize((self.resolution, self.resolution))
            arr = np.array(img)
        return arr[:, :, None] if arr.ndim == 2 else arr

    def get_label(self, idx: int) -> np.ndarray:
        return np.concatenate([self.labels[idx], self.cams[idx]], axis=-1)

    def get_vert(self, idx: int) -> Dict[str, np.ndarray]:
        """The frame's `uvcoords_image` (and `coeff` with `coeffs_path`)."""
        npy = os.path.splitext(self.fnames[idx])[0] + ".npy"
        uvc = np.load(os.path.join(self.mesh_path, npy)).astype(np.float32)[..., :3]
        uvc[..., -1] = (uvc[..., -1] >= 0.5).astype(np.float32)
        out = {"uvcoords_image": uvc}
        if self.coeffs_path is not None:
            out["coeff"] = np.load(os.path.join(self.coeffs_path, npy)).astype(np.float32)
        return out

    def get_uv(self, idx: int) -> np.ndarray:
        """[256, 256, 6] = (UV texture in [-1, 1] ‖ UV vertex image, its mask
        times the UV face mask)."""
        import PIL.Image

        stem = os.path.splitext(self.fnames[idx])[0]
        uv_pverts = np.load(os.path.join(self.uv_path, stem + ".npy")).astype(np.float32)
        if self.uv_face_mask is not None:
            uv_pverts[..., -1] *= self.uv_face_mask
        with open(os.path.join(self.uv_path, stem + "_uvgttex.png"), "rb") as f:
            uv_gttex = normalize_image(np.array(PIL.Image.open(f)))
        return np.concatenate([uv_gttex, uv_pverts], axis=-1)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        out = {"image": self._image(self.fnames[idx]), "c": self.get_label(idx),
               **self.get_vert(idx)}
        if self.load_uv:
            out["uv"] = self.get_uv(idx)
        return out


class VideoDataset(AvatarDataset):
    """Per-video frame sampling for the few-shot stage: the frames of a
    video are the files under one top folder (`<vid>/<frame>.png`), in name
    order; UV inputs are always loaded."""

    def __init__(self, *args, frm_per_vid: int = 4, **kwargs):
        super().__init__(*args, load_uv=True, **kwargs)
        self.frm_per_vid = frm_per_vid
        videos: Dict[str, List[int]] = {}
        for idx, fname in enumerate(self.fnames):
            videos.setdefault(fname.split("/")[0], []).append(idx)
        self.videos = [sorted(v, key=lambda i: self.fnames[i]) for v in videos.values()]

    @property
    def num_videos(self) -> int:
        return len(self.videos)

    def sample_clip(self, vidx: int, rng: np.random.RandomState,
                    T: Optional[int] = None) -> Dict[str, np.ndarray]:
        """T frames (default `frm_per_vid`) of video `vidx` drawn uniformly
        with replacement: {"image" [T, H, W, 3] in [-1, 1], "c" [T, 25(+)],
        "uvcoords_image" [T, 256, 256, 3], "uv" [T, 256, 256, 6]}."""
        frames = self.videos[vidx]
        picks = [frames[i] for i in rng.uniform(0.0, len(frames), size=T or self.frm_per_vid)
                 .astype(np.int32)]
        return {"image": np.stack([normalize_image(self._image(self.fnames[i])) for i in picks]),
                "c": np.stack([self.get_label(i) for i in picks]).astype(np.float32),
                "uvcoords_image": np.stack([self.get_vert(i)["uvcoords_image"] for i in picks]),
                "uv": np.stack([self.get_uv(i) for i in picks])}


class InfiniteSampler:
    """A seeded endless shuffled index stream with a sliding-window reshuffle;
    rank `rank` of `num_replicas` takes every `num_replicas`-th index."""

    def __init__(self, dataset_size: int, rank: int = 0, num_replicas: int = 1,
                 shuffle: bool = True, seed: int = 0, window_size: float = 0.5):
        assert dataset_size > 0 and 0 <= rank < num_replicas
        self.size = dataset_size
        self.rank = rank
        self.num_replicas = num_replicas
        self.shuffle = shuffle
        self.seed = seed
        self.window_size = window_size

    def __iter__(self) -> Iterator[int]:
        order = np.arange(self.size)
        rnd = None
        window = 0
        if self.shuffle:
            rnd = np.random.RandomState(self.seed)
            rnd.shuffle(order)
            window = int(np.rint(order.size * self.window_size))
        idx = 0
        while True:
            i = idx % order.size
            if idx % self.num_replicas == self.rank:
                yield int(order[i])
            if window >= 2:
                j = (i - rnd.randint(window)) % order.size
                order[i], order[j] = order[j], order[i]
            idx += 1


def prefetch_batches(dataset, sampler: InfiniteSampler, batch_size: int, prefetch: int = 2,
                     collate=None):
    """Endless batches of `batch_size` items in the sampler's order, built by
    a daemon thread up to `prefetch` ahead; `collate` (default: stack each
    key) turns a list of items into a batch."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    it = iter(sampler)

    def stack(items):
        return {k: np.stack([item[k] for item in items]) for k in items[0]}

    collate = collate or stack

    def worker():
        while True:
            q.put(collate([dataset[next(it)] for _ in range(batch_size)]))

    threading.Thread(target=worker, daemon=True).start()
    while True:
        yield q.get()
