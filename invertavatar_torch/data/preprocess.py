"""Offline dataset preparation (reference data_preprocess/ chain).

Counterpart of `invertavatar_tpu/data/preprocess.py`. The reference runs
frame extraction, MTCNN 5-point landmarks, a smoothed FFHQ-style crop
(`align_in_the_wild.py`), FaceVerse fitting (an external tool) and the
dataset assembly (`make_dataset_pipe.py`). Landmark detection and the 3DMM
fit stay external; this module holds what surrounds them:

  * host side (numpy, scipy; PIL imported where an image is read or
    written): `align_quad` / `align_image`, the 5-point FFHQ alignment;
    `smooth_landmark_sequence` / `align_video_frames`, per-video Gaussian
    smoothing of the landmark tracks; `write_dataset_json`, the
    `dataset_realcam.json` / `dataset.json` labels;
  * device side, through the port's FaceVerse model and rasterizer on the
    card: `render_uvcoords_for_video` (the `orthRender256x256_face_eye`
    `.npy` files from fitted coefficients) and the uvRender step
    (`build_uv_raster`, `uv_pverts_map`, `uv_gttex_image`,
    `render_uv_for_video`: the `uv_pverts` fp16 `.npy` files and the
    `*_uvgttex.png` textures).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
from scipy.ndimage import gaussian_filter1d

from ..faceverse.model import compute_norm, project_vs, rigid_transform
from ..ops.grid_sample import grid_sample
from ..render.rasterizer import RasterOut, face_vertices, interpolate_attributes, rasterize
from ..utils.misc import resolve_device


def align_quad(lm5p: np.ndarray) -> np.ndarray:
    """5-point landmarks (left eye, right eye, nose, left mouth, right mouth)
    -> the source quad [4, 2] (FFHQ alignment geometry)."""
    eye_left, eye_right = lm5p[0], lm5p[1]
    mouth_left, mouth_right = lm5p[3], lm5p[4]
    eye_avg = (eye_left + eye_right) * 0.5
    eye_to_eye = eye_right - eye_left
    mouth_avg = (mouth_left + mouth_right) * 0.5
    eye_to_mouth = mouth_avg - eye_avg

    x = eye_to_eye - np.flipud(eye_to_mouth) * [-1, 1]
    x /= np.hypot(*x)
    x *= max(np.hypot(*eye_to_eye) * 2.0, np.hypot(*eye_to_mouth) * 1.8)
    y = np.flipud(x) * [-1, 1]
    c = eye_avg + eye_to_mouth * 0.1
    return np.stack([c - x - y, c - x + y, c + x + y, c + x - y])


def align_image(img, lm5p: np.ndarray, output_size: int = 512, transform_size: int = 2048):
    """Quad-to-square warp of the aligned face region of a PIL image."""
    import PIL.Image

    quad = align_quad(np.asarray(lm5p, np.float64))
    img = img.transform((transform_size, transform_size), PIL.Image.QUAD, (quad + 0.5).flatten(),
                        PIL.Image.BILINEAR)
    if output_size < transform_size:
        img = img.resize((output_size, output_size), PIL.Image.LANCZOS)
    return img


def smooth_landmark_sequence(lms: np.ndarray, sigma: float = 3.0) -> np.ndarray:
    """Temporal Gaussian smoothing of per-frame landmarks [T, K, 2]."""
    if sigma <= 0:
        return lms
    return gaussian_filter1d(np.asarray(lms, np.float64), sigma=sigma, axis=0)


def align_video_frames(frames: Sequence, lm5p_seq: np.ndarray, output_size: int = 512,
                       smooth_sigma: float = 3.0) -> List:
    """Align each PIL frame with its smoothed landmarks [T, 5, 2]."""
    lm5p_seq = smooth_landmark_sequence(lm5p_seq, smooth_sigma)
    return [align_image(f, lm, output_size) for f, lm in zip(frames, lm5p_seq)]


def write_dataset_json(out_dir: str, labels: Dict[str, Sequence[float]],
                       extra_labels: Optional[Dict[str, Sequence[float]]] = None) -> None:
    """Write dataset_realcam.json (+ dataset.json: `extra_labels` if given)
    with the 25-dim cameras (16 c2w + 9 K) by file name."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "dataset_realcam.json"), "w") as f:
        json.dump({"labels": {k: list(map(float, v)) for k, v in labels.items()}}, f)
    with open(os.path.join(out_dir, "dataset.json"), "w") as f:
        src = extra_labels if extra_labels is not None else labels
        json.dump({"labels": {k: list(map(float, v)) for k, v in src.items()}}, f)


def render_uvcoords_for_video(manager, coeff_paths: Iterable[str], out_dir: str) -> None:
    """Write `orthRender256x256_face_eye/<stem>.npy` (fp16 [256, 256, 3]) for
    each fitted-coefficient file, through `manager` (a `FaceverseManager`
    with its identity set) on its device."""
    os.makedirs(out_dir, exist_ok=True)
    for path in coeff_paths:
        coeff = np.load(path).astype(np.float32)
        with torch.no_grad():
            uvc = manager.make_driven_rendering(coeff)[0].cpu().numpy()
        stem = os.path.splitext(os.path.basename(path))[0]
        np.save(os.path.join(out_dir, stem + ".npy"), uvc.astype(np.float16))


# --------------------------------------------------------------- uvRender step
# reference data_preprocess/preprocess_faceverse.py:330-412 (save_uv_): the
# per-frame UV-space projected-position maps (`uv_pverts`, fp16 npy) and the
# UV-unwrapped ground-truth textures (`*_uvgttex.png`, uint8), the inputs of
# `uvnet.get_unet_uvinput` and of the evaluation CLIs' UV loading


def expand_uv_islands(vert_uvcoords: np.ndarray):
    """Enlarge the face block of the UV atlas (preprocess_faceverse.py:347-349:
    [0.195, 0.805] × [0.273, 0.727] scales ×1.4 about the centre). Returns
    (expanded uv [V, 2], bool mask of the expanded vertices)."""
    uv = np.array(vert_uvcoords[:, :2], np.float32)
    vert_idx = (uv[:, 1] > 0.273) & (uv[:, 1] < 0.727) & (uv[:, 0] > 0.195) & (uv[:, 0] < 0.805)
    uv[vert_idx] = (uv[vert_idx] - 0.5) * 1.4 + 0.5
    return uv, vert_idx


def build_uv_raster(vert_uvcoords: np.ndarray, faces: np.ndarray, vert_mask: np.ndarray,
                    res: int = 256, faces_per_tile: int = 2048, device="cuda"):
    """The one-time UV-space rasterization (preprocess_faceverse.py:346-360)
    on `device` (CUDA unless `device="cpu"` is asked for).

    The mesh is flattened into the UV atlas: vertex position uv·2−1 with
    z = 1 − mask, so masked (face) triangles win where islands overlap. The uv
    value (u, v) lands at pixel ((u+1)/2·res, (v+1)/2·res), where
    `grid_sample(tex, uv)` reads. Returns (RasterOut, the vertex mask zeroed
    outside the expanded block, numpy [V])."""
    uv, vert_idx = expand_uv_islands(vert_uvcoords)
    mask = np.array(vert_mask, np.float32).reshape(-1) * vert_idx
    verts = np.concatenate([uv * 2.0 - 1.0, (1.0 - mask)[:, None]], axis=-1)
    device = resolve_device(device)
    out = rasterize(torch.from_numpy(verts).to(device),
                    torch.from_numpy(np.asarray(faces, np.int64)).to(device), height=res,
                    width=res, window=(-1.0, 1.0, -1.0, 1.0), faces_per_tile=faces_per_tile,
                    cull_backfaces=False)
    return out, mask


def uv_pverts_map(model, coeff, uv_raster: RasterOut, faces, vert_mask, point_buf, K,
                  uv_face_eye_mask=None, cam_dist: float = 5.0,
                  img_res: int = 512) -> torch.Tensor:
    """One frame's UV projected-position map (preprocess_faceverse.py:394-406)
    on the model's device: per vertex the world transform, the perspective
    projection to [-1, 1] and visibility = mask · (view-space normal z >
    0.1), interpolated over `uv_raster` and multiplied by its coverage; the
    mask channel times `uv_face_eye_mask` [res, res] if given. `coeff` [1,
    all_dims] (or flat), `faces` [F, 3], `vert_mask` [V], `point_buf` [V, k]
    (arrays or tensors). Returns [res, res, 3] float32 (saved as fp16)."""
    dev = model.device

    def t(a, dtype):
        return torch.as_tensor(a).to(dev, dtype)

    coeff = t(coeff, torch.float32).reshape(1, -1)
    faces = t(faces, torch.long)
    id_c, exp_c, _tex, angles, _gamma, trans, eye, scale = model.split_coeffs(coeff)
    vs = model.get_vs(id_c, exp_c, model.compute_eye_rotation_matrix(eye[:, :2]),
                      model.compute_eye_rotation_matrix(eye[:, 2:]),
                      model.get_l_eye_center(id_c), model.get_r_eye_center(id_c))
    vs_t = rigid_transform(vs, model.compute_rotation_matrix(angles), trans, scale.abs())
    vs_norm = compute_norm(vs_t, faces, t(point_buf, torch.long))
    vs_proj = project_vs(vs_t, t(K, torch.float32), cam_dist=cam_dist) / img_res * 2.0 - 1.0

    visible = t(vert_mask, torch.float32).reshape(1, -1, 1) * (vs_norm[..., 2:] > 0.1)
    vert_attr = torch.cat([vs_proj, visible.float()], dim=-1)[0]  # [V, 3]
    rendered = interpolate_attributes(uv_raster, face_vertices(vert_attr, faces))  # [res, res, 4]
    uv_pverts = rendered[..., :3] * rendered[..., 3:]
    if uv_face_eye_mask is not None:
        uv_pverts = torch.cat([uv_pverts[..., :2],
                               uv_pverts[..., 2:] * t(uv_face_eye_mask, torch.float32)[..., None]],
                              dim=-1)
    return uv_pverts


def uv_gttex_image(image, uv_pverts: torch.Tensor) -> torch.Tensor:
    """The UV-unwrapped ground-truth texture (preprocess_faceverse.py:408-411):
    the frame `image` ([3, H, W] in [0, 1]) sampled at the xy of `uv_pverts`
    [res, res, 3], white outside its mask. Returns uint8 [res, res, 3] (the
    PNG layout) on `uv_pverts`' device."""
    image = torch.as_tensor(image, dtype=torch.float32).to(uv_pverts.device)
    uv_gt = grid_sample(image[None], uv_pverts[None, ..., :2])[0].permute(1, 2, 0)
    mask = uv_pverts[..., 2:]
    tex = uv_gt * mask + (1.0 - mask)
    return (tex * 255.0).clamp(0, 255).to(torch.uint8)


def uv_camera_intrinsics(focal_ratio: float = 4.2647, img_res: int = 512) -> np.ndarray:
    """The pinhole K [3, 3] of the uvRender step: focal focal_ratio·img_res,
    centre img_res // 2."""
    K = np.eye(3, dtype=np.float32)
    K[0, 0] = K[1, 1] = focal_ratio * img_res
    K[0, 2] = K[1, 2] = img_res // 2
    return K


def render_uv_for_video(model, model_dict: Dict, vert_mask: np.ndarray,
                        coeff_paths: Iterable[str], image_paths: Iterable[str], out_dir: str,
                        focal_ratio: float = 4.2647, img_res: int = 512,
                        uv_face_eye_mask: Optional[np.ndarray] = None) -> None:
    """Write the uvRender256x256 directory: `<stem>.npy` (fp16 uv_pverts) and
    `<stem>_uvgttex.png` per frame (preprocess_faceverse.py:335-411 layout).
    `model_dict` holds 'uv_per_ver', 'tri' and 'point_buf'; the rasters run
    on the model's device."""
    import PIL.Image

    os.makedirs(out_dir, exist_ok=True)
    K = uv_camera_intrinsics(focal_ratio, img_res)
    faces = np.asarray(model_dict["tri"], np.int64)
    uv_raster, mask = build_uv_raster(np.asarray(model_dict["uv_per_ver"], np.float32), faces,
                                      vert_mask, device=model.device)
    with torch.no_grad():
        for coeff_path, img_path in zip(coeff_paths, image_paths):
            pverts = uv_pverts_map(model, np.load(coeff_path).astype(np.float32), uv_raster,
                                   faces, mask, np.asarray(model_dict["point_buf"]), K,
                                   uv_face_eye_mask=uv_face_eye_mask, img_res=img_res)
            stem = os.path.splitext(os.path.basename(coeff_path))[0]
            np.save(os.path.join(out_dir, stem + ".npy"),
                    pverts.cpu().numpy().astype(np.float16))
            img = np.asarray(PIL.Image.open(img_path), np.float32) / 255.0
            tex = uv_gttex_image(np.ascontiguousarray(img.transpose(2, 0, 1)), pverts)
            PIL.Image.fromarray(tex.cpu().numpy()).save(
                os.path.join(out_dir, stem + "_uvgttex.png"))
