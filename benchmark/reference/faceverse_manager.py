"""[benchmark reference] A frozen copy of `invertavatar_torch/faceverse/manager.py`: plain
PyTorch, every kernel route replaced by its plain version, nothing of the
program imported. The text below is the original module's.

Online driving signal from FaceVerse coefficients, plain PyTorch.

Counterpart of `invertavatar_tpu/faceverse/manager.py` (reference
`Faceverse_manager`, data_preprocess/FaceVerse/renderer.py): per frame,
coefficients → blendshape mesh with eye rotations and expression clamps →
FLAME-space transform → orthographic raster → `uvcoords_image`
[1, 256, 256, 3] (expanded UV coordinates and the binarised face mask).

The crop `[128, 114, 256, 256]` of the 512² frame is folded into the raster
window, so only the cropped region is rasterized. Everything per frame runs
on the manager's device with no host round trip.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .rasterizer import interpolate_attributes, rasterize
from .misc import resolve_device
from .faceverse_model import FaceVerseAssets, FaceVerseModel


class FaceverseManager:
    """The assets and the avatar's identity coefficients on `device` (CUDA by
    default)."""

    CROP = (128, 114, 256, 256)  # [left, top, w, h] of the 512² ortho frame
    RENDER_RES = 512
    ORTH_SCALE = 5.0
    ORTH_SHIFT = (0.0, 0.005, 0.0)

    def __init__(self, assets: FaceVerseAssets, fv2fl: np.ndarray, face_mask: np.ndarray,
                 base_coeff: Optional[np.ndarray] = None, device="cuda"):
        """`fv2fl` [4, 4] is the FaceVerse → FLAME-space transform
        (`fv2fl_30.npy`), `face_mask` [V] the vertex face-region mask
        (`v31_face_mask_new.npy`)."""
        self.device = resolve_device(device)
        self.model = FaceVerseModel(assets, self.device)
        fv2fl = torch.from_numpy(np.asarray(fv2fl, np.float32)).to(self.device)
        self._fv2fl_rot = fv2fl[:3, :3].T.contiguous()
        self._fv2fl_trans = fv2fl[:3, 3:].T.contiguous()
        # made once: a host-to-device copy per frame would wait on the card
        self._orth_shift = torch.tensor(self.ORTH_SHIFT, device=self.device)
        self._flip_z = torch.tensor([1.0, 1.0, -1.0], device=self.device)

        # expand the face area in UV space
        uv = np.array(assets.uv_per_ver, np.float32)
        inner = (uv[:, 1] > 0.273) & (uv[:, 1] < 0.727) & (uv[:, 0] > 0.195) & (uv[:, 0] < 0.805)
        uv[inner] = (uv[inner] - 0.5) * 1.4 + 0.5
        mask = np.asarray(face_mask, np.float32).copy()
        mask[assets.ver_inds[0]:assets.ver_inds[2]] = 1  # the eyes are always in the mask

        # per-vertex (u·2−1, v·2−1, mask) gathered per face
        vert_attrs = np.concatenate([uv * 2 - 1, mask[:, None]], axis=-1)
        self.face_attrs = torch.from_numpy(np.ascontiguousarray(vert_attrs[assets.tri])).to(
            self.device)  # [F, 3, 3]
        self.tri = torch.from_numpy(np.asarray(assets.tri, np.int64)).to(self.device)

        self.id_coeff = None
        self.base_avatar_exp_coeff = None
        self._id_cache = None
        if base_coeff is not None:
            c = self._coeffs(base_coeff)
            self.id_coeff, self.base_avatar_exp_coeff = self.model.split_coeffs(c)[:2]
            self._refresh_id_cache()

    def _coeffs(self, coeff) -> torch.Tensor:
        c = torch.as_tensor(coeff, dtype=torch.float32, device=self.device)
        return c[None] if c.ndim == 1 else c

    def set_identity(self, coeff):
        """The avatar's identity: the id part of `coeff` [C] or [1, C]."""
        self.id_coeff = self.model.split_coeffs(self._coeffs(coeff))[0]
        self._refresh_id_cache()

    def _refresh_id_cache(self):
        """The identity-fixed terms, once per identity: the id-basis shape and
        both eye centres."""
        self._id_cache = (self.model.id_shape(self.id_coeff),
                          self.model.get_l_eye_center(self.id_coeff),
                          self.model.get_r_eye_center(self.id_coeff))

    def _render(self, id_shape, l_eye_mean, r_eye_mean, exp_coeff, eye_coeff):
        model = self.model
        left, top, w, h = self.CROP
        R = self.RENDER_RES
        # the crop folded into the raster window: pixel_x = (x + 1)/2·R
        window = (2 * left / R - 1.0, 2 * (left + w) / R - 1.0,
                  2 * top / R - 1.0, 2 * (top + h) / R - 1.0)
        l_eye_mat = model.compute_eye_rotation_matrix(eye_coeff[:, :2])
        r_eye_mat = model.compute_eye_rotation_matrix(eye_coeff[:, 2:])
        vs = model.get_vs(None, exp_coeff, l_eye_mat, r_eye_mat, l_eye_mean, r_eye_mean,
                          id_shape=id_shape)
        vert = torch.matmul(vs[0], self._fv2fl_rot) + self._fv2fl_trans
        transformed = (vert + self._orth_shift) * self.ORTH_SCALE
        # the orthographic camera (1, 0, 0) leaves xy as they are; z is flipped
        transformed = transformed * self._flip_z
        out = rasterize(transformed, self.tri, height=h, width=w, window=window,
                        faces_per_tile=1024, cull_backfaces=False, binning="anchor")
        rendering = interpolate_attributes(out, self.face_attrs)  # [h, w, 4] = (u, v, mask, vis)
        rendering = rendering * (rendering[..., 3:4] * rendering[..., 2:3])
        # binarise the mask channel
        uvcoords = torch.cat([rendering[..., :2], (rendering[..., 2:3] >= 0.5).float()], dim=-1)
        return uvcoords[None]  # [1, h, w, 3]

    def make_driven_rendering(self, drive_coeff, base_drive_coeff=None) -> torch.Tensor:
        """One frame's driving signal -> `uvcoords_image` [1, 256, 256, 3] on
        the manager's device. With `base_drive_coeff`, the expression moves by
        the drive's delta from it, applied to the avatar's base expression."""
        if self.id_coeff is None:
            raise ValueError("identity coefficients not set (set_identity)")
        _, exp_coeff, _, _, _, _, eye_coeff, _ = self.model.split_coeffs(self._coeffs(drive_coeff))
        # clamp two jaw-adjacent blendshapes
        exp_coeff = exp_coeff.clone()
        exp_coeff[:, -4] = exp_coeff[:, -4].clamp(-0.75, 0.6)
        exp_coeff[:, -2] = exp_coeff[:, -2].clamp(-0.75, 0.75)
        if base_drive_coeff is not None:
            base_exp = self.model.split_coeffs(self._coeffs(base_drive_coeff))[1]
            exp_coeff = (exp_coeff - base_exp) + self.base_avatar_exp_coeff
        id_shape, l_eye_mean, r_eye_mean = self._id_cache
        return self._render(id_shape, l_eye_mean, r_eye_mean, exp_coeff, eye_coeff)
