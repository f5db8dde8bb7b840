"""[benchmark reference] A frozen copy of `invertavatar_torch/faceverse/model.py`: plain
PyTorch, every kernel route replaced by its plain version, nothing of the
program imported. The text below is the original module's.

FaceVerse v3 3DMM coefficient pipeline, plain PyTorch.

Counterpart of `invertavatar_tpu/faceverse/model.py` (reference
`data_preprocess/FaceVerse/FaceVerseModel_v3.py`): identity and expression
blendshapes with per-eye rotations, coefficient split/merge, Euler rotations,
the texture basis and SH illumination. The published `faceverse_v3_1.npy`
dict is not in the repository; `load_faceverse_assets` reads it by path and
the tests write synthetic dicts of the same schema.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .misc import resolve_device
from .precision import tf32


class FaceVerseAssets(NamedTuple):
    meanshape: np.ndarray  # [1, 3V] (axis-flipped, scaled: see load_faceverse_assets)
    id_base: np.ndarray  # [3V, id_dims]
    exp_base: np.ndarray  # [3V, exp_dims]
    uv_per_ver: np.ndarray  # [V, 2]
    tri: np.ndarray  # [F, 3] int32
    ver_inds: Tuple[int, int, int]  # (l_eye_start, l_eye_end = r_eye_start, r_eye_end)
    id_dims: int
    exp_dims: int
    tex_dims: int
    # the fitting-side texture model; None when the dict has no texBase/meantex
    tex_base: Optional[np.ndarray] = None  # [3V, tex_dims]
    meantex: Optional[np.ndarray] = None  # [1, 3V]


def _rot_x(a, zeros, ones):
    s, c = torch.sin(a), torch.cos(a)
    return torch.stack([ones, zeros, zeros, zeros, c, -s, zeros, s, c], -1).reshape(-1, 3, 3)


def _rot_y(a, zeros, ones):
    s, c = torch.sin(a), torch.cos(a)
    return torch.stack([c, zeros, s, zeros, ones, zeros, -s, zeros, c], -1).reshape(-1, 3, 3)


def _rot_z(a, zeros, ones):
    s, c = torch.sin(a), torch.cos(a)
    return torch.stack([c, -s, zeros, s, c, zeros, zeros, zeros, ones], -1).reshape(-1, 3, 3)


class FaceVerseModel:
    """The coefficient pipeline over loaded assets, with the bases held on
    `device` (CUDA by default)."""

    def __init__(self, assets: FaceVerseAssets, device="cuda"):
        self.assets = assets
        self.device = resolve_device(device)

        def t(a):
            return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self.meanshape = t(assets.meanshape)
        self.id_base = t(assets.id_base)
        self.exp_base = t(assets.exp_base)
        self.tex_base = t(assets.tex_base)
        self.meantex = t(assets.meantex)

    @property
    def id_dims(self):
        return self.assets.id_dims

    @property
    def exp_dims(self):
        return self.assets.exp_dims

    @property
    def all_dims(self):
        return self.assets.id_dims + self.assets.exp_dims + self.assets.tex_dims

    def split_coeffs(self, coeffs: torch.Tensor):
        """(id, exp, tex, angles, gamma, translation, eye, scale); without a
        trailing scale coefficient the scale is 1."""
        idd, expd, alld = self.id_dims, self.exp_dims, self.all_dims
        id_coeff = coeffs[:, :idd]
        exp_coeff = coeffs[:, idd:idd + expd]
        tex_coeff = coeffs[:, idd + expd:alld]
        angles = coeffs[:, alld:alld + 3]
        gamma = coeffs[:, alld + 3:alld + 30]
        translation = coeffs[:, alld + 30:alld + 33]
        if coeffs.shape[1] == alld + 36:
            eye_coeff = coeffs[:, alld + 33:]
            scale = torch.ones_like(coeffs[:, -1:])
        else:
            eye_coeff = coeffs[:, alld + 33:-1]
            scale = coeffs[:, -1:]
        return id_coeff, exp_coeff, tex_coeff, angles, gamma, translation, eye_coeff, scale

    def merge_coeffs(self, id_coeff, exp_coeff, tex_coeff, angles, gamma, translation, eye, scale):
        return torch.cat([id_coeff, exp_coeff, tex_coeff, angles, gamma, translation, eye, scale],
                         dim=1)

    def id_shape(self, id_coeff: torch.Tensor) -> torch.Tensor:
        """id_base @ id + meanshape -> [B, 3V]."""
        return tf32(id_coeff) @ tf32(self.id_base.T) + self.meanshape

    def get_vs(self, id_coeff, exp_coeff, l_eye_mat=None, r_eye_mat=None, l_eye_mean=None,
               r_eye_mean=None, id_shape=None) -> torch.Tensor:
        """Blendshapes plus eye rotations -> vertices [B, V, 3]. `id_shape`
        ([B, 3V], `self.id_shape(id)`) skips the identity product, which a
        driving loop computes once."""
        if id_shape is None:
            id_shape = self.id_shape(id_coeff)
        shape = id_shape + tf32(exp_coeff) @ tf32(self.exp_base.T)
        vs = shape.reshape(exp_coeff.shape[0], -1, 3)
        if l_eye_mat is not None:
            i0, i1, i2 = self.assets.ver_inds
            l = torch.matmul(vs[:, i0:i1] - l_eye_mean, l_eye_mat) + l_eye_mean
            r = torch.matmul(vs[:, i1:i2] - r_eye_mean, r_eye_mat) + r_eye_mean
            vs = torch.cat([vs[:, :i0], l, r, vs[:, i2:]], dim=1)
        return vs

    def get_color(self, tex_coeff) -> torch.Tensor:
        """Per-vertex albedo from the texture basis -> [B, V, 3]."""
        if self.tex_base is None:
            raise ValueError("the model dict was loaded without texBase/meantex")
        tex = tex_coeff @ self.tex_base.T + self.meantex
        return tex.reshape(tex_coeff.shape[0], -1, 3)

    @staticmethod
    def add_illumination(face_texture, norm, gamma) -> torch.Tensor:
        """Second-order SH illumination: gamma [B, 27] = 3×9 SH coefficients
        with +0.8 ambient on band 0, over vertex normals [B, V, 3]."""
        B = face_texture.shape[0]
        gamma = gamma.reshape(B, 3, 9).clone()
        gamma[:, :, 0] += 0.8
        gamma = gamma.permute(0, 2, 1)  # [B, 9, 3]

        a0 = np.pi
        a1 = 2 * np.pi / np.sqrt(3.0)
        a2 = 2 * np.pi / np.sqrt(8.0)
        c0 = 1 / np.sqrt(4 * np.pi)
        c1 = np.sqrt(3.0) / np.sqrt(4 * np.pi)
        c2 = 3 * np.sqrt(5.0) / np.sqrt(12 * np.pi)
        d0 = 0.5 / np.sqrt(3.0)

        nx, ny, nz = norm[..., 0], norm[..., 1], norm[..., 2]
        H = torch.stack([
            a0 * c0 * torch.ones_like(nx),
            -a1 * c1 * ny,
            a1 * c1 * nz,
            -a1 * c1 * nx,
            a2 * c2 * nx * ny,
            -a2 * c2 * ny * nz,
            a2 * c2 * d0 * (3 * nz ** 2 - 1),
            -a2 * c2 * nx * nz,
            a2 * c2 * 0.5 * (nx ** 2 - ny ** 2),
        ], dim=-1)  # [B, V, 9]
        return face_texture * torch.matmul(H, gamma)

    def _eye_center(self, id_coeff, lo, hi):
        eye = self.id_shape(id_coeff).reshape(id_coeff.shape[0], -1, 3)[:, lo:hi].clone()
        eye[:, :, 2] += 0.005
        return eye.mean(dim=1, keepdim=True)

    def get_l_eye_center(self, id_coeff):
        """Mean of the left eye's vertices after z += 0.005."""
        i0, i1, _ = self.assets.ver_inds
        return self._eye_center(id_coeff, i0, i1)

    def get_r_eye_center(self, id_coeff):
        _, i1, i2 = self.assets.ver_inds
        return self._eye_center(id_coeff, i1, i2)

    @staticmethod
    def compute_eye_rotation_matrix(eye: torch.Tensor) -> torch.Tensor:
        """(rotY @ rotX)ᵀ per batch from (pitch, yaw)."""
        zeros, ones = torch.zeros_like(eye[:, 0]), torch.ones_like(eye[:, 0])
        return torch.matmul(_rot_y(eye[:, 1], zeros, ones),
                            _rot_x(eye[:, 0], zeros, ones)).transpose(1, 2)

    @staticmethod
    def compute_rotation_matrix(angles: torch.Tensor) -> torch.Tensor:
        """(rotZ @ rotY @ rotX)ᵀ per batch."""
        zeros, ones = torch.zeros_like(angles[:, 0]), torch.ones_like(angles[:, 0])
        r = torch.matmul(torch.matmul(_rot_z(angles[:, 2], zeros, ones),
                                      _rot_y(angles[:, 1], zeros, ones)),
                         _rot_x(angles[:, 0], zeros, ones))
        return r.transpose(1, 2)


def rigid_transform(vs: torch.Tensor, rot: torch.Tensor, trans: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """World transform: (vs·scale) @ rot + trans."""
    return torch.matmul(vs * scale, rot) + trans.reshape(-1, 1, 3)


def compute_norm(vs: torch.Tensor, tri: torch.Tensor, point_buf: torch.Tensor) -> torch.Tensor:
    """Per-vertex unit normals: the sum of the adjacent (unnormalised) face
    normals listed in `point_buf` [V, K]."""
    tri, point_buf = tri.long(), point_buf.long()
    v1, v2, v3 = vs[:, tri[:, 0]], vs[:, tri[:, 1]], vs[:, tri[:, 2]]
    face_norm = torch.cross(v1 - v2, v2 - v3, dim=-1)  # [B, F, 3]
    v_norm = face_norm[:, point_buf].sum(dim=2)  # [B, V, 3]
    return v_norm / (torch.linalg.norm(v_norm, dim=2, keepdim=True) + 1e-9)


def project_vs(vs: torch.Tensor, K, cam_dist: float = 5.0) -> torch.Tensor:
    """Pinhole projection to pixels: world x and z flipped, camera at
    (0, 0, cam_dist), perspective divide."""
    reverse_xz = torch.tensor([[-1.0, 0, 0], [0, 1.0, 0], [0, 0, -1.0]], device=vs.device)
    p = torch.matmul(vs, reverse_xz) + torch.tensor([0.0, 0.0, cam_dist], device=vs.device)
    aug = torch.matmul(p, torch.as_tensor(K, dtype=vs.dtype, device=vs.device).T)
    return aug[..., :2] / aug[..., 2:3]


def batch_orth_proj(X: torch.Tensor, camera: torch.Tensor) -> torch.Tensor:
    """Orthographic projection: (xy + translation) and z, times the scale."""
    camera = camera.reshape(-1, 1, 3)
    x_trans = torch.cat([X[:, :, :2] + camera[:, :, 1:], X[:, :, 2:]], dim=2)
    return camera[:, :, 0:1] * x_trans


def angle2matrix(angles_deg: torch.Tensor) -> torch.Tensor:
    """Rotation matrices from Euler angles in degrees."""
    angles = angles_deg * (np.pi / 180.0)
    s, c = torch.sin(angles), torch.cos(angles)
    cx, cy, cz = c[:, 0], c[:, 1], c[:, 2]
    sx, sy, sz = s[:, 0], s[:, 1], s[:, 2]
    R = torch.stack([
        cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx,
        sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx,
        -sy, cy * sx, cy * cx,
    ], dim=0)
    return R.reshape(-1, 3, 3)
