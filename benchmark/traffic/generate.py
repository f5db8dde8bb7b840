"""The one traffic generator: every input of a run, made from `--seed` and
the parameters of a traffic mix (`traffic/<name>.json`) and of a
configuration (`configs/<name>.json`).

A run serves `streams` live users or driving streams, each driving
`identities_per_stream` avatars (a grid shares one stream). Each step takes
frame `t mod cycle_frames` of every stream: a camera on a smooth yaw and
pitch path and the driving signal, either FaceVerse coefficients (a smooth
expression and eye trajectory) or the vertices of a mesh moving smoothly.
The tables are made once, on the device, so a step reads rows and copies
nothing from the host. The same seed gives the same inputs.

Copied from the port, not imported: the coefficient trajectory
(`faceverse/synthetic.py:coeff_trajectory`), the FaceVerse stand-in basis
(`synthetic_assets`, `grid_faces`), the sphere mesh (`chip_smoke.py:
sphere_mesh`) and the look-at camera (`camera.py:lookat_camera_pose`,
`fov_to_intrinsics`), each drawn from a numpy `Generator` here."""

from __future__ import annotations

import math

import numpy as np
import torch

ID_D, EXP_D, TEX_D = 150, 52, 251
COEFF_DIM = ID_D + EXP_D + TEX_D + 38  # + rotation / gamma / translation / eye tail


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The numpy generator of one named draw stream of run `seed`."""
    return np.random.default_rng([int(seed), *stream])


# ------------------------------------------------------------------ cameras


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def lookat_cameras(yaw: np.ndarray, pitch: np.ndarray, lookat, radius: float,
                   fov_degrees: float) -> np.ndarray:
    """[N, 25] conditioning cameras (cam2world ‖ intrinsics) looking at
    `lookat` from yaw `yaw` and pitch `pitch` (radians; π/2 is frontal)."""
    v = np.clip(pitch, 1e-5, math.pi - 1e-5) / math.pi
    phi = np.arccos(1 - 2 * v)
    origin = np.stack([radius * np.sin(phi) * np.cos(math.pi - yaw), radius * np.cos(phi),
                       radius * np.sin(phi) * np.sin(math.pi - yaw)], axis=-1)
    forward = _normalize(np.asarray(lookat, np.float64)[None] - origin)
    up = np.broadcast_to(np.array([0.0, 1.0, 0.0]), forward.shape)
    right = -_normalize(np.cross(up, forward))
    up = _normalize(np.cross(forward, right))
    pose = np.tile(np.eye(4), (len(yaw), 1, 1))
    pose[:, :3, :3] = np.stack([right, up, forward], axis=-1)
    pose[:, :3, 3] = origin
    f = float(1 / (math.tan(fov_degrees * 3.14159 / 360) * 1.414))
    K = np.array([[f, 0, 0.5], [0, f, 0.5], [0, 0, 1]])
    return np.concatenate([pose.reshape(-1, 16), np.tile(K.reshape(1, 9), (len(yaw), 1))],
                          axis=1).astype(np.float32)


def camera_path(cam: dict, n: int, r: np.random.Generator) -> np.ndarray:
    """[n, 25] cameras on a smooth seeded path: yaw and pitch swing about
    the frontal view with amplitudes and periods from the mix."""
    t = np.arange(n, dtype=np.float64)
    lo, hi = cam["period_frames"]
    periods = r.uniform(lo, hi, 2)
    phase = r.uniform(0, 2 * math.pi, 2)
    yaw = math.pi / 2 + cam["yaw_amplitude"] * np.sin(2 * math.pi * t / periods[0] + phase[0])
    pitch = math.pi / 2 + cam["pitch_amplitude"] * np.sin(2 * math.pi * t / periods[1] + phase[1])
    return lookat_cameras(yaw, pitch, cam["lookat"], cam["radius"], cam["fov_degrees"])


def frontal_camera(cam: dict) -> np.ndarray:
    """[1, 25] the frontal camera: the mapping's conditioning label."""
    return lookat_cameras(np.array([math.pi / 2]), np.array([math.pi / 2]), cam["lookat"],
                          cam["radius"], cam["fov_degrees"])


# ----------------------------------------------------------------- FaceVerse


def grid_faces(n_grid: int) -> np.ndarray:
    """Two triangles per grid cell, row-major: [a, a+1, a+n], [a+1, a+n+1, a+n]."""
    a = (np.arange(n_grid - 1)[:, None] * n_grid + np.arange(n_grid - 1)[None]).ravel()
    first = np.stack([a, a + 1, a + n_grid], 1)
    second = np.stack([a + 1, a + n_grid + 1, a + n_grid], 1)
    return np.stack([first, second], 1).reshape(-1, 3).astype(np.int32)


def faceverse_assets(n_grid: int, r: np.random.Generator) -> dict:
    """The fields of a FaceVerse asset set at the real coefficient layout: a
    grid-triangulated face disc of n_grid² vertices with seeded blendshape
    bases (the published basis is not in the repository)."""
    us, vs = np.meshgrid(np.linspace(0.05, 0.95, n_grid), np.linspace(0.05, 0.95, n_grid))
    uv = np.stack([us.ravel(), vs.ravel()], -1).astype(np.float32)
    V = uv.shape[0]
    xy = (uv - 0.5) * 0.5
    z = 0.15 - ((uv - 0.5) ** 2).sum(-1) * 0.4
    meanshape = np.stack([xy[:, 0], xy[:, 1], z], -1).reshape(1, -1).astype(np.float32)
    return dict(meanshape=meanshape,
                id_base=(r.standard_normal((3 * V, ID_D), np.float32) * 1e-3),
                exp_base=(r.standard_normal((3 * V, EXP_D), np.float32) * 2e-3),
                uv_per_ver=uv, tri=grid_faces(n_grid), ver_inds=(0, 8, 16), id_dims=ID_D,
                exp_dims=EXP_D, tex_dims=TEX_D)


def faceverse_rig() -> dict:
    """The manager's fixed inputs beside the assets: the FaceVerse → FLAME
    transform and the all-ones face mask of the stand-in disc."""
    fv2fl = np.eye(4, dtype=np.float32) * 0.6
    fv2fl[3, 3] = 1.0
    return dict(fv2fl=fv2fl)


def coeff_trajectory(n: int, drive: dict, r: np.random.Generator) -> np.ndarray:
    """Smooth sinusoidal drive coefficients [n, COEFF_DIM]: expression and
    eye channels move, identity and texture hold."""
    base = (r.standard_normal(COEFF_DIM) * 0.1).astype(np.float32)
    amp = np.zeros(COEFF_DIM, np.float32)
    amp[ID_D:ID_D + EXP_D] = r.random(EXP_D) * drive["expression_amplitude"]
    amp[-4:] = drive["eye_amplitude"]
    phase = r.random(COEFF_DIM) * 2 * np.pi
    lo, hi = drive["frequency"]
    freq = lo + r.random(COEFF_DIM) * (hi - lo)
    t = np.arange(n, dtype=np.float32)[:, None]
    return (base[None] + amp[None] * np.sin(freq[None] * t + phase[None])).astype(np.float32)


# ------------------------------------------------------------ the UV sphere


def sphere_mesh(n_lat: int, n_lon: int, r: np.random.Generator):
    """A UV sphere scaled to a head in the Next3D ortho window (a stand-in for
    FLAME), as (uvs [V, 2], faces [F, 3], uv face mask [1, 256, 256, 1],
    vertices [V + 68, 3]) whose last 68 rows (seeded vertex picks) stand in
    for the landmarks."""
    lat = np.linspace(0.12, np.pi - 0.12, n_lat)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    th, ph = np.meshgrid(lat, lon, indexing="ij")
    verts = np.stack([np.sin(th) * np.sin(ph), np.cos(th), np.sin(th) * np.cos(ph)],
                     axis=-1).reshape(-1, 3).astype(np.float32) * np.float32(0.12)
    jj, ii = np.meshgrid(np.arange(n_lon), np.arange(n_lat), indexing="xy")
    uvs = np.stack([jj / n_lon, ii / (n_lat - 1)], axis=-1).reshape(-1, 2).astype(np.float32)
    i, j = np.meshgrid(np.arange(n_lat - 1), np.arange(n_lon), indexing="ij")
    a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
    c, d = a + n_lon, b + n_lon
    faces = np.stack([np.stack([a, b, c], -1), np.stack([b, d, c], -1)], axis=2)
    faces = faces.reshape(-1, 3).astype(np.int32)
    lms = r.choice(len(verts), 68)
    return (uvs, faces, np.ones((1, 256, 256, 1), np.float32),
            np.concatenate([verts, verts[lms]], axis=0), lms)


def vertex_trajectory(verts: np.ndarray, lms: np.ndarray, n: int, drive: dict,
                      r: np.random.Generator) -> np.ndarray:
    """[n, V + 68, 3] vertices moving smoothly: `modes` seeded smooth radial
    displacement fields, each swinging with its own frequency and phase; the
    landmark rows follow the vertices they were picked from."""
    V = len(verts) - len(lms)
    base = verts[:V].astype(np.float64)
    radial = base / np.linalg.norm(base, axis=-1, keepdims=True)
    k = drive["vertex_modes"]
    waves = r.standard_normal((k, 3)) * drive["vertex_wavenumber"]
    offs = r.uniform(0, 2 * math.pi, k)
    fields = np.sin(base @ waves.T + offs)  # [V, k]
    lo, hi = drive["frequency"]
    freq = r.uniform(lo, hi, k)
    phase = r.uniform(0, 2 * math.pi, k)
    t = np.arange(n, dtype=np.float64)[:, None]
    coef = np.sin(freq[None] * t + phase[None]) * drive["vertex_amplitude"] / math.sqrt(k)
    moved = base[None] + (coef @ fields.T)[..., None] * radial[None]  # [n, V, 3]
    return np.concatenate([moved, moved[:, lms]], axis=1).astype(np.float32)


# ------------------------------------------------------------------- a run


def make_inputs(traffic: dict, config: dict, seed: int, device) -> dict:
    """Every input of a run of `traffic` on `config`, on `device`:
    "z" [B, z_dim] (B = streams × identities_per_stream, stream-major),
    "cond_c" [B, 25] (the frontal camera), "cameras" [streams, L, 25] and,
    by the configuration's driving kind, "faceverse" (the asset fields and
    rig), "identity" [streams, COEFF_DIM] and "coeffs" [streams, L,
    COEFF_DIM], or "mesh" (uvs, faces, mask, landmark picks) and
    "vertices" [streams, L, V + 68, 3]. L is the mix's `cycle_frames`."""
    streams, per = traffic["streams"], traffic["identities_per_stream"]
    B, L = streams * per, traffic["cycle_frames"]
    cam = traffic["camera"]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    out = {"batch": B, "streams": streams, "cycle": L}
    out["z"] = dev(rng(seed, 1).standard_normal((B, config["z_dim"]), np.float32))
    out["cond_c"] = dev(np.repeat(frontal_camera(cam), B, axis=0))
    out["cameras"] = dev(np.stack([camera_path(cam, L, rng(seed, 2, s)) for s in range(streams)]))
    drive = traffic["drive"]
    if config["driving"] == "faceverse":
        out["faceverse"] = dict(faceverse_assets(config["faceverse_grid"], rng(seed, 3)),
                                **faceverse_rig())
        out["identity"] = dev(np.stack([rng(seed, 4, s).standard_normal(COEFF_DIM, np.float32)
                                        * np.float32(0.1) for s in range(streams)]))
        out["coeffs"] = dev(np.stack([coeff_trajectory(L, drive, rng(seed, 5, s))
                                      for s in range(streams)]))
    elif config["driving"] == "vertices":
        uvs, faces, mask, verts, lms = sphere_mesh(*config["sphere"], rng(seed, 3))
        out["mesh"] = dict(uvs=uvs, faces=faces, mask=mask, n_verts=len(verts) - 68)
        out["vertices"] = dev(np.stack([vertex_trajectory(verts, lms, L, drive, rng(seed, 5, s))
                                        for s in range(streams)]))
    else:
        raise ValueError(f"unknown driving kind {config['driving']!r}")
    return out
