"""The port's FaceVerse model, manager and synthetic assets on the CPU, held
against the JAX package; and, on a CUDA device, the manager's driving signal
on the card against the CPU.

Tolerances: the coefficient math is float32 matmuls summed in another order,
1e-5 absolute on unit-scale outputs (1e-4 relative for the SH lighting and
the projection to pixels). The driving signal goes through the raster, so
an edge pixel may fall the other way: the mask channel agrees on ≥ 99.9% of
pixels; where both sides hit, u and v agree to 1e-4 on ≥ 99.9% of pixels and
to 1e-3 on all. The largest readings: against JAX 3.9e-5 under the suite's
XLA flags and 1.19e-4 (one pixel of 56,460) with XLA's default optimisation;
the card against the CPU 1.46e-4 (one pixel of 65,536).

    python -m pytest --noconftest -m cuda tests/test_torch_faceverse.py
"""

import numpy as np
import pytest
import torch

from invertavatar_torch.faceverse import model as pm
from invertavatar_torch.faceverse.synthetic import (
    COEFF_DIM,
    coeff_trajectory,
    synthetic_assets,
    synthetic_manager,
)

# one intra-op thread: the suite runs test files in parallel worker processes
torch.set_num_threads(1)


def _assets_with_texture(seed=0, n_grid=24):
    rng = np.random.RandomState(seed + 100)
    a = synthetic_assets(n_grid, seed)
    V = a.uv_per_ver.shape[0]
    return a._replace(tex_base=(rng.randn(3 * V, a.tex_dims) * 1e-2).astype(np.float32),
                      meantex=(rng.rand(1, 3 * V) * 255).astype(np.float32))


def _jax_assets(a):
    from invertavatar_tpu.faceverse.model import FaceVerseAssets

    return FaceVerseAssets(*a)


def _close(got, ref, atol=1e-5, rtol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=rtol)


def test_synthetic_assets_and_trajectory_match_jax():
    """The same numpy draws: assets, the drive bank and the trajectory are
    equal; the grid faces keep the JAX loop's order."""
    from invertavatar_tpu.faceverse import synthetic as js

    for n in (5, 24):
        a, b = synthetic_assets(n, seed=n), js.synthetic_assets(n, seed=n)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    np.testing.assert_array_equal(coeff_trajectory(7, seed=2), js.coeff_trajectory(7, seed=2))
    _, bank = synthetic_manager(n_grid=5, seed=4, device="cpu")
    np.testing.assert_array_equal(bank, js.synthetic_manager(n_grid=5, seed=4)[1])
    assert bank.shape == (8, COEFF_DIM)


def test_model_functions_match_jax():
    """split/merge, get_vs (with and without the id cache, with eye
    rotations), eye centres, both rotation matrices, get_color,
    add_illumination, rigid_transform, compute_norm, project_vs,
    batch_orth_proj and angle2matrix against JAX on the same inputs."""
    import jax.numpy as jnp

    from invertavatar_tpu.faceverse import model as jm

    a = _assets_with_texture()
    port, ref = pm.FaceVerseModel(a, device="cpu"), jm.FaceVerseModel(_jax_assets(a))
    rng = np.random.RandomState(1)
    B = 2
    for dim in (COEFF_DIM, COEFF_DIM - 1):  # with and without the trailing scale
        c = (rng.randn(B, dim) * 0.3).astype(np.float32)
        parts_t, parts_j = port.split_coeffs(torch.from_numpy(c)), ref.split_coeffs(jnp.asarray(c))
        for x, y in zip(parts_t, parts_j):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        np.testing.assert_array_equal(port.merge_coeffs(*parts_t).numpy(),
                                      np.asarray(ref.merge_coeffs(*parts_j)))
    c = (rng.randn(B, COEFF_DIM) * 0.3).astype(np.float32)
    idc, expc, texc, ang, gamma, trans, eye, scale = port.split_coeffs(torch.from_numpy(c))
    jid, jexp, jtex, jang, jgamma, jtrans, jeye, jscale = ref.split_coeffs(jnp.asarray(c))

    lm = port.compute_eye_rotation_matrix(eye[:, :2])
    rm = port.compute_eye_rotation_matrix(eye[:, 2:])
    jlm = ref.compute_eye_rotation_matrix(jeye[:, :2])
    jrm = ref.compute_eye_rotation_matrix(jeye[:, 2:])
    _close(lm, jlm, 1e-6)
    _close(port.compute_rotation_matrix(ang), ref.compute_rotation_matrix(jang), 1e-6)
    lc, rc = port.get_l_eye_center(idc), port.get_r_eye_center(idc)
    _close(lc, ref.get_l_eye_center(jid))
    _close(rc, ref.get_r_eye_center(jid))
    _close(port.get_vs(idc, expc), ref.get_vs(jid, jexp))
    vs = port.get_vs(None, expc, lm, rm, lc, rc, id_shape=port.id_shape(idc))
    jvs = ref.get_vs(jid, jexp, jlm, jrm, ref.get_l_eye_center(jid), ref.get_r_eye_center(jid))
    _close(vs, jvs)

    color = port.get_color(texc)
    jcolor = ref.get_color(jtex)
    _close(color, jcolor, atol=2e-4, rtol=1e-5)
    norm = rng.randn(B, color.shape[1], 3).astype(np.float32)
    norm /= np.linalg.norm(norm, axis=-1, keepdims=True)
    _close(port.add_illumination(color, torch.from_numpy(norm), gamma),
           ref.add_illumination(jcolor, jnp.asarray(norm), jgamma), atol=1e-3, rtol=1e-4)

    rot = port.compute_rotation_matrix(ang)
    _close(pm.rigid_transform(vs, rot, trans, scale[:, :, None]),
           jm.rigid_transform(jvs, ref.compute_rotation_matrix(jang), jtrans, jscale[:, :, None]))
    tri = a.tri
    lists = [[] for _ in range(vs.shape[1])]
    for f, face in enumerate(tri):
        for v in face:
            lists[v].append(f)
    buf = np.full((len(lists), max(map(len, lists))), 0, np.int64)
    for v, fl in enumerate(lists):
        buf[v, :len(fl)] = fl
    _close(pm.compute_norm(vs, torch.from_numpy(tri), torch.from_numpy(buf)),
           jm.compute_norm(jvs, jnp.asarray(tri), jnp.asarray(buf)))
    K = np.array([[4.2647 * 512, 0, 256], [0, 4.2647 * 512, 256], [0, 0, 1]], np.float32)
    _close(pm.project_vs(vs * 0.1, K), jm.project_vs(jvs * 0.1, K), atol=1e-3, rtol=1e-5)
    cam = rng.randn(B, 3).astype(np.float32)
    _close(pm.batch_orth_proj(vs, torch.from_numpy(cam)), jm.batch_orth_proj(jvs, jnp.asarray(cam)))
    deg = (rng.randn(B, 3) * 30).astype(np.float32)
    _close(pm.angle2matrix(torch.from_numpy(deg)), jm.angle2matrix(jnp.asarray(deg)), 1e-6)


def test_load_faceverse_assets_matches_jax(tmp_path):
    """A synthetic model dict of the published schema (with and without the
    texture model, and with a separate 52-blendshape basis) loads to the same
    arrays in both packages."""
    from invertavatar_tpu.faceverse.model import load_faceverse_assets as jax_load

    rng = np.random.RandomState(2)
    V, F = 40, 60
    d = {"meanshape": rng.randn(1, 3 * V).astype(np.float32),
         "idBase": rng.randn(3 * V, 150).astype(np.float32),
         "exBase": rng.randn(3 * V, 171).astype(np.float32),
         "uv_per_ver": rng.rand(V, 2).astype(np.float64),
         "tri": rng.randint(0, V, (F, 3)).astype(np.int64),
         "ver_inds": np.array([0, 4, 8]),
         "texBase": rng.randn(3 * V, 251).astype(np.float32),
         "meantex": rng.rand(3 * V).astype(np.float32)}
    exp52 = rng.randn(3 * V, 52).astype(np.float32)
    np.save(tmp_path / "exp52.npy", exp52)
    for name, dd in (("full", d), ("geometry", {k: v for k, v in d.items()
                                                if k not in ("texBase", "meantex")})):
        path = tmp_path / f"{name}.npy"
        np.save(path, dd, allow_pickle=True)
        for exp_path in (None, str(tmp_path / "exp52.npy")):
            got = pm.load_faceverse_assets(str(path), exp_base_path=exp_path)
            ref = jax_load(str(path), exp_base_path=exp_path)
            assert got._fields == ref._fields
            for f, x, y in zip(got._fields, got, ref):
                if x is None:
                    assert y is None, f
                else:
                    np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f)
                    assert np.asarray(x).dtype == np.asarray(y).dtype, f


class _RunsShell:
    """Pickles as a call of `os.system` (the shape of a forged model file)."""

    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        import os

        return (os.system, (f"touch {self.marker}",))


def test_forged_model_npy_runs_no_code(tmp_path):
    """An object `.npy` whose dict holds a `__reduce__` to `os.system` is
    refused and runs nothing; the same schema without it loads, with a list
    and a numpy integer among its values, to the arrays `np.load` gives."""
    rng = np.random.RandomState(3)
    V = 12
    d = {"meanshape": rng.randn(1, 3 * V).astype(np.float32),
         "idBase": rng.randn(3 * V, 150).astype(np.float32),
         "exBase": rng.randn(3 * V, 52).astype(np.float32),
         "uv_per_ver": rng.rand(V, 2), "tri": rng.randint(0, V, (20, 3)),
         "ver_inds": [0, 4, np.int64(8)], "n": np.int32(3)}
    marker = tmp_path / "ran"
    for key in ("evil", "tri"):
        forged = dict(d, **{key: _RunsShell(marker)})
        path = tmp_path / f"forged_{key}.npy"
        np.save(path, forged, allow_pickle=True)
        with pytest.raises(Exception):
            pm.load_faceverse_assets(str(path))
        assert not marker.exists()
    path = tmp_path / "plain.npy"
    np.save(path, d, allow_pickle=True)
    got = pm.load_model_dict(str(path))
    ref = np.load(path, allow_pickle=True).item()
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
    assert pm.load_faceverse_assets(str(path)).ver_inds == (0, 4, 8)
    np.save(tmp_path / "array.npy", d["meanshape"])
    with pytest.raises(ValueError):
        pm.load_model_dict(str(tmp_path / "array.npy"))


def _compare_driving(got, ref):
    got, ref = got.cpu().numpy(), np.asarray(ref)
    assert got.shape == ref.shape == (1, 256, 256, 3)
    assert set(np.unique(got[..., 2])) <= {0.0, 1.0}
    agree = got[..., 2] == ref[..., 2]
    assert agree.mean() >= 0.999, agree.mean()
    both = (got[..., 2] == 1) & (ref[..., 2] == 1)
    assert both.sum() > 1000
    d = np.abs(got[..., :2] - ref[..., :2]).max(-1)[both]
    assert (d <= 1e-4).mean() >= 0.999 and d.max() <= 1e-3, ((d <= 1e-4).mean(), d.max())
    return got


def test_make_driven_rendering_matches_jax():
    """The driving signal of the synthetic manager, with and without
    `base_drive_coeff`, against the JAX manager on the same assets and
    coefficients."""
    from invertavatar_tpu.faceverse.manager import FaceverseManager as JaxManager

    a = synthetic_assets(n_grid=60, seed=1)
    fv2fl = np.eye(4, dtype=np.float32) * 0.6
    fv2fl[3, 3] = 1.0
    mask = (np.random.RandomState(0).rand(a.uv_per_ver.shape[0]) > 0.1).astype(np.float32)
    traj = coeff_trajectory(3, seed=5)
    from invertavatar_torch.faceverse.manager import FaceverseManager

    port = FaceverseManager(a, fv2fl, mask, base_coeff=traj[0], device="cpu")
    ref = JaxManager(_jax_assets(a), fv2fl, mask, base_coeff=traj[0])
    port.set_identity(traj[1])
    ref.set_identity(traj[1])
    plain = _compare_driving(port.make_driven_rendering(traj[2]),
                             ref.make_driven_rendering(traj[2]))
    delta = _compare_driving(port.make_driven_rendering(traj[2], base_drive_coeff=traj[1]),
                             ref.make_driven_rendering(traj[2], base_drive_coeff=traj[1]))
    assert (plain != delta).any()


@pytest.mark.cuda
def test_cuda_driving_matches_cpu():
    """`make_driven_rendering` of the full-size synthetic manager (59,168
    faces) on the card against the CPU, with the bands of the module
    docstring."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gpu, bank = synthetic_manager(n_grid=173, device="cuda")
    cpu, _ = synthetic_manager(n_grid=173, device="cpu")
    for coeff in bank[1:3]:
        got = gpu.make_driven_rendering(coeff)
        assert got.device.type == "cuda"
        _compare_driving(got, cpu.make_driven_rendering(coeff).numpy())
