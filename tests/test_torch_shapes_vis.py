"""The port's shape and visualisation helpers (`utils/shapes.py`,
`utils/vis.py`) against the JAX package: the voxel grid and the density
volume, the cross-section through `TriPlaneGenerator.sample_mixed`, the
vertex-image visualisation and the PNG grid, to 1e-5 (exactly where both
sides run the same numpy)."""

import numpy as np
import PIL.Image
import pytest
import torch

import jax.numpy as jnp

from invertavatar_torch.utils import shapes as ps
from invertavatar_torch.utils import vis as pv
from invertavatar_tpu.utils import shapes as js
from invertavatar_tpu.utils import vis as jv

torch.set_num_threads(1)


def _sphere(coords, ws, v):
    r = torch.linalg.norm(coords, dim=-1, keepdim=True)
    return {"sigma": torch.exp(-r / 0.05) + 0 * ws.sum()}


def _sphere_j(coords, ws, v):
    r = jnp.linalg.norm(coords, axis=-1, keepdims=True)
    return {"sigma": jnp.exp(-r / 0.05)}


def test_voxel_samples_and_density_grid_match_jax():
    for a, b in zip(ps.create_samples(8, (0.1, 0, -0.2), 1.5),
                    js.create_samples(8, (0.1, 0, -0.2), 1.5)):
        np.testing.assert_array_equal(a, b)
    ws = torch.zeros(1, 4, 8)
    vol = ps.sample_density_grid(_sphere, ws, None, voxel_resolution=16, max_batch=1000,
                                 device="cpu")
    ref = js.sample_density_grid(_sphere_j, None, None, voxel_resolution=16, max_batch=1000)
    assert vol.shape == (16, 16, 16) and vol[8, 8, 8] > vol[0, 0, 0]
    np.testing.assert_allclose(vol, ref, atol=1e-5, rtol=0)


def test_cross_section_through_sample_mixed_matches_jax():
    """The cross-section's coordinates on a toy density, against JAX; then
    through the port's tiny generator's `sample_mixed`, against a direct
    call on the same coordinates."""
    cs = pv.sample_cross_section(_sphere, torch.zeros(2, 4, 8), None, resolution=32, w=0.5)
    ref = jv.sample_cross_section(_sphere_j, jnp.zeros((2, 4, 8)), None, resolution=32, w=0.5)
    assert cs.shape == (2, 1, 32, 32)
    np.testing.assert_allclose(cs, np.moveaxis(np.asarray(ref), -1, 1), atol=1e-5, rtol=0)

    from invertavatar_torch.flagship import example_inputs
    from tests.test_torch_gan import _gen_cfg, _rk
    from invertavatar_torch.models.triplane import TriPlaneGenerator

    torch.manual_seed(0)
    G = TriPlaneGenerator(**_gen_cfg(_rk())).eval()
    z, c, uvc = (torch.from_numpy(a) for a in example_inputs(1))
    with torch.no_grad():
        ws = G.mapping(z[:, :32], c)
    mesh = {"uvcoords_image": uvc}
    kw = dict(noise_mode="const")
    cs = pv.sample_cross_section(lambda x, w, m: G.sample_mixed(x, w, m, **kw), ws, mesh,
                                 resolution=16, w=1.2)
    a = torch.linspace(0.6, -0.6, 16)
    A, B = torch.meshgrid(a, -a, indexing="ij")
    coords = torch.stack([torch.zeros_like(A), A, B], -1).reshape(1, -1, 3)
    with torch.no_grad():
        direct = G.sample_mixed(coords, ws, mesh, **kw)["sigma"].reshape(1, 1, 16, 16)
    assert np.isfinite(cs).all() and cs.std() > 0
    np.testing.assert_allclose(cs, direct.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("fill", [False, True])
def test_visualize_mesh_condition_matches_jax(fill):
    rng = np.random.RandomState(1)
    uvc = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    uvc[..., 2] = rng.rand(2, 16, 16) > 0.4
    alpha = (rng.rand(2, 16, 16, 1) > 0.5).astype(np.float32) if fill else None
    np.testing.assert_array_equal(pv.visualize_mesh_condition(uvc, alpha),
                                  jv.visualize_mesh_condition(uvc, alpha))


@pytest.mark.parametrize("n,grid_wh,channels", [(5, None, 3), (4, (4, 1), 1)])
def test_save_image_grid_matches_jax(tmp_path, n, grid_wh, channels):
    imgs = np.random.RandomState(n).uniform(-1.2, 1.2, (n, channels, 8, 6)).astype(np.float32)
    pv.save_image_grid(torch.from_numpy(imgs), str(tmp_path / "p.png"), grid_wh=grid_wh)
    jv.save_image_grid(np.moveaxis(imgs, 1, -1), str(tmp_path / "j.png"), grid_wh=grid_wh)
    np.testing.assert_array_equal(np.asarray(PIL.Image.open(tmp_path / "p.png")),
                                  np.asarray(PIL.Image.open(tmp_path / "j.png")))
