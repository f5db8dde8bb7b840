"""The port's mesh rasterizer on the CPU, held against the JAX package's
`rasterize` and against the brute-force oracle of tests/test_rasterizer.py;
and, on a CUDA device, the card against the CPU.

Against JAX (the same float32 formulas, in another evaluation order): hit
masks equal, face ids equal on ≥ 99.9% of hit pixels (an exact z tie or an
edge pixel may resolve the other way), z and barycentrics to 1e-4 where the
face ids agree.

    python -m pytest --noconftest -m cuda tests/test_torch_rasterizer.py
"""

import numpy as np
import pytest
import torch

from invertavatar_torch.render.rasterizer import (
    face_vertices,
    interpolate_attributes,
    rasterize,
)

# one intra-op thread: the suite runs test files in parallel worker processes
torch.set_num_threads(1)


def _mixed_mesh(seed, V=60, n_small=50, n_big=12):
    """Tiny faces (span ≤2 tiles: the anchor class) and image-spanning ones
    (the overflow class), random depths."""
    rng = np.random.RandomState(seed)
    verts = np.stack([rng.uniform(-1, 1, V), rng.uniform(-1, 1, V), rng.uniform(0.5, 2.0, V)],
                     axis=-1)
    centers = rng.uniform(-0.9, 0.9, (n_small, 2))
    sv = np.concatenate([centers[:, None, :] + rng.uniform(-0.05, 0.05, (n_small, 3, 2)),
                         rng.uniform(0.5, 2.0, (n_small, 3, 1))], axis=-1).reshape(-1, 3)
    faces = np.concatenate([rng.randint(0, V, (n_big, 3)),
                            V + np.arange(3 * n_small).reshape(n_small, 3)])
    return np.concatenate([verts, sv]).astype(np.float32), faces.astype(np.int32)


def _slivers(seed, n=60):
    """Thin diagonal slivers whose bboxes cover tiles the triangle misses."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(-0.9, 0.9, (n, 2))
    d = rng.uniform(-1, 1, (n, 2))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    perp = np.stack([-d[:, 1], d[:, 0]], 1)
    sv = np.stack([base, base + d * rng.uniform(0.2, 0.5, (n, 1)),
                   base + perp * rng.uniform(0.02, 0.08, (n, 1))], axis=1)
    z = rng.uniform(0.5, 2.0, (n, 3, 1))
    verts = np.concatenate([sv, z], axis=-1).astype(np.float32).reshape(-1, 3)
    return verts, np.arange(3 * n).reshape(n, 3).astype(np.int32)


def _crowded(seed, n=300):
    """Many small faces in one tile: more candidates than `faces_per_tile`."""
    rng = np.random.RandomState(seed)
    c = rng.uniform(-0.9, -0.6, (n, 2))
    sv = np.concatenate([c[:, None, :] + rng.uniform(-0.1, 0.1, (n, 3, 2)),
                         rng.uniform(0.5, 2.0, (n, 3, 1))], axis=-1)
    return sv.astype(np.float32).reshape(-1, 3), np.arange(3 * n).reshape(n, 3).astype(np.int32)


def _port(verts, faces, **kw):
    out = rasterize(torch.from_numpy(verts), torch.from_numpy(faces), **kw)
    return out.face_id.numpy(), out.bary.numpy(), out.zbuf.numpy()


def _assert_close(port, ref):
    (f, b, z), (rf, rb, rz) = port, ref
    np.testing.assert_array_equal(f >= 0, rf >= 0)
    hits = rf >= 0
    assert hits.sum() > 50
    same = f == rf
    assert same[hits].mean() >= 0.999, same[hits].mean()
    np.testing.assert_allclose(z[hits & same], rz[hits & same], atol=1e-4)
    np.testing.assert_allclose(b[hits & same], rb[hits & same], atol=1e-4)


CASES = {
    "mixed_sort": (_mixed_mesh, dict(binning="sort")),
    "mixed_anchor": (_mixed_mesh, dict(binning="anchor", big_cap=16)),
    "slivers_anchor_exact_cover": (_slivers, dict(binning="anchor", big_cap=16,
                                                  exact_cover=True)),
    "crowded_sort": (_crowded, dict(binning="sort")),
    "crowded_anchor": (_crowded, dict(binning="anchor", big_cap=16)),
}


@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_rasterize_matches_jax(case, cull):
    """Each binning (sort, anchor, anchor with exact cover), culling on and
    off; the crowded meshes put ~300 faces in one tile against a capacity
    of 64, so both sides must drop the same faces."""
    import jax.numpy as jnp

    from invertavatar_tpu.render.rasterizer import rasterize as jax_rasterize

    make, kw = CASES[case]
    verts, faces = make(seed=sorted(CASES).index(case))
    kw = dict(kw, height=64, width=64, tile=16, faces_per_tile=64, chunk=16, cull_backfaces=cull)
    ref = jax_rasterize(jnp.asarray(verts), jnp.asarray(faces), **kw)
    ref = tuple(np.asarray(a) for a in (ref.face_id, ref.bary, ref.zbuf))
    if case.startswith("crowded"):
        # the capacity is really exceeded: some faces of that tile are dropped
        full = _port(verts, faces, **dict(kw, faces_per_tile=512, chunk=64))
        assert (full[0] != ref[0]).any()
    _assert_close(_port(verts, faces, **kw), ref)


def test_rasterize_matches_bruteforce():
    """The oracle's bar (tests/test_rasterizer.py): hit masks equal, face ids
    ≥ 99.9%, z and barycentrics to 1e-4."""
    from tests.test_rasterizer import brute_force_raster

    rng = np.random.RandomState(0)
    V, F, H = 30, 40, 64
    verts = np.stack([rng.uniform(-1, 1, V), rng.uniform(-1, 1, V), rng.uniform(0.5, 2.0, V)],
                     axis=-1).astype(np.float32)
    faces = rng.randint(0, V, (F, 3)).astype(np.int32)
    ref = brute_force_raster(verts, faces, H, H)
    _assert_close(_port(verts, faces, height=H, width=H, tile=16, faces_per_tile=64, chunk=16,
                        cull_backfaces=False), ref)


def test_interpolate_attributes_matches_jax():
    """Interpolated attributes and the visibility channel against JAX, to 1e-5;
    a linear attribute reproduces its plane."""
    import jax.numpy as jnp

    from invertavatar_tpu.render import rasterizer as jr

    verts, faces = _mixed_mesh(seed=5)
    rng = np.random.RandomState(6)
    attr_v = rng.randn(verts.shape[0], 3).astype(np.float32)
    kw = dict(height=64, width=64, tile=16, faces_per_tile=64, chunk=16, cull_backfaces=False)
    ref = np.asarray(jr.interpolate_attributes(
        jr.rasterize(jnp.asarray(verts), jnp.asarray(faces), **kw),
        jr.face_vertices(jnp.asarray(attr_v), jnp.asarray(faces))))
    out = interpolate_attributes(rasterize(torch.from_numpy(verts), torch.from_numpy(faces), **kw),
                                 face_vertices(torch.from_numpy(attr_v), torch.from_numpy(faces)))
    assert out.shape == (64, 64, 4)
    np.testing.assert_array_equal(out[..., 3].numpy(), ref[..., 3])
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)

    plane_v = np.array([[-0.9, -0.9, 1.0], [0.9, -0.9, 1.0], [-0.9, 0.9, 1.0]], np.float32)
    tri = np.array([[0, 1, 2]], np.int32)
    lin = torch.from_numpy(plane_v[:, 0] + 2 * plane_v[:, 1])[:, None]
    img = interpolate_attributes(
        rasterize(torch.from_numpy(plane_v), torch.from_numpy(tri), height=32, width=32, tile=16,
                  faces_per_tile=16, chunk=8, cull_backfaces=False),
        face_vertices(lin, torch.from_numpy(tri))).numpy()
    hit = img[..., 1] > 0
    ii, jj = np.mgrid[0:32, 0:32]
    expect = ((jj + 0.5) / 32 * 2 - 1) + 2 * ((ii + 0.5) / 32 * 2 - 1)
    np.testing.assert_allclose(img[..., 0][hit], expect[hit], atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("binning", ["sort", "anchor"])
def test_cuda_rasterize_matches_cpu(binning):
    """The raster on the card against the CPU at the driving configuration's
    tiling (256², tile 32, capacity 1024, chunk 256) on a 30k-vertex grid
    mesh: hit masks on ≥ 99.9% of pixels, face ids ≥ 99.9% of hits, z and
    barycentrics 1e-4 where the ids agree."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from invertavatar_torch.faceverse.synthetic import synthetic_assets

    a = synthetic_assets(n_grid=173, seed=0)
    v = a.meanshape.reshape(-1, 3) * 3.0
    kw = dict(height=256, width=256, cull_backfaces=False, binning=binning)
    outs = [rasterize(torch.from_numpy(v).to(d), torch.from_numpy(a.tri).to(d), **kw)
            for d in ("cuda", "cpu")]
    (f, b, z), (rf, rb, rz) = ([t.cpu().numpy() for t in o] for o in outs)
    assert ((f >= 0) == (rf >= 0)).mean() >= 0.999
    hits = (rf >= 0) & (f >= 0)
    same = f == rf
    assert hits.sum() > 1000 and same[hits].mean() >= 0.999
    np.testing.assert_allclose(z[hits & same], rz[hits & same], atol=1e-4)
    np.testing.assert_allclose(b[hits & same], rb[hits & same], atol=1e-4)
