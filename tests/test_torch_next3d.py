"""The port's legacy Next3D family (`invertavatar_torch/models/next3d.py`) and the
renderer's `next3d` plane mode against the JAX package on the same weights
and inputs.

JAX variables come from `init` at fixed keys, their 1-D parameters and
buffers randomised (`tests/test_torch_encoders.py::_randomize`) and every
`noise_strength` set to 0.1 so that the const noise counts; `jax_to_state_dict`
carries them into the port, loaded strictly (a generator's JAX tree lacks
the mapping networks flax never ran: exactly those may be missing). The
mesh is the synthetic UV-sphere of `tests/test_next3d.py` (no FLAME asset
is in the repository); renders use `det_stratified`, so no offset is drawn.
Tolerances are 1e-4 absolute unless a case states another with its reason.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from invertavatar_tpu.models import next3d as jn
from invertavatar_torch.models import next3d as tn
from invertavatar_torch.utils.weights import jax_to_state_dict
from tests.test_next3d import RENDER_KWARGS_NEXT3D, _sphere_topology
from tests.test_torch_encoders import _randomize

# one intra-op thread: the suite runs test files in parallel worker processes
torch.set_num_threads(1)

ATOL = 1e-4


def _nchw(x):
    """[..., H, W, C] numpy/JAX -> [..., C, H, W] torch."""
    x = np.array(x, np.float32)
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


def _err(got, ref):
    ref = torch.as_tensor(np.array(ref, np.float32))
    assert tuple(got.shape) == tuple(ref.shape), (tuple(got.shape), tuple(ref.shape))
    assert torch.isfinite(got).all()
    return (got.detach().float() - ref).abs()


def _close(got, ref, atol=ATOL):
    err = _err(got, ref).max().item()
    assert err < atol, err


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _init_rngs(seed):
    k = jax.random.PRNGKey(seed)
    return {"params": k, "buffers": jax.random.fold_in(k, 1), "noise": jax.random.fold_in(k, 2)}


def _randomized(variables, seed):
    """`_randomize`, and every noise strength 0.1."""
    out = _randomize(variables, seed)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                (np.float32(0.1) if k == "noise_strength" else v) for k, v in tree.items()}

    return {coll: walk(tree) for coll, tree in out.items()}


def _load(port, variables, unused=()):
    """Load strictly, but for the modules in `unused`: flax creates a
    module's variables only when it runs, and the generators never call the
    mapping networks of their other backbones (the torch reference has
    them, and so does the port)."""
    missing, unexpected = port.load_state_dict(jax_to_state_dict(variables), strict=False)
    assert not unexpected, unexpected
    assert {k.split(".mapping.")[0] for k in missing} == set(unused), missing
    return port.eval()


UNUSED_MAPPINGS = {"next3d": ("texture_backbone", "mouth_backbone", "neural_blending"),
                   "legacy": ("texture_backbone",)}


# ------------------------------------------------------------ the backbone

COND_KW = {
    "deep": dict(w_dim=64, img_resolution=64, img_channels=8, cond_channels=6, in_size=16,
                 final_size=4, channel_base=512, channel_max=64, num_fp16_res=0,
                 num_cond_res=16),
    # neural_blending's shape: the pyramid starts at 32² beside a 64² condition
    "shallow": dict(w_dim=64, img_resolution=64, img_channels=8, cond_channels=6, in_size=64,
                    final_size=32, channel_base=512, channel_max=64, num_fp16_res=0,
                    num_cond_res=64),
}


@pytest.mark.parametrize("shape", ["deep", "shallow"])
def test_cond_synthesis_network(shape):
    """Only the used blocks exist, each reading its w slice of the full
    pyramid (`num_ws` counts from 4²)."""
    kw = COND_KW[shape]
    jm = jn.CondSynthesisNetwork(**kw)
    pm = tn.CondSynthesisNetwork(device="cpu", **kw)
    assert pm.num_ws == jm.num_ws
    x = _rand(0, 2, kw["in_size"], kw["in_size"], 6)
    ws = _rand(1, 2, jm.num_ws, 64)
    variables = _randomized(jm.init(_init_rngs(0), jnp.asarray(x), jnp.asarray(ws),
                                    noise_mode="const"), 0)
    ref = jm.apply(variables, jnp.asarray(x), jnp.asarray(ws), noise_mode="const")
    with torch.no_grad():
        out = _load(pm, variables)(_nchw(x), torch.from_numpy(ws), noise_mode="const")
    _close(out, _nchw(ref))


def test_cond_generator():
    kw = dict(COND_KW["deep"], z_dim=16, c_dim=0, map_num_layers=2)
    jm = jn.CondGenerator(**kw)
    pm = tn.CondGenerator(device="cpu", **kw)
    z, x = _rand(7, 2, 16), _rand(8, 2, 16, 16, 6)
    variables = _randomized(jm.init(_init_rngs(7), jnp.asarray(z), None, jnp.asarray(x),
                                    noise_mode="const"), 7)
    assert pm.num_ws == jm.apply(variables, method=lambda m: m.num_ws)
    ref = jm.apply(variables, jnp.asarray(z), None, jnp.asarray(x), noise_mode="const")
    with torch.no_grad():
        out = _load(pm, variables)(torch.from_numpy(z), None, _nchw(x), noise_mode="const")
    _close(out, _nchw(ref))


# ---------------------------------------------------- mouth boxes, topology


def test_mouth_boxes_crop_and_paste():
    """Fractional boxes, the second partly outside the image: the boxes, the
    64² crops (zeros outside) and the paste."""
    rng = np.random.RandomState(2)
    lm = (rng.rand(2, 68, 2) * 0.6 - 0.3).astype(np.float32)
    lm[1, 48:60] += np.float32(0.95)  # the second mouth past the image's corner
    boxes_j = jn.gen_mouth_mask(jnp.asarray(lm))
    boxes = tn.gen_mouth_mask(torch.from_numpy(lm))
    _close(boxes, boxes_j, atol=1e-4)
    b = np.asarray(boxes_j)
    assert (b != np.round(b)).all() and b[1].max() > 256
    img = _rand(3, 2, 256, 256, 4)
    crop_j = jn.crop_resize_boxes(jnp.asarray(img), boxes_j, out=64)
    crop = tn.crop_resize_boxes(_nchw(img), torch.from_numpy(b.copy()), out=64)
    _close(crop, _nchw(crop_j))
    patch = _rand(4, 2, 64, 64, 4)
    pasted_j = jn.paste_boxes(jnp.asarray(img), jnp.asarray(patch), boxes_j)
    pasted = tn.paste_boxes(_nchw(img), _nchw(patch), torch.from_numpy(b.copy()))
    _close(pasted, _nchw(pasted_j))
    assert not torch.equal(pasted, _nchw(img))


def test_parse_obj_topology_and_dense_triangles(tmp_path):
    """Bit for bit: the parsed arrays (with and without uv indices), the
    raster buffers and the dense grid triangles."""
    p = tmp_path / "t.obj"
    p.write_text("# a quad\nv 0 0 0\nv 1 0 0\nv 0 1 0.5\nv 1 1 0.25\nvt 0 0\nvt 1 0\n"
                 "vt 0 1\nvt 1 1\n\nf 1/1 2/2 3/3\nf 2/2/1 4/4/1 3/3/1\nf 1 3 4\n")
    got, ref = tn.parse_obj(str(p)), jn.parse_obj(str(p))
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    _, uvs, faces, uvfaces = ref
    mask = np.random.RandomState(5).rand(1, 256, 256, 1).astype(np.float32)
    tg = tn.make_topology(uvs, faces, uvfaces, mask, n_verts=4)
    tr = jn.make_topology(uvs, faces, uvfaces, mask, n_verts=4)
    for name in ("faces", "face_uvcoords", "uv_face_mask"):
        np.testing.assert_array_equal(getattr(tg, name), getattr(tr, name))
    assert tg.n_verts == tr.n_verts == 4
    for h, w in ((16, 16), (24, 40)):
        g, r = tn.generate_dense_grid_triangles(h, w), jn.generate_dense_grid_triangles(h, w)
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


def test_load_flame_topology_resizes_the_mask(tmp_path):
    """A 200×200 three-channel PNG: channel 0, nearest-resized to 256² with
    half-pixel centres (torch's "nearest-exact", JAX's "nearest")."""
    cv2 = pytest.importorskip("cv2")
    obj = tmp_path / "head.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 0 1\nf 1/1 2/2 3/3\n")
    png = tmp_path / "mask.png"
    cv2.imwrite(str(png), np.random.RandomState(6).randint(0, 256, (200, 200, 3), np.uint8))
    got = tn.load_flame_topology(str(obj), str(png))
    ref = jn.load_flame_topology(str(obj), str(png))
    assert got.uv_face_mask.shape == (1, 256, 256, 1)
    np.testing.assert_array_equal(got.uv_face_mask, ref.uv_face_mask)
    np.testing.assert_array_equal(got.face_uvcoords, ref.face_uvcoords)
    # plain "nearest" (no half-pixel centres) would differ
    plain = torch.nn.functional.interpolate(
        torch.from_numpy(cv2.imread(str(png))[:, :, 0] / np.float32(255.0))[None, None],
        size=(256, 256), mode="nearest")[0, 0].numpy()
    assert not np.array_equal(plain, ref.uv_face_mask[0, :, :, 0])


# ------------------------------------------------------------ generators

GEN_KW = dict(z_dim=32, c_dim=25, w_dim=512, img_resolution=128, img_channels=3,
              neural_rendering_resolution=32, channel_base=512, channel_max=64,
              num_fp16_res=0, map_num_layers=2, faces_per_tile=512)
RK = dict(RENDER_KWARGS_NEXT3D, det_stratified=True)


def _topologies():
    verts, topo = _sphere_topology()
    port = tn.FlameTopology(faces=topo.faces, face_uvcoords=topo.face_uvcoords,
                            uv_face_mask=topo.uv_face_mask, n_verts=topo.n_verts)
    return verts, topo, port


def _camera(B=1):
    from invertavatar_tpu.camera import fov_to_intrinsics, lookat_camera_pose

    c2w = np.asarray(lookat_camera_pose(None, np.pi / 2 + 0.2, np.pi / 2 - 0.1,
                                        jnp.array([0.0, 0.0, 0.0]), radius=2.7, batch_size=B))
    K = np.tile(np.asarray(fov_to_intrinsics(18.837))[None], (B, 1, 1))
    return np.concatenate([c2w.reshape(B, 16), K.reshape(B, 9)], axis=1).astype(np.float32)


def _next3d_vertices(verts, seed=0):
    lms = verts[np.random.RandomState(seed).choice(len(verts), 68)]
    return np.concatenate([verts, lms], axis=0)[None]


def test_rasterize_views():
    """The four ortho views of the sphere: renders of a random texture, the
    face-mask-weighted and mouth-filled alphas, and the landmarks."""
    verts, topo, ptopo = _topologies()
    v = _next3d_vertices(verts)
    tex = _rand(9, 1, 256, 256, 32)
    jm = jn.Next3DTriPlaneGenerator(topology=topo, rendering_kwargs=RK, **GEN_KW)
    n = topo.n_verts
    ref = jm.apply({}, jnp.asarray(v[:, :n]), jnp.asarray(v[:, n:]), jnp.asarray(tex),
                   method=jm.rasterize_views)
    pm = tn.Next3DTriPlaneGenerator(topology=ptopo, rendering_kwargs=RK, device="cpu", **GEN_KW)
    with torch.no_grad():
        got = pm.rasterize_views(torch.from_numpy(v[:, :n]), torch.from_numpy(v[:, n:]),
                                 _nchw(tex))
    renders, alphas, lm2ds = got
    for g, r in zip(renders, ref[0]):
        _close(g, _nchw(r))
    for g, r in zip(alphas, ref[1]):
        _close(g, _nchw(r))
        assert 0 < g.mean() < 1
    for g, r in zip(lm2ds, ref[2]):
        _close(g, r, atol=1e-5)


# The views' rotations and constant vectors as the frame made them before
# they were made once a device (`tn.view_constants`): copied from host memory
# at each call. The port's views must give these outputs bit for bit.


def _vec_per_call(values, like):
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def _transform_per_call(v, rot):
    v = v.float() * _vec_per_call([1.0, -1.0, 1.0], v)
    tv = (v @ rot + _vec_per_call(tn._ORTH_SHIFT, v)) * tn._ORTH_SCALE
    return tv * _vec_per_call([1.0, -1.0, -1.0], v) + _vec_per_call([0.0, 0.0, 10.0], v)


def _views_per_call(G, v, lms, textures):
    uv_mask = G.uv_face_mask.expand(v.shape[0], -1, -1, -1)
    renders, alphas, lm2ds = [], [], []
    for view in tn._VIEWS_DEG:
        rot = torch.from_numpy(tn._angle2matrix_np(view)).to(v.device)
        tv = _transform_per_call(v, rot)
        lm = (lms.float() * _vec_per_call([1.0, -1.0, 1.0], lms) @ rot
              + _vec_per_call(tn._ORTH_SHIFT, lms)) * tn._ORTH_SCALE
        lm2ds.append(lm[..., :2] * _vec_per_call([1.0, -1.0], lms))
        rendering = G._raster(tv, G.faces, G.face_uvcoords).detach()
        grid = rendering[..., :2]
        alpha = tn.grid_sample(uv_mask, grid) * rendering[..., 3:4].permute(0, 3, 1, 2)
        if G.do_fill_mouth:
            alpha, _ = tn.fill_mouth(alpha)
        renders.append(tn.grid_sample(textures, grid))
        alphas.append(alpha)
    alpha_side = (alphas[1] > 0).float()
    return ([renders[0], renders[1] + renders[2], renders[3]],
            [alphas[0], alpha_side, alphas[3]], lm2ds)


def _orth_per_call(G, v, textures):
    faces = G.faces[:, [0, 2, 1]]
    face_attrs = G.face_uvcoords[:, [0, 2, 1]]
    renders, alphas = [], []
    for view in tn._LEGACY_VIEWS_DEG:
        rot = torch.from_numpy(tn._angle2matrix_np(view)).to(v.device)
        tv = (v.float() @ rot) * G.orth_scale * _vec_per_call([1.0, -1.0, -1.0], v)
        rendering = G._raster(tv, faces, face_attrs).detach()
        alphas.append(rendering[..., 3:4].permute(0, 3, 1, 2))
        renders.append(tn.grid_sample(textures, rendering[..., :2]))
    return torch.stack(renders, dim=1), torch.stack(alphas, dim=1)


def _flat(x):
    return [t for item in x for t in (_flat(item) if isinstance(item, (list, tuple)) else [item])]


@pytest.mark.parametrize("generator", ["next3d", "legacy"])
def test_views_bitwise_as_with_per_call_constants(generator):
    """Two items of the jittered sphere, moved apart: every output of
    `rasterize_views` (and `transform_to_view` of each view) or
    `rasterize_orth` equals, bit for bit, what the per-call constants give;
    the constants are made once for the device."""
    verts, _, ptopo = _topologies()
    v = _next3d_vertices(_jittered(verts))
    v = np.concatenate([v, v * np.float32(0.9) + np.float32(0.02)], axis=0)
    tex = _nchw(_rand(18, 2, 256, 256, 32))
    consts = tn.view_constants(torch.device("cpu"))
    with torch.no_grad():
        if generator == "next3d":
            G = tn.Next3DTriPlaneGenerator(topology=ptopo, rendering_kwargs=RK, device="cpu",
                                           **GEN_KW)
            n = ptopo.n_verts
            vt, lms = torch.from_numpy(v[:, :n]), torch.from_numpy(v[:, n:])
            got, want = G.rasterize_views(vt, lms, tex), _views_per_call(G, vt, lms, tex)
            for rot, view in zip(consts["views"], tn._VIEWS_DEG):
                assert torch.equal(rot, torch.from_numpy(tn._angle2matrix_np(view)))
                assert torch.equal(tn.transform_to_view(vt, rot), _transform_per_call(vt, rot))
        else:
            G = tn.LegacyTriPlaneGenerator(topology=ptopo, rendering_kwargs=RK, device="cpu",
                                           **GEN_KW)
            vt = torch.from_numpy(v[:, :ptopo.n_verts])
            got, want = G.rasterize_orth(vt, tex), _orth_per_call(G, vt, tex)
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want) == (10 if generator == "next3d" else 2)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert tn.view_constants(torch.device("cpu")) is consts
    assert not any("view" in k for k in G.state_dict())


@pytest.fixture(scope="module")
def next3d_pair():
    """The tiny Next3D generator in both packages on the same weights, and
    its inputs (the JAX smoke test's geometry)."""
    verts, topo, ptopo = _topologies()
    v = _next3d_vertices(verts)
    c = _camera()
    z = _rand(10, 1, 32)
    jm = jn.Next3DTriPlaneGenerator(topology=topo, rendering_kwargs=RK, **GEN_KW)
    variables = _randomized(jm.init(_init_rngs(3), jnp.asarray(z), jnp.asarray(c),
                                    jnp.asarray(v), noise_mode="const"), 3)
    pm = _load(tn.Next3DTriPlaneGenerator(topology=ptopo, rendering_kwargs=RK, device="cpu",
                                          **GEN_KW), variables, UNUSED_MAPPINGS["next3d"])
    ws = np.asarray(jm.apply(variables, jnp.asarray(z), jnp.asarray(c), method=jm.mapping))
    with torch.no_grad():
        ws_p = pm.mapping(torch.from_numpy(z), torch.from_numpy(c))
    _close(ws_p, ws)
    return jm, variables, pm, ws, c, v


def test_next3d_synthesis(next3d_pair):
    """The whole frame: 4 ortho views, the mouth stitch, neural blending, the
    static blend, the render on the Next3D planes (exact route) and SR."""
    jm, variables, pm, ws, c, v = next3d_pair
    ref = jm.apply(variables, jnp.asarray(ws), jnp.asarray(c), jnp.asarray(v),
                   evaluation=True, noise_mode="const", method=jm.synthesis)
    with torch.no_grad():
        out = pm.synthesis(torch.from_numpy(ws), torch.from_numpy(c), torch.from_numpy(v),
                           evaluation=True, noise_mode="const")
    for key in ("image", "image_raw", "image_depth"):
        _close(out[key], _nchw(ref[key]))


def test_next3d_sample_mixed(next3d_pair):
    jm, variables, pm, ws, c, v = next3d_pair
    pts = (np.random.RandomState(11).rand(1, 500, 3).astype(np.float32) - 0.5) * 0.6
    ref = jm.apply(variables, jnp.asarray(pts), jnp.asarray(ws), jnp.asarray(v),
                   noise_mode="const", method=jm.sample_mixed)
    with torch.no_grad():
        out = pm.sample_mixed(torch.from_numpy(pts), torch.from_numpy(ws), torch.from_numpy(v),
                              noise_mode="const")
    _close(out["sigma"], ref["sigma"])
    _close(out["rgb"], ref["rgb"])


# The legacy views have no shift, so on the sphere as built (symmetric about
# its axes) whole rows of pixel centres lie exactly on mesh edges, where the
# order of float rounding decides coverage: the two packages' rasterizers,
# fed identical vertices, split 32 of the top view's 65,536 pixels the other
# way (XLA fuses the edge functions' multiply-adds, torch does not). The
# legacy comparisons jitter the vertices by 1e-4 (~0.01 pixel), which moves
# every edge off the pixel centres, and bound the ties on the sphere as built.
LEGACY_JITTER = 1e-4


def _jittered(verts):
    return verts + np.random.RandomState(16).randn(*verts.shape).astype(np.float32) * np.float32(
        LEGACY_JITTER)


@pytest.mark.parametrize("jitter", [True, False])
def test_legacy_rasterize_orth(jitter):
    """The three legacy views (winding swapped, camera scale 2): exact on the
    jittered sphere; on the sphere as built, renders and alphas differ only
    at the tie pixels, under 0.1% of a view."""
    verts, topo, ptopo = _topologies()
    v = (_jittered(verts) if jitter else verts)[None]
    tex = _rand(17, 1, 256, 256, 32)
    jm = jn.LegacyTriPlaneGenerator(topology=topo, rendering_kwargs=RK, **GEN_KW)
    rj, aj = jm.apply({}, jnp.asarray(v), jnp.asarray(tex), method=jm.rasterize_orth)
    pm = tn.LegacyTriPlaneGenerator(topology=ptopo, rendering_kwargs=RK, device="cpu", **GEN_KW)
    with torch.no_grad():
        rp, ap = pm.rasterize_orth(torch.from_numpy(v), _nchw(tex))
    if jitter:
        _close(rp, _nchw(rj))
        _close(ap, _nchw(aj))
    else:
        ties = (_err(ap, _nchw(aj)) > 0).flatten(2).sum(dim=2)  # pixels per view
        assert ties.max().item() <= 65536 // 1000, ties
        moved = (_err(rp, _nchw(rj)).amax(dim=2) > ATOL).flatten(2).sum(dim=2)
        assert moved.max().item() <= 65536 // 1000, moved
    assert 0 < ap.mean() < 1


def test_legacy_synthesis():
    """The whole legacy frame on the jittered sphere (see above)."""
    verts, topo, ptopo = _topologies()
    v = _jittered(verts)[None]
    c = _camera()
    z = _rand(12, 1, 32)
    jm = jn.LegacyTriPlaneGenerator(topology=topo, rendering_kwargs=RK, **GEN_KW)
    variables = _randomized(jm.init(_init_rngs(4), jnp.asarray(z), jnp.asarray(c),
                                    jnp.asarray(v), noise_mode="const"), 4)
    pm = _load(tn.LegacyTriPlaneGenerator(topology=ptopo, rendering_kwargs=RK, device="cpu",
                                          **GEN_KW), variables, UNUSED_MAPPINGS["legacy"])
    ref = jm.apply(variables, jnp.asarray(z), jnp.asarray(c), jnp.asarray(v),
                   evaluation=True, noise_mode="const")
    with torch.no_grad():
        out = pm(torch.from_numpy(z), torch.from_numpy(c), torch.from_numpy(v),
                 evaluation=True, noise_mode="const")
    for key in ("image", "image_raw", "image_depth"):
        _close(out[key], _nchw(ref[key]))


# --------------------------------------------------------- the plane modes


@pytest.fixture(scope="module")
def render_inputs():
    """Random planes [1, 3, 64, 64, 32], a seeded decoder in both packages,
    and 32² rays of the tiny generator's camera."""
    from invertavatar_tpu.models.triplane import OSGDecoder as JaxDecoder
    from invertavatar_torch.models.triplane import OSGDecoder
    from invertavatar_torch.render.ray_sampler import sample_rays

    planes = _rand(13, 1, 3, 64, 64, 32)
    jd = JaxDecoder(32, decoder_output_dim=32)
    dvars = _randomize(jd.init(jax.random.PRNGKey(5), jnp.zeros((1, 3, 4, 32))), 5)
    # the bridge renames `decoder.fc0` / `.fc1` to the port's `decoder.net.0` / `.2`
    state = jax_to_state_dict({"params": {"decoder": dvars["params"]}})
    pd = OSGDecoder(32, decoder_output_dim=32)
    pd.load_state_dict({k[len("decoder."):]: v for k, v in state.items()}, strict=True)
    c = torch.from_numpy(_camera())
    ray_o, ray_d = sample_rays(c[:, :16].reshape(-1, 4, 4), c[:, 16:25].reshape(-1, 3, 3), 32)
    return planes, (jd, dvars), pd, ray_o, ray_d


def _renders(render_inputs, plane_mode, rk, b3_payloads=None):
    """(port, JAX) (rgb, depth, Σw) of one evaluation render; the payload
    dtype of each B3 call the port makes goes into `b3_payloads`."""
    from invertavatar_tpu.render.renderer import ImportanceRenderer as JaxRenderer
    from invertavatar_torch.render import renderer as rmod

    planes, (jd, dvars), pd, ray_o, ray_d = render_inputs
    ref = JaxRenderer(plane_mode)(jnp.asarray(planes), lambda f: jd.apply(dvars, f),
                                  jnp.asarray(ray_o.numpy()), jnp.asarray(ray_d.numpy()), rk,
                                  evaluation=True)
    sample = rmod.sample_planes_windowed

    def recorded(planes_cl, grid, payload_dtype=torch.float32):
        b3_payloads.append(payload_dtype)
        return sample(planes_cl, grid, payload_dtype)

    try:
        if b3_payloads is not None:
            rmod.sample_planes_windowed = recorded
        with torch.no_grad():
            got = rmod.ImportanceRenderer(plane_mode)(_nchw(planes), pd, ray_o, ray_d, rk,
                                                      evaluation=True)
    finally:
        rmod.sample_planes_windowed = sample
    return got, ref


RENDER_RK = dict(RK, depth_resolution=12, depth_resolution_importance=12)


@pytest.mark.parametrize("plane_mode", ["v20", "next3d"])
def test_renderer_plane_modes_exact_route(render_inputs, plane_mode):
    """A whole render on the exact route in each plane mode, and `run_model`
    at scattered points."""
    from invertavatar_tpu.render.renderer import ImportanceRenderer as JaxRenderer
    from invertavatar_torch.render.renderer import ImportanceRenderer

    got, ref = _renders(render_inputs, plane_mode, RENDER_RK)
    for g, r in zip(got, ref):
        _close(g, r)
    planes, (jd, dvars), pd, _, _ = render_inputs
    pts = (np.random.RandomState(14).rand(1, 300, 3).astype(np.float32) - 0.5) * 0.9
    ref = JaxRenderer(plane_mode).run_model(jnp.asarray(planes), lambda f: jd.apply(dvars, f),
                                            jnp.asarray(pts), RENDER_RK)
    with torch.no_grad():
        out = ImportanceRenderer(plane_mode).run_model(_nchw(planes), pd,
                                                       torch.from_numpy(pts), RENDER_RK)
    _close(out["sigma"], ref["sigma"])
    _close(out["rgb"], ref["rgb"])


def test_renderer_next3d_projection_reads_z_y():
    """The Next3D set reads (x, y), (x, z), (z, y); the v20 set (x, y),
    (x, z), (z, x). Both match JAX's einsum projection bit for bit."""
    from invertavatar_tpu.render.renderer import NEXT3D_PLANE_AXES_INV as JAX_INV
    from invertavatar_tpu.render.renderer import project_onto_planes as jax_project
    from invertavatar_torch.render.renderer import (
        ImportanceRenderer,
        NEXT3D_PLANE_AXES_INV,
        project_onto_planes,
    )

    np.testing.assert_array_equal(NEXT3D_PLANE_AXES_INV, JAX_INV)
    x = _rand(15, 2, 50, 3)
    for mode, inv in (("v20", None), ("next3d", JAX_INV)):
        got = project_onto_planes(torch.from_numpy(x), ImportanceRenderer(mode).picks)
        assert torch.equal(got, torch.from_numpy(np.asarray(jax_project(jnp.asarray(x), inv))))
    n3 = project_onto_planes(torch.from_numpy(x), ImportanceRenderer("next3d").picks)
    assert torch.equal(n3[:, 2], torch.from_numpy(x[..., [2, 1]]))
    with pytest.raises(ValueError):
        ImportanceRenderer("v21")


def test_renderer_next3d_pallas_exact_route(render_inputs):
    """`pallas_coarse` + `pallas_exact` in evaluation: the coarse pass on
    B3's float32 plain version (`sample_planes_windowed_reference`); JAX off
    the TPU takes its exact route. Float32 both sides: 1e-4."""
    rk = dict(RENDER_RK, pallas_coarse=True, pallas_exact=True)
    payloads = []
    got, ref = _renders(render_inputs, "next3d", rk, payloads)
    assert payloads == [torch.float32]  # one B3 call, the coarse pass
    for g, r in zip(got, ref):
        _close(g, r)


def test_renderer_next3d_pallas_coarse_route(render_inputs):
    """`pallas_coarse` in evaluation: the coarse pass on B3's bfloat16 plain
    version and the fine pass on bf16-rounded planes, against JAX's float32
    route off the TPU. Rounding the payload to bf16 moves features by ~1e-2
    (JAX's note, render/renderer.py:284-286); averaged over the planes and
    marched, the outputs here moved by 1.6e-4 max and 2.0e-5 mean. Held
    within 2e-3 max and 2e-4 mean, and it must differ from the exact route
    (the bf16 payload is really used)."""
    rk = dict(RENDER_RK, pallas_coarse=True)
    payloads = []
    got, ref = _renders(render_inputs, "next3d", rk, payloads)
    assert payloads == [torch.bfloat16]  # one B3 call, the coarse pass
    exact, _ = _renders(render_inputs, "next3d", RENDER_RK)
    for g, r, e in zip(got, ref, exact):
        err = _err(g, r)
        assert err.max().item() < 2e-3 and err.mean().item() < 2e-4, (err.max(), err.mean())
        assert not torch.equal(g, e)


def test_next3d_modules_default_to_the_card(monkeypatch):
    """Built without a device the Next3D modules go to CUDA, and raise where
    there is none rather than stay on the CPU."""
    _, _, ptopo = _topologies()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: tn.Next3DTriPlaneGenerator(topology=ptopo, **GEN_KW),
                  lambda: tn.LegacyTriPlaneGenerator(topology=ptopo, **GEN_KW),
                  lambda: tn.CondGenerator(z_dim=16, c_dim=0, **COND_KW["deep"]),
                  lambda: tn.CondSynthesisNetwork(**COND_KW["deep"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
