"""The fused render kernels' plain versions and the port's renderer on the CPU,
held against the JAX package in Pallas interpret mode; and, on a CUDA device,
each kernel against its plain version.

Setups and bands follow tests/test_pallas_interpret.py: res 32, S 4, tile 8,
C 8 for the kernel; `_renderer_setup` for the renderer. The bf16 payload is
read by both sides, so the bands are those of the bf16 fast path (the TPU
kernel also rounds its tent weights and partial sums to bf16).

JAX is imported inside the tests that use it, so that the CUDA test also runs
on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_render.py
"""

import numpy as np
import pytest
import torch

from invertavatar_torch.ops import fused_render as fr
from invertavatar_torch.render.renderer import ImportanceRenderer

# one intra-op thread: the suite runs test files in parallel worker processes
torch.set_num_threads(1)


def _structured_grid(rng, N, res, S, spread=0.08, scale=1.1):
    """Tile-coherent sampling grid like the real coarse pass (numpy; the same
    draws as tests/test_pallas_interpret.py's helper)."""
    ys, xs = np.mgrid[0:res, 0:res].astype(np.float32) / res
    base = np.stack([xs * 2 - 1, ys * 2 - 1], -1).reshape(res * res, 2)
    offs = (rng.rand(res * res, S, 2) - 0.5) * spread
    grid = np.clip(base[:, None, :] * scale + offs, -1.15, 1.15).astype(np.float32)
    return np.broadcast_to(grid[None], (N, res * res, S, 2)).copy()


def _decoder_params(rng, C=8, HID=16, OUT=8):
    return (rng.randn(C, HID).astype(np.float32) * 0.3, rng.randn(HID).astype(np.float32) * 0.1,
            rng.randn(HID, 1 + OUT).astype(np.float32) * 0.3,
            rng.randn(1 + OUT).astype(np.float32) * 0.1)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


@pytest.mark.parametrize("tile,window", [(8, 32), ((16, 2), (48, 16))])
def test_fused_render_reference_matches_pallas_interpret(tile, window):
    import jax
    import jax.numpy as jnp

    from invertavatar_tpu.ops.grid_sample import grid_sample
    from invertavatar_tpu.ops.pallas_fused_render import fused_render_pallas
    from tests.test_pallas_interpret import _osg_oracle

    rng = np.random.RandomState(3)
    N, H, C = 3, 64, 8
    res, S = 32, 4
    planes = jnp.asarray(rng.randn(N, H, H, C).astype(np.float32))
    grid = jnp.asarray(_structured_grid(rng, N, res, S))
    params = tuple(jnp.asarray(p) for p in _decoder_params(rng, C=C))
    t_params = tuple(_t(p) for p in params)

    # each JAX call is one jitted dispatch that the test then waits on: an
    # eager op dispatched while an interpret-mode kernel is still running can
    # deadlock with the kernel's own callbacks
    rgb_j, sigma_j = jax.jit(lambda p, g, w: fused_render_pallas(
        p, g, w, res=res, tile=tile, window=window, interpret=True))(planes, grid, params)
    rgb, sigma = fr.fused_render_reference(_t(planes), _t(grid), t_params, res=res, tile=tile)
    assert np.abs(rgb.numpy() - np.asarray(rgb_j)).max() < 2e-2
    assert np.abs(sigma.numpy() - np.asarray(sigma_j)).max() < 1e-1

    # the raw tile-major layout B2 reads: same rows, same bands
    raw_j = jax.jit(lambda p, g, w: fused_render_pallas(
        p, g, w, res=res, tile=tile, window=window, return_raw=True, interpret=True))(
            planes, grid, params)
    raw = fr.fused_render_reference(_t(planes), _t(grid), t_params, res=res, tile=tile,
                                    return_raw=True)
    assert raw.dtype == torch.bfloat16 and tuple(raw.shape) == tuple(raw_j.shape)
    d = np.abs(raw.float().numpy() - np.asarray(raw_j, np.float32))
    assert d[..., 1:].max() < 2e-2 and d[..., 0].max() < 1e-1

    # against the exact oracle (grid_sample → OSG MLP) the port stays in the
    # same band; the wrapper on CPU tensors is the plain version
    feats = grid_sample(planes, grid.reshape(N, -1, 2)).reshape(N, res * res, S, C)
    rgb_ref, sigma_ref = _osg_oracle(jnp.mean(feats, axis=0), params)
    rgb_w, sigma_w = fr.fused_render(_t(planes), _t(grid), t_params, res=res, tile=tile)
    assert torch.equal(rgb_w, rgb) and torch.equal(sigma_w, sigma)
    assert np.abs(rgb.numpy() - np.asarray(rgb_ref)).max() < 2e-2
    assert np.abs(sigma.numpy() - np.asarray(sigma_ref)).max() < 1e-1


def _port_setup(planes, params, ro, rd):
    planes_t = _t(planes).permute(0, 1, 4, 2, 3)  # [B,3,H,W,C] -> [B,3,C,H,W]
    t_params = tuple(_t(p) for p in params)
    w1, b1, w2, b2 = t_params

    def decoder(feats):
        x = feats.float().mean(dim=1)
        o = torch.nn.functional.softplus(x @ w1 + b1) @ w2 + b2
        return {"rgb": torch.sigmoid(o[..., 1:]) * 1.002 - 0.001, "sigma": o[..., :1]}

    return planes_t, decoder, t_params, _t(ro), _t(rd)


@pytest.mark.parametrize("tile_shape,bands", [
    (None, dict(rgb_max=5e-2, rgb_mean=5e-3, dep=5e-2, ws=5e-2)),
    ((16, 2), dict(rgb_max=8e-2, rgb_mean=1e-2, dep=8e-2, ws=8e-2)),
])
def test_renderer_fused_path_matches_jax_interpret(tile_shape, bands):
    """The flagship route (pallas_coarse + pooled_importance + det_stratified
    → B1, pooled CDF, B2): port (plain versions) vs JAX (interpret, one jitted
    dispatch as above)."""
    import jax

    from invertavatar_tpu.render.renderer import ImportanceRenderer as JaxRenderer
    from tests.test_pallas_interpret import _renderer_setup

    rng = np.random.RandomState(4)
    planes, decoder_j, params, ro, rd, opts = _renderer_setup(rng)
    fast = dict(opts, pallas_coarse=True, fused_render=True, march_in_kernel=True)
    if tile_shape is not None:
        fast["tile_shape"] = tile_shape
    jax_opts = dict(fast, pallas_interpret=True)
    rgb_j, dep_j, ws_j = jax.jit(lambda p, o, d, w: JaxRenderer()(
        p, decoder_j, o, d, jax_opts, evaluation=True, decoder_params=w))(planes, ro, rd, params)

    planes_t, decoder, t_params, ro_t, rd_t = _port_setup(planes, params, ro, rd)
    fr.fused_render.launches = fr.fused_merged_march.launches = 0
    with torch.no_grad():
        rgb, dep, ws = ImportanceRenderer()(planes_t, decoder, ro_t, rd_t, dict(fast),
                                            evaluation=True, decoder_params=t_params)
    # CPU tensors never launch a kernel
    assert fr.fused_render.launches == 0 and fr.fused_merged_march.launches == 0
    rgb_err = np.abs(rgb.numpy() - np.asarray(rgb_j))
    assert rgb_err.max() < bands["rgb_max"], rgb_err.max()
    assert rgb_err.mean() < bands["rgb_mean"], rgb_err.mean()
    assert np.abs(dep.numpy() - np.asarray(dep_j)).max() < bands["dep"]
    assert np.abs(ws.numpy() - np.asarray(ws_j)).max() < bands["ws"]


@pytest.mark.parametrize("pooled", [False, True])
def test_renderer_exact_paths_match_jax(pooled):
    """Without the fast path both renderers take the exact float32 route
    (per-ray or tile-pooled importance); they agree to float32 rounding."""
    from invertavatar_tpu.render.renderer import ImportanceRenderer as JaxRenderer
    from tests.test_pallas_interpret import _renderer_setup

    rng = np.random.RandomState(5)
    planes, decoder_j, params, ro, rd, opts = _renderer_setup(rng)
    opts = dict(opts, pooled_importance=pooled)
    if pooled:
        opts["windowed_coarse"] = True  # the pooled CDF needs the structured route
    rgb_j, dep_j, ws_j = JaxRenderer()(planes, decoder_j, ro, rd, dict(opts), evaluation=True)
    planes_t, decoder, _, ro_t, rd_t = _port_setup(planes, params, ro, rd)
    with torch.no_grad():
        rgb, dep, ws = ImportanceRenderer()(planes_t, decoder, ro_t, rd_t, dict(opts),
                                            evaluation=True)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), atol=1e-4)
    np.testing.assert_allclose(dep.numpy(), np.asarray(dep_j), atol=1e-4)
    np.testing.assert_allclose(ws.numpy(), np.asarray(ws_j), atol=1e-4)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10-bit mantissa), to nearest with ties away from
    zero, as `cvt.rna.tf32.f32` does: add half of the dropped bits, mask them."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_matmul(a, b, split):
    """a @ b on TF32 tensor cores with float32 sums: one pass, or the 3-term
    split big·big + big·small + small·big that the B1/B2 decoder uses."""
    ab, bb = _tf32(a), _tf32(b)
    if not split:
        return ab @ bb
    a_s, b_s = _tf32(a - ab), _tf32(b - bb)
    return a_s @ bb + ab @ b_s + ab @ bb


def _tf32_decode(x, params, split):
    w1, b1, w2, b2 = params
    o = _tf32_matmul(torch.nn.functional.softplus(_tf32_matmul(x, w1, split) + b1), w2, split) + b2
    return torch.cat([o[:, :1], torch.sigmoid(o[:, 1:]) * (1 + 2 * 0.001) - 0.001], dim=1)


@pytest.mark.parametrize("C,HID", [(32, 64), (8, 16)])
def test_split_tf32_decoder_matches_fp32(C, HID):
    """The kernels' decoder emulated on the CPU: the 3-term TF32 split meets
    B2's tolerance (1e-4|p| + 1e-4) against the float32 `_decode`; one TF32
    pass does not, which is why the kernels split."""
    rng = np.random.RandomState(7)
    x = _t(rng.randn(8192, C))  # plane means of unit-scale features
    params = tuple(_t(p) for p in _decoder_params(rng, C=C, HID=HID, OUT=C))
    ref = fr._decode(x, params)
    tol = 1e-4 * ref.abs() + 1e-4
    split = _tf32_decode(x, params, split=True)
    assert (split - ref).abs().le(tol).all(), (split - ref).abs().max()
    single = _tf32_decode(x, params, split=False)
    assert (single - ref).abs().gt(tol).any()
    # TF32 keeps 10 mantissa bits: rounding leaves at most 2^-11 relative
    assert _tf32(x).sub(x).abs().le(x.abs() * 2.0 ** -11).all()


@pytest.mark.cuda
@pytest.mark.parametrize("C,HID,tile", [(8, 16, (16, 2)), (32, 64, (16, 4))])
def test_cuda_kernels_match_plain_versions(C, HID, tile):
    """B1 and B2 on the card against their plain versions on the same inputs,
    at the tests' decoder with a ragged 32-ray B2 block and at the flagship's
    widths. B1 writes bf16: one bf16 ulp of the output (2^-7 relative) plus
    1e-4 for fp32 sums taken in another order. B2 writes fp32: 1e-4 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.RandomState(6)
    res, S, n_imp = 32, 8, 8
    planes = _t(rng.randn(3, 64, 64, C)).to(dev).to(torch.bfloat16)
    params = tuple(_t(p).to(dev) for p in _decoder_params(rng, C=C, HID=HID, OUT=C))
    grid = torch.from_numpy(_structured_grid(rng, 3, res, S)).to(dev)

    raw_k = fr.fused_render(planes, grid, params, res=res, tile=tile, return_raw=True)
    raw_p = fr.fused_render_reference(planes, grid, params, res=res, tile=tile, return_raw=True)
    torch.cuda.synchronize()
    ref = raw_p.float()
    assert (raw_k.float() - ref).abs().le(ref.abs() * 2.0 ** -7 + 1e-4).all()
    # the float32 route (the renderer's unpooled fused coarse pass)
    rgb_k, sigma_k = fr.fused_render(planes, grid, params, res=res, tile=tile)
    rgb_p, sigma_p = fr.fused_render_reference(planes, grid, params, res=res, tile=tile)
    assert torch.allclose(rgb_k, rgb_p, rtol=1e-4, atol=1e-4)
    assert torch.allclose(sigma_k, sigma_p, rtol=1e-4, atol=1e-4)

    th, tw = tile
    T, P, Sm = (res // th) * (res // tw), th * tw, S + n_imp
    d_m = torch.sort(torch.rand(T, Sm, device=dev) + 2.2, dim=1).values
    is_fine = (torch.rand(T, Sm, device=dev) < 0.5).to(torch.int32)
    src = torch.randint(0, S, (T, Sm), device=dev, dtype=torch.int32)
    proj_m = torch.rand(3, T, Sm, P, 2, device=dev) * 2 - 1
    args = (planes, proj_m, is_fine, src, d_m, raw_k, params)
    out_k = fr.fused_merged_march(*args, res=res, S=S, tile=tile)
    out_p = fr.fused_merged_march_reference(*args, res=res, S=S, tile=tile)
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_p):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-4)
