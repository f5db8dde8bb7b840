"""Kernel B3 and its transpose: the plain versions and the autograd function on
the CPU against the JAX package (Pallas interpret mode, one jitted dispatch
each), and, on a CUDA device, the kernels against their plain versions.

Shapes keep every footprint inside the TPU kernel's window (N 3, planes 64²
x 8 channels, 32² rays, tile 8, window 32, the tile-coherent grid of
tests/test_pallas_interpret.py), where the windowed TPU formulation is the
exact bilinear sample that the port computes.

The cases of `_transpose_case` (one 2x2 patch, edges with NaN, ±inf and
±1e9, points all over a large plane, a ray count that is not a square, C = 8
and 32) run through the plain transpose here, against a numpy `np.add.at`
transpose, and through the kernel on a CUDA device. The cases of
`_sample_case` (a coarse grid, importance-like strata spread across the
plane, rays out of raster order, the plane's edges, ±1e9, NaN and ±inf, a
ray count that is not a square) run through the forward's plain version
here, against numpy and the JAX package, and through the kernel on a CUDA
device.

Non-finite coordinates, per point: a NaN in x or y samples NaN in every
channel and its transpose adds NaN·cot to texels (0..1, 0..1) of its own
plane; ±inf (and no NaN) samples 0 and adds nothing. JAX's windowed sampler
(`sample_planes_coarse_windowed`) and its transpose give the same at +inf,
and NaN on the same points and planes; a NaN or −inf point moves JAX's
window for the rest of its (tile, stratum) block, so −inf is held against
numpy.

JAX is imported inside the tests that use it, so that the CUDA tests also run
on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_plane_sample.py
"""

import numpy as np
import pytest
import torch

from invertavatar_torch.ops import plane_sample as ps

# one intra-op thread: the suite runs test files in parallel worker processes
torch.set_num_threads(1)

N, H, C = 3, 64, 8
RES, S, TILE, WINDOW = 32, 4, 8, 32


def _structured_grid(rng, n, res, s, spread=0.08, scale=1.1):
    """Tile-coherent sampling grid like the real coarse pass (the draws of
    tests/test_pallas_interpret.py's helper)."""
    ys, xs = np.mgrid[0:res, 0:res].astype(np.float32) / res
    base = np.stack([xs * 2 - 1, ys * 2 - 1], -1).reshape(res * res, 2)
    offs = (rng.rand(res * res, s, 2) - 0.5) * spread
    grid = np.clip(base[:, None, :] * scale + offs, -1.15, 1.15).astype(np.float32)
    return np.broadcast_to(grid[None], (n, res * res, s, 2)).copy()


def _inputs(seed):
    rng = np.random.RandomState(seed)
    planes = rng.randn(N, H, H, C).astype(np.float32)
    grid = _structured_grid(rng, N, RES, S)
    cot = rng.randn(N, RES * RES, S, C).astype(np.float32)
    return planes, grid, cot


@pytest.mark.parametrize("payload", ["float32", "bfloat16"])
def test_sample_matches_pallas_interpret(payload):
    """fp32: both sides are the exact bilinear sample up to float32 sum order
    (1e-5). bf16: both read the same bf16 payload and round the output to
    bf16; the TPU kernel also rounds its tent weights to bf16 in its
    single-pass matmuls, so the band is that of the bf16 fast path (2e-2 max,
    2e-3 mean)."""
    import jax
    import jax.numpy as jnp

    from invertavatar_tpu.ops.pallas_plane_sample import sample_planes_windowed_pallas

    planes, grid, _ = _inputs(1)
    jdt, tdt = (jnp.float32, torch.float32) if payload == "float32" else (jnp.bfloat16,
                                                                          torch.bfloat16)
    ref = jax.jit(lambda p, g: sample_planes_windowed_pallas(
        p, g, res=RES, tile=TILE, window=WINDOW, payload_dtype=jdt,
        exact=payload == "float32", interpret=True))(jnp.asarray(planes), jnp.asarray(grid))
    ref = np.asarray(ref, np.float32)
    out = ps.sample_planes_windowed(torch.from_numpy(planes), torch.from_numpy(grid), tdt)
    assert out.dtype == tdt and tuple(out.shape) == ref.shape
    err = np.abs(out.float().numpy() - ref)
    if payload == "float32":
        assert err.max() < 1e-5, err.max()
    else:
        assert err.max() < 2e-2 and err.mean() < 2e-3, (err.max(), err.mean())
    # CPU tensors never launch the kernel
    assert ps.sample_planes_windowed.launches == 0


def test_transpose_matches_jax():
    """The plain transpose against `windowed_sample_transpose` (XLA): the
    same sums in another order, 1e-4."""
    import jax
    import jax.numpy as jnp

    from invertavatar_tpu.ops.plane_sample import windowed_sample_transpose

    planes, grid, cot = _inputs(2)
    ref = jax.jit(lambda g, c: windowed_sample_transpose(
        g, c, planes.shape, RES, TILE, WINDOW))(jnp.asarray(grid), jnp.asarray(cot))
    out = ps.windowed_sample_transpose(torch.from_numpy(grid), torch.from_numpy(cot), planes.shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-5)
    assert np.abs(out.numpy()).sum() > 1.0
    assert ps.windowed_sample_transpose.launches == 0


def test_cvjp_value_and_grad_match_jax():
    """`sample_planes_windowed_cvjp` against `jax.vjp` of the JAX custom-VJP
    sampler (Pallas forward in interpret mode, XLA transpose backward): value
    1e-5, plane gradient 1e-4; the grid gets no gradient on either side."""
    import jax
    import jax.numpy as jnp

    from invertavatar_tpu.ops.plane_sample import sample_planes_windowed_cvjp

    planes, grid, cot = _inputs(3)

    def vjp(p, g, ct):
        out, pull = jax.vjp(lambda p_, g_: sample_planes_windowed_cvjp(
            p_, g_, RES, TILE, WINDOW, True, True), p, g)
        return (out, *pull(ct))

    out_j, dp_j, dg_j = jax.jit(vjp)(jnp.asarray(planes), jnp.asarray(grid), jnp.asarray(cot))
    assert float(jnp.abs(dg_j).max()) == 0.0

    p = torch.from_numpy(planes).requires_grad_(True)
    g = torch.from_numpy(grid).requires_grad_(True)
    out = ps.sample_planes_windowed_cvjp(p, g)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(dp_j), atol=1e-4, rtol=1e-5)
    assert g.grad is None


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """B3 (both payloads) and its transpose on the card against their plain
    versions on the same inputs, at the test shapes and at the e4e shapes
    (3 planes of 256² x 32, 128² rays x 40 samples). Forward: float32 to
    1e-5 (fused multiply-adds in another order); bf16 to one bf16 ulp of the
    output (2^-7 relative) + 1e-6. Transpose: float32 atomics in no fixed
    order, 1e-4 relative + 1e-5 absolute."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.RandomState(6)
    for n, h, c, res, s in ((N, H, C, RES, S), (3, 256, 32, 128, 40)):
        planes = torch.from_numpy(rng.randn(n, h, h, c).astype(np.float32)).to(dev)
        grid = torch.from_numpy(_structured_grid(rng, n, res, s)).to(dev)
        cot = torch.randn((n, res * res, s, c), device=dev)
        for dt, rel, atol in ((torch.float32, 0.0, 1e-5), (torch.bfloat16, 2.0 ** -7, 1e-6)):
            k = ps.sample_planes_windowed(planes, grid, dt)
            p = ps.sample_planes_windowed_reference(planes, grid, dt)
            torch.cuda.synchronize()
            assert k.dtype == dt and k.shape == p.shape
            assert ((k.float() - p.float()).abs() <= p.float().abs() * rel + atol).all()
        k = ps.windowed_sample_transpose(grid, cot, planes.shape)
        p = ps.windowed_sample_transpose_reference(grid, cot, planes.shape)
        torch.cuda.synchronize()
        assert torch.allclose(k, p, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------- the transpose's cases

TRANSPOSE_CASES = ["c8", "c32", "one_patch", "edges_nan", "scattered", "rays_not_square"]


def _transpose_case(name, rng):
    """(grid, cot, planes_shape) of one transpose case, at test size."""
    n, h, c, res, s = N, H, C, RES, S
    if name == "c32":
        c = 32
    grid = _structured_grid(rng, n, res, s)
    if name == "one_patch":  # worst contention: every point on texels (20..21, 40..41)
        cell = (np.array([40.5, 20.5]) + 0.5) / (h * 0.5) - 1.0
        grid = (cell + rng.rand(n, res * res, s, 2) / h).astype(np.float32)
    elif name == "edges_nan":  # straddling the edges; NaN, ±inf and ±1e9 have no taps
        grid = rng.uniform(-1.05, 1.05, (n, res * res, s, 2)).astype(np.float32)
        flat = grid.reshape(-1)
        for v in (np.nan, np.inf, -np.inf, 1e9, -1e9):
            flat[rng.choice(flat.size, 300, replace=False)] = v
    elif name == "scattered":  # points all over a 256² plane, few sharing a texel
        h, c = 256, 32
        grid = rng.uniform(-1, 1, (n, res * res, s, 2)).astype(np.float32)
    elif name == "rays_not_square":
        grid = _structured_grid(rng, n, res, s)[:, :1000]
    cot = rng.randn(*grid.shape[:-1], c).astype(np.float32)
    return torch.from_numpy(grid), torch.from_numpy(cot), (n, h, h, c)


def _assert_nan_and_close(out, ref, tol, what):
    """NaN exactly where `ref` is NaN, and |out - ref| <= tol elsewhere."""
    out, ref, tol = (np.asarray(a, np.float64) for a in (out, ref, tol))
    nan = np.isnan(ref)
    assert np.array_equal(np.isnan(out), nan), (what, int(np.isnan(out).sum()), int(nan.sum()))
    err = np.abs(out - ref)[~nan]
    assert (err <= tol[~nan]).all(), (what, err.max(), int((err > tol[~nan]).sum()))


def _assert_transpose_close(out, grid, cot, shape):
    """|k - p| <= 1e-5·Σw|cot| + 1e-7 against the plain `index_add_` version,
    NaN exactly where it has NaN: the same float32 products summed in
    another order."""
    p = ps.windowed_sample_transpose_reference(grid.cpu(), cot.cpu(), shape)
    m = ps.windowed_sample_transpose_reference(grid.cpu(), cot.cpu().abs(), shape)
    out = out.cpu()
    assert out.shape == p.shape and out.dtype == torch.float32
    _assert_nan_and_close(out.numpy(), p.numpy(), 1e-5 * m.numpy() + 1e-7, "kernel")
    assert np.nansum(m.numpy()) > 0


def _nan_points(grid):
    """Points with a NaN in x or y."""
    return np.isnan(grid).any(-1)


def _numpy_transpose(grid, cot, shape):
    """d planes by `np.add.at`, summed in float64, with the plain version's
    float32 tap weights (each step rounded to float32); a point with a NaN
    coordinate adds NaN·cot to texels (0..1, 0..1) of its own plane, one
    at ±inf nothing."""
    n, h, w, c = shape
    grid = grid.reshape(n, -1, 2)
    cot = cot.reshape(n, -1, c).astype(np.float64)
    one, half = np.float32(1), np.float32(0.5)
    gx = (grid[..., 0] + one) * np.float32(w * 0.5) - half
    gy = (grid[..., 1] + one) * np.float32(h * 0.5) - half
    with np.errstate(invalid="ignore"):
        x0f, y0f = np.floor(gx), np.floor(gy)
        wx, wy = gx - x0f, gy - y0f
    out = np.zeros(shape, np.float64)
    plane = np.broadcast_to(np.arange(n)[:, None], gx.shape)
    for dy, dx, wt in ((0, 0, (one - wx) * (one - wy)), (0, 1, wx * (one - wy)),
                       (1, 0, (one - wx) * wy), (1, 1, wx * wy)):
        y, x = y0f + dy, x0f + dx
        ok = (y >= 0) & (y < h) & (x >= 0) & (x < w)
        np.add.at(out, (plane[ok], y[ok].astype(np.int64), x[ok].astype(np.int64)),
                  wt[ok, None].astype(np.float64) * cot[ok])
    nan = _nan_points(grid)
    out[nan.any(1), :2, :2] = np.nan
    return out


@pytest.mark.parametrize("case", TRANSPOSE_CASES)
def test_transpose_cases_match_numpy(case):
    """The wrapper's CPU route (the plain `index_add_` version) on each
    transpose case against `_numpy_transpose`, |k - p| <= 1e-5·Σw|cot| +
    1e-7, NaN exactly where numpy has it (the edge case's NaN points); no
    launch."""
    grid, cot, shape = _transpose_case(case, np.random.RandomState(7))
    launches = ps.windowed_sample_transpose.launches
    out = ps.windowed_sample_transpose(grid, cot, shape)
    assert ps.windowed_sample_transpose.launches == launches
    assert out.shape == shape and out.dtype == torch.float32
    p = _numpy_transpose(grid.numpy(), cot.numpy(), shape)
    m = _numpy_transpose(grid.numpy(), np.abs(cot.numpy()), shape)
    _assert_nan_and_close(out.numpy(), p, 1e-5 * m + 1e-7, "numpy")
    assert np.nansum(m) > 0
    assert np.isnan(p).any() == (case == "edges_nan")


@pytest.mark.cuda
@pytest.mark.parametrize("case", TRANSPOSE_CASES)
def test_cuda_transpose_cases(case):
    """The transpose kernel on the card against its plain version on each
    case, |k - p| <= 1e-5·Σw|cot| + 1e-7; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    grid, cot, shape = _transpose_case(case, np.random.RandomState(7))
    launches = ps.windowed_sample_transpose.launches
    out = ps.windowed_sample_transpose(grid.cuda(), cot.cuda(), shape)
    torch.cuda.synchronize()
    assert ps.windowed_sample_transpose.launches == launches + 1
    _assert_transpose_close(out, grid, cot, shape)


# ---------------------------------------------------------- the forward's cases

SAMPLE_CASES = ["coarse", "importance", "not_raster", "edges", "huge", "non_finite",
                "rays_not_square"]
PAYLOADS = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _sample_case(name, rng):
    """(planes, grid) of one forward case, at test size: float32 planes
    `[N, H, H, C]` and a float32 grid `[N, R, S, 2]`."""
    n, h, c, res, s = N, H, C, RES, S
    grid = _structured_grid(rng, n, res, s)
    if name == "importance":  # sorted strata along a line: near a surface or across the plane
        c = 32
        t = np.sort(rng.uniform(-1, 1, (n, res * res, s, 1)), axis=2)
        t = t * np.where(grid[:, :, :1, :1] < 0, 0.02, 1.0)
        grid = (grid[:, :, :1] * 0.3 + t * np.array([0.9, 0.6])).astype(np.float32)
    elif name == "not_raster":  # the rays in a random order
        grid = grid[:, rng.permutation(res * res)]
    elif name == "edges":  # on, just inside and just outside the plane's edges
        edge = np.array([-1 - 1 / h, -1, -1 + 0.5 / h, -1 + 1 / h, 0, 1 - 1 / h, 1 - 0.5 / h,
                         1, 1 + 1 / h], np.float32)
        grid = np.where(rng.rand(*grid.shape) < 0.5, rng.choice(edge, grid.shape),
                        rng.uniform(-1.05, 1.05, grid.shape)).astype(np.float32)
    elif name in ("huge", "non_finite"):
        values = (1e9, -1e9) if name == "huge" else (np.nan, np.inf, -np.inf)
        flat = grid.reshape(-1)
        for v in values:
            flat[rng.choice(flat.size, 200, replace=False)] = v
    elif name == "rays_not_square":
        grid = grid[:, :1000]
    planes = rng.randn(n, h, h, c).astype(np.float32)
    return torch.from_numpy(planes), torch.from_numpy(np.ascontiguousarray(grid))


def _numpy_sample(planes, grid):
    """Bilinear samples in float64 with the plain version's float32 tap
    weights; NaN for a point with a NaN coordinate, 0 for one at ±inf (off
    the plane); and Σw|v|."""
    n, h, w, c = planes.shape
    g = grid.reshape(n, -1, 2)
    one, half = np.float32(1), np.float32(0.5)
    with np.errstate(invalid="ignore", over="ignore"):
        gx = (g[..., 0] + one) * np.float32(w * 0.5) - half
        gy = (g[..., 1] + one) * np.float32(h * 0.5) - half
        x0f, y0f = np.floor(gx), np.floor(gy)
        wx, wy = gx - x0f, gy - y0f
    out = np.zeros(g.shape[:2] + (c,))
    mag = np.zeros_like(out)
    plane = np.broadcast_to(np.arange(n)[:, None], gx.shape)
    for dy, dx, wt in ((0, 0, (one - wx) * (one - wy)), (0, 1, wx * (one - wy)),
                       (1, 0, (one - wx) * wy), (1, 1, wx * wy)):
        y, x = y0f + dy, x0f + dx
        ok = (y >= 0) & (y < h) & (x >= 0) & (x < w)
        v = np.zeros(out.shape)
        v[ok] = planes[plane[ok], y[ok].astype(np.int64), x[ok].astype(np.int64)]
        wt = np.where(ok, wt, 0)[..., None].astype(np.float64)
        out += wt * v
        mag += np.abs(wt * v)
    out[_nan_points(g)] = np.nan
    return out.reshape(grid.shape[:-1] + (c,)), mag.reshape(grid.shape[:-1] + (c,))


def _assert_samples_close(out, ref, mag, rel, what):
    """|out - ref| <= rel·|ref| + 2e-6·Σw|v| + 1e-7 where ref is finite, and
    NaN exactly where ref is NaN."""
    _assert_nan_and_close(out, ref, rel * np.abs(ref) + 2e-6 * mag + 1e-7, what)


@pytest.mark.parametrize("payload", list(PAYLOADS))
@pytest.mark.parametrize("case", SAMPLE_CASES)
def test_sample_cases_match_plain(case, payload):
    """The forward's CPU route (its plain version) on each case against
    `bilinear_sample_reference`, a float64 numpy sample, and the JAX
    package: `ops/grid_sample.py` on every case, and the Pallas kernel in
    interpret mode on the coarse grid, the one whose footprints fit its
    window. NaN where a coordinate is NaN, 0 at ±inf; no launch. JAX's exact
    `grid_sample` gives NaN at ±inf too (the exact paths of both packages
    do), so the points at ±inf are left out of that one comparison; they are
    held against numpy here and against JAX's windowed sampler in
    `test_non_finite_matches_jax_windowed`."""
    import jax
    import jax.numpy as jnp

    from invertavatar_tpu.ops.grid_sample import grid_sample
    from invertavatar_tpu.ops.pallas_plane_sample import sample_planes_windowed_pallas

    dt = PAYLOADS[payload]
    planes, grid = _sample_case(case, np.random.RandomState(11))
    launches = ps.sample_planes_windowed.launches
    out = ps.sample_planes_windowed(planes, grid, dt)
    assert ps.sample_planes_windowed.launches == launches
    assert out.dtype == dt and out.shape == (*grid.shape[:-1], planes.shape[-1])
    ref = ps.bilinear_sample_reference(planes.to(dt), grid.reshape(grid.shape[0], -1, 2))
    torch.testing.assert_close(out, ref.reshape(out.shape).to(dt), rtol=0, atol=0,
                               equal_nan=True)
    rel = 0.0 if dt == torch.float32 else 2.0 ** -7  # bf16: one ulp of the output
    p = planes.to(dt).float().numpy()
    ref, mag = _numpy_sample(p, grid.numpy())
    _assert_samples_close(out.float().numpy(), ref, mag, rel, "numpy")
    jdt = jnp.float32 if dt == torch.float32 else jnp.bfloat16
    j = jax.jit(grid_sample)(jnp.asarray(planes.numpy(), jdt), jnp.asarray(grid.numpy()))
    g = grid.numpy()
    exact = ~(np.isinf(g).any(-1) & ~_nan_points(g))  # the points the exact path samples alike
    assert exact.sum() > 0.9 * exact.size
    _assert_samples_close(out.float().numpy()[exact], np.asarray(j, np.float64)[exact],
                          mag[exact], rel, "JAX grid_sample")
    if case == "coarse":  # the TPU kernel's band, as in test_sample_matches_pallas_interpret
        j = jax.jit(lambda q, g: sample_planes_windowed_pallas(
            q, g, res=RES, tile=TILE, window=WINDOW, payload_dtype=jdt,
            exact=dt == torch.float32, interpret=True))(jnp.asarray(planes.numpy()),
                                                        jnp.asarray(grid.numpy()))
        err = np.abs(out.float().numpy() - np.asarray(j, np.float32))
        assert err.max() < (1e-5 if dt == torch.float32 else 2e-2), err.max()


@pytest.mark.cuda
@pytest.mark.parametrize("payload", list(PAYLOADS))
@pytest.mark.parametrize("case", SAMPLE_CASES)
def test_cuda_sample_cases(case, payload):
    """The forward kernel on the card on each case against its plain
    version: |k - p| <= rel·|p| + 2e-6·Σw|v| (fused multiply-adds; bf16: one
    ulp of the output), NaN exactly where the plain version's; one launch
    per call; the same bits from a second launch. C = 8 runs the bf16
    payload's one-vector-a-thread route, C = 32 (the importance case) the
    two-vector one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = PAYLOADS[payload]
    planes, grid = _sample_case(case, np.random.RandomState(11))
    planes_d, grid_d = planes.cuda(), grid.cuda()
    launches = ps.sample_planes_windowed.launches
    out = ps.sample_planes_windowed(planes_d, grid_d, dt)
    torch.cuda.synchronize()
    assert ps.sample_planes_windowed.launches == launches + 1
    assert out.dtype == dt and out.shape == (*grid.shape[:-1], planes.shape[-1])
    p = ps.sample_planes_windowed_reference(planes, grid, dt).float().numpy()
    mag = ps.sample_planes_windowed_reference(planes.abs(), grid).numpy()
    rel = 0.0 if dt == torch.float32 else 2.0 ** -7
    _assert_samples_close(out.float().cpu().numpy(), p.astype(np.float64), mag, rel, "kernel")
    again = ps.sample_planes_windowed(planes_d, grid_d, dt)
    torch.testing.assert_close(again, out, rtol=0, atol=0, equal_nan=True)


# ------------------------------------------ non-finite coordinates against JAX

NON_FINITE = {"+inf": np.inf, "nan": np.nan, "-inf": -np.inf}


def _non_finite_case(value, seed):
    """`_inputs` with 40 coordinates of the tile-coherent grid set to
    `value` (x or y, spread over the three planes)."""
    planes, grid, cot = _inputs(seed)
    flat = grid.reshape(-1)
    flat[np.random.RandomState(seed).choice(flat.size, 40, replace=False)] = NON_FINITE[value]
    assert (_nan_points(grid) | np.isinf(grid).any(-1)).any(1).all()  # on every plane
    return planes, grid, cot


@pytest.mark.parametrize("kind", ["sample", "transpose"])
@pytest.mark.parametrize("value", ["+inf", "nan"])
def test_non_finite_matches_jax_windowed(value, kind):
    """The plain forward and transpose against JAX's XLA windowed sampler
    (`sample_planes_coarse_windowed`, `windowed_sample_transpose`), one
    jitted dispatch each. +inf points leave JAX's window in place: both
    sample 0 there and add nothing, 1e-5 everywhere. NaN points: NaN on
    the same output points, and the same planes' gradients hold a NaN
    (JAX spreads it over its window, the port over texels (0..1, 0..1))."""
    import jax
    import jax.numpy as jnp

    from invertavatar_tpu.ops.plane_sample import (sample_planes_coarse_windowed,
                                                   windowed_sample_transpose)

    planes, grid, cot = _non_finite_case(value, 12)
    if kind == "sample":
        ref = np.asarray(jax.jit(lambda p, g: sample_planes_coarse_windowed(
            p, g, res=RES, tile=TILE, window=WINDOW))(jnp.asarray(planes), jnp.asarray(grid)))
        out = ps.sample_planes_windowed(torch.from_numpy(planes), torch.from_numpy(grid)).numpy()
        point_nan = np.isnan(out).any(-1)
        assert np.array_equal(np.isnan(out), np.isnan(ref))
        assert np.array_equal(point_nan, _nan_points(grid)) and np.isnan(out[point_nan]).all()
    else:
        ref = np.asarray(jax.jit(lambda g, c: windowed_sample_transpose(
            g, c, planes.shape, RES, TILE, WINDOW))(jnp.asarray(grid), jnp.asarray(cot)))
        out = ps.windowed_sample_transpose(torch.from_numpy(grid), torch.from_numpy(cot),
                                           planes.shape).numpy()
        assert np.array_equal(np.isnan(out).any((1, 2, 3)), np.isnan(ref).any((1, 2, 3)))
        assert np.array_equal(np.isnan(out).any((1, 2, 3)), _nan_points(grid).any((1, 2)))
        assert np.isnan(out).sum() == (4 * C * 3 if value == "nan" else 0)
    if value == "+inf":
        inf = np.isinf(grid).any(-1)
        assert inf.sum() > 30 and not np.isnan(out).any()
        if kind == "sample":
            assert (out[inf] == 0).all()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["sample", "transpose"])
def test_negative_inf_points_match_numpy(kind):
    """−inf points sample 0 and add nothing, in the plain forward and
    transpose, against the numpy versions. (JAX's window moves to the
    plane's corner for the whole (tile, stratum) block of such a point, so
    its other points lose their taps there: a fault of the JAX package.)"""
    planes, grid, cot = _non_finite_case("-inf", 13)
    inf = np.isinf(grid).any(-1)
    if kind == "sample":
        out = ps.sample_planes_windowed(torch.from_numpy(planes), torch.from_numpy(grid)).numpy()
        ref, mag = _numpy_sample(planes, grid)
        _assert_samples_close(out, ref, mag, 0.0, "numpy")
        assert (out[inf] == 0).all()
    else:
        out = ps.windowed_sample_transpose(torch.from_numpy(grid), torch.from_numpy(cot),
                                           planes.shape).numpy()
        ref = _numpy_transpose(grid, cot, planes.shape)
        m = _numpy_transpose(grid, np.abs(cot), planes.shape)
        _assert_nan_and_close(out, ref, 1e-5 * m + 1e-7, "numpy")
        # the −inf points add nothing: the same as their grid moved far off the plane
        off = ps.windowed_sample_transpose(
            torch.from_numpy(np.where(inf[..., None], np.float32(4.0), grid)),
            torch.from_numpy(cot), planes.shape).numpy()
        np.testing.assert_array_equal(out, off)
    assert inf.sum() > 30 and np.isfinite(out).all()


@pytest.mark.parametrize("value", list(NON_FINITE))
def test_exact_path_at_a_non_finite_point(value):
    """The exact path (`ops/grid_sample.py`, ATen's sampler) at one point with
    one non-finite coordinate, beside JAX's `grid_sample`: both forwards
    give that point NaN in every channel, so a loss over it is NaN before
    any backward runs; the port's backward then gives the planes no NaN,
    where JAX's gathers put NaN into 32 (NaN, +inf) or 16 (−inf) entries of
    that plane's gradient. A departure by design: matching it would mean
    replacing ATen's sampler on every path."""
    import jax
    import jax.numpy as jnp

    from invertavatar_torch.ops.grid_sample import grid_sample as port_grid_sample
    from invertavatar_tpu.ops.grid_sample import grid_sample

    rng = np.random.RandomState(14)
    planes = rng.randn(N, H, H, C).astype(np.float32)
    grid = rng.uniform(-0.9, 0.9, (N, 256, S, 2)).astype(np.float32)
    cot = rng.randn(N, 256, S, C).astype(np.float32)
    grid[1, 37, 2, 0] = NON_FINITE[value]

    def vjp(p, g, c):
        out, pull = jax.vjp(lambda p_: grid_sample(p_, g), p)
        return out, pull(c)[0]

    out_j, d_j = (np.asarray(a) for a in jax.jit(vjp)(planes, grid, cot))
    p = torch.from_numpy(planes.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    out = port_grid_sample(p, torch.from_numpy(grid))
    out.backward(torch.from_numpy(cot.transpose(0, 3, 1, 2).copy()))
    assert np.isnan(out_j).sum() == C and np.isnan(out_j[1, 37, 2]).all()
    assert int(torch.isnan(out).sum()) == C and torch.isnan(out[1, :, 37, 2]).all()
    assert np.isnan(d_j).sum() == (16 if value == "-inf" else 32) and np.isnan(d_j[1]).any()
    assert not torch.isnan(p.grad).any()
