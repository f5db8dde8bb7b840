"""Kernel B3 and its transpose: the plain versions and the autograd function on
the CPU against the JAX package (Pallas interpret mode, one jitted dispatch
each), and, on a CUDA device, the kernels against their plain versions.

Shapes keep every footprint inside the TPU kernel's window (N 3, planes 64²
x 8 channels, 32² rays, tile 8, window 32, the tile-coherent grid of
tests/test_pallas_interpret.py), where the windowed TPU formulation is the
exact bilinear sample that the port computes.

JAX is imported inside the tests that use it, so that the CUDA test also runs
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
