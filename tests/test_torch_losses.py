"""The port's training criteria against the JAX package on the same weights:
LPIPS (AlexNet and VGG16 trunks) and the ArcFace identity loss.

The JAX modules are initialised by flax (the ArcFace backbone with random
BatchNorm statistics and 1-D parameters) and carried into the port by
`utils/weights.jax_to_state_dict`. JAX runs each reference as one `jax.jit`
call. Tolerance: 1e-5 relative on the losses and on the embeddings (float32
on both sides, sums in other orders).

The JAX ArcFace backbone has no tiny trunk (`trunk_layers` is always
IR-SE-50 there), so the identity loss runs the 50-layer trunk at batch 2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from invertavatar_torch.losses import LPIPS, ArcFaceBackbone, id_loss
from invertavatar_torch.losses.id_loss import extract_feats, load_arcface
from invertavatar_torch.losses.lpips import load_lpips
from invertavatar_torch.utils.weights import jax_to_state_dict
from tests.test_torch_encoders import _randomize

# one intra-op thread: the suite runs test files in parallel worker processes
torch.set_num_threads(1)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _pair(seed, res, batch=2):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (batch, res, res, 3)).astype(np.float32)
    y = np.clip(x + rng.randn(*x.shape).astype(np.float32) * 0.3, -1, 1)
    return x, y


@pytest.mark.parametrize("net_type,res", [("alex", 64), ("alex", 32), ("vgg", 32), ("vgg", 64)])
def test_lpips_matches_jax(net_type, res):
    """Value and input gradient of LPIPS, 1e-5 relative."""
    from invertavatar_tpu.losses.lpips import LPIPS as JaxLPIPS

    x, y = _pair(res, res)
    jl = JaxLPIPS(net_type)
    variables = jl.init(jax.random.PRNGKey(res), jnp.asarray(x), jnp.asarray(y))
    val_j, grad_j = jax.jit(jax.value_and_grad(lambda a: jl.apply(variables, a, jnp.asarray(y))))(
        jnp.asarray(x))

    lp = LPIPS(net_type)
    lp.load_state_dict(jax_to_state_dict(variables), strict=True)
    xt = _nchw(x).requires_grad_(True)
    val = lp(xt, _nchw(y))
    val.backward()
    assert not any(p.requires_grad for p in lp.parameters())
    np.testing.assert_allclose(val.item(), float(val_j), rtol=1e-5)
    gj = np.moveaxis(np.asarray(grad_j), -1, 1)
    np.testing.assert_allclose(xt.grad.numpy(), gj, atol=1e-5 * np.abs(gj).max())


def test_lpips_loads_torch_weights_by_path(tmp_path):
    """`load_lpips` reads a torch state dict by path (the reference's
    `net.layers.*` prefix mapped by `rename`), drops BatchNorm counters, and
    refuses a file that lacks a head."""
    src = LPIPS("alex")
    torch.manual_seed(0)
    for p in src.parameters():
        p.data.normal_()
    sd = {k.replace("net.", "net.layers.", 1): v for k, v in src.state_dict().items()}
    sd["net.layers.0.num_batches_tracked"] = torch.tensor(3)
    path = tmp_path / "alex.pth"
    torch.save(sd, path)
    lp = load_lpips(str(path), "alex", rename={"net.layers.": "net."}, device="cpu")
    for k, v in src.state_dict().items():
        assert torch.equal(lp.state_dict()[k], v), k
    del sd["lin.4.1.weight"]
    torch.save(sd, path)
    with pytest.raises(KeyError, match="lacks 1"):
        load_lpips(str(path), "alex", rename={"net.layers.": "net."}, device="cpu")


def _jax_arcface(seed):
    """The JAX backbone and two variable trees: flax's init, and the same with
    random BatchNorm statistics and 1-D parameters. A random trunk with
    random statistics maps every input to nearly one embedding (1 − cos is
    ~1e-3, below float32's cancellation at 1e-5 relative), so the loss is
    held on the init weights (1 − cos ~0.7) and the embeddings on both."""
    from invertavatar_tpu.losses.id_loss import ArcFaceBackbone as JaxArcFace

    bb = JaxArcFace()
    variables = bb.init(jax.random.PRNGKey(seed), jnp.zeros((1, 112, 112, 3)))
    variables = {k: dict(v) for k, v in variables.items()}
    return bb, variables, _randomize(variables, seed + 1)


def test_id_loss_matches_jax(tmp_path):
    """`extract_feats` (the 256² crop, the antialiased resize to 112², the
    IR-SE-50 embedding) and `id_loss` against JAX at batch 2, 1e-5
    relative; and a 512² image cropped with the same 256² indices, as JAX
    does. The backbone loads from a torch state dict on disk."""
    from invertavatar_tpu.losses.id_loss import extract_feats as j_feats, id_loss as j_id_loss

    bb_j, init_vars, random_vars = _jax_arcface(5)
    x, y = _pair(6, 256)
    y = np.random.RandomState(8).uniform(-1, 1, x.shape).astype(np.float32)
    big = _pair(7, 512)[0]

    @jax.jit
    def run(v, x, y, big):
        apply = lambda a: bb_j.apply(v, a)  # noqa: E731
        return j_feats(apply, x), j_id_loss(apply, x, y), j_feats(apply, big)

    for variables, hold_loss in ((init_vars, True), (random_vars, False)):
        fx_j, loss_j, fbig_j = run(variables, jnp.asarray(x), jnp.asarray(y), jnp.asarray(big))
        path = tmp_path / "model_ir_se50.pth"
        torch.save(jax_to_state_dict(variables), path)
        bb = load_arcface(str(path), device="cpu")
        assert isinstance(bb, ArcFaceBackbone)
        assert not any(p.requires_grad for p in bb.parameters())
        with torch.no_grad():
            fx = extract_feats(bb, _nchw(x))
            loss = id_loss(bb, _nchw(x), _nchw(y))
            fbig = extract_feats(bb, _nchw(big))
        for got, ref in ((fx, fx_j), (fbig, fbig_j)):
            ref = np.asarray(ref)
            assert got.shape == ref.shape == (2, 512)
            np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * np.abs(ref).max())
        if hold_loss:
            assert float(loss_j) > 0.1
            np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)


@pytest.mark.parametrize("res,val_range", [(176, 1.0), (193, 2.0)])
def test_ms_ssim_matches_jax(res, val_range):
    """MS-SSIM over five scales (an odd size drops a row at each pooling) and
    SSIM to 1e-5 relative, the loss (1 − MS-SSIM) to 1e-5 absolute, its
    input gradient to 1e-4 of the largest entry (float32 sums through five
    scales of separable windows, in other orders)."""
    from invertavatar_torch.losses.ms_ssim import ms_ssim, ms_ssim_loss, ssim
    from invertavatar_tpu.losses import ms_ssim as jms

    rng = np.random.RandomState(res)
    x = rng.rand(2, res, res, 3).astype(np.float32) * val_range
    y = np.clip(x + rng.randn(*x.shape).astype(np.float32) * 0.1 * val_range, 0, val_range)
    val_j, grad_j = jax.jit(jax.value_and_grad(
        lambda a: jms.ms_ssim_loss(a, jnp.asarray(y), val_range)))(jnp.asarray(x))
    s_j, cs_j = jms.ssim(jnp.asarray(x), jnp.asarray(y), val_range)
    xt = _nchw(x).requires_grad_(True)
    val = ms_ssim_loss(xt, _nchw(y), val_range)
    val.backward()
    np.testing.assert_allclose(float(val), float(val_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(ms_ssim(_nchw(x), _nchw(y), val_range)),
                               1.0 - float(val_j), rtol=1e-5)
    for a, b in zip(ssim(_nchw(x), _nchw(y), val_range), (s_j, cs_j)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    gj = np.moveaxis(np.asarray(grad_j), -1, 1)
    np.testing.assert_allclose(xt.grad.numpy(), gj, atol=1e-4 * np.abs(gj).max())


def test_weight_loaders_default_to_the_card(tmp_path, monkeypatch):
    """`load_lpips` and `load_arcface` build on CUDA unless the CPU is asked
    for: without a card the default raises, as every entry point's does."""
    path = tmp_path / "alex.pth"
    torch.save(LPIPS("alex").state_dict(), path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_lpips(str(path))
    with pytest.raises(RuntimeError, match="CUDA"):
        load_arcface(str(path))
    assert next(load_lpips(str(path), device="cpu").parameters()).device.type == "cpu"
