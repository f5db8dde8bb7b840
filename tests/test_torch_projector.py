"""The port's W+ projector (PTI stage 1) and PTI locality regulariser against
the JAX package, on the JAX tests' toy generator (`tests/test_projector.py`).

Tolerances: the projected w after 20 deterministic steps (no w-noise) to
1e-4 relative of its scale (float32 Adam on both sides, sums in other
orders); the regulariser to 1e-5 relative.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from invertavatar_torch.inversion import project_w_plus
from invertavatar_torch.inversion.projector import morphed_w_code, space_regularizer_loss

torch.set_num_threads(1)

Z_DIM, NUM_WS, C = 8, 3, 8


def _toy(seed=0):
    """The JAX test's toy: (numpy weights, the true w's z)."""
    rng = np.random.RandomState(seed)
    W_map = rng.randn(Z_DIM, C).astype(np.float32)
    W_img = (rng.randn(C, 16 * 16 * 3) * 0.1).astype(np.float32)
    return W_map, W_img, rng.randn(1, Z_DIM).astype(np.float32)


def _port_fns(W_map, W_img):
    Wm, Wi = torch.from_numpy(W_map), torch.from_numpy(W_img)

    def mapping_fn(z):
        return torch.tanh(z @ Wm)[:, None, :].repeat(1, NUM_WS, 1)

    def synth_fn(ws, noise_bufs):
        img = torch.tanh(ws.mean(dim=1) @ Wi).reshape(1, 16, 16, 3).permute(0, 3, 1, 2)
        return img + 0.001 * noise_bufs["n0"][None, None]

    return mapping_fn, synth_fn, lambda img255: img255.reshape(1, -1) / 255.0


def _jax_fns(W_map, W_img):
    Wm, Wi = jnp.asarray(W_map), jnp.asarray(W_img)

    def mapping_fn(z):
        return jnp.repeat(jnp.tanh(z @ Wm)[:, None, :], NUM_WS, axis=1)

    def synth_fn(ws, noise_bufs):
        img = jnp.tanh(jnp.mean(ws, axis=1) @ Wi).reshape(1, 16, 16, 3)
        return img + 0.001 * noise_bufs["n0"][None, :, :, None]

    # NHWC features in the port's NCHW order, so both sides see one vector
    def feature_fn(img255):
        return jnp.transpose(img255, (0, 3, 1, 2)).reshape(1, -1) / 255.0

    return mapping_fn, synth_fn, feature_fn


def _target(W_map, W_img, z):
    mapping_fn, synth_fn, _ = _port_fns(W_map, W_img)
    w_true = mapping_fn(torch.from_numpy(z))
    img = synth_fn(w_true, {"n0": torch.zeros(16, 16)})
    return w_true, ((img + 1) * 127.5)[0]


def test_projector_recovers_target():
    """The JAX test's recovery bar on its toy generator: mean |img - img_true|
    < 0.05 after 120 steps."""
    W_map, W_img, z = _toy()
    mapping_fn, synth_fn, feature_fn = _port_fns(W_map, W_img)
    w_true, target = _target(W_map, W_img, z)
    w_opt, noise = project_w_plus(synth_fn, mapping_fn, feature_fn, target,
                                  noise_bufs={"n0": torch.zeros(16, 16)}, num_ws=NUM_WS,
                                  z_dim=Z_DIM, num_steps=120, w_avg_samples=256,
                                  initial_learning_rate=0.05, device="cpu")
    assert w_opt.shape == (1, NUM_WS, C)
    err = (synth_fn(w_opt, noise) - synth_fn(w_true, {"n0": torch.zeros(16, 16)})).abs().mean()
    assert float(err) < 0.05, float(err)


def test_projector_steps_match_jax():
    """With `initial_noise_factor=0` the projection is deterministic: the
    port's w and noise buffer after 20 steps (the learning-rate ramp-up, the
    noise regulariser, the renormalisation) against JAX's, and the feature
    distance each step reports."""
    from invertavatar_tpu.inversion import project_w_plus as jax_project

    W_map, W_img, z = _toy(1)
    _, target = _target(W_map, W_img, z)
    kw = dict(num_ws=NUM_WS, z_dim=Z_DIM, num_steps=20, w_avg_samples=64,
              initial_learning_rate=0.05, initial_noise_factor=0.0, lr_rampup_length=0.2)
    dists = []
    mapping_fn, synth_fn, feature_fn = _port_fns(W_map, W_img)
    w_p, n_p = project_w_plus(synth_fn, mapping_fn, feature_fn, target,
                              noise_bufs={"n0": torch.zeros(16, 16)},
                              on_step=lambda i, d, loss: dists.append(float(d)), device="cpu",
                              **kw)
    j_map, j_synth, j_feat = _jax_fns(W_map, W_img)
    w_j, n_j = jax_project(j_synth, j_map, j_feat, np.transpose(target.numpy(), (1, 2, 0)),
                           noise_bufs={"n0": jnp.zeros((16, 16))}, **kw)
    w_j, n_j = np.asarray(w_j), np.asarray(n_j["n0"])
    assert len(dists) == 20 and dists[-1] < dists[0]
    np.testing.assert_allclose(w_p.numpy(), w_j, rtol=0, atol=1e-4 * np.abs(w_j).max())
    np.testing.assert_allclose(n_p["n0"].numpy(), n_j, rtol=0, atol=1e-4 * np.abs(n_j).max())


def test_space_regularizer_matches_jax():
    """`space_regularizer_loss` (the morph, the tuned and the frozen
    syntheses, LPIPS stand-in and l2 terms) and `morphed_w_code` against
    JAX, 1e-5 relative; the w samples come from one numpy draw on both
    sides (the two packages draw z differently), and the frozen side
    carries no gradient."""
    from invertavatar_tpu.inversion.projector import (morphed_w_code as j_morph,
                                                      space_regularizer_loss as j_space)

    rng = np.random.RandomState(4)
    w_batch = rng.randn(1, NUM_WS, C).astype(np.float32)
    w_samples = rng.randn(3, NUM_WS, C).astype(np.float32)
    A = rng.randn(C, 12).astype(np.float32)
    B = (A + rng.randn(C, 12) * 0.1).astype(np.float32)
    kw = dict(num_samples=3, alpha=2.0, l2_lambda=0.5, lpips_lambda=1.0)

    At = torch.from_numpy(A).requires_grad_(True)
    Bt = torch.from_numpy(B)
    loss = space_regularizer_loss(
        lambda w: torch.tanh(w.mean(dim=1) @ At), lambda w: torch.tanh(w.mean(dim=1) @ Bt),
        lambda z: torch.from_numpy(w_samples), torch.from_numpy(w_batch),
        lambda a, b: (a - b).abs().mean(dim=1), generator=torch.Generator().manual_seed(0), **kw)
    loss.backward()

    def j_loss(Aj):
        return j_space(lambda w: jnp.tanh(jnp.mean(w, axis=1) @ Aj),
                       lambda w: jnp.tanh(jnp.mean(w, axis=1) @ jnp.asarray(B)),
                       lambda z: jnp.asarray(w_samples), jnp.asarray(w_batch),
                       lambda a, b: jnp.mean(jnp.abs(a - b), axis=1), jax.random.PRNGKey(0), **kw)

    val_j, grad_j = jax.value_and_grad(j_loss)(jnp.asarray(A))
    np.testing.assert_allclose(float(loss), float(val_j), rtol=1e-5)
    np.testing.assert_allclose(At.grad.numpy(), np.asarray(grad_j), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(grad_j)).max())
    np.testing.assert_allclose(
        morphed_w_code(torch.from_numpy(w_samples[:1]), torch.from_numpy(w_batch), 30.0).numpy(),
        np.asarray(j_morph(jnp.asarray(w_samples[:1]), jnp.asarray(w_batch), 30.0)), rtol=1e-5)
