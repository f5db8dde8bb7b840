"""The port's 3D-GAN training (step, optimizer, EMA, schedules, loop)
against the JAX package on the CPU.

Models: `invertavatar_tpu/train/dryrun.py:tiny_models` (128² output, 32²
neural render, 8+8 samples, channel_base 1024, channel_max 64) with the
generator's weights N(0, 1)·0.1 by shape and the discriminator's from a flax
init with randomised 1-D parameters, carried into the port by the weight
bridge. JAX draws randomness the port cannot reproduce; each such draw is
removed or fed to both sides:
  * synthesis noise: every `noise_strength` is set to 0 on both sides;
  * ray strata: `det_stratified=True`;
  * importance samples (`u`, drawn in training renders): the step test
    renders without an importance pass (`depth_resolution_importance=0`);
  * the conditioning swap: `gpc_reg_prob=None` (the pose label is zeroed);
  * the density-TV points: the same points are fed to both sides;
  * ADA: off in the comparisons (its deterministic parts are
    `tests/test_torch_augment.py`'s).

Slow (`-m slow`, ~70 s in one process): `test_gan_step_matches_jax`, the
whole JAX step; its D loss with R1 and its density TV are held in Tier-1 by
the tests beside it.

Tolerances (float32 both sides, sums in other orders): losses and the R1
penalty to 1e-4 relative (+1e-7); the discriminator's gradients, through
R1's double backward, to 1e-3 of each tensor's largest entry; the density TV
to 1e-4 relative; Adam to 1e-6 relative + 1e-8 absolute (the bias
corrections are applied in another order; 1e-8 is 5e-6 of a step of lr
2e-3), the EMA to 1e-6 relative (+1e-9).
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from invertavatar_torch.models.discriminator import DualDiscriminator
from invertavatar_torch.models.triplane import TriPlaneGenerator
from invertavatar_torch.train import gan as pg
from invertavatar_torch.train import state as pstate
from invertavatar_torch.train.loop_gan import GANTrainConfig, train_gan
from invertavatar_torch.utils.weights import jax_to_state_dict
from tests.test_torch_encoders import _randomize
from tests.test_torch_inversion import _NEVER_RUN

# one intra-op thread: the suite runs test files in parallel worker processes
torch.set_num_threads(1)

NRR = 32


def _rk(**over):
    from invertavatar_tpu.train.dryrun import TINY_RENDERING_KWARGS

    return {**TINY_RENDERING_KWARGS, "det_stratified": True, **over}


def _gen_cfg(rk):
    return dict(z_dim=32, c_dim=25, w_dim=512, img_resolution=128, img_channels=3,
                rendering_kwargs=rk, neural_rendering_resolution=NRR, channel_base=1024,
                channel_max=64, map_num_layers=2)


D_CFG = dict(c_dim=25, img_resolution=128, img_channels=6, channel_base=1024, channel_max=64,
             num_fp16_res=0)


def _batch(seed, batch=2, nchw=False):
    from invertavatar_tpu.train.dryrun import _fake_batch

    b = _fake_batch(np.random.RandomState(seed), batch=batch, res=128, z_dim=32)
    if nchw:
        b["image"] = np.ascontiguousarray(np.moveaxis(b["image"], -1, 1))
    return b


def _jax_models(rk, seed=0):
    """JAX G and D of the tiny config and their variables; every
    `noise_strength` 0."""
    from invertavatar_tpu.models.discriminator import DualDiscriminator as JD
    from invertavatar_tpu.models.triplane import TriPlaneGenerator as JG

    G, D = JG(**_gen_cfg(rk)), JD(**D_CFG)
    b = _batch(0, batch=1)
    key = jax.random.PRNGKey(seed)
    rngs = {"params": key, "buffers": key, "noise": key, "ray": key}
    shapes = jax.eval_shape(lambda: G.init(rngs, jnp.asarray(b["z"]), jnp.asarray(b["c"]),
                                           {"uvcoords_image": jnp.asarray(b["v"]["uvcoords_image"])}))
    npr = np.random.RandomState(seed + 1)

    def fill(path, s):
        if getattr(path[-1], "key", None) == "noise_strength":
            return np.zeros(s.shape, np.float32)
        return (npr.standard_normal(s.shape) * 0.1).astype(np.float32)

    g_vars = jax.tree_util.tree_map_with_path(fill, shapes)
    d_vars = _randomize(D.init(key, {"image": jnp.asarray(b["image"]),
                                     "image_raw": jnp.zeros((1, NRR, NRR, 3))},
                               jnp.asarray(b["c"])), seed + 2)
    return G, D, g_vars, d_vars


def _port_models(rk, g_vars, d_vars):
    G = TriPlaneGenerator(**_gen_cfg(rk))
    missing, unexpected = G.load_state_dict(jax_to_state_dict(g_vars), strict=False)
    assert unexpected == [] and all(("generator." + k).startswith(_NEVER_RUN) for k in missing)
    D = DualDiscriminator(**D_CFG)
    D.load_state_dict(jax_to_state_dict(d_vars), strict=True)
    return G, D


def _close(got, ref, rel, abs_=1e-7, what=""):
    got = float(got.detach()) if isinstance(got, torch.Tensor) else float(got)
    ref = float(ref)
    assert abs(got - ref) <= rel * abs(ref) + abs_, (what, got, ref)


def test_schedules_match_jax():
    """Blur kernels, swap probabilities and neural rendering resolutions
    along the fades."""
    from invertavatar_tpu.train import gan as jg

    cfg_kw = dict(blur_init_sigma=10.0, blur_fade_kimg=8.0, gpc_reg_prob=0.5,
                  gpc_reg_fade_kimg=4.0, neural_rendering_resolution_fade_kimg=6.0)
    for nimg in (0, 1000, 2500, 7990, 9000):
        s_j = jg.make_schedules(jg.GANLossConfig(**cfg_kw), nimg, augment_p=0.3)
        s_t = pg.make_schedules(pg.GANLossConfig(**cfg_kw), nimg, augment_p=0.3)
        np.testing.assert_array_equal(s_t.blur_kernel, np.asarray(s_j.blur_kernel))
        assert s_t.swapping_prob == float(s_j.swapping_prob)
        assert s_t.augment_p == float(s_j.augment_p)
        assert pg.neural_rendering_resolution(pg.GANLossConfig(**cfg_kw), nimg) == \
            jg.neural_rendering_resolution(jg.GANLossConfig(**cfg_kw), nimg)
    assert pg.make_schedules(pg.GANLossConfig(), 0).swapping_prob == -1.0


def test_discriminator_loss_and_r1_match_jax():
    """Dmain with R1 on the same fake pair and real image, under a blur of
    σ 8.75: the JAX step's D loss (`train/gan.py` d_loss_fn, restated on the
    JAX modules) against `discriminator_loss`: the loss, its terms and the
    discriminator's gradients."""
    from invertavatar_tpu.models.discriminator import DualDiscriminator as JD
    from invertavatar_tpu.ops.resize import resize_bilinear
    from invertavatar_tpu.train import gan as jg

    cfg = pg.GANLossConfig(blur_init_sigma=10.0, blur_fade_kimg=8.0)
    sched = pg.make_schedules(cfg, 1000)
    rng = np.random.RandomState(3)
    fake = rng.randn(2, 128, 128, 3).astype(np.float32)
    fake_raw = rng.randn(2, NRR, NRR, 3).astype(np.float32)
    real = rng.randn(2, 128, 128, 3).astype(np.float32)
    c = _batch(0)["c"]
    D = JD(**D_CFG)
    d_vars = _randomize(D.init(jax.random.PRNGKey(4), {"image": jnp.asarray(fake),
                                                       "image_raw": jnp.asarray(fake_raw)},
                               jnp.asarray(c)), 5)
    kernel = jnp.asarray(sched.blur_kernel)

    def jax_loss(params, fake, fake_raw, real, c):
        def run_D(img):
            img = dict(img, image=jg._blur(img["image"], kernel))
            return D.apply({"params": params}, img, c)

        real_raw = jg._blur(resize_bilinear(real, (NRR, NRR), antialias=True), kernel)
        loss_dgen = jnp.mean(jax.nn.softplus(run_D({"image": fake, "image_raw": fake_raw})))
        (_, logits), r1 = jax.value_and_grad(
            lambda i, r: (jnp.sum(run_D({"image": i, "image_raw": r})),
                          run_D({"image": i, "image_raw": r})),
            argnums=(0, 1), has_aux=True)(real, real_raw)
        r1_penalty = jnp.sum(jnp.square(r1[0]), axis=(1, 2, 3)) + jnp.sum(
            jnp.square(r1[1]), axis=(1, 2, 3))
        loss_dreal = jnp.mean(jax.nn.softplus(-logits))
        total = loss_dgen + loss_dreal + jnp.mean(r1_penalty) * (cfg.r1_gamma / 2) * 16.0
        return total, (loss_dgen + loss_dreal, jnp.mean(r1_penalty), jnp.mean(logits))

    (total_j, (dloss_j, r1_j, real_j)), grads_j = jax.jit(
        jax.value_and_grad(jax_loss, has_aux=True))(
        d_vars["params"], jnp.asarray(fake), jnp.asarray(fake_raw), jnp.asarray(real),
        jnp.asarray(c))

    Dt = DualDiscriminator(**D_CFG)
    Dt.load_state_dict(jax_to_state_dict(d_vars), strict=True)
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))  # noqa: E731
    total, m = pg.discriminator_loss(Dt, {"image": nchw(fake), "image_raw": nchw(fake_raw)},
                                     nchw(real), NRR, torch.from_numpy(c), sched, cfg, True)
    _close(total, total_j, 1e-4, what="total")
    _close(m["Loss/D/loss"], dloss_j, 1e-4, what="D loss")
    _close(m["Loss/r1_penalty"], r1_j, 1e-4, what="r1")
    _close(m["Loss/scores/real"], real_j, 1e-4, 1e-6, what="real score")
    names = list(dict(Dt.named_parameters()))
    grads = torch.autograd.grad(total, list(Dt.parameters()))
    ref = jax_to_state_dict({"params": grads_j})
    for n, g in zip(names, grads):
        r = ref[n]
        assert (g - r).abs().max() <= 1e-3 * r.abs().max() + 1e-9, n


def test_density_tv_matches_jax():
    """The density TV term of the same 2×2,000 points (1,000 uniform and
    their perturbed copies) through `sample_mixed`."""
    rk = _rk()
    Gj, _, g_vars, d_vars = _jax_models(rk)
    G, _ = _port_models(rk, g_vars, d_vars)
    b = _batch(6)
    rng = np.random.RandomState(7)
    init = rng.uniform(-1, 1, (2, 1000, 3)).astype(np.float32)
    coords = np.concatenate([init, init + rng.randn(*init.shape).astype(np.float32) * 0.004], 1)
    cfg = pg.GANLossConfig()

    def jax_tv(v, z, c, coords, uvc):
        def fn(m, z, c, coords, uvc):
            ws = m.mapping(z, jnp.zeros_like(c))
            return m.sample_mixed(coords, ws, {"uvcoords_image": uvc}, noise_mode="random")

        sigma = Gj.apply(v, z, c, coords, uvc, method=fn,
                         rngs={"noise": jax.random.PRNGKey(1), "ray": jax.random.PRNGKey(2)})
        sigma = sigma["sigma"]
        return jnp.mean(jnp.abs(sigma[:, :1000] - sigma[:, 1000:])) * cfg.density_reg

    ref = jax.jit(jax_tv)(g_vars, jnp.asarray(b["z"]), jnp.asarray(b["c"]), jnp.asarray(coords),
                          jnp.asarray(b["v"]["uvcoords_image"]))
    with torch.no_grad():
        tv = pg.density_tv(G, torch.from_numpy(b["z"]), torch.from_numpy(b["c"]),
                           {"uvcoords_image": torch.from_numpy(b["v"]["uvcoords_image"])},
                           pg.make_schedules(cfg, 0), cfg, coords=torch.from_numpy(coords))
    assert float(ref) > 0
    _close(tv, ref, 1e-4, what="density TV")


@pytest.mark.slow
def test_gan_step_matches_jax():
    """One whole step (Gmain, then Dmain with R1) of the JAX package's
    `make_gan_train_step` and of the port's on the same weights and batch:
    the G loss, fake score, D loss, real score and R1 penalty."""
    from invertavatar_tpu.train import gan as jg
    from invertavatar_tpu.train.state import TrainState as JState
    from invertavatar_tpu.train.state import adam_with_lazy_reg as jadam

    rk = _rk(depth_resolution_importance=0)
    Gj, Dj, g_vars, d_vars = _jax_models(rk)
    G, D = _port_models(rk, g_vars, d_vars)
    cfg_kw = dict(neural_rendering_resolution_initial=NRR, neural_rendering_resolution_final=None,
                  blur_init_sigma=10.0, blur_fade_kimg=8.0)
    b = _batch(8)
    g_tx, d_tx = jadam(0.0025, 0.0, 0.99, 1e-8, 4), jadam(0.002, 0.0, 0.99, 1e-8, 16)
    step_j = jg.make_gan_train_step(Gj, Dj, g_tx, d_tx, jg.GANLossConfig(**cfg_kw), NRR,
                                    do_greg=False, do_dreg=True)
    _, _, m_j = jax.jit(step_j)(
        JState(g_vars["params"], g_tx.init(g_vars["params"]), g_vars["buffers"]),
        JState(d_vars["params"], d_tx.init(d_vars["params"]), {}),
        jax.tree_util.tree_map(jnp.asarray, b),
        jg.make_schedules(jg.GANLossConfig(**cfg_kw), 1000), jax.random.PRNGKey(0))
    cfg = pg.GANLossConfig(**cfg_kw)
    g_state = pstate.TrainState(G, pstate.LazyRegAdam(G.parameters(), 0.0025, 0.0, 0.99,
                                                             1e-8, 4))
    d_state = pstate.TrainState(D, pstate.LazyRegAdam(D.parameters(), 0.002, 0.0, 0.99,
                                                             1e-8, 16))
    bt = _batch(8, nchw=True)
    step = pg.make_gan_train_step(G, D, cfg, NRR, do_greg=False, do_dreg=True)
    m = step(g_state, d_state, {"image": torch.from_numpy(bt["image"]),
                                "c": torch.from_numpy(bt["c"]), "z": torch.from_numpy(bt["z"]),
                                "v": {"uvcoords_image": torch.from_numpy(
                                    bt["v"]["uvcoords_image"])}},
             pg.make_schedules(cfg, 1000), torch.Generator().manual_seed(0))
    assert sorted(m) == sorted(m_j)
    for k in ("Loss/G/loss", "Loss/scores/fake", "Loss/D/loss", "Loss/scores/real",
              "Loss/r1_penalty"):
        _close(m[k], m_j[k], 1e-4, 1e-6, what=k)


def test_lazy_reg_adam_scrub_and_ema_match_jax():
    """Three steps of the lazy-reg Adam (interval 4: lr and betas scaled by
    4/5) on the same gradients, a NaN and two infinities among them, against
    the JAX optax chain; then the EMA and its decay."""
    import optax

    from invertavatar_tpu.train import state as js

    rng = np.random.RandomState(9)
    shapes = [(4, 3), (7,), (2, 2, 3)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    p_t = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = pstate.LazyRegAdam(p_t, 0.0025, 0.0, 0.99, 1e-8, 4)
    tx = js.adam_with_lazy_reg(0.0025, 0.0, 0.99, 1e-8, 4)
    p_j = [jnp.asarray(p) for p in params]
    st = tx.init(p_j)
    for i in range(3):
        grads = [rng.randn(*s).astype(np.float32) * 10 ** i for s in shapes]
        if i == 1:
            grads[0][1, 2], grads[1][3], grads[2][0, 1, 1] = np.nan, np.inf, -np.inf
        upd, st = tx.update([jnp.asarray(g) for g in grads], st, p_j)
        p_j = optax.apply_updates(p_j, upd)
        for p, g in zip(p_t, grads):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        for a, b in zip(p_t, p_j):
            b = np.asarray(b)
            assert np.isfinite(a.detach().numpy()).all()
            np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-6, atol=1e-8)
    assert opt.param_groups[0]["lr"] == pytest.approx(0.0025 * 0.8)
    assert opt.param_groups[0]["betas"] == pytest.approx((0.0, 0.99 ** 0.8))

    ema = [rng.randn(*s).astype(np.float32) for s in shapes]
    for cur_nimg in (0, 640, 10 ** 6):
        beta = pstate.ema_beta(32, 10.0, cur_nimg, 0.05)
        assert beta == js.ema_beta(32, 10.0, cur_nimg, 0.05)
        ema_t = [torch.from_numpy(e.copy()) for e in ema]
        pstate.ema_update(ema_t, [p.detach() for p in p_t], beta)
        ref = js.ema_update([jnp.asarray(e) for e in ema], p_j, beta)
        for a, b in zip(ema_t, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)


def test_multisteps_adam_and_ema_match_jax():
    """Gradient accumulation: four micro-steps of `MultiSteps(LazyRegAdam, 2)`
    against `optax.MultiSteps` around the JAX `adam_with_lazy_reg`, on the
    same gradients, with the EMA after each micro-step (as both loops run
    it). The parameters hold still on the first micro-step of each pair and
    take the mean's Adam step on the second. The gradients are finite: a NaN
    in optax's accumulator outlives the update (0·NaN)."""
    import optax

    from invertavatar_tpu.train import state as js

    rng = np.random.RandomState(11)
    shapes = [(4, 3), (7,), (2, 2, 3)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    p_t = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = pstate.MultiSteps(pstate.LazyRegAdam(p_t, 0.0025, 0.0, 0.99, 1e-8, 4), 2)
    tx = optax.MultiSteps(js.adam_with_lazy_reg(0.0025, 0.0, 0.99, 1e-8, 4), every_k_schedule=2)
    p_j = [jnp.asarray(p) for p in params]
    st = tx.init(p_j)
    ema_t = [p.detach().clone() for p in p_t]
    ema_j = list(p_j)
    for i in range(4):
        before = [p.detach().clone() for p in p_t]
        grads = [rng.randn(*s).astype(np.float32) * 10 ** (i % 2) for s in shapes]
        upd, st = tx.update([jnp.asarray(g) for g in grads], st, p_j)
        p_j = optax.apply_updates(p_j, upd)
        for p, g in zip(p_t, grads):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        beta = pstate.ema_beta(32, 10.0, 640 * (i + 1), 0.05)
        pstate.ema_update(ema_t, [p.detach() for p in p_t], beta)
        ema_j = js.ema_update(ema_j, p_j, beta)
        for a, b, a0 in zip(p_t, p_j, before):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-6, atol=1e-8)
            assert torch.equal(a.detach(), a0) == (i % 2 == 0), i
        for a, b in zip(ema_t, ema_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)
    assert opt.mini_step == 0 and opt.acc is None


def _tiny_port_models(seed=0):
    torch.manual_seed(seed)
    return (TriPlaneGenerator(**_gen_cfg(_rk(gpc_reg_prob=0.5, det_stratified=False))),
            DualDiscriminator(**D_CFG))


@pytest.fixture
def _drop_tmp_path(tmp_path):
    """Removes `tmp_path` after the test: its runs write several snapshots of
    ~75 MB, and a test session keeps its temporary directories."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.usefixtures("_drop_tmp_path")
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_gan_resumes_bitwise(tmp_path, grad_accum):
    """3 uninterrupted steps against 2 steps, a snapshot, and the third step
    resumed from it: G, D, the EMA, both optimizers' moments and the ADA
    probability are bitwise equal. The run has both lazy-reg phases every
    second step, a blur fade, conditioning swaps and ADA (from p = 0.5)
    adjusted every step, so each piece of resumed state is exercised.
    With `grad_accum` 2 (micro-batches of 2 of a batch of 4) the snapshot
    falls after the first micro-step, whose partial gradient mean it holds,
    and G and D are still their initial weights there."""
    from invertavatar_torch.train.augment import AugmentConfig, AugmentPipe

    split = 2 if grad_accum == 1 else 1  # micro-steps before the snapshot

    def cfg_for(run_dir):
        return GANTrainConfig(
            run_dir=str(run_dir), batch_size=2 * grad_accum, grad_accum=grad_accum,
            kimg_per_tick=0.002, snapshot_ticks=1, augment_p=0.5,
            loss=pg.GANLossConfig(r1_gamma=8.0, gpc_reg_prob=0.5, blur_init_sigma=10.0,
                                  blur_fade_kimg=1.0, neural_rendering_resolution_initial=NRR,
                                  neural_rendering_resolution_final=None, g_reg_interval=2,
                                  d_reg_interval=2, ada_target=0.6, ada_interval=1))

    pipe = AugmentPipe(AugmentConfig(xflip=1, rotate90=1, brightness=1, contrast=1))
    seq = [_batch(10 + i, nchw=True) for i in range(3)]

    def run(run_dir, batches, max_steps, resume=None):
        G, D = _tiny_port_models()
        return train_gan(G, D, iter(batches), cfg_for(run_dir), max_steps=max_steps,
                         resume_path=resume, augment_pipe=pipe, device="cpu")

    gA, dA, emaA, nimgA = run(tmp_path / "a", seq, 3)
    gS, dS, _, _ = run(tmp_path / "b", seq[:split], split)
    snap = tmp_path / "b" / f"snapshot-{2 * split:08d}.pt"
    assert snap.exists(), os.listdir(tmp_path / "b")
    if grad_accum > 1:
        G0, D0 = _tiny_port_models()
        for a, b in ((gS.module, G0), (dS.module, D0)):
            assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
        assert gS.opt.acc is not None and gS.opt.mini_step == 1
    gB, dB, emaB, nimgB = run(tmp_path / "c", seq[split:], 3, resume=str(snap))
    assert nimgA == nimgB == 6
    for a, b, what in ((gA.module, gB.module, "G"), (dA.module, dB.module, "D"),
                       (emaA, emaB, "EMA")):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (what, k)
    for a, b in ((gA.opt, gB.opt), (dA.opt, dB.opt)):
        for sa, sb in zip(a.state.values(), b.state.values()):
            assert all(torch.equal(sa[k], sb[k]) for k in sa)
        if grad_accum > 1:  # both runs end mid-way through a mean
            assert all(torch.equal(x, y) for x, y in zip(a.acc, b.acc))
    snapA = torch.load(tmp_path / "a" / "snapshot-00000006.pt", weights_only=True)
    snapB = torch.load(tmp_path / "c" / "snapshot-00000006.pt", weights_only=True)
    assert snapA["augment_p"] == snapB["augment_p"] != 0.5
    assert all(np.isfinite(float(v.float().abs().max())) for v in emaA.state_dict().values())
    with open(tmp_path / "a" / "stats.jsonl") as f:
        assert len(f.readlines()) == 3
    assert os.path.getsize(tmp_path / "a" / "fakes00000006.png") > 1000


def test_train_gan_refuses_metrics_and_many_cards(tmp_path, capsys):
    """In-training metrics without their dataset and detector raise, naming
    what they need; `--dry-run --gpus 2` reports two ranks (each of which
    would take half of `--batch`), and a batch that does not split over the
    ranks raises."""
    import json

    from invertavatar_torch.cli import train_gan as cli

    G, D = _tiny_port_models()
    with pytest.raises(ValueError, match="metric_dataset and metric_detector_fn"):
        train_gan(G, D, iter([]), GANTrainConfig(run_dir=str(tmp_path)),
                  metric_names=("fid50k_full",), device="cpu")
    cli.main(["--outdir", str(tmp_path), "--data", str(tmp_path), "--gpus", "2", "--dry-run"])
    opts = json.loads(capsys.readouterr().out)
    assert opts["ranks"] == opts["gpus"] == 2 and opts["batch"] == 32
    with pytest.raises(ValueError, match="split evenly"):
        cli.main(["--outdir", str(tmp_path), "--data", str(tmp_path), "--gpus", "3",
                  "--dry-run"])


def test_train_gan_metric_tick(tmp_path):
    """`train_gan(metric_names=("fid64",))` with the seeded metric dataset
    (64 items at 128²) and the stand-in detector: the snapshot after one
    step (as JAX's `test_train_gan_metric_tick`) renders 64 samples with the EMA generator in evaluation mode
    through the fused route (the GAN CLI's `pallas_coarse`; the plain
    versions on the CPU), writes `metric-fid64.jsonl` and the real
    statistics' cache, and reports `Metrics/fid64` in the same tick's
    `stats.jsonl` line (JAX reports it after that line is written: a tick
    late, and the last tick's never, ROADMAP C)."""
    import json

    from invertavatar_torch.flagship import SeededMetricDataset, standin_detector

    torch.manual_seed(0)
    G = TriPlaneGenerator(**_gen_cfg(_rk(gpc_reg_prob=None, det_stratified=False,
                                         pallas_coarse=True, pooled_importance=True)))
    D = DualDiscriminator(**D_CFG)
    cfg = GANTrainConfig(run_dir=str(tmp_path / "run"), batch_size=2, kimg_per_tick=1,
                         snapshot_ticks=1, snapshot_images=False,
                         loss=pg.GANLossConfig(r1_gamma=0.0, density_reg=0.0,
                                               neural_rendering_resolution_initial=NRR,
                                               neural_rendering_resolution_final=None))
    threads = torch.get_num_threads()
    torch.set_num_threads(4)  # the 64 samples' backbones: ~13 s a batch of 8 on one thread
    try:
        train_gan(G, D, iter([_batch(20, nchw=True)]), cfg, max_steps=1,
                  metric_names=("fid64",), metric_dataset=SeededMetricDataset(64, 128),
                  metric_detector_fn=standin_detector(device="cpu"), device="cpu")
    finally:
        torch.set_num_threads(threads)
    with open(tmp_path / "run" / "metric-fid64.jsonl") as f:
        (line,) = f.read().strip().splitlines()
    fid = json.loads(line)["results"]["fid64"]
    assert np.isfinite(fid) and fid > 0
    with open(tmp_path / "run" / "stats.jsonl") as f:
        stats = [json.loads(x) for x in f.read().strip().splitlines()]
    assert len(stats) == 1 and stats[-1]["Metrics/fid64"]["mean"] == fid
    assert len(os.listdir(tmp_path / "run" / "metric-cache")) == 1
