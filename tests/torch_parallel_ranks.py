"""Rank functions of the port's data-parallel tests (`test_torch_parallel.py`).

Each runs on one spawned rank (`parallel.multihost.spawn_ranks`, gloo on the
CPU, one intra-op thread) and returns what the test holds against one
process at the global batch or against the JAX package. The module imports
no JAX at import time: a spawned rank imports it afresh.
"""

import numpy as np
import torch

from invertavatar_torch.parallel import mesh as pm


def _shard(mesh, x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)[mesh.rank::mesh.world_size]))


def minibatch_std_rank(mesh, x, cot):
    """The gathered minibatch std on this rank's rows of `x` [B, C, H, W]:
    its output, the input gradient of <y, cot> and the gradient of the
    squared input gradient's sum (R1's double backward)."""
    from invertavatar_torch.models.discriminator import MinibatchStdLayer

    xl = _shard(mesh, x).requires_grad_(True)
    with pm.use_mesh(mesh):
        y = MinibatchStdLayer(4)(xl)
        (g,) = torch.autograd.grad(y, xl, _shard(mesh, cot), create_graph=True)
        (gg,) = torch.autograd.grad(g.square().sum(), xl)
    return y.detach().numpy(), g.detach().numpy(), gg.numpy()


def w_avg_rank(mesh, state, z, c, cfg):
    """The mapping network's `w_avg` after one update on this rank's rows."""
    from invertavatar_torch.models.mapping import MappingNetwork

    net = MappingNetwork(**cfg)
    net.load_state_dict(state)
    with torch.no_grad(), pm.use_mesh(mesh):
        net(_shard(mesh, z), _shard(mesh, c), update_emas=True)
    return net.w_avg.numpy()


def collector_rank(mesh, reports):
    """`Collector.sync` of this rank's reports ([(name, values)] per rank)."""
    from invertavatar_torch.utils.stats import Collector

    col = Collector()
    for name, values in reports[mesh.rank]:
        col.report(name, values)
    col.sync()
    col.update()
    return col.as_dict()


def replica_rank(mesh):
    """`check_replica_consistency` on equal modules (None), then with a
    buffer perturbed on the last rank (the error's text)."""
    from invertavatar_torch.models.mapping import MappingNetwork
    from invertavatar_torch.parallel.multihost import check_replica_consistency

    torch.manual_seed(0)
    net = MappingNetwork(z_dim=8, c_dim=0, w_dim=16, num_ws=2, num_layers=2)
    first = check_replica_consistency(mesh, {"mapping": net})
    if mesh.rank == mesh.world_size - 1:
        net.w_avg[3] += 1e-6
    try:
        check_replica_consistency(mesh, {"mapping": net})
    except AssertionError as e:
        return first, str(e)
    return first, None


def collector_mismatch_rank(mesh, reports):
    """`Collector.sync` of reports whose names differ between ranks: the
    `RuntimeError`'s text, or None when nothing was raised."""
    try:
        collector_rank(mesh, reports)
    except RuntimeError as e:
        return str(e)
    return None


def replica_fault_rank(mesh, fault):
    """`check_replica_consistency` on a `Linear` that the last rank corrupts:
    "swap" exchanges two of its weight entries (the sums stay), "nan" puts a
    NaN in its bias; the error's text, or None."""
    from invertavatar_torch.parallel.multihost import check_replica_consistency

    torch.manual_seed(0)
    lin = torch.nn.Linear(4, 3)
    if mesh.rank == mesh.world_size - 1:
        with torch.no_grad():
            if fault == "swap":
                w = lin.weight.view(-1)
                w[[0, 5]] = w[[5, 0]].clone()
            else:
                lin.bias[1] = float("nan")
    try:
        check_replica_consistency(mesh, {"lin": lin})
    except AssertionError as e:
        return str(e)
    return None


def collectives_rank(mesh):
    """Draws, gathers and reductions under the mesh, `replicate` and
    `all_reduce_grads`, as numpy for the test to hold against one process."""
    gen = torch.Generator().manual_seed(5)
    out = {}
    with pm.use_mesh(mesh):
        out["rand"] = pm.batch_rand((3, 2), gen).numpy()
        out["randn"] = pm.batch_rand((3, 2, 2), gen, normal=True).numpy()
        with pm.batch_layout(outer=2, inner=3):
            out["layout"] = pm.batch_rand((2 * 1 * 3, 4), gen).numpy()
        x = torch.arange(3.0) + 10 * mesh.rank
        out["roll"] = pm.take_rows(torch.roll(pm.gather_rows(x), 1, dims=0)).numpy()
        out["mean"] = pm.mean_over_ranks(torch.tensor(float(mesh.rank))).item()
        out["min"] = pm.min_over_ranks(torch.tensor(float(mesh.rank))).item()
        out["max"] = pm.max_over_ranks(torch.tensor(float(mesh.rank))).item()
    torch.manual_seed(mesh.rank)
    lin = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(lin.parameters())
    lin(torch.ones(1, 3)).sum().backward()
    opt.step()  # per-rank moments
    pm.replicate(mesh, lin, opt)
    out["replicated"] = [t.detach().numpy().copy() for t in pm._state_tensors(lin)
                         + pm._state_tensors(opt)]
    w = torch.nn.Parameter(torch.zeros(2))
    v = torch.nn.Parameter(torch.zeros(3))
    w.grad = torch.tensor([1.0, 2.0]) * (mesh.rank + 1)
    pm.all_reduce_grads(mesh, [w, v])
    out["grad"], out["none_stays"] = w.grad.numpy(), v.grad is None
    return out


def one_rank(mesh):
    """On a mesh of one rank: the minibatch std's output, input gradient and
    double backward, a `w_avg` update, draws and `all_reduce_grads`, each
    with the mesh and without, as pairs of arrays."""
    from invertavatar_torch.models.discriminator import MinibatchStdLayer
    from invertavatar_torch.models.mapping import MappingNetwork

    rng = np.random.RandomState(3)
    x0 = torch.from_numpy(rng.randn(4, 8, 4, 4).astype(np.float32))
    cot = torch.from_numpy(rng.randn(4, 9, 4, 4).astype(np.float32))
    z = torch.from_numpy(rng.randn(4, 8).astype(np.float32))
    out = {}
    for key, m in (("none", None), ("mesh", mesh)):
        x = x0.clone().requires_grad_(True)
        torch.manual_seed(0)
        net = MappingNetwork(z_dim=8, c_dim=0, w_dim=16, num_ws=2, num_layers=2)
        p = torch.nn.Parameter(torch.zeros(4, 8, 4, 4))
        with pm.use_mesh(m):
            y = MinibatchStdLayer(4)(x)
            (g,) = torch.autograd.grad(y, x, cot, create_graph=True)
            (gg,) = torch.autograd.grad(g.square().sum(), x)
            with torch.no_grad():
                net(z, None, update_emas=True)
            r = pm.batch_rand((4, 3), torch.Generator().manual_seed(1), normal=True)
        p.grad = gg.clone()
        if m is not None:
            pm.all_reduce_grads(m, [p])
        out[key] = [t.detach().numpy().copy() for t in (y, g, gg, net.w_avg, r, p.grad)]
    return out


# ---------------------------------------------------------------- trainers
#
# Each `*_run(mesh, ...)` runs on a rank with a mesh and in the test's own
# process with `mesh=None` at the global batch.


def _np_state(module):
    return {k: v.detach().cpu().numpy().copy() for k, v in module.state_dict().items()}


def _gan_pipe():
    from invertavatar_torch.train.augment import AugmentConfig, AugmentPipe

    return AugmentPipe(AugmentConfig(xflip=1, rotate90=1, xint=1, brightness=1, contrast=1))


def _gan_loss(**over):
    from invertavatar_torch.train.gan import GANLossConfig

    return GANLossConfig(**{**dict(r1_gamma=8.0, gpc_reg_prob=0.5, blur_init_sigma=10.0,
                                   blur_fade_kimg=1.0, neural_rendering_resolution_initial=32,
                                   neural_rendering_resolution_final=None), **over})


def gan_batches(n, B, start=0):
    from invertavatar_torch.train.dryrun import _fake_batch

    return [_fake_batch(np.random.RandomState(10 + i), B, 128, 32) for i in range(start, n)]


def gan_step_run(mesh):
    """One GAN step of the dry run's models with every draw on (synthesis
    noise, strata, importance samples, swaps, density probes, ADA) on the
    global batch of 2 or this rank's rows of it, without applying it:
    (metrics, gradients, w_avg)."""
    from invertavatar_torch.parallel.mesh import local_batch
    from invertavatar_torch.train import gan as pg
    from invertavatar_torch.train.dryrun import tiny_models
    from invertavatar_torch.train.state import LazyRegAdam, TrainState
    from invertavatar_torch.utils.misc import to_device

    torch.manual_seed(0)
    G, D = tiny_models(det_stratified=False)
    cfg = _gan_loss()
    gs = TrainState(G, LazyRegAdam(G.parameters(), 0.0025, 0.0, 0.99, 1e-8, 4))
    ds = TrainState(D, LazyRegAdam(D.parameters(), 0.002, 0.0, 0.99, 1e-8, 16))
    batch = to_device(local_batch(mesh, gan_batches(1, 2)[0], 2), "cpu")
    step = pg.make_gan_train_step(G, D, cfg, 32, True, True, augment_pipe=_gan_pipe(),
                                  mesh=mesh)
    m = step(gs, ds, batch, pg.make_schedules(cfg, 0, augment_p=0.5),
             torch.Generator().manual_seed(3), apply=False)
    grads = {f"{n}.{k}": p.grad.numpy().copy() for n, net in (("G", G), ("D", D))
             for k, p in net.named_parameters()}
    return {k: float(v) for k, v in m.items()}, grads, G.backbone.mapping.w_avg.numpy().copy()


def train_gan_run(mesh, run_dir, steps, grad_accum, B=4, start=0, resume=None):
    """`train_gan` of the dry run's models over a global batch of `B` in
    `grad_accum` micro-batches, every draw on, both regularisations every
    second step, ADA adjusted every step: (per-step metrics, G, D and the
    EMA's state, the images counted)."""
    from invertavatar_torch.train.dryrun import tiny_models
    from invertavatar_torch.train.loop_gan import GANTrainConfig, train_gan

    torch.manual_seed(0)
    G, D = tiny_models(det_stratified=False)
    cfg = GANTrainConfig(run_dir=run_dir, batch_size=B, grad_accum=grad_accum,
                         kimg_per_tick=B // grad_accum / 1000, snapshot_ticks=1,
                         snapshot_images=True, augment_p=0.5,
                         loss=_gan_loss(g_reg_interval=2, d_reg_interval=2, ada_target=0.6,
                                        ada_interval=1))
    metrics = []
    g, d, ema, nimg = train_gan(G, D, iter(gan_batches(steps, B // grad_accum, start)), cfg,
                                max_steps=steps, resume_path=resume, augment_pipe=_gan_pipe(),
                                on_step=lambda i, n, m: metrics.append(m), device="cpu",
                                mesh=mesh)
    return metrics, _np_state(g.module), _np_state(d.module), _np_state(ema), nimg


def train_e4e_run(mesh, run_dir):
    """Two `train_e4e` steps of a tiny `InversionNet` (stochastic renders,
    the latent discriminator with R1 at step 0) over a global batch of 2:
    (per-step losses, the encoder's and WD's state, the encoder's and WD's
    gradients of step 0 as the optimizers took them)."""
    from invertavatar_torch.models.encoders import InversionNet, LatentCodesDiscriminator
    from invertavatar_torch.train.dryrun import _fake_batch, tiny_gen_cfg
    from invertavatar_torch.train.inversion import InversionLossWeights
    from invertavatar_torch.train.loop_inversion import InversionTrainConfig, train_e4e

    torch.manual_seed(0)
    net = InversionNet(tiny_gen_cfg(superresolution_noise_mode="none", depth_resolution=6,
                                    depth_resolution_importance=6), trunk_layers_n=8)
    wd = LatentCodesDiscriminator()
    weights = InversionLossWeights(l1=1.0, lpips=0.0, id=0.0, w_delta=0.001, w_regular=0.0,
                                   w_discriminator=0.01, raw_l1=1.0, tri=0.001)
    cfg = InversionTrainConfig(run_dir=run_dir, total_kimg=1, batch_size=2, kimg_per_tick=1,
                               weights=weights)
    losses, grads = [], {}

    def l1(a, b):
        return (a - b).abs().mean()

    def on_step(i, nimg, aux):
        losses.append({k: float(v) for k, v in aux.items()})
        if i == 0:
            grads.update({f"{n}.{k}": p.grad.numpy().copy()
                          for n, m in (("net", net), ("wd", wd))
                          for k, p in m.named_parameters() if p.grad is not None})

    batches = [_fake_batch(np.random.RandomState(30 + i), 2, 128, 32) for i in range(2)]
    train_e4e(net, wd, iter(batches), cfg, l1, max_steps=2, device="cpu", mesh=mesh,
              on_step=on_step)
    enc = {k: v for k, v in _np_state(net).items() if k.startswith("encoder.")}
    return losses, enc, _np_state(wd), grads


def train_oneshot_run(mesh, run_dir):
    """Four `train_oneshot` steps (the schedule's four phases, R1 every 2) of
    the one-shot tests' mock network with a render noise drawn per item,
    and a 16² dual discriminator, over a global batch of 2: (per-step aux,
    the network's and D's state)."""
    from invertavatar_torch.parallel.mesh import batch_rand
    from invertavatar_torch.train.inversion import InversionLossWeights
    from invertavatar_torch.train.loop_inversion import InversionTrainConfig, train_oneshot
    from tests import test_torch_oneshot_train as ost

    class MeshNoisyMockNet(ost._TorchMockNet):
        def forward(self, *args, generator=None, **kw):
            out = super().forward(*args, **kw)
            noise = batch_rand(out["image"].shape, generator, normal=True)
            return dict(out, image=out["image"] + 0.01 * noise)

    torch.manual_seed(0)
    net = MeshNoisyMockNet(ost._mock_weights(35))
    D = ost._biased_d(ost.MOCK_D_CFG)
    cfg = InversionTrainConfig(run_dir=run_dir, batch_size=2, wd_reg_interval=2,
                               weights=InversionLossWeights(**ost.OS_WEIGHTS))
    aux = []
    train_oneshot(net, D, ost._mock_train_batches(4), cfg, ost._lp, max_steps=4, device="cpu",
                  mesh=mesh, on_step=lambda i, n, a: aux.append(
                      {k: float(v) for k, v in a.items()}))
    return aux, _np_state(net), _np_state(D)


def train_fewshot_run(mesh, run_dir):
    """Four `train_fewshot` steps (curriculum (2, 4, 4) in chunks of 2, R1
    every 2) of the few-shot tests' mock network with a render noise drawn
    per frame, and a 16² dual discriminator whose minibatch std groups the
    D phase's [chunk, clip, frame] rows over the global batch, over 2 clips:
    (per-step aux, the network's and D's state)."""
    from invertavatar_torch.parallel.mesh import batch_rand
    from invertavatar_torch.train.inversion import InversionLossWeights
    from invertavatar_torch.train import loop_inversion as li
    from tests import test_torch_fewshot_train as fst

    class MeshNoiseGen(fst._MockGen):
        def synthesis_withTexture(self, *args, evaluation=False, generator=None, **kw):
            out = super().synthesis_withTexture(*args, evaluation=evaluation, **kw)
            if evaluation:
                return out
            noise = batch_rand(out["image"].shape, generator, normal=True)
            return dict(out, image=out["image"] + 0.01 * noise)

    torch.manual_seed(0)
    net = fst._MockNet(fst._mock_weights(61))
    net.generator.__class__ = MeshNoiseGen
    D = fst._biased_d(fst.MOCK_D_CFG)
    cfg = li.InversionTrainConfig(run_dir=run_dir, batch_size=2, wd_reg_interval=2, seed=5,
                                  weights=InversionLossWeights(**fst.FS_WEIGHTS))
    clips = (fst._port_clip(fst._mock_clip(60 + i, B=2, T=4)) for i in range(4))
    aux = []
    li.train_fewshot(net, clips, cfg, fst._lp, d_module=D, max_steps=4, multiT=(2, 4, 4),
                     frm_per_chunk=2, device="cpu", mesh=mesh,
                     on_step=lambda i, n, a: aux.append({k: float(v) for k, v in a.items()}))
    return aux, _np_state(net), _np_state(D)


def jax_mesh_gan_rank(mesh, rk, g_state, d_state, batch, cfg_kw):
    """One GAN step (Gmain, Dmain with R1) of `test_gan_step_matches_jax`'s
    port models on this rank's rows of `batch` (the JAX package's NHWC
    fake batch): the rank's metrics."""
    from invertavatar_torch.models.discriminator import DualDiscriminator
    from invertavatar_torch.models.triplane import TriPlaneGenerator
    from invertavatar_torch.train import gan as pg
    from invertavatar_torch.train.state import LazyRegAdam, TrainState
    from tests.test_torch_gan import D_CFG, NRR, _gen_cfg

    G = TriPlaneGenerator(**_gen_cfg(rk))
    G.load_state_dict(g_state, strict=False)
    D = DualDiscriminator(**D_CFG)
    D.load_state_dict(d_state, strict=True)
    cfg = pg.GANLossConfig(**cfg_kw)
    gs = TrainState(G, LazyRegAdam(G.parameters(), 0.0025, 0.0, 0.99, 1e-8, 4))
    ds = TrainState(D, LazyRegAdam(D.parameters(), 0.002, 0.0, 0.99, 1e-8, 16))
    mine = pm.shard_batch(mesh, batch)
    local = {"image": torch.from_numpy(np.ascontiguousarray(np.moveaxis(mine["image"], -1, 1))),
             "c": torch.from_numpy(np.ascontiguousarray(mine["c"])),
             "z": torch.from_numpy(np.ascontiguousarray(mine["z"])),
             "v": {"uvcoords_image": torch.from_numpy(
                 np.ascontiguousarray(mine["v"]["uvcoords_image"]))}}
    step = pg.make_gan_train_step(G, D, cfg, NRR, do_greg=False, do_dreg=True, mesh=mesh)
    m = step(gs, ds, local, pg.make_schedules(cfg, 1000), torch.Generator().manual_seed(0))
    return {k: float(v) for k, v in m.items()}
