"""The port's data parallelism (`invertavatar_torch/parallel`) on the CPU.

Ranks are spawned processes (`spawn_ranks`: gloo, a `FileStore` in
`tmp_path`, never a TCP port, one intra-op thread a rank, every collective
bounded by a timeout) running `tests/torch_parallel_ranks.py`. Each check
holds N ranks against one process at the global batch, the meaning the
port keeps from JAX's one program over a `Mesh(('data',))`, or against the
JAX package on the global batch:
  * `shard_batch` takes the rows `InfiniteSampler` gives rank r of N, and the
    per-item draws under a mesh are the one-process draws' rows; a mesh of
    one rank gives the bits of no mesh;
  * the gathered minibatch std (forward, input gradient, and the gradient
    of the squared input gradient, R1's double backward) and the global
    `w_avg` against JAX's layers on the global batch;
  * `Collector.sync` against one collector, and JAX's, fed every report;
  * `Collector.sync` raises on every rank when the ranks' names differ,
    by name or by count, and is a no-op when no rank reported;
  * `check_replica_consistency` passes on equal replicas and, on every
    rank, names a perturbed buffer, two swapped entries or a NaN;
  * the GAN step, `train_gan`, `train_e4e`, `train_oneshot` and
    `train_fewshot` on 2 ranks against one process at the global batch,
    with every draw on; the replicas bitwise equal;
  * (slow) the port's GAN step on 2 ranks against JAX's step jitted over 2
    devices of the virtual CPU mesh.

Tolerances (float32, the same arithmetic in other summation orders: a mean
of per-rank means, the all-reduced gradient sums): losses to 1e-5 relative
(+1e-7); gradients to 1e-3 of each tensor's largest entry (as
`test_torch_gan.py` holds D's through R1's double backward; e4e's of each
module's largest entry); parameters after
Adam steps within 2·lr a step everywhere and within lr/50 on all but 0.1% of
the entries (as `test_e4e_step_matches_jax` holds 2e-6 at lr 1e-4: Adam
moves a parameter by ~lr·g/(|g| + ε), ±lr whatever |g|, so where a gradient
is float noise about zero the two sides may step apart); against JAX
1e-6 for the minibatch std's forward and input gradient, 1e-5 for its
double backward, `w_avg` to 4 float32 ulps of its largest entry (a mean of
per-rank means against one mean, then the lerp), 1e-12 for the collectors
(float64), 1e-4 for the GAN step's losses and R1 (as
`test_gan_step_matches_jax`).
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from invertavatar_torch.data.dataset import InfiniteSampler
from invertavatar_torch.parallel import mesh as pm
from invertavatar_torch.parallel.multihost import local_batch_slice, spawn_ranks
from invertavatar_torch.utils.weights import jax_to_state_dict
from tests import torch_parallel_ranks as ranks

# one intra-op thread: the suite runs test files in parallel worker processes
torch.set_num_threads(1)

TIMEOUT_S = 240  # each collective's bound
F32_EPS = float(np.finfo(np.float32).eps)


def _spawn(fn, tmp_path, *args, n=2):
    return spawn_ranks(fn, n, str(tmp_path / "ranks"), args=args, timeout_s=TIMEOUT_S)


def _cpu_mesh(rank, n):
    """A mesh view without a process group: enough for the row arithmetic
    and the draws, which run no collective."""
    return pm.DataMesh(rank, n, torch.device("cpu"))


def _global(per_rank, n=2):
    """Rank r's rows r, r + n, ... back in the global order."""
    out = np.empty((per_rank[0].shape[0] * n,) + per_rank[0].shape[1:], per_rank[0].dtype)
    for r, x in enumerate(per_rank):
        out[r::n] = x
    return out


def _close(got, ref, rel=1e-5, abs_=1e-7, what=""):
    assert abs(got - ref) <= rel * abs(ref) + abs_, (what, got, ref)


def _same_replicas(states):
    for k in states[0]:
        for s in states[1:]:
            assert np.array_equal(states[0][k], s[k]), k


def _adam_close(got, ref, lr, steps, what):
    """Adam-stepped parameters: every entry within 2·lr a step, all but 0.1%
    within lr/50."""
    d = np.concatenate([np.abs(got[k] - ref[k]).ravel() for k in ref
                        if np.issubdtype(ref[k].dtype, np.floating)])
    assert d.max() <= 2 * lr * steps, (what, d.max())
    assert (d > lr / 50).mean() < 1e-3, (what, (d > lr / 50).mean())


# ------------------------------------------------------- rows and draws


@pytest.mark.parametrize("n_ranks", [2, 3])
def test_shard_batch_takes_the_sampler_rows(n_ranks):
    """Rank r of N gets from `shard_batch` (and `local_batch_slice`) the rows
    of each global batch that `InfiniteSampler(rank=r, num_replicas=N)`
    yields it, so that a loader sharded by rank and a global batch cut by
    rank agree."""
    B, n_batches = 6, 5
    stream = iter(InfiniteSampler(13, seed=3))
    glob = [np.asarray([next(stream) for _ in range(B)]) for _ in range(n_batches)]
    for r in range(n_ranks):
        mesh = _cpu_mesh(r, n_ranks)
        mine = iter(InfiniteSampler(13, rank=r, num_replicas=n_ranks, seed=3))
        for g in glob:
            want = np.asarray([next(mine) for _ in range(B // n_ranks)])
            np.testing.assert_array_equal(pm.shard_batch(mesh, {"i": {"j": g}})["i"]["j"], want)
            np.testing.assert_array_equal(g[local_batch_slice(B, mesh)], want)
            assert torch.equal(pm.shard_batch(mesh, torch.from_numpy(g)), torch.from_numpy(want))


def test_local_batch_rows_and_draws_under_a_mesh():
    """`local_batch` cuts a global batch and keeps a rank's own; the rows of
    a [outer, item, inner] layout; `batch_rand` keeps this rank's rows of
    the one-process draw, in both layouts; nothing changes without a mesh."""
    batch = {"x": np.arange(8)[:, None] * np.ones((1, 3)), "v": {"y": np.arange(8)}}
    mesh = _cpu_mesh(1, 2)
    np.testing.assert_array_equal(pm.local_batch(mesh, batch, 8)["v"]["y"], [1, 3, 5, 7])
    own = pm.shard_batch(mesh, batch)
    assert pm.local_batch(mesh, own, 8) is own and pm.local_batch(None, batch, 8) is batch
    with pytest.raises(ValueError, match="neither the global batch"):
        pm.local_batch(mesh, batch, 12)
    assert pm.active_mesh() is None
    with pm.use_mesh(mesh):
        assert pm.active_mesh() is mesh
        np.testing.assert_array_equal(pm.local_rows(2), [1, 3])
        with pm.batch_layout(outer=2, inner=3):
            glob = np.arange(2 * 4 * 3).reshape(2, 4, 3)  # [chunk, item, frame]
            np.testing.assert_array_equal(pm.local_rows(2 * 2 * 3),
                                          glob[:, 1::2].reshape(-1))
            got = pm.batch_rand((12, 5), torch.Generator().manual_seed(1))
            want = torch.rand((24, 5), generator=torch.Generator().manual_seed(1))
            assert torch.equal(got, want[torch.from_numpy(glob[:, 1::2].reshape(-1))])
        got = pm.batch_rand((2, 3, 4), torch.Generator().manual_seed(2), normal=True)
        want = torch.randn((4, 3, 4), generator=torch.Generator().manual_seed(2))
        assert torch.equal(got, want[1::2])
    assert pm.active_mesh() is None
    assert torch.equal(pm.batch_rand((2, 3), torch.Generator().manual_seed(4)),
                       torch.rand((2, 3), generator=torch.Generator().manual_seed(4)))


def test_a_mesh_of_one_rank_gives_the_bits_of_no_mesh(tmp_path):
    """Every collective still runs at a world size of 1, and each is exact:
    the minibatch std (forward, input gradient, double backward), a `w_avg`
    update, the draws and the gradient all-reduce give the same bits over a
    mesh of one rank as without a mesh."""
    (res,) = _spawn(ranks.one_rank, tmp_path, n=1)
    for a, b in zip(res["none"], res["mesh"]):
        np.testing.assert_array_equal(a, b)


def test_collectives_match_one_process(tmp_path):
    """On 2 ranks: draws and the layout's rows of the one-process draw, the
    swap's roll over the global batch, mean / min / max over ranks,
    `replicate` (rank 0's parameters and Adam moments everywhere) and
    `all_reduce_grads` (the mean; a missing gradient stays missing)."""
    res = _spawn(ranks.collectives_rank, tmp_path)
    gen = torch.Generator().manual_seed(5)
    rand, randn = torch.rand((6, 2), generator=gen), torch.randn((6, 2, 2), generator=gen)
    layout = torch.rand((12, 4), generator=gen).numpy().reshape(2, 2, 3, 4)
    x = np.concatenate([np.arange(3.0), np.arange(3.0) + 10])  # rank r's rows r::2
    glob = _global([x[:3], x[3:]])
    rolled = np.roll(glob, 1)
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["rand"], rand.numpy()[r::2])
        np.testing.assert_array_equal(out["randn"], randn.numpy()[r::2])
        np.testing.assert_array_equal(out["layout"], layout[:, r::2].reshape(-1, 4))
        np.testing.assert_array_equal(out["roll"], rolled[r::2])
        assert (out["mean"], out["min"], out["max"]) == (0.5, 0.0, 1.0)
        np.testing.assert_array_equal(out["grad"], [1.5, 3.0])
        assert out["none_stays"]
        assert len(out["replicated"]) == 2 + 2 * 3  # weight, bias; Adam's avg, sq, step each
        for a, b in zip(out["replicated"], res[0]["replicated"]):
            np.testing.assert_array_equal(a, b)
    torch.manual_seed(0)  # rank 0's
    lin = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(lin.parameters())
    lin(torch.ones(1, 3)).sum().backward()
    opt.step()
    np.testing.assert_array_equal(res[1]["replicated"][0], lin.weight.detach().numpy())


# ------------------------------------------------ global batch statistics


def test_minibatch_std_gathered_matches_jax(tmp_path):
    """The minibatch std on 2 ranks of 2 rows (one group of 4 spanning both
    ranks) against JAX's `MinibatchStdLayer` on the global batch: output,
    the input gradient of <y, cot> and, through the gather's differentiable
    backward, the gradient of that gradient's squared sum."""
    from invertavatar_tpu.models.discriminator import MinibatchStdLayer as JLayer

    rng = np.random.RandomState(0)
    x = rng.randn(4, 8, 4, 4).astype(np.float32)
    cot = rng.randn(4, 9, 4, 4).astype(np.float32)
    res = _spawn(ranks.minibatch_std_rank, tmp_path, x, cot)
    y, g, gg = (_global([r[i] for r in res]) for i in range(3))

    def nhwc(a):
        return jnp.asarray(np.moveaxis(a, 1, -1))

    def fwd(xj):
        return JLayer(group_size=4, num_channels=1).apply({}, xj)

    def grad_of(xj):
        return jax.vjp(fwd, xj)[1](nhwc(cot))[0]

    y_j, g_j = fwd(nhwc(x)), grad_of(nhwc(x))
    gg_j = jax.grad(lambda xj: jnp.sum(jnp.square(grad_of(xj))))(nhwc(x))
    for got, ref, tol in ((y, y_j, 1e-6), (g, g_j, 1e-6), (gg, gg_j, 1e-5)):
        np.testing.assert_allclose(got, np.moveaxis(np.asarray(ref), -1, 1), rtol=tol, atol=tol)


def test_w_avg_global_matches_jax(tmp_path):
    """The mapping's `w_avg` EMA on 2 ranks of 2 rows against JAX's update on
    the global batch of 4; both replicas hold the same bits."""
    from invertavatar_tpu.models.mapping import MappingNetwork as JMapping

    cfg = dict(z_dim=8, c_dim=25, w_dim=16, num_ws=3, num_layers=2, w_avg_beta=0.5)
    rng = np.random.RandomState(1)
    z = rng.randn(4, 8).astype(np.float32)
    c = rng.randn(4, 25).astype(np.float32)
    net = JMapping(**cfg)
    variables = net.init(jax.random.PRNGKey(0), jnp.asarray(z), jnp.asarray(c))
    variables = {"params": variables["params"],
                 "buffers": {"w_avg": jnp.asarray(rng.randn(16).astype(np.float32))}}
    _, new = net.apply(variables, jnp.asarray(z), jnp.asarray(c), update_emas=True,
                       mutable=["buffers"])
    res = _spawn(ranks.w_avg_rank, tmp_path, jax_to_state_dict(variables), z, c, cfg)
    np.testing.assert_array_equal(res[0], res[1])
    ref = np.asarray(new["buffers"]["w_avg"])
    np.testing.assert_allclose(res[0], ref, rtol=0, atol=4 * F32_EPS * np.abs(ref).max())


def test_collector_sync_matches_one_collector_and_jax(tmp_path):
    """2 ranks reporting different values (and counts) read, after `sync`,
    the means and stds of one collector fed every report, the port's and
    JAX's."""
    from invertavatar_tpu.utils.stats import Collector as JCollector
    from invertavatar_torch.utils.stats import Collector

    reports = [[("Loss/a", [1.0, 2.5]), ("Loss/b", 3.0), ("Loss/a", [-4.0])],
               [("Loss/b", [5.0, 6.25, 0.5]), ("Loss/a", 7.0)]]
    res = _spawn(ranks.collector_rank, tmp_path, reports)
    one, jax_col = Collector(), JCollector()
    for rep in reports:
        for name, v in rep:
            one.report(name, v)
            jax_col.report(name, v)
    one.update()
    jax_col.update()
    for got in res:
        assert sorted(got) == sorted(one.as_dict()) == ["Loss/a", "Loss/b"]
        for name, st in got.items():
            assert st["num"] == one.as_dict()[name]["num"]
            for ref in (one, jax_col):
                _close(st["mean"], ref.mean(name), 1e-12, 1e-12, name)
                _close(st["std"], ref.std(name), 1e-12, 1e-12, name)


def test_check_replica_consistency_names_the_differing_buffer(tmp_path):
    """Equal replicas pass; a `w_avg` perturbed by 1e-6 on one rank fails on
    every rank, naming it."""
    for first, err in _spawn(ranks.replica_rank, tmp_path):
        assert first is None
        assert err is not None and "replicas differ at mapping.w_avg" in err, err


@pytest.mark.parametrize("reports", [
    [[("Loss/A", 1.0)], [("Loss/B", 2.0)]],
    [[("Loss/A", 1.0), ("Loss/B", 3.0)], [("Loss/A", 2.0)]],
], ids=["same_count_other_names", "other_counts"])
def test_collector_sync_raises_on_every_rank_when_names_differ(tmp_path, reports):
    """Ranks whose names differ all raise `RuntimeError` from `sync`, with
    the same count (the sums would land under the wrong names) and with
    another count (the sums' all-reduce would abort gloo)."""
    for rank, err in enumerate(_spawn(ranks.collector_mismatch_rank, tmp_path, reports)):
        assert err is not None and "ranks reported different names" in err, (rank, err)
        assert repr(sorted(n for n, _ in reports[rank])) in err, err


def test_collector_sync_with_nothing_reported_is_a_no_op(tmp_path):
    for got in _spawn(ranks.collector_rank, tmp_path, [[], []]):
        assert got == {}


@pytest.mark.parametrize("fault", ["swap", "nan"])
def test_check_replica_consistency_fails_every_rank_on_a_swap_or_a_nan(tmp_path, fault):
    """Two swapped weight entries (equal sums) and a NaN on one rank fail the
    check on every rank, naming the tensor."""
    what = "lin.weight" if fault == "swap" else "lin.bias"
    for err in _spawn(ranks.replica_fault_rank, tmp_path, fault):
        assert err is not None and f"replicas differ at {what}" in err, err


# ---------------------------------------------------------------- trainers


def _losses_match(ref, per_rank, rel=1e-5):
    """Per-step metrics: the mean over ranks of the ranks' own against the
    one-process value."""
    assert len(ref) == len(per_rank[0])
    for i, m in enumerate(ref):
        assert sorted(m) == sorted(per_rank[0][i])
        for k, v in m.items():
            _close(np.mean([r[i][k] for r in per_rank]), v, rel, 1e-7, f"step {i} {k}")


def test_gan_step_on_two_ranks_matches_one_process(tmp_path):
    """One GAN step with the density TV and R1, every draw on (noise, strata,
    importance samples, swaps, density probes, ADA), on 2 ranks of 1 item
    against one process at 2: losses, the all-reduced gradients (bitwise
    equal across ranks) and the global `w_avg`."""
    m_ref, g_ref, w_ref = ranks.gan_step_run(None)
    res = _spawn(ranks.gan_step_run, tmp_path)
    _losses_match([m_ref], [[m] for m, _, _ in res])
    assert "Loss/r1_penalty" in m_ref and "Loss/G/reg" in m_ref
    _same_replicas([g for _, g, _ in res])
    np.testing.assert_array_equal(res[0][2], res[1][2])
    np.testing.assert_allclose(res[0][2], w_ref, rtol=1e-7, atol=1e-7)
    for k, ref in g_ref.items():
        scale = max(np.abs(ref).max(), 1e-30)
        assert np.abs(res[0][1][k] - ref).max() <= 1e-3 * scale, k


@pytest.mark.slow
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_gan_on_two_ranks_matches_one_process(tmp_path, grad_accum):
    """Two `train_gan` steps (both regularisations at step 0, ADA adjusted
    every step) on 2 ranks of 2 items against one process at 4, with
    `grad_accum` micro-batches: losses, G, D and the EMA; replicas bitwise
    equal."""
    ref = ranks.train_gan_run(None, str(tmp_path / "one"), 2, grad_accum)
    res = _spawn(ranks.train_gan_run, tmp_path, str(tmp_path / "two"), 2, grad_accum)
    _losses_match(ref[0], [r[0] for r in res])
    for i, (what, lr) in enumerate((("G", 0.0025), ("D", 0.002), ("EMA", 0.0025)), start=1):
        _same_replicas([r[i] for r in res])
        _adam_close(res[0][i], ref[i], lr, 2, what)
    assert ref[4] == res[0][4] == 4 * 2 // grad_accum


@pytest.mark.slow
def test_train_gan_resumes_bitwise_on_two_ranks(tmp_path):
    """`train_gan(mesh=)` on 2 ranks of 1 item: 2 steps straight against 1
    step, a snapshot and the second resumed from it end on the same bits
    (G, D, EMA); only rank 0 writes (one `stats.jsonl` line a tick, one
    snapshot and one fakes grid a tick, and one TensorBoard event file
    where `tensorboard` is installed)."""
    a = _spawn(ranks.train_gan_run, tmp_path / "a", str(tmp_path / "run_a"), 2, 1, 2)
    _spawn(ranks.train_gan_run, tmp_path / "b", str(tmp_path / "run_b"), 1, 1, 2)
    snap = str(tmp_path / "run_b" / "snapshot-00000002.pt")
    c = _spawn(ranks.train_gan_run, tmp_path / "c", str(tmp_path / "run_c"), 2, 1, 2, 1, snap)
    for i in (1, 2, 3):
        _same_replicas([a[0][i], a[1][i], c[0][i], c[1][i]])
    assert a[0][4] == c[0][4] == 4
    with open(tmp_path / "run_a" / "stats.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [e["step"] for e in lines] == [2, 4]
    names = sorted(os.listdir(tmp_path / "run_a"))
    events = [n for n in names if n.startswith("events.out.tfevents.")]
    assert len(events) == (importlib.util.find_spec("tensorboard") is not None), names
    assert [n for n in names if n not in events] == [
        "fakes00000002.png", "fakes00000004.png", "snapshot-00000002.pt",
        "snapshot-00000004.pt", "stats.jsonl", "training_options.json"]


@pytest.mark.slow
def test_train_e4e_on_two_ranks_matches_one_process(tmp_path):
    """Two `train_e4e` steps of a tiny `InversionNet` with stochastic renders
    and the latent discriminator (R1 at step 0) on 2 ranks of 1 item against
    one process at 2: losses, step 0's all-reduced gradients of the encoder
    and WD (each entry to 1e-3 of its module's largest, as chip phases 18
    and 20 hold a trained module's gradients: a style head whose gradients
    are ~1e-4 of the encoder's sums two items' nearly cancelling parts), and
    the parameters after both steps within Adam's bound (here
    ~13% of the encoder's gradients are below 1e-9, float noise about zero
    that Adam's first steps blow up to ±lr); replicas bitwise equal."""
    ref = ranks.train_e4e_run(None, str(tmp_path / "one"))
    res = _spawn(ranks.train_e4e_run, tmp_path, str(tmp_path / "two"))
    _losses_match(ref[0], [r[0] for r in res])
    _same_replicas([r[3] for r in res])
    assert sorted(ref[3]) == sorted(res[0][3])
    for module in ("net.", "wd."):  # each entry to 1e-3 of the module's largest
        keys = [k for k in ref[3] if k.startswith(module)]
        scale = max(np.abs(ref[3][k]).max() for k in keys)
        for k in keys:
            assert np.abs(res[0][3][k] - ref[3][k]).max() <= 1e-3 * scale, k
    for i, (what, lr) in enumerate((("encoder", 1e-4), ("WD", 2e-5)), start=1):
        _same_replicas([r[i] for r in res])
        d = max(np.abs(res[0][i][k] - ref[i][k]).max() for k in ref[i])
        assert d <= 2 * lr * 2, (what, d)


def test_train_oneshot_on_two_ranks_matches_one_process(tmp_path):
    """Four `train_oneshot` steps (Ireal, Ireal, Igen, Igen with their D
    phases, R1 every 2) of the mock network with a per-item render noise and
    a 16² dual discriminator (its minibatch std over the global batch) on 2
    ranks of 1 item against one process at 2: every phase's losses, the
    network and D; replicas bitwise equal."""
    ref = ranks.train_oneshot_run(None, str(tmp_path / "one"))
    res = _spawn(ranks.train_oneshot_run, tmp_path, str(tmp_path / "two"))
    _losses_match(ref[0], [r[0] for r in res])
    for i, what in ((1, "net"), (2, "D")):
        _same_replicas([r[i] for r in res])
        _adam_close(res[0][i], ref[i], 1e-4, 4, what)
    with open(tmp_path / "two" / "stats.jsonl") as f:  # rank 0's line alone
        assert len(f.readlines()) == 1


def test_train_fewshot_on_two_ranks_matches_one_process(tmp_path):
    """Four `train_fewshot` steps (clips of 2 and 4 frames in chunks of 2,
    Ireal, Igen and the D phase, R1 every 2) of the mock network with a
    per-frame render noise, and a 16² dual discriminator grouping the D
    phase's [chunk, clip, frame] rows over the global batch, on 2 ranks of
    1 clip against one process at 2: every phase's losses, the network and
    D; replicas bitwise equal."""
    ref = ranks.train_fewshot_run(None, str(tmp_path / "one"))
    res = _spawn(ranks.train_fewshot_run, tmp_path, str(tmp_path / "two"))
    _losses_match(ref[0], [r[0] for r in res])
    for i, what in ((1, "net"), (2, "D")):
        _same_replicas([r[i] for r in res])
        _adam_close(res[0][i], ref[i], 1e-4, 4, what)


# ------------------------------------------------------------ against JAX


@pytest.mark.slow
def test_gan_step_on_two_ranks_matches_jax_mesh(tmp_path):
    """One GAN step (Gmain, then Dmain with R1) of JAX's `make_gan_train_step`
    jitted with the batch of 4 sharded over 2 devices of the virtual CPU
    mesh, against the port on 2 ranks of 2 (the minibatch-std group of 4
    spans both ranks), with `test_gan_step_matches_jax`'s deterministic
    set-up: losses and R1 to 1e-4."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from invertavatar_tpu.train import gan as jg
    from invertavatar_tpu.train.state import TrainState as JState
    from invertavatar_tpu.train.state import adam_with_lazy_reg as jadam
    from tests.test_torch_gan import NRR, _jax_models, _rk

    rk = _rk(depth_resolution_importance=0)
    Gj, Dj, g_vars, d_vars = _jax_models(rk)
    from invertavatar_tpu.train.dryrun import _fake_batch

    b = _fake_batch(np.random.RandomState(8), batch=4, res=128, z_dim=32)
    cfg_kw = dict(neural_rendering_resolution_initial=NRR, neural_rendering_resolution_final=None,
                  blur_init_sigma=10.0, blur_fade_kimg=8.0)
    g_tx, d_tx = jadam(0.0025, 0.0, 0.99, 1e-8, 4), jadam(0.002, 0.0, 0.99, 1e-8, 16)
    step_j = jg.make_gan_train_step(Gj, Dj, g_tx, d_tx, jg.GANLossConfig(**cfg_kw), NRR,
                                    do_greg=False, do_dreg=True)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))

    def shard(x):
        return jax.device_put(x, NamedSharding(mesh, P("data", *([None] * (x.ndim - 1)))))

    rep = NamedSharding(mesh, P())
    _, _, m_j = jax.jit(step_j)(
        jax.device_put(JState(g_vars["params"], g_tx.init(g_vars["params"]),
                              g_vars["buffers"]), rep),
        jax.device_put(JState(d_vars["params"], d_tx.init(d_vars["params"]), {}), rep),
        jax.tree_util.tree_map(lambda x: shard(jnp.asarray(x)), b),
        jax.device_put(jg.make_schedules(jg.GANLossConfig(**cfg_kw), 1000), rep),
        jax.random.PRNGKey(0))
    res = _spawn(ranks.jax_mesh_gan_rank, tmp_path, rk, jax_to_state_dict(g_vars),
                 jax_to_state_dict(d_vars), b, cfg_kw)
    for k in ("Loss/G/loss", "Loss/scores/fake", "Loss/D/loss", "Loss/scores/real",
              "Loss/r1_penalty"):
        _close(np.mean([r[k] for r in res]), float(m_j[k]), 1e-4, 1e-6, k)
