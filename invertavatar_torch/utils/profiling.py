"""Where the time of a reenactment frame, a few-shot absorb, a one-shot
inversion or a training step (e4e, GAN, one-shot) goes on one GPU.

    python -m invertavatar_torch.utils.profiling          # the 512² frame
    python -m invertavatar_torch.utils.profiling online   # ... driven by FaceVerse
    python -m invertavatar_torch.utils.profiling absorb   # encode + 2 chunks of T=4
    python -m invertavatar_torch.utils.profiling oneshot  # one one-shot inversion
    python -m invertavatar_torch.utils.profiling e4e      # one e4e training step
    python -m invertavatar_torch.utils.profiling gan      # one GAN step, batch 4
    python -m invertavatar_torch.utils.profiling gan_r1   # ... with the R1 penalty
    python -m invertavatar_torch.utils.profiling oneshot_train  # Ireal+Dreal, Igen+Dgen
    python -m invertavatar_torch.utils.profiling fewshot_train  # Ireal+Igen+D at T=18

`frame` builds the flagship generator with seeded random weights (as
`chip_smoke.py` does) and precomputes the avatar once; `online` drives it
with the synthetic FaceVerse manager at the v3 mesh size (phase 11);
`absorb` builds `fewshot_inversion_net` and absorbs a synthetic 8-frame clip
(phase 13); `oneshot` builds `oneshot_inversion_net` and inverts a
synthetic 512² frame through `cli.eval_os.invert_source` (phase 15); `gan`
builds the flagship-width generator and dual discriminator of phase 17 and
runs a GAN step without the lazy regularisations (as 45 of every 48 steps
are), batch 4, or with R1 (`gan_r1`: 1 warm-up, 2 timed and 1 traced
iteration, as it takes seconds); `e4e` builds the e4e network (float32 flagship generator, IR-SE-50
encoder, latent discriminator) and steps `make_e4e_grad_programs` with the
B3 fast paths on a synthetic B=1 512² batch, as `chip_smoke.py` phase 10
does; `oneshot_train` builds phase 19's one-shot training models (float32
flagship generator with 48+48 samples, IR-SE-50 encoder, float32 SegFormer
U-Nets, the dual discriminator at 512²) and runs, per iteration, an Ireal
step (tri U-Net) with its Dreal phase and an Igen step (tex U-Net) with its
Dgen phase, batch 2, 512², under the B3 fast paths (1 warm-up, 2 timed and
1 traced iteration); `fewshot_train` builds phase 21's few-shot training
models (float32 flagship generator with 48+48 samples, IR-SE-50 encoder,
float32 IR-SE-50 ConvGRU U-Nets, the dual discriminator at 512², LPIPS
AlexNet with seeded weights) and runs one step of the curriculum's longest
clip: Ireal (tri-plane decoder, 6 of 18 frames), Igen and D on a seeded
18-frame 512² clip in chunks of 6, batch 1, no-grad renders fused (B1/B2),
grad-carrying ones on B3 and its transpose (1 warm-up, 2 timed and 1
traced iteration). Each times untraced iterations on the host clock, then traces
iterations with `torch.profiler` and prints, per iteration:
  * host ms and the peak memory (untraced) and device busy ms (the sum of kernel times; one
    stream, so kernels do not overlap), the device's idle share and the
    blocking host-device synchronisations by span (`utils/trace.py`)
  * each of the program's spans that ran (`utils/trace.py`; a frame:
    `faceverse` > `raster`, `frame` > `uvwarp`, `stylegan` > `stylegan.b<res>`,
    `volume` > `rays` / `coarse` / `importance` / `fine`, `superres` >
    `superres.b<res>`; absorb and oneshot add `encode`, `texture_unet`,
    `triplane_unet`; the training paths `discriminator`, fewshot_train
    `lpips`; the backward passes and Adam fall in "other"): the device time
    of the ops launched inside it (children included, and its own alone)
    and their number
  * the device ops with the most device time
and, last, one JSON line with the same numbers.
"""

from __future__ import annotations

import bisect
import collections
import json
import time
from collections import defaultdict

import torch

from . import trace

TRACED_FRAMES = 5
TIMED_FRAMES = 20
TOP_OPS = 15


def _frame(dev, online=False):
    """The iteration of the reenactment frame loop, from the
    fixed synthetic `uvcoords_image` or, `online`, from FaceVerse
    coefficients."""
    from ..flagship import example_inputs, flagship_generator, init_flagship

    G = init_flagship(flagship_generator(device=dev), seed=0)
    z, c, uvc = (torch.from_numpy(a).to(dev) for a in example_inputs(1))
    with torch.inference_mode():
        ws = G.mapping(z, c)
        tex = G.texture_backbone.synthesis(ws, return_list=True, noise_mode="const")
        static = G.backbone.synthesis(ws, return_list=True, noise_mode="const")
        cache = G.precompute_raster_static(static)
        tex_cat = G.precompute_texture_concat(tex)
    drive = lambda: uvc  # noqa: E731
    if online:
        from ..faceverse.synthetic import coeff_trajectory, synthetic_manager

        mgr, _ = synthetic_manager(n_grid=173, device=dev)
        traj = torch.from_numpy(coeff_trajectory(TIMED_FRAMES)).to(dev)
        frames = iter(range(1 << 62))
        drive = lambda: mgr.make_driven_rendering(traj[next(frames) % TIMED_FRAMES])  # noqa: E731

    @torch.inference_mode()
    def frame():
        return G.synthesis_withTexture(ws, tex, c, {"uvcoords_image": drive()},
                                       static_feats=static, noise_mode="const", evaluation=True,
                                       raster_static_cache=cache,
                                       texture_concat_cache=tex_cat)["image"]

    return frame


def _absorb(dev):
    """The iteration of the few-shot absorb: encode and two
    chunks of T=4 of a synthetic 512² clip through `cli.eval_seq.absorb_clip`."""
    from ..cli.eval_seq import absorb_clip
    from ..faceverse.synthetic import coeff_trajectory, synthetic_manager, synthetic_source_clip
    from ..flagship import fewshot_inversion_net

    net = fewshot_inversion_net(device=dev)
    mgr, _ = synthetic_manager(n_grid=173, device=dev)
    clip = synthetic_source_clip(mgr, torch.from_numpy(coeff_trajectory(8)).to(dev), 8, seed=13)

    @torch.inference_mode()
    def run():
        return absorb_clip(net, *clip, T=4)

    return run


def _oneshot(dev):
    """The iteration of one one-shot inversion of a synthetic
    512² frame through `cli.eval_os.invert_source`."""
    from ..cli.eval_os import invert_source
    from ..faceverse.synthetic import coeff_trajectory, synthetic_manager, synthetic_source_clip
    from ..flagship import oneshot_inversion_net

    net = oneshot_inversion_net(device=dev)
    mgr, _ = synthetic_manager(n_grid=173, device=dev)
    src = synthetic_source_clip(mgr, torch.from_numpy(coeff_trajectory(1)).to(dev), 1, seed=15)
    image, uv, cam, uvc = src
    return lambda: invert_source(net, image, cam, uv, uvc)


def _gan(dev, r1=False):
    """The iteration of one GAN step at flagship width, batch
    4, nrr 64, 48+48 samples, without the lazy regularisations (with `r1`,
    Dmain with the R1 penalty)."""
    import numpy as np

    from ..flagship import FLAGSHIP_RENDERING_KWARGS, example_inputs
    from ..models.discriminator import DualDiscriminator
    from ..models.triplane import TriPlaneGenerator
    from ..train import gan
    from ..train.state import LazyRegAdam, TrainState

    rk = dict(FLAGSHIP_RENDERING_KWARGS, gpc_reg_prob=None, superresolution_noise_mode="random",
              det_stratified=False, depth_resolution=48, depth_resolution_importance=48)
    torch.manual_seed(17)
    with torch.device(dev):
        G = TriPlaneGenerator(z_dim=512, c_dim=25, w_dim=512, img_resolution=512,
                              img_channels=3, rendering_kwargs=rk,
                              neural_rendering_resolution=64, channel_base=32768,
                              channel_max=512, map_num_layers=2)
        D = DualDiscriminator(c_dim=25, img_resolution=512, img_channels=6, channel_base=32768,
                              channel_max=512, num_fp16_res=4)
    g_state = TrainState(G, LazyRegAdam(G.parameters(), 0.0025, 0.0, 0.99, 1e-8, 4))
    d_state = TrainState(D, LazyRegAdam(D.parameters(), 0.002, 0.0, 0.99, 1e-8, 16))
    z, c, uvc = (torch.from_numpy(a).to(dev) for a in example_inputs(4))
    img = np.random.RandomState(0).randn(4, 3, 512, 512).astype(np.float32)
    batch = {"image": torch.from_numpy(img).to(dev), "c": c, "v": {"uvcoords_image": uvc}, "z": z}
    cfg = gan.GANLossConfig(blur_init_sigma=10.0, blur_fade_kimg=200.0)
    sched = gan.make_schedules(cfg, 0)
    step = gan.make_gan_train_step(G, D, cfg, 64, do_greg=False, do_dreg=r1)
    gen = torch.Generator(device=dev).manual_seed(0)
    return lambda: step(g_state, d_state, batch, sched, gen)


def _e4e(dev):
    """The iteration of the e4e training step."""
    import numpy as np

    from ..flagship import example_inputs, flagship_inversion_net
    from ..models.encoders import LatentCodesDiscriminator
    from ..train.inversion import InversionLossWeights
    from ..train.loop_inversion import e4e_trainable, make_e4e_grad_programs, masked_adam
    from ..train.state import TrainState

    net = flagship_inversion_net(device=dev)
    wd = LatentCodesDiscriminator().to(dev)
    state = TrainState(net, masked_adam(net, 1e-4, e4e_trainable))
    wd_state = TrainState(wd, torch.optim.Adam(wd.parameters(), lr=2e-5))
    z, c, uvc = (torch.from_numpy(a).to(dev) for a in example_inputs(1))
    img = np.random.RandomState(0).uniform(-1, 1, (1, 3, 512, 512)).astype(np.float32)
    batch = {"image": torch.from_numpy(img).to(dev), "c": c, "v": {"uvcoords_image": uvc}, "z": z}
    weights = InversionLossWeights(l1=1.0, lpips=0.0, id=0.0, w_delta=0.001, w_regular=0.0,
                                   w_discriminator=0.01, raw_l1=1.0, tri=0.001)
    step = make_e4e_grad_programs(net, lambda a, b: (a - b).abs().mean(), None, weights,
                                  fast_igen_target="exact", fast_grad="pallas")
    return lambda: step(state, wd_state, batch)


def _oneshot_train(dev):
    """The iteration of two one-shot training steps at phase
    19's shape: Ireal (tri U-Net) + Dreal, then Igen (tex U-Net) + Dgen."""
    from ..flagship import oneshot_train_batch, oneshot_train_models
    from ..train import loop_inversion as li
    from ..train.inversion import InversionLossWeights
    from ..train.state import TrainState

    net, D = oneshot_train_models(seed=19, device=dev)
    batch = oneshot_train_batch(2, 512, seed=19, device=dev)
    weights = InversionLossWeights(l1=1.0, lpips=0.0, id=0.0, raw_l1=1.0, tri=0.001,
                                   texture=0.001, adv=0.01)
    step = li.make_oneshot_train_step(net, lambda a, b: (a - b).abs().mean(), None, weights,
                                      fast_igen_target="exact", fast_grad="pallas")
    states = {u: TrainState(net, li.masked_adam(net, 1e-4, pred)) for u, pred in
              (("tex", li.oneshot_tex_trainable), ("tri", li.oneshot_tri_trainable))}
    d_state = TrainState(D, torch.optim.Adam(D.parameters(), lr=1e-4))

    def run():
        for i_phase, unet, d_phase in (("Ireal", "tri", "Dreal"), ("Igen", "tex", "Dgen")):
            step(states[unet], d_state, batch, phase=i_phase)
            step(states[unet], d_state, batch, phase=d_phase)

    return run


def _fewshot_train(dev):
    """The iteration of one few-shot training step at phase
    21's shape and longest clip: Ireal (tri-plane decoder) + Igen + D, T=18."""
    from ..flagship import fewshot_train_batch, fewshot_train_models
    from ..losses.lpips import LPIPS
    from ..train import loop_inversion as li
    from ..train.inversion import InversionLossWeights
    from ..train.state import TrainState

    net, D = fewshot_train_models(seed=21, device=dev)
    torch.manual_seed(21)
    lpips = LPIPS("alex").to(dev).eval().requires_grad_(False)
    with torch.no_grad():
        for p in lpips.lin.parameters():
            p.abs_()
    clip = fewshot_train_batch(1, 18, 512, seed=21, device=dev)
    weights = InversionLossWeights(l1=1.0, lpips=1.0, id=0.0, raw_l1=1.0, tri=0.001,
                                   lr_lpips=1.0, adv=0.1)
    step = li.make_fewshot_train_step(net, lpips, weights, 6, "fused", "pallas")
    d_step = li.make_fewshot_d_step(net, weights, 6, "fused")
    state = TrainState(net, li.masked_adam(net, 1e-4, li.fewshot_tri_trainable))
    d_state = TrainState(D, torch.optim.Adam(D.parameters(), lr=1e-4))
    idx = li.fewshot_fake_idx(0, 3, 18, 6)

    def run():
        step(state, clip, multiT=True, fake_idx=idx)
        step(state, clip, do_igen=True, multiT=True, d_module=D)
        d_step(d_state, clip)

    return run


def main(argv=None):
    import sys

    path = (argv if argv is not None else sys.argv[1:] or ["frame"])[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    paths = {"frame": _frame, "online": lambda d: _frame(d, online=True), "absorb": _absorb,
             "oneshot": _oneshot, "e4e": _e4e, "gan": _gan, "gan_r1": lambda d: _gan(d, True),
             "oneshot_train": _oneshot_train, "fewshot_train": _fewshot_train}
    run = paths[path](dev)
    warmup, timed, traced = ((1, 2, 1) if path in ("gan_r1", "oneshot_train", "fewshot_train")
                             else (3, TIMED_FRAMES, TRACED_FRAMES))
    for _ in range(warmup):
        run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(timed):
        run()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / timed * 1e3
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    syncs = collections.Counter(trace.syncs)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(traced):
            run()
        torch.cuda.synchronize()
    syncs = {k: (v - syncs[k]) / traced for k, v in trace.syncs.items() if v != syncs[k]}

    n = traced
    stages, work = _stages(prof)
    busy_ms = sum(e.time_range.elapsed_us() for e in work) / n / 1e3
    idle = max(0.0, 1 - busy_ms / host_ms)
    card = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}; path {path} (per {path} below)")
    print(f"host ms (untraced, {timed} iterations): {host_ms:.3f}; peak memory "
          f"{peak_gib:.3f} GiB (the untraced iterations)")
    print(f"device busy ms: {busy_ms:.3f}; device ops: {len(work) / n:.1f}; "
          f"idle share: {idle:.3f}; host syncs: {sum(syncs.values()):.1f} {syncs}")
    for name, st in stages.items():
        for k in st:
            st[k] /= n * (1e3 if k != "ops" else 1)
        print(f"  span {name:16s} busy {st['busy_ms']:8.3f} ms (self {st['self_ms']:8.3f}), "
              f"{st['ops']:6.1f} ops")
    ops = sorted((e for e in prof.key_averages()
                  if e.self_device_time_total > 0 and not e.key.startswith(trace.PREFIX)),
                 key=lambda e: e.self_device_time_total, reverse=True)[:TOP_OPS]
    print("top device ops (ms, calls):")
    for e in ops:
        print(f"  {e.self_device_time_total / n / 1e3:8.3f}  {e.count / n:6.1f}  {e.key[:100]}")
    print(json.dumps({
        "card": card, "path": path, "host_ms": host_ms, "peak_gib": peak_gib,
        "device_busy_ms": busy_ms, "idle_share": idle, "device_ops": len(work) / n,
        "host_syncs": syncs, "stages": stages,
        "top_ops_ms": {e.key[:100]: e.self_device_time_total / n / 1e3 for e in ops},
    }))


def _stages(prof):
    """({span name: busy_ms, self_ms, ops}, device ops) over the traced
    iterations (microseconds until `main` divides). The device ops are the
    kernels, copies and fills (the ctypes-bound kernels too). The profiler
    files each under the host op that launched it (`FunctionEvent.kernels`,
    through the launch's correlation id); it is charged to the program's
    spans around that op: to every one of them (`busy_ms`, `ops`) and to the
    innermost one alone (`self_ms`); "other" holds the ops launched outside
    every span (the backward passes, the optimiser). Names in the order
    they first ran."""
    events = list(prof.events())
    cpu = torch.autograd.DeviceType.CPU
    work = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(trace.PREFIX)]
    stages = defaultdict(lambda: {"busy_ms": 0.0, "self_ms": 0.0, "ops": 0})
    stages["other"]
    for e in sorted((e for e in events if e.device_type == cpu and e.kernels),
                    key=lambda e: e.time_range.start):
        parent, names = e, []
        while parent is not None:
            if parent.name.startswith(trace.PREFIX):
                names.append(parent.name[len(trace.PREFIX):])
            parent = parent.cpu_parent
        for k in e.kernels:
            for name in dict.fromkeys(names or ["other"]):
                stages[name]["busy_ms"] += k.duration
                stages[name]["ops"] += 1
            stages[names[0] if names else "other"]["self_ms"] += k.duration
    other = stages.pop("other")
    return dict(stages, other=other), work


if __name__ == "__main__":
    main()
