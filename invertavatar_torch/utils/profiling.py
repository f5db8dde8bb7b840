"""Where the time of a reenactment frame, a few-shot absorb or an e4e training
step goes on one GPU.

    python -m invertavatar_torch.utils.profiling          # the 512² frame
    python -m invertavatar_torch.utils.profiling online   # ... driven by FaceVerse
    python -m invertavatar_torch.utils.profiling absorb   # encode + 2 chunks of T=4
    python -m invertavatar_torch.utils.profiling e4e      # one e4e training step

`frame` builds the flagship generator with seeded random weights (as
`chip_smoke.py` does) and precomputes the avatar once; `online` drives it
with the synthetic FaceVerse manager at the v3 mesh size (phase 11);
`absorb` builds `fewshot_inversion_net` and absorbs a synthetic 8-frame clip
(phase 13); `e4e` builds the e4e network (float32 flagship generator, IR-SE-50
encoder, latent discriminator) and steps `make_e4e_grad_programs` with the
B3 fast paths on a synthetic B=1 512² batch, as `chip_smoke.py` phase 10
does. Each times untraced iterations on the host clock, then traces
iterations with `torch.profiler` and prints, per iteration:
  * host ms (untraced) and device busy ms (the sum of kernel times; one
    stream, so kernels do not overlap) and the device's idle share
  * for all but `e4e`, each stage (frame: the driving signal, rasterize,
    face backbone, renderer, super-resolution; absorb: encode, the texture
    and static backbones, the render, both U-Nets), and the rest: its window
    on the device timeline, the device time busy inside it, its device ops
  * the device ops with the most device time
and, last, one JSON line with the same numbers.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict

import torch

TRACED_FRAMES = 5
TIMED_FRAMES = 20
TOP_OPS = 15


@contextlib.contextmanager
def _stage_scopes(targets):
    """Wrap each `(stage, object, attribute)` callable in a `record_function`
    scope (restored after)."""

    def scoped(stage, fn):
        def wrapped(*a, **k):
            with torch.profiler.record_function(f"stage:{stage}"):
                return fn(*a, **k)
        return wrapped

    saved = []
    for stage, obj, attr in targets:
        saved.append((obj, attr, attr in vars(obj), getattr(obj, attr)))
        setattr(obj, attr, scoped(stage, getattr(obj, attr)))
    try:
        yield
    finally:
        for obj, attr, own, fn in reversed(saved):
            if own:
                setattr(obj, attr, fn)
            else:
                delattr(obj, attr)


def _frame(dev, online=False):
    """(iteration, stages, scopes) of the reenactment frame loop, from the
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
    targets = [("rasterize", G, "rasterize"), ("render", G, "renderer"),
               ("face_backbone", G.face_backbone.synthesis, "forward"),
               ("superresolution", G.superresolution, "forward")]
    drive = lambda: uvc  # noqa: E731
    if online:
        from ..faceverse.synthetic import coeff_trajectory, synthetic_manager

        mgr, _ = synthetic_manager(n_grid=173, device=dev)
        traj = torch.from_numpy(coeff_trajectory(TIMED_FRAMES)).to(dev)
        frames = iter(range(1 << 62))
        drive = lambda: mgr.make_driven_rendering(traj[next(frames) % TIMED_FRAMES])  # noqa: E731
        targets.insert(0, ("driving", mgr, "make_driven_rendering"))

    @torch.inference_mode()
    def frame():
        return G.synthesis_withTexture(ws, tex, c, {"uvcoords_image": drive()},
                                       static_feats=static, noise_mode="const", evaluation=True,
                                       raster_static_cache=cache,
                                       texture_concat_cache=tex_cat)["image"]

    return frame, [t[0] for t in targets], _stage_scopes(targets)


def _absorb(dev):
    """(iteration, stages, scopes) of the few-shot absorb: encode and two
    chunks of T=4 of a synthetic 512² clip through `cli.eval_seq.absorb_clip`."""
    from ..cli.eval_seq import absorb_clip
    from ..faceverse.synthetic import coeff_trajectory, synthetic_manager, synthetic_source_clip
    from ..flagship import fewshot_inversion_net

    net = fewshot_inversion_net(device=dev)
    mgr, _ = synthetic_manager(n_grid=173, device=dev)
    clip = synthetic_source_clip(mgr, torch.from_numpy(coeff_trajectory(8)).to(dev), 8, seed=13)
    G, unets = net.generator, net.unet_encoder
    targets = [("encode", net, "encode"),
               ("texture_backbone", G.texture_backbone.synthesis, "forward"),
               ("backbone", G.backbone.synthesis, "forward"),
               ("render", G, "synthesis_withTexture"),
               ("texture_unet", unets.texture_unet, "forward"),
               ("triplane_unet", unets.triplane_unet, "forward")]

    @torch.inference_mode()
    def run():
        return absorb_clip(net, *clip, T=4)

    return run, [t[0] for t in targets], _stage_scopes(targets)


def _e4e(dev):
    """(iteration, no stages, no scopes) of the e4e training step."""
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
    return (lambda: step(state, wd_state, batch)), (), contextlib.nullcontext()


def main(argv=None):
    import sys

    path = (argv if argv is not None else sys.argv[1:] or ["frame"])[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    paths = {"frame": _frame, "online": lambda d: _frame(d, online=True), "absorb": _absorb,
             "e4e": _e4e}
    run, stage_names, scopes = paths[path](dev)
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_FRAMES):
        run()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / TIMED_FRAMES * 1e3

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with scopes, torch.profiler.profile(activities=acts) as prof:
        for _ in range(TRACED_FRAMES):
            run()
        torch.cuda.synchronize()

    n = TRACED_FRAMES
    # Device timeline: kernels, copies and fills (the ctypes-bound kernels too,
    # which no aten op encloses), and each stage's `record_function` span as
    # the profiler mirrors it onto the device (first to last kernel of it).
    on_device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end, e.name[len("stage:"):])
                   for e in on_device if e.name.startswith("stage:"))
    work = [e for e in on_device if not e.name.startswith("stage:")]
    busy_us, window_us = defaultdict(float), defaultdict(float)
    count = defaultdict(int)
    for start, end, stage in spans:
        window_us[stage] += end - start
    for e in work:
        t = e.time_range.start
        stage = next((st for s0, s1, st in spans if s0 <= t < s1), "other")
        busy_us[stage] += e.time_range.elapsed_us()
        count[stage] += 1
    busy_ms = sum(busy_us.values()) / n / 1e3
    idle = max(0.0, 1 - busy_ms / host_ms)
    card = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}; path {path} (per {path} below)")
    print(f"host ms (untraced, {TIMED_FRAMES} iterations): {host_ms:.3f}")
    print(f"device busy ms: {busy_ms:.3f}; device ops: {len(work) / n:.1f}; "
          f"idle share: {idle:.3f}")
    stages = {}
    for stage in (*stage_names, "other") if stage_names else ():
        stages[stage] = {"window_ms": window_us[stage] / n / 1e3,
                         "busy_ms": busy_us[stage] / n / 1e3, "ops": count[stage] / n}
        print(f"  stage {stage:16s} device window {stages[stage]['window_ms']:8.3f} ms, "
              f"busy {stages[stage]['busy_ms']:8.3f} ms, {stages[stage]['ops']:6.1f} ops")
    ops = sorted((e for e in prof.key_averages()
                  if e.self_device_time_total > 0 and not e.key.startswith("stage:")),
                 key=lambda e: e.self_device_time_total, reverse=True)[:TOP_OPS]
    print("top device ops (ms, calls):")
    for e in ops:
        print(f"  {e.self_device_time_total / n / 1e3:8.3f}  {e.count / n:6.1f}  {e.key[:100]}")
    print(json.dumps({
        "card": card, "path": path, "host_ms": host_ms, "device_busy_ms": busy_ms,
        "idle_share": idle, "device_ops": len(work) / n, "stages": stages,
        "top_ops_ms": {e.key[:100]: e.self_device_time_total / n / 1e3 for e in ops},
    }))


if __name__ == "__main__":
    main()
