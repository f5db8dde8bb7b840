#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`invertavatar_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. the card's name and power limit, torch version; TF32 off for the checks
  2. build the CUDA kernels from `invertavatar_torch/csrc/` (nvcc, sm_90a)
  3. kernel B1 (`fused_render`) against its plain version at the flagship
     shapes: the flagship camera's rays and coarse depths through the port's
     own projection, random bf16 planes [3,256,256,32], random decoder weights
     (32 -> 64 -> 33); then again at the tests' decoder (C=8, HID=16), 64²
     planes, 32² rays and tile (16, 2), whose 32-ray tiles leave B2's 64-ray
     blocks ragged; the flagship shapes are timed
  4. kernel B2 (`fused_merged_march`) likewise, fed B1's raw output
  5. a small-config frame on the card (kernels) against the same frame on the
     CPU (plain versions)
  6. the frame loop: the flagship generator with seeded random weights, the
     avatar precomputed once, then warm-up and timed 512² reenactment frames
     through `synthesis_withTexture`; B1 and B2 must launch once per frame
  7. load kernel B3 and its transpose (`csrc/plane_sample.cu`, built in
     phase 2 beside `fused_render.cu`, each by its own nvcc)
  8. B3 (float32 and bf16 payloads) and its transpose against their plain
     versions at the shapes of a real full-width student render (recorded
     through the renderer), with `F.grid_sample`'s forward and backward timed
     as the library yardstick, and the channels-last copy of the planes
  9. a small-config e4e training step on the card against the same step on
     the CPU: losses and encoder gradients
 10. the e4e training path: the float32 flagship generator (frozen) with an
     IR-SE-50 e4e encoder and the latent discriminator, seeded random
     weights, B=1 synthetic 512² batches, `make_e4e_grad_programs` with the
     Igen target on B3 (fp32) and the student renders on B3 + its transpose;
     warm-up and timed steps; B3 must launch 6 times and its transpose 4
     times per step
Kernel times are each kernel's own device time (torch.profiler); plain
versions and library calls are timed by the device time of all their ops.
The last lines are the kernels' JSON record, the card's name and power limit,
and `{"ok": true, ...}`.
"""

import contextlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

N_WARMUP = 3
N_FRAMES = 20
N_TIMED = 15  # profiled calls per kernel (median), plain version and library call (mean)
N_E4E_WARMUP = 2
N_E4E_STEPS = 5
# B3 launches per e4e step: two render passes (coarse, fine) of the Igen
# target and of both students; transpose launches: both passes of both students
B3_PER_STEP, B3T_PER_STEP = 6, 4

# H100 SXM published peaks (dense): fp32 outside the tensor cores, TF32 on
# the tensor cores, HBM3 rate
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, kernel=None, n=N_TIMED, warmup=3, tries=3):
    """Device time of one call of fn(), from torch.profiler over `n` calls:
    the median time of the kernel whose name holds `kernel` (one launch per
    call), or else the mean device time of all the ops a call launches. CUDA
    events around a call would also count the device's idle time while the
    host prepares it. A session that lost kernel records (seen now and then
    on the card) is repeated when it kept fewer than a third of them."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        times = sorted(e.time_range.elapsed_us() / 1e3 for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and (kernel is None or kernel in e.name))
        if kernel is None and times:
            return sum(times) / n
        if kernel is not None and len(times) * 3 >= n:
            if len(times) != n:
                print(f"chip_smoke: note: the profiler kept {len(times)} of {n} launches of "
                      f"{kernel}; their median is used")
            return times[len(times) // 2]
    fail(f"the profiler kept {len(times)} records of {kernel or 'a call'} in {n} calls")


CU_SOURCES = ("fused_render", "plane_sample")


def print_build(tag, name):
    from invertavatar_torch.utils import cuda_build

    secs, report = cuda_build.BUILD_INFO[name]
    print(f"{tag} csrc/{name}.cu: nvcc {secs:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"{tag}   ptxas: {line.strip()}")


def bound(bytes_, flops, tc_flops=0.0):
    """Least time (ms) for the work and what sets it: the bytes over the memory
    rate against the operations, `flops` at the fp32 peak plus `tc_flops` at
    the TF32 tensor-core peak."""
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    t_ops = (flops / PEAK_FP32_FLOPS + tc_flops / PEAK_TF32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tap_flops_per_point(C):
    return 2 * 12 * C  # 3 planes x 4 taps x C multiply-adds


def mlp_flops_per_point(C, HID):
    return 2 * (C * HID + HID * (C + 1))  # the decoder, counted once


@contextlib.contextmanager
def recording(module, name, calls):
    """Record (args, kwargs, result) of every call to module.<name>."""
    orig = getattr(module, name)

    def rec(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    setattr(module, name, rec)
    try:
        yield
    finally:
        setattr(module, name, orig)


def render_kernel_checks(torch, fr, rmod, card, label, c_np, planes, decoder, rk, res,
                         timed=False):
    """Phases 3-4 at one shape: one render through the port's renderer with B1
    and B2 recorded, each held against its plain version on the recorded
    inputs; with `timed`, both are timed and their kernel records returned."""
    from invertavatar_torch.render.ray_sampler import sample_rays

    c = torch.from_numpy(c_np).to(planes.device)
    ray_o, ray_d = sample_rays(c[:, :16].reshape(-1, 4, 4), c[:, 16:25].reshape(-1, 3, 3), res)
    b1_calls, b2_calls = [], []
    with torch.inference_mode(), recording(rmod, "fused_render", b1_calls), \
            recording(rmod, "fused_merged_march", b2_calls):
        rmod.ImportanceRenderer()(planes, decoder, ray_o, ray_d, rk, evaluation=True,
                                  decoder_params=decoder.return_params())
    torch.cuda.synchronize()
    if len(b1_calls) != 1 or len(b2_calls) != 1:
        fail(f"the {label} render made {len(b1_calls)} B1 and {len(b2_calls)} B2 calls, "
             "expected one each")
    kernels = []

    def record(name, replaces, err, ms, plain_ms, nbytes, ops, mlp, what):
        """Print the kernel's time beside both bounds (MLP on the tensor cores,
        and on the fp32 cores as before) and keep its JSON record."""
        b, by = bound(nbytes, ops, mlp)
        b_fp32, by_fp32 = bound(nbytes, ops + mlp)
        print(f"[{'3' if name == 'fused_render' else '4'}] {name} kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms; bound {b:.4f} ms ({by}; MLP on the TF32 tensor cores) beside "
              f"{b_fp32:.4f} ms ({by_fp32}; MLP on the fp32 cores); {nbytes / 1e6:.1f} MB, "
              f"{mlp / 1e9:.2f} GFLOP MLP + {ops / 1e9:.2f} GFLOP {what} on {card}")
        kernels.append(dict(name=name, route="cuda",
                            source="invertavatar_torch/csrc/fused_render.cu", replaces=replaces,
                            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                            library_ms=None))

    with torch.inference_mode():
        # B1
        args, kw, raw = b1_calls[0]
        pl, grid, params = args[0], args[1], args[2]
        ref = fr.fused_render_reference(*args, **kw).float()
        err = (raw.float() - ref).abs()
        tol = ref.abs() * 2.0 ** -7 + 1e-4  # one bf16 ulp of the output + fp32 reorder
        bad = int((err > tol).sum())
        C = pl.shape[-1]
        HID = params[0].shape[1]
        points = raw.shape[0] * raw.shape[1]
        print(f"[3] B1 fused_render {label}: out {tuple(raw.shape)} bf16, {points} points; "
              f"max|k-p| {err.max().item():.3e} mean {err.mean().item():.3e}; "
              f"tolerance |k-p| <= 2^-7|p| + 1e-4, violations {bad}")
        if bad or not torch.isfinite(raw.float()).all():
            fail(f"B1 ({label}) disagrees with its plain version")
        if timed:
            record("fused_render", "invertavatar_tpu/ops/pallas_fused_render.py:150",
                   err.max().item(),
                   device_ms(lambda: fr.fused_render(*args, **kw), "fused_render_kernel<"),
                   device_ms(lambda: fr.fused_render_reference(*args, **kw)),
                   grid.numel() * 4 + pl.numel() * 2 + raw.numel() * 2,
                   points * tap_flops_per_point(C), points * mlp_flops_per_point(C, HID), "taps")

        # B2, fed B1's raw output from the same render
        args, kw, out_k = b2_calls[0]
        out_p = fr.fused_merged_march_reference(*args, **kw)
        worst, total, count, bad = 0.0, 0.0, 0, 0
        for a, b in zip(out_k, out_p):
            e = (a - b).abs()
            worst = max(worst, e.max().item())
            total += e.sum().item()
            count += e.numel()
            bad += int((e > 1e-4 * b.abs() + 1e-4).sum())
        pl, proj_m, is_fine, src, d_m, coarse = args[:6]
        T, Sm = is_fine.shape
        P = proj_m.shape[3]
        n_fine_pts = int(is_fine.sum().item()) * P
        print(f"[4] B2 fused_merged_march {label}: T={T} Sm={Sm} P={P}, {n_fine_pts} fine "
              f"points; max|k-p| {worst:.3e} mean {total / count:.3e}; "
              f"tolerance |k-p| <= 1e-4|p| + 1e-4, violations {bad}")
        if bad or not all(torch.isfinite(a).all() for a in out_k):
            fail(f"B2 ({label}) disagrees with its plain version")
        if timed:
            record("fused_merged_march", "invertavatar_tpu/ops/pallas_fused_render.py:398", worst,
                   device_ms(lambda: fr.fused_merged_march(*args, **kw), "merged_march_kernel<"),
                   device_ms(lambda: fr.fused_merged_march_reference(*args, **kw)),
                   coarse.numel() * 2 + 3 * n_fine_pts * 2 * 4 + pl.numel() * 2
                   + 3 * T * Sm * 4 + T * P * (C + 2) * 4,
                   n_fine_pts * tap_flops_per_point(C) + T * Sm * P * (3 * C + 12),
                   n_fine_pts * mlp_flops_per_point(C, HID), "taps and march")
    return kernels


def e4e_phases(torch, dev, card, ps, rmod):
    """Phases 7-10; returns the kernel records of B3 and its transpose."""
    import numpy as np
    import torch.nn.functional as F

    from invertavatar_torch.flagship import example_inputs, flagship_inversion_net
    from invertavatar_torch.models.encoders import LatentCodesDiscriminator
    from invertavatar_torch.train.fast_render import grad_overrides
    from invertavatar_torch.train.inversion import InversionLossWeights
    from invertavatar_torch.train.loop_inversion import (e4e_trainable, make_e4e_grad_programs,
                                                         masked_adam)
    from invertavatar_torch.train.state import TrainState
    from invertavatar_torch.utils import cuda_build

    # the validation run's weights: train_e4e_real.yaml with LPIPS and ID off
    weights = InversionLossWeights(l1=1.0, lpips=0.0, id=0.0, w_delta=0.001, w_regular=0.0,
                                   w_discriminator=0.01, raw_l1=1.0, tri=0.001)

    def l1(a, b):
        return (a - b).abs().mean()

    def batch_on(d, z_dim, res, seed=0):
        z_np, c_np, uvc_np = example_inputs(1, seed=seed)
        img = np.random.RandomState(seed).uniform(-1, 1, (1, 3, res, res)).astype(np.float32)
        return {"image": torch.from_numpy(img).to(d), "c": torch.from_numpy(c_np).to(d),
                "v": {"uvcoords_image": torch.from_numpy(uvc_np).to(d)},
                "z": torch.from_numpy(z_np[:, :z_dim]).to(d)}

    def states(net):
        wd = LatentCodesDiscriminator().to(next(net.parameters()).device)
        return (TrainState(net, masked_adam(net, 1e-4, e4e_trainable)),
                TrainState(wd, torch.optim.Adam(wd.parameters(), lr=2e-5)))

    # ---------------------------------------------------------------- phase 7
    cuda_build.load("plane_sample")
    print_build("[7]", "plane_sample")

    # ---------------------------------------------------------------- phase 8
    t0 = time.perf_counter()
    net = flagship_inversion_net(device=dev)
    batch = batch_on(dev, 512, 512)
    torch.cuda.synchronize()
    print(f"[8] e4e network built (float32 flagship generator + IR-SE-50 encoder), weights "
          f"filled in {time.perf_counter() - t0:.2f} s")
    calls = []
    G = net.generator
    with torch.no_grad(), recording(rmod, "sample_planes_windowed_cvjp", calls):
        ws = net.encode(batch["image"])
        tex = G.texture_backbone.synthesis(ws, return_list=True, noise_mode="const")
        static = G.backbone.synthesis(ws, return_list=True, noise_mode="const")
        G.synthesis_withTexture(ws, tex, batch["c"], batch["v"], static_feats=static,
                                noise_mode="const", rendering_overrides=grad_overrides("pallas"))
    torch.cuda.synchronize()
    if len(calls) != 2:
        fail(f"a student render made {len(calls)} B3 calls, expected 2 (coarse, fine)")
    print(f"[8] student render recorded: planes {tuple(calls[0][0][0].shape)}, grids "
          f"{[tuple(c[0][1].shape) for c in calls]}")
    records = []
    with torch.no_grad():
        # the channels-last copy the renderer makes once per render
        planes_nc = G.backbone.synthesis(ws, return_list=True, noise_mode="const")[-1]
        planes_nc = planes_nc.reshape(1, 3, -1, *planes_nc.shape[-2:]).float()
        copy_ms = device_ms(lambda: planes_nc.permute(0, 1, 3, 4, 2).reshape(
            3, *planes_nc.shape[-2:], planes_nc.shape[2]).contiguous())
        print(f"[8] [B,3,C,H,W] -> [3B,H,W,C] copy of the planes: {copy_ms:.4f} ms "
              f"({planes_nc.numel() * 8 / 1e6:.1f} MB moved) on {card}")
        for (args, _, out), label in zip(calls, ("coarse", "fine")):
            planes, grid = args
            N, H, W, C = planes.shape
            R, S = grid.shape[1], grid.shape[2]
            n_pts = N * R * S
            planes_nchw = planes.permute(0, 3, 1, 2).contiguous()
            # forward, float32 payload (the training route) and bf16 (the eval
            # route). Scale of the rounding: m = Σ_taps w·|v|, the sample of |planes|.
            m = ps.sample_planes_windowed_reference(planes.abs(), grid)
            errs = {}
            for dt, rel in ((torch.float32, 0.0), (torch.bfloat16, 2.0 ** -7)):
                k = ps.sample_planes_windowed(planes, grid, dt)
                p = ps.sample_planes_windowed_reference(planes, grid, dt)
                e = (k.float() - p.float()).abs()
                bad = int((e > p.float().abs() * rel + 2e-6 * m).sum())
                errs[dt] = e.max().item()
                print(f"[8] B3 {label} S={S} {str(dt)[6:]}: max|k-p| {e.max().item():.3e} mean "
                      f"{e.mean().item():.3e}; tolerance |k-p| <= {rel:.3g}|p| + 2e-6·Σw|v| "
                      f"(fused multiply-adds; bf16: one ulp of the output), violations {bad}")
                if bad or not torch.isfinite(k.float()).all():
                    fail(f"B3 ({dt}) disagrees with its plain version")
            if not torch.equal(out, ps.sample_planes_windowed(planes, grid)):
                fail("the recorded student render's B3 output differs from a fresh launch")
            f_ms = device_ms(lambda: ps.sample_planes_windowed(planes, grid), "sample_kernel<")
            f_plain = device_ms(lambda: ps.sample_planes_windowed_reference(planes, grid))
            f_lib = device_ms(lambda: F.grid_sample(planes_nchw, grid, mode="bilinear",
                                                  padding_mode="zeros", align_corners=False))
            bf_ms = device_ms(lambda: ps.sample_planes_windowed(planes, grid, torch.bfloat16),
                              "sample_kernel<")
            f_bytes = grid.numel() * 4 + planes.numel() * 4 + n_pts * C * 4
            f_bound, f_by = bound(f_bytes, n_pts * 4 * C * 2)
            print(f"[8] B3 {label} fp32 kernel {f_ms:.4f} ms, plain {f_plain:.4f} ms, "
                  f"F.grid_sample {f_lib:.4f} ms, bound {f_bound:.4f} ms ({f_by}; "
                  f"{f_bytes / 1e6:.1f} MB); bf16 payload kernel {bf_ms:.4f} ms on {card}")
            # backward: the transpose, against its plain version and grid_sample's backward
            cot = torch.randn((N, R, S, C), device=dev)
            k = ps.windowed_sample_transpose(grid, cot, planes.shape)
            p = ps.windowed_sample_transpose_reference(grid, cot, planes.shape)
            m = ps.windowed_sample_transpose_reference(grid, cot.abs(), planes.shape)
            e = (k - p).abs()
            bad = int((e > 1e-5 * m + 1e-7).sum())
            print(f"[8] B3 transpose {label} S={S}: max|k-p| {e.max().item():.3e} mean "
                  f"{e.mean().item():.3e}; tolerance |k-p| <= 1e-5·Σw|cot| + 1e-7 (float32 "
                  f"atomics in no fixed order), violations {bad}")
            if bad or not torch.isfinite(k).all():
                fail("the B3 transpose disagrees with its plain version")
            cot_nchw = cot.permute(0, 3, 1, 2).contiguous()
            b_ms = device_ms(lambda: ps.windowed_sample_transpose(grid, cot, planes.shape),
                             "transpose_kernel(")
            b_plain = device_ms(lambda: ps.windowed_sample_transpose_reference(grid, cot,
                                                                            planes.shape))
            b_lib = device_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
                cot_nchw, planes_nchw, grid, 0, 0, False, [True, False]))
            b_bytes = grid.numel() * 4 + cot.numel() * 4 + planes.numel() * 4
            b_bound, b_by = bound(b_bytes, n_pts * 4 * C * 2)
            print(f"[8] B3 transpose {label} kernel {b_ms:.4f} ms, plain {b_plain:.4f} ms, "
                  f"grid_sample backward {b_lib:.4f} ms, bound {b_bound:.4f} ms ({b_by}; "
                  f"{b_bytes / 1e6:.1f} MB) on {card}")
            if label == "coarse":  # the JSON record holds the S=40 pass
                records = [
                    dict(name="plane_sample", route="cuda",
                         source="invertavatar_torch/csrc/plane_sample.cu",
                         replaces="invertavatar_tpu/ops/pallas_plane_sample.py:39",
                         max_abs_err=errs[torch.float32], ms=f_ms, plain_ms=f_plain,
                         bound_ms=f_bound, bound_by=f_by, library_ms=f_lib),
                    dict(name="plane_sample_transpose", route="cuda",
                         source="invertavatar_torch/csrc/plane_sample.cu",
                         replaces="invertavatar_tpu/ops/plane_sample.py:170",
                         max_abs_err=e.max().item(), ms=b_ms, plain_ms=b_plain,
                         bound_ms=b_bound, bound_by=b_by, library_ms=b_lib)]
    del calls, tex, static, ws, planes_nc

    # ---------------------------------------------------------------- phase 9
    from invertavatar_torch.flagship import init_flagship

    small_rk = {"superresolution_module": "x.SuperresolutionHybrid2X",
                "c_gen_conditioning_zero": False, "c_scale": 1.0,
                "superresolution_noise_mode": "none", "decoder_lr_mul": 1.0,
                "sr_antialias": True, "depth_resolution": 6, "depth_resolution_importance": 6,
                "box_warp": 1.0}
    small = dict(z_dim=32, c_dim=25, w_dim=512, img_resolution=128, img_channels=3,
                 rendering_kwargs=small_rk, neural_rendering_resolution=32, channel_base=1024,
                 channel_max=64, map_num_layers=2)
    from invertavatar_torch.models.encoders import InversionNet

    torch.manual_seed(1)
    net_cpu = InversionNet(small, trunk_layers_n=8)
    init_flagship(net_cpu.generator, seed=1)
    net_gpu = InversionNet(small, trunk_layers_n=8).to(dev)
    net_gpu.load_state_dict(net_cpu.state_dict())
    wd_init = LatentCodesDiscriminator().state_dict()
    results = []
    for n, d in ((net_gpu, dev), (net_cpu, torch.device("cpu"))):
        st, wst = states(n)
        wst.module.load_state_dict(wd_init)
        step = make_e4e_grad_programs(n, l1, None, weights, fast_igen_target="exact",
                                      fast_grad="pallas")
        aux = step(st, wst, batch_on(d, 32, 256, seed=1), do_wd_reg=True)
        grads = {k: p.grad.detach().cpu() for k, p in n.named_parameters()
                 if p.grad is not None and k.startswith("encoder.")}
        results.append(({k: float(v) for k, v in aux.items()}, grads))
    (aux_g, grad_g), (aux_c, grad_c) = results
    # float32 sums in other orders (cuDNN, the transpose's atomics) on both
    # renders and ~40 layers of backward: losses to 1e-3 relative (+1e-7 for
    # raw_l1, itself ~1e-7), gradients to 1e-4 of the encoder gradient's
    # largest entry (the L1 terms of nearly equal renders have gradients whose
    # signs are float32 noise, so a tensor's own scale is no yardstick)
    bad = [k for k in aux_c if not abs(aux_g[k] - aux_c[k]) <= 1e-3 * abs(aux_c[k]) + 1e-7]
    for k in sorted(aux_c):
        print(f"[9] small e4e step {k}: card {aux_g[k]:.7g} CPU {aux_c[k]:.7g}")
    if sorted(aux_g) != sorted(aux_c) or bad:
        fail(f"the small e4e step on the card disagrees with the CPU on {bad}")
    scale = max(g.abs().max().item() for g in grad_c.values())
    worst = {k: (grad_g[k] - grad_c[k]).abs().max().item() / scale for k in grad_c}
    for k in sorted(worst, key=worst.get)[-5:]:
        print(f"[9]   grad {k}: max|card-cpu| = {worst[k]:.3e} of the largest encoder gradient "
              f"entry {scale:.3e} (< 1e-4)")
    if sorted(grad_g) != sorted(grad_c) or not max(worst.values()) < 1e-4:
        fail("the small e4e step's encoder gradients differ between card and CPU")
    del net_cpu, net_gpu, results

    # --------------------------------------------------------------- phase 10
    state, wd_state = states(net)
    step = make_e4e_grad_programs(net, l1, None, weights, fast_igen_target="exact",
                                  fast_grad="pallas")
    gen0 = [p.detach().clone() for p in net.generator.parameters()]
    enc0 = [p.detach().clone() for p in net.encoder.parameters()]
    wd0 = [p.detach().clone() for p in wd_state.module.parameters()]
    step_idx = 0
    for _ in range(N_E4E_WARMUP):
        step(state, wd_state, batch, do_wd_reg=step_idx % 16 == 0)
        step_idx += 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ps.sample_planes_windowed.launches = 0
    ps.windowed_sample_transpose.launches = 0
    t0 = time.perf_counter()
    auxes = []
    for _ in range(N_E4E_STEPS):
        auxes.append(step(state, wd_state, batch, do_wd_reg=step_idx % 16 == 0))
        step_idx += 1
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"plane_sample": ps.sample_planes_windowed.launches,
                "plane_sample_transpose": ps.windowed_sample_transpose.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = dt / N_E4E_STEPS * 1e3
    print(f"[10] e4e step (B=1, 512², float32 flagship generator, IR-SE-50 encoder, "
          f"Igen target on B3 fp32, students on B3 + transpose): {N_E4E_STEPS} steps after "
          f"{N_E4E_WARMUP} warm-up, {ms:.3f} ms/step (host clock); peak memory "
          f"{peak:.3f} GiB on {card}; launches {launches}")
    for i, aux in enumerate(auxes):
        vals = {k: float(v) for k, v in aux.items()}
        print(f"[10]   step {N_E4E_WARMUP + i}: " + " ".join(f"{k}={v:.6g}" for k, v in vals.items()))
        if not all(np.isfinite(v) for v in vals.values()):
            fail("an e4e step gave a non-finite loss")
    moved = {
        "encoder": max((a - p).abs().max().item() for a, p in zip(enc0, net.encoder.parameters())),
        "generator": max((a - p).abs().max().item()
                         for a, p in zip(gen0, net.generator.parameters())),
        "latent discriminator": max((a - p).abs().max().item()
                                    for a, p in zip(wd0, wd_state.module.parameters())),
    }
    print(f"[10] largest parameter change over {N_E4E_WARMUP + N_E4E_STEPS} steps: {moved}")
    if not (moved["encoder"] > 0 and moved["generator"] == 0 and moved["latent discriminator"] > 0):
        fail("the encoder and the latent discriminator must move and the generator must not")
    expect = {"plane_sample": B3_PER_STEP * N_E4E_STEPS,
              "plane_sample_transpose": B3T_PER_STEP * N_E4E_STEPS}
    if launches != expect:
        fail(f"B3 launches {launches} in {N_E4E_STEPS} e4e steps, expected {expect}")
    for r in records:
        r["launches"] = launches[r["name"]]
    return records


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA device",
              file=sys.stderr)
        return 2
    try:
        from invertavatar_torch.flagship import (FLAGSHIP_RENDERING_KWARGS, example_inputs,
                                                 flagship_generator, init_flagship)
        from invertavatar_torch.models.triplane import OSGDecoder, TriPlaneGenerator
        from invertavatar_torch.ops import fused_render as fr
        from invertavatar_torch.ops import plane_sample as ps
        from invertavatar_torch.render import renderer as rmod
        from invertavatar_torch.utils import cuda_build
    except ImportError as e:
        print(f"chip_smoke: the invertavatar_torch package is not importable here ({e})",
              file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    # ---------------------------------------------------------------- phase 1
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__} (CUDA {torch.version.cuda}); "
          f"device count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1] torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # ---------------------------------------------------------------- phase 2
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(CU_SOURCES)) as pool:  # one nvcc per source, all at once
        list(pool.map(cuda_build.build, CU_SOURCES))
    print(f"[2] built {', '.join(f'csrc/{n}.cu' for n in CU_SOURCES)} in parallel in "
          f"{time.perf_counter() - t0:.2f} s")
    cuda_build.load("fused_render")
    print_build("[2]", "fused_render")

    # ------------------------------------------------------------- phases 3-4
    rk = dict(FLAGSHIP_RENDERING_KWARGS)
    rk.pop("ray_start")
    rk.pop("ray_end")
    z_np, c_np, uvc_np = example_inputs(1)
    gen = torch.Generator(device=dev).manual_seed(0)
    planes = torch.randn((1, 3, 32, 256, 256), generator=gen, device=dev)
    torch.manual_seed(0)
    kernels = render_kernel_checks(torch, fr, rmod, card, "flagship", c_np, planes,
                                   OSGDecoder(32, decoder_output_dim=32).to(dev), rk, 128,
                                   timed=True)
    render_kernel_checks(torch, fr, rmod, card, "C=8 HID=16 tile (16, 2)", c_np,
                         torch.randn((1, 3, 8, 64, 64), generator=gen, device=dev),
                         OSGDecoder(8, hidden_dim=16, decoder_output_dim=8).to(dev),
                         dict(rk, depth_resolution=8, depth_resolution_importance=8,
                              tile_shape=(16, 2)), 32)
    del planes

    # ---------------------------------------------------------------- phase 5
    small_rk = dict(FLAGSHIP_RENDERING_KWARGS, depth_resolution=12,
                    depth_resolution_importance=12, tile_shape=(16, 4))
    small = dict(z_dim=32, c_dim=25, w_dim=512, img_resolution=512, img_channels=3,
                 sr_num_fp16_res=0, rendering_kwargs=small_rk, neural_rendering_resolution=32,
                 channel_base=2048, channel_max=128, num_fp16_res=0, map_num_layers=2)
    torch.manual_seed(1)
    g_cpu = init_flagship(TriPlaneGenerator(**small).eval(), seed=1)
    g_gpu = TriPlaneGenerator(**small).eval().to(dev)
    g_gpu.load_state_dict(g_cpu.state_dict())
    outs = []
    for g, d in ((g_gpu, dev), (g_cpu, torch.device("cpu"))):
        with torch.inference_mode():
            ws = g.mapping(torch.from_numpy(z_np[:, :32]).to(d), torch.from_numpy(c_np).to(d))
            o = g.synthesis(ws, torch.from_numpy(c_np).to(d),
                            {"uvcoords_image": torch.from_numpy(uvc_np).to(d)},
                            noise_mode="const", evaluation=True)
        outs.append({k: v.float().cpu() for k, v in o.items()})
    for key, max_tol, mean_tol in (("image_raw", 5e-2, 5e-3), ("image_depth", 5e-2, 5e-3),
                                   ("image", 1e-1, 1e-2)):
        e = (outs[0][key] - outs[1][key]).abs()
        print(f"[5] small frame, card vs CPU plain versions: {key} max {e.max().item():.3e} "
              f"(< {max_tol}) mean {e.mean().item():.3e} (< {mean_tol})")
        if not (torch.isfinite(outs[0][key]).all() and e.max() < max_tol and e.mean() < mean_tol):
            fail(f"small-config frame on the card disagrees with the CPU on {key}")
    del g_cpu, g_gpu

    # ---------------------------------------------------------------- phase 6
    t0 = time.perf_counter()
    G = init_flagship(flagship_generator(device="cuda"), seed=0)
    z, c, uvc = (torch.from_numpy(a).to(dev) for a in (z_np, c_np, uvc_np))
    mesh = {"uvcoords_image": uvc}
    with torch.inference_mode():
        ws = G.mapping(z, c)
        tex = G.texture_backbone.synthesis(ws, return_list=True, noise_mode="const")
        static = G.backbone.synthesis(ws, return_list=True, noise_mode="const")
        cache = G.precompute_raster_static(static)
        tex_cat = G.precompute_texture_concat(tex)
        torch.cuda.synchronize()
        print(f"[6] flagship generator built, weights filled, avatar precomputed in "
              f"{time.perf_counter() - t0:.2f} s")

        def frame():
            return G.synthesis_withTexture(ws, tex, c, mesh, static_feats=static,
                                           noise_mode="const", evaluation=True,
                                           raster_static_cache=cache,
                                           texture_concat_cache=tex_cat)["image"]

        for _ in range(N_WARMUP):
            img = frame()
        torch.cuda.synchronize()
        fr.fused_render.launches = 0
        fr.fused_merged_march.launches = 0
        t0 = time.perf_counter()
        for _ in range(N_FRAMES):
            img = frame()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {"fused_render": fr.fused_render.launches,
                    "fused_merged_march": fr.fused_merged_march.launches}
    if tuple(img.shape) != (1, 3, 512, 512):
        fail(f"frame shape {tuple(img.shape)} != (1, 3, 512, 512)")
    if not torch.isfinite(img).all():
        fail("frame has non-finite values")
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] != N_FRAMES:
            fail(f"{k['name']} launched {k['launches']} times in {N_FRAMES} frames")
    ms = dt / N_FRAMES * 1e3
    print(f"[6] frame loop: {N_FRAMES} frames of [1,3,512,512], {ms:.3f} ms/frame, "
          f"{1e3 / ms:.3f} frames/s (host clock, B=1) on {card}; launches {launches}; "
          f"image mean {img.float().mean().item():.4f} std {img.float().std().item():.4f}")

    del G, static, tex, cache, tex_cat
    torch.cuda.empty_cache()

    kernels += e4e_phases(torch, dev, card, ps, rmod)

    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{key: k[key] for key in order} for k in kernels]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
