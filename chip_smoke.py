#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`invertavatar_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--earlier-src PATH ...]

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
     through the renderer), with `F.grid_sample`'s forward (on float32 and on
     bf16 planes) and backward timed as the library yardstick, the
     transpose's zero fill beside it, and the channels-last copy of the
     planes; the transpose also at the worst contention (every coarse point
     on one 2x2 texel patch). With `--earlier-src PATH` (repeatable), both
     kernels of another `plane_sample.cu` (an earlier commit's, say, written
     under build/) are built by nvcc and checked and timed on the same
     grids, between two timings of the port's; its forward also on
     tile-major points and with streaming stores, beside a store-only kernel
     and the port's forward with every point on one texel patch
     (`b3_forward_diagnosis`, here and in 27c)
  9. a small-config e4e training step on the card against the same step on
     the CPU: losses and encoder gradients
 10. the e4e training path: the float32 flagship generator (frozen) with an
     IR-SE-50 e4e encoder and the latent discriminator, seeded random
     weights, B=1 synthetic 512² batches, `make_e4e_grad_programs` with the
     Igen target on B3 (fp32) and the student renders on B3 + its transpose;
     warm-up and timed steps; B3 must launch 6 times and its transpose 4
     times per step
 11. online driving: the synthetic FaceVerse manager at the v3 mesh size
     (29,929 vertices, 59,168 faces); one `make_driven_rendering` on the card
     against the CPU, the driving signal's device time, then the flagship
     online loop (coefficients -> raster -> `synthesis_withTexture`, 512²,
     B=1); B1 and B2 must launch once per frame
 12. few-shot, small config: a tiny-trunk GRU `InversionNet` (float32 and
     bf16 U-Nets) absorbs two chunks of T=2 (the second with carried
     states) on the card and on the CPU; features and GRU states compared
 13. few-shot, full width: the flagship eval generator with IR-SE-50 GRU
     U-Nets in bf16 (`fewshot_inversion_net`) encodes and absorbs two chunks
     of T=4 of seeded 512² frames (the first with the e4e render caches),
     timed over repetitions with the peak memory; B1 and B2 must launch 4
     times each per chunk; then 20 online frames drive the absorbed avatar
 14. one-shot, small config: a tiny-e4e-trunk `InversionNet` with the
     full-width SegFormer U-Nets (float32) inverts one frame
     (`cli/eval_os.invert_source`) and drives it 5 frames on the card and on
     the CPU; features and frames compared
 15. one-shot, full width: the flagship eval generator with an IR-SE-50 e4e
     encoder and the SegFormer U-Nets (`oneshot_inversion_net`) inverts one
     seeded 512² frame, timed over repetitions with the peak memory; B1 and
     B2 must launch twice per inversion (the prefix and the final render);
     then 20 online frames drive the inverted avatar (once per frame)
 16. a tiny GAN step (the JAX dry run's models) on the card against the CPU:
     Gmain and Dmain with R1, every draw the two would make differently
     removed; losses and both networks' gradients, and the density TV at
     shared points
 17. GAN training at flagship width through `train_gan`: the generator
     (channel_base 32768, channel_max 512, neural rendering 64², 48+48
     samples) against the dual discriminator at 512² (6 channels, bf16 top
     4 resolutions), batch 4, 6 steps (step 0 with both lazy
     regularisations, step 4 with the density TV, the rest with neither),
     then 2 warm steps with both; ms/step and the peak memory; losses,
     parameters and the EMA finite; no B1/B2 launch (training renders are
     not evaluation renders)
 18. a small one-shot training step (the tests' tiny widths rendering 256²,
     full-width SegFormer U-Nets, a dual discriminator at 256² with adv on):
     Ireal, Dreal with R1, Igen and Dgen, each from the same weights, under
     `fast_igen_target="exact"` with the student render on B3 and its
     transpose (`fast_grad="pallas"`) on the card, against the same phases
     through `F.grid_sample` (`"structured"`) on the card and against the
     CPU, on seed 28; losses and the trained network's gradients
 19. one-shot training at flagship width through `train_oneshot`: the
     float32 flagship generator (48+48 samples) and IR-SE-50 e4e encoder,
     frozen, two float32 SegFormer U-Nets, the dual discriminator at 512²,
     batch 2, 512², 8 steps (0-3 cover the schedule, R1 at step 0; 4-7
     timed); per phase ms and B3 / transpose launches against the counts
     from the code, the peak memory; only the scheduled U-Net moves in each
     step, D moves, the generator and the encoder never do
 20. a small few-shot training step (phase 18's tiny generator, a tiny-trunk
     ConvGRU `InversionNet`, a dual discriminator at 256², adv on) on a
     4-frame clip in chunks of 2 (one carried GRU state): Ireal (tri-plane
     decoder), Igen (texture decoder) and D without and with R1, each from
     the same weights, on seed 28; the no-grad renders on B1/B2 (`"fused"`), the
     grad-carrying render on B3 and its transpose (`"pallas"`) or on
     `F.grid_sample` (`"structured"`) on the card, against the CPU's plain
     versions; losses, the trained module's gradients, and every phase's
     launches against the counts from the code
 21. few-shot training at flagship width through `train_fewshot`: the
     float32 flagship generator (48+48 samples) and IR-SE-50 e4e encoder,
     frozen, two float32 IR-SE-50 ConvGRU U-Nets, the dual discriminator at
     512², LPIPS (AlexNet, seeded weights), batch 1, seeded 512² clips of
     18 frames, 6 steps: the curriculum T = 6, 12, 12, 18, 18, then T = 6
     again, in chunks of 6, each step Ireal, Igen and D (R1 at step 0), the
     no-grad renders fused (B1/B2), the grad-carrying ones on B3 and its
     transpose; B1/B2 and B3/transpose first checked and timed at this
     path's shapes (one no-grad e4e render, one student render); per phase
     and per T ms from the steps whose T ran before (2, 4, 5),
     the launches of each phase against the counts from the code, the peak
     memory; only the scheduled decoder moves in each step, D moves, the
     trunks, the generator and the encoder never do
 22. dataset preparation (`data/preprocess.py`) on the card at the FaceVerse
     v3 mesh size (`synthetic_manager(n_grid=173)`: 59,168 faces) for 16
     seeded coefficient frames and 512² frames: the uvcoords `.npy` files
     (`render_uvcoords_for_video`), the UV raster once (`build_uv_raster`),
     then per frame `uv_pverts_map` (saved as fp16 `.npy`) and
     `uv_gttex_image` (kept as tensors: the card's machine has no PIL), all
     in a temporary directory; ms per frame; the card against the CPU
     within the driving-signal band (1e-4 on >= 99.9% of face pixels, 1e-3
     on all; the textures within one level)
 23. metrics through the GAN trainer: phase 17's models with the GAN CLI's
     rendering kwargs (64² render, 48+48 samples, `pallas_coarse`), a seeded
     metric dataset of 64 items at 512² and a seeded stand-in detector (not
     Inception); `train_gan(max_steps=2, metric_names=("fid64",))`: the
     snapshot's `metric-fid64.jsonl` and its `Metrics/fid64` in
     `stats.jsonl`, finite and positive, B1 launched twice per generated
     image (coarse, fine; B2 not at all: the CLI's `det_stratified=False`
     keeps the merged march off); on the metric's own features FID real vs
     real = 0 (1e-6), KID, precision/recall and IS; PPL over 8 samples with
     LPIPS VGG on seeded weights; B1 checked and timed at the sampler's
     shapes, and B1 (raw) and B2 on its planes and 64² rays with the 48+48
     merged list (`det_stratified` on)
 24. the W+ projector (`project_w_plus`): the frozen float32 flagship
     generator at B=1, 512², the render's gradient through B3 and its
     transpose (`pallas_grad`), LPIPS VGG features on seeded weights, the
     target its own render of a seeded W+ code (a mapped z plus N(0, 0.1²)
     per layer), 30 steps with w statistics over
     1000 samples: the feature distance at least halves, B3 and the
     transpose launch twice per step, both checked and timed (with their
     plain versions and `F.grid_sample`) at this path's shapes; s/step and
     the peak memory
 25. data parallelism on the one card, each comparison beside the card's
     own repeat of the run without a mesh (the card does not repeat a
     training step bit for bit): a result passes within a fixed bar or
     twice the repeat's difference. 25a, over an NCCL mesh of world size 1
     in this process: the first flagship GAN step (phase 17's models with D
     in float32, batch 4, both regularisations) against no mesh: losses to
     1e-4 relative,
     gradients to 1e-3 of each network's largest entry, `w_avg` (bitwise
     where the card repeats bitwise); the step time of phase 17's path with
     and without the mesh in turns; `train_gan` over the mesh, 2 steps. 25b,
     on 2 spawned
     gloo ranks sharing the card against one process at the global batch:
     the first GAN step (as 25a) and `train_gan` (2 steps); the one-shot
     path at flagship width (phase 19's models with D in float32, batch 2, 2
     steps, B3 + transpose) and the few-shot path at phase 20's small width (2 clips of
     4 frames, 2 steps, all four kernels): losses to 1e-4 relative,
     parameters within Adam's first-step bound; the replicas bitwise equal
     at every snapshot; each rank's launches against the counts from the
     code, and one launch of each of its kernels against the plain version;
     s/step and peak memory per rank; and two negative cases that must raise
     on every rank: `Collector.sync` with the same count of names and other
     names, and `check_replica_consistency` on a replica with two swapped
     entries (the same sums)
 26. the rest of the generator, the sinks and the legacy modules. 26a:
     `synthesis_withCondition` at flagship width (B=1, 40+24 samples) with
     seeded nonzero CS-SFT (scale, shift) at every resolution of both
     backbones: B1 and B2 held against their plain versions on the call's
     own inputs and timed, the kernel route against the exact route
     (`pallas_exact`) within phase 5's bands, no conditions against
     `synthesis`, phase 5's small configuration with conditions on the card
     against the CPU; ms per call; B1 and B2 once per call. 26b:
     `remat_stages` off, on and off again from the same weights and draws on
     phase 10's e4e step and on phase 19's one-shot Ireal phase (batch 2):
     losses (relative, or absolute below 1e-3) and gradients on against off
     within a fixed bar or twice the card's own repeat, the launches against the counts from the code (each
     grad-carrying B3 forward runs again in the recompute), peak memory and
     ms/step. 26c: `SG3Generator` at NVlabs stylegan3-t FFHQ-1024 (1024²,
     channel_base 32768, channel_max 512, 14 layers, 2 mapping layers),
     seeded, B=1: finite, timed; the tests' 32² configuration on the card
     against the CPU to 1e-4. 26d: DeepLabV3+ on ResNet-50 at 512², the MoCo
     loss at 224², the CX loss on a 512² pair, `VideoDiscriminator` and
     `FusionVideoDiscriminator` at 512² (2 videos of T=2): finite, timed,
     and each at a small size on the card against the CPU to 1e-4. 26e:
     whether `torch.utils.tensorboard` imports; one `train_gan` tick of
     phase 16's tiny models, whose event file (with the sink) holds the
     means of its `stats.jsonl`
 27. the style-U-Nets and the Next3D generators. 27a: the seven style-U-Net
     configurations (`CondSynthesisNetworkWithGRU`, `CondSynthesisNetwork`
     plain and `residual_arch`, `_New`, `_WithConvFusion`, `_SFT`,
     `PlainSynthesisNetwork`) at the tests' widths on the card against the
     CPU to 1e-4, then at the widths the classes default to (channel_base
     32768, channel_max 512, a 3-channel condition at 64², 32 output
     channels at 256², B=1, T=4; `_New` reads its condition at 256², as its
     pyramid needs): finite, ms per call and peak memory; no kernel. 27b:
     the Next3D generator at the smoke tests' geometry on a 24 x 32 sphere,
     on the exact, `pallas_exact` (B3 float32) and `pallas_coarse` (B3
     bf16) routes, on the card against the CPU within phase 5's bands, the
     kernel routes against the exact route, and B3 (both payloads) against
     its plain version at those shapes. 27c: Next3D at full width (z 512,
     channel_base 32768, channel_max 512, 256² backbones in float32, 128²
     render, 48+48 samples, `det_stratified`, `pallas_coarse`, SR 8XDC with
     bf16 blocks, 512²) over a sphere of FLAME's size (5,096 vertices,
     9,984 faces, 68 landmarks; every 32² tile's candidate faces under the
     cap of 1024): B3 held against its plain version and timed with its
     bound and `F.grid_sample` at the frame's own shapes for both payloads,
     the kernel routes against the exact route within phase 5's bands, warm
     frames timed with the peak memory, B3 once per frame and B1/B2 never;
     then one `LegacyTriPlaneGenerator` at the same width: finite, timed
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
from functools import partial
from pathlib import Path

T_START = time.perf_counter()
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
N_ONLINE = 20  # timed online-driving frames (phases 11, 13)
FEWSHOT_T = 4  # source frames per absorb chunk (phase 13)
N_ABSORB_REPS = 3  # timed absorbs of 2 chunks (phase 13)
N_ONESHOT_SMALL = 5  # driven frames of the small one-shot avatar, card vs CPU (phase 14)
N_ONESHOT_REPS = 3  # timed one-shot inversions (phase 15)
GAN_BATCH = 4  # the reference's per-GPU batch (32 over 8 GPUs)
ONESHOT_BATCH = 2  # the reference's one-shot per-GPU batch (16 over 8 GPUs)
N_ONESHOT_TRAIN = 8  # flagship one-shot steps (phase 19): 0-3 cover the schedule, R1 at 0
N_ONESHOT_TIMED_FROM = 4  # steps 4-7 are the timed ones
# phase 18's seeds: every phase and route runs on each, Dreal with R1 on
# both; seed 28 has come nearest the bar (Ireal's gradient 5.3e-4 of 1e-3
# on an H100), so it stays and seed 18 went to make room for phase 27
SMALL_ONESHOT_SEEDS = (28,)
# phase 20's seeds: seed 18 ran D with R1 and seed 28 without; seed 28 now
# runs D both ways (one more D phase in place of a second seed's three)
SMALL_FEWSHOT_SEEDS = (28,)
FEWSHOT_TRAIN_BATCH = 1  # the reference's few-shot per-GPU batch (8 over 8 GPUs)
FEWSHOT_CURRICULUM = (6, 12, 18)  # clip lengths of the few-shot schedule (phase 21)
FEWSHOT_TC = 6  # frames per chunk
FEWSHOT_TRAIN_T = 18  # frames per clip: the curriculum's longest
N_FEWSHOT_TRAIN = 6  # flagship few-shot steps: the curriculum once, then T = 6 again;
# a step is timed when its T has run before (steps 2, 4, 5)
N_PREP_FRAMES = 16  # seeded frames through dataset preparation (phase 22)
N_METRIC_ITEMS = 64  # fid64's real and generated images (phase 23)
N_METRIC_GAN_STEPS = 2  # train_gan steps before the metric snapshot (phase 23)
N_PPL_SAMPLES = 8  # PPL samples (phase 23)
N_PROJ_STEPS = 30  # project_w_plus steps (phase 24)
N_PROJ_W_AVG = 1000  # its w statistics' samples
PROJ_LR = 0.01  # its initial learning rate: 30 steps reach a W+ offset of ~0.1
PROJ_W_OFFSET = 0.1  # the target's W+ code: a mapped z plus N(0, PROJ_W_OFFSET²)
N_GAN_STEPS = 6  # flagship GAN steps (phase 17): step 0 runs both regularisations,
# step 4 the density TV, the others neither
N_GAN_REG_TIMED = 2  # warm steps with both regularisations, timed after the run
DP_RANKS = 2  # phase 25b's gloo ranks, all on card 0
DP_GAN_STEPS = 2  # phase 25's train_gan steps: step 0 with both regularisations
DP_ONESHOT_STEPS = 2  # phase 25b's one-shot steps: Ireal + Dreal (R1 at step 0)
DP_FEWSHOT_CURRICULUM = (2, 4, 4)  # phase 25b's few-shot clip lengths, chunks of 2
DP_FEWSHOT_STEPS = 2  # T = 2 then 4; R1 at step 0
DP_TIMEOUT_S = 600  # each collective's bound in phase 25
N_COND_WARMUP, N_COND_TIMED = 3, 10  # synthesis_withCondition calls (phase 26a)
N_REMAT_TIMED = 2  # timed steps of each remat_stages setting (phase 26b)
N_MODULE_WARMUP, N_MODULE_TIMED = 2, 5  # calls of each module of phases 26c-26d
# phase 5's small configuration (phase 26a holds it on the card against the CPU)
SMALL_FRAME_RK = dict(depth_resolution=12, depth_resolution_importance=12, tile_shape=(16, 4))
SMALL_FRAME_CFG = dict(z_dim=32, c_dim=25, w_dim=512, img_resolution=512, img_channels=3,
                       sr_num_fp16_res=0, neural_rendering_resolution=32, channel_base=2048,
                       channel_max=128, num_fp16_res=0, map_num_layers=2)
# phase 5's bands, (max, mean) of |a - b|
FRAME_BANDS = (("image_raw", 5e-2, 5e-3), ("image_depth", 5e-2, 5e-3), ("image", 1e-1, 1e-2))
# NVlabs stylegan3 `train.py --cfg=stylegan3-t` for FFHQ-1024 (the JAX defaults)
SG3_T_1024 = dict(z_dim=512, c_dim=0, w_dim=512, img_resolution=1024, img_channels=3,
                  channel_base=32768, channel_max=512, num_layers=14, map_num_layers=2)
SG3_SMALL = dict(z_dim=16, c_dim=0, w_dim=32, img_resolution=32, img_channels=3, num_layers=6,
                 channel_base=1024, channel_max=32)
VIDEO_SMALL = dict(c_dim=25, img_resolution=32, img_channels=3, channel_base=1024,
                   channel_max=64, num_fp16_res=0)
# phase 26d's full sizes: DeepLabV3+ input, MoCo input, the CX pair, the
# video discriminators' frames
DEEPLAB_RES, MOCO_RES, CX_RES, VIDEO_RES = 512, 224, 512, 512

# phase 27a: the tests' tiny style-U-Net widths, and the widths the classes
# default to with a 3-channel condition at 64², 32 output channels at 256²,
# B=1 and T=4 (the absorb's chunk) for the clip variants
STYLEUNET_SMALL = dict(img_resolution=64, img_channels=8, cond_channels=3, in_size=16,
                       final_size=4, channel_base=512, channel_max=64, num_cond_res=16)
STYLEUNET_FULL = dict(img_resolution=256, img_channels=32, cond_channels=3, in_size=64,
                      final_size=4, channel_base=32768, channel_max=512, num_cond_res=64)
STYLEUNET_T = 4
# phase 27b: the Next3D smoke tests' geometry (tests/test_next3d.py) on their
# 24 x 32 sphere; 27c: Next3D at full width on a sphere of FLAME's size
N3D_SMALL = dict(z_dim=32, c_dim=25, w_dim=512, img_resolution=128, img_channels=3,
                 neural_rendering_resolution=32, channel_base=512, channel_max=64,
                 num_fp16_res=0, map_num_layers=2, faces_per_tile=512)
N3D_SMALL_RK = {"image_resolution": 128, "superresolution_module": "x.SuperresolutionHybrid2X",
                "c_gen_conditioning_zero": False, "c_scale": 1.0,
                "superresolution_noise_mode": "const", "density_reg": 0.25,
                "decoder_lr_mul": 1.0, "sr_antialias": True, "depth_resolution": 6,
                "depth_resolution_importance": 6, "ray_start": 2.25, "ray_end": 3.3,
                "box_warp": 1.0, "det_stratified": True}
N3D_SMALL_SPHERE = (24, 32)
N3D_FULL = dict(z_dim=512, c_dim=25, w_dim=512, img_resolution=512, img_channels=3,
                channel_base=32768, channel_max=512, num_fp16_res=0, sr_num_fp16_res=4,
                map_num_layers=2, neural_rendering_resolution=128, faces_per_tile=1024)
N3D_FULL_RK = dict(N3D_SMALL_RK, image_resolution=512,
                   superresolution_module="x.SuperresolutionHybrid8XDC",
                   superresolution_noise_mode="none", depth_resolution=48,
                   depth_resolution_importance=48, pallas_coarse=True)
N3D_FULL_SPHERE = (49, 104)  # 5,096 vertices, 9,984 faces (FLAME: 5,023 and 9,976)
N3D_FRAMES, N3D_EXACT_FRAMES = 10, 3  # timed 27c frames on the bf16 and fp32 B3 routes

# H100 SXM published peaks (dense): fp32 outside the tensor cores, TF32 on
# the tensor cores, HBM3 rate
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12


PHASE_MARKS = [("1-2", T_START)]


def mark(label):
    """Start the wall-clock span of the phases `label` (ends at the next mark)."""
    PHASE_MARKS.append((label, time.perf_counter()))


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
    on the card) is repeated when it kept fewer than a third of them; after
    `tries` such sessions CUDA events time the calls, with a note."""
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
    # the profiler lost its records in every session (seen once in phase
    # 24, late in a full run): time the calls with CUDA events, which also
    # count the device's idle time between them
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / n
    print(f"chip_smoke: note: the profiler kept {len(times)} records of {kernel or 'a call'} "
          f"in {n} calls, {tries} times; CUDA events give {ms:.4f} ms per call instead")
    return ms


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
                         timed=False, tags=("[3]", "[4]")):
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
    return fused_kernel_checks(torch, fr, card, label, b1_calls[0], b2_calls[0], timed, tags)


def fused_kernel_checks(torch, fr, card, label, b1_call, b2_call, timed=False,
                        tags=("[3]", "[4]")):
    """B1 and B2 against their plain versions on one recorded call each
    (args, kwargs, output; B2's fed B1's raw output of the same render);
    with `timed`, both are timed and their kernel records returned, else
    their names and largest differences."""
    kernels = []

    def record(name, replaces, err, ms, plain_ms, nbytes, ops, mlp, what):
        """Print the kernel's time beside both bounds (MLP on the tensor cores,
        and on the fp32 cores as before) and keep its JSON record."""
        b, by = bound(nbytes, ops, mlp)
        b_fp32, by_fp32 = bound(nbytes, ops + mlp)
        print(f"{tags[0] if name == 'fused_render' else tags[1]} {name} kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms; bound {b:.4f} ms ({by}; MLP on the TF32 tensor cores) beside "
              f"{b_fp32:.4f} ms ({by_fp32}; MLP on the fp32 cores); {nbytes / 1e6:.1f} MB, "
              f"{mlp / 1e9:.2f} GFLOP MLP + {ops / 1e9:.2f} GFLOP {what} on {card}")
        kernels.append(dict(name=name, route="cuda",
                            source="invertavatar_torch/csrc/fused_render.cu", replaces=replaces,
                            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                            library_ms=None))

    with torch.inference_mode():
        # B1
        args, kw, raw = b1_call
        pl, grid, params = args[0], args[1], args[2]
        ref = fr.fused_render_reference(*args, **kw).float()
        err = (raw.float() - ref).abs()
        tol = ref.abs() * 2.0 ** -7 + 1e-4  # one bf16 ulp of the output + fp32 reorder
        bad = int((err > tol).sum())
        C = pl.shape[-1]
        HID = params[0].shape[1]
        points = raw.shape[0] * raw.shape[1]
        print(f"{tags[0]} B1 fused_render {label}: out {tuple(raw.shape)} bf16, {points} points; "
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
        else:
            kernels.append(dict(name="fused_render", max_abs_err=err.max().item()))

        # B2, fed B1's raw output from the same render
        args, kw, out_k = b2_call
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
        print(f"{tags[1]} B2 fused_merged_march {label}: T={T} Sm={Sm} P={P}, {n_fine_pts} fine "
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
        else:
            kernels.append(dict(name="fused_merged_march", max_abs_err=worst))
    return kernels


def b3_forward_check(torch, ps, tag, label, planes, grid, out):
    """B3 with the float32 payload (the training route) and bf16 (the eval
    route) against its plain version, and `out` (B3's output recorded in a
    render) against a fresh launch; returns {dtype: max |k - p|}."""
    m = ps.sample_planes_windowed_reference(planes.abs(), grid)  # the rounding's scale Σw|v|
    errs = {}
    for dt, rel in ((torch.float32, 0.0), (torch.bfloat16, 2.0 ** -7)):
        k = ps.sample_planes_windowed(planes, grid, dt)
        p = ps.sample_planes_windowed_reference(planes, grid, dt)
        e = (k.float() - p.float()).abs()
        bad = int((e > p.float().abs() * rel + 2e-6 * m).sum())
        errs[dt] = e.max().item()
        print(f"{tag} B3 {label} {str(dt)[6:]}: max|k-p| {e.max().item():.3e} mean "
              f"{e.mean().item():.3e}; tolerance |k-p| <= {rel:.3g}|p| + 2e-6·Σw|v| "
              f"(fused multiply-adds; bf16: one ulp of the output), violations {bad}")
        if bad or not torch.isfinite(k.float()).all():
            fail(f"B3 ({dt}, {label}) disagrees with its plain version")
    if not torch.equal(out, ps.sample_planes_windowed(planes, grid, out.dtype)):
        fail(f"the recorded render's B3 output ({label}) differs from a fresh launch")
    return errs


def transpose_check(torch, ps, label, grid, cot, planes_shape, transpose=None, tag="[8]"):
    """The transpose kernel (the port's, or `transpose`) against its plain
    version; returns max |k - p|."""
    k = (transpose or ps.windowed_sample_transpose)(grid, cot, planes_shape)
    p = ps.windowed_sample_transpose_reference(grid, cot, planes_shape)
    m = ps.windowed_sample_transpose_reference(grid, cot.abs(), planes_shape)
    e = (k - p).abs()
    bad = int((e > 1e-5 * m + 1e-7).sum())
    print(f"{tag} B3 transpose {label}: max|k-p| {e.max().item():.3e} mean "
          f"{e.mean().item():.3e}; tolerance |k-p| <= 1e-5·Σw|cot| + 1e-7 (float32 "
          f"sums in no fixed order), violations {bad}")
    if bad or not torch.isfinite(k).all():
        fail(f"the B3 transpose ({label}) disagrees with its plain version")
    return e.max().item()


def earlier_kernels(torch, ps, paths):
    """{path: (transpose(grid, cot, planes_shape), forward(planes, grid, dt),
    forward with streaming stores or None)} launching the kernels of each
    earlier `plane_sample.cu` with the port's C interface, built by nvcc into
    build/; the streaming-store forward (`b3_forward_diagnosis`'s (d)) is the
    source with its forward's plain store replaced by `__stcs`, where that
    store is found."""
    import ctypes

    from invertavatar_torch.utils import cuda_build

    plain_store = "out[point * vecs + lane] = pack(acc);"
    out = {}
    for i, path in enumerate(paths):
        text = Path(path).read_text()
        libs = [ctypes.CDLL(str(cuda_build.build(f"earlier{i}_plane_sample", path)))]
        if plain_store in text:
            stcs = Path(cuda_build.BUILD_DIR) / f"earlier{i}_stcs_plane_sample.cu"
            stcs.write_text(text.replace(plain_store,
                                         "__stcs(out + point * vecs + lane, pack(acc));"))
            libs.append(ctypes.CDLL(str(cuda_build.build(f"earlier{i}_stcs_plane_sample",
                                                         stcs))))
        for lib in libs:
            for name in ("plane_sample_launch", "plane_sample_transpose_launch"):
                getattr(lib, name).argtypes = getattr(ps._lib(), name).argtypes
                getattr(lib, name).restype = ctypes.c_int

        def transpose(grid, cot, planes_shape, lib=libs[0], path=path):
            grid, cot = grid.contiguous(), cot.contiguous()
            d = torch.zeros(planes_shape, device=grid.device)
            rc = lib.plane_sample_transpose_launch(
                grid.data_ptr(), cot.data_ptr(), d.data_ptr(), *planes_shape,
                grid[0].numel() // 2, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                fail(f"the transpose of {path} did not launch: CUDA error {rc}")
            return d

        def forward(planes, grid, dt, lib=libs[0], path=path):
            planes, grid = planes.to(dt).contiguous(), grid.contiguous()
            o = torch.empty((*grid.shape[:-1], planes.shape[-1]), device=grid.device, dtype=dt)
            rc = lib.plane_sample_launch(
                planes.data_ptr(), grid.data_ptr(), o.data_ptr(), *planes.shape,
                grid[0].numel() // 2, int(dt == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                fail(f"the forward of {path} did not launch: CUDA error {rc}")
            return o

        out[path] = (transpose, forward,
                     partial(forward, lib=libs[1]) if len(libs) > 1 else None)
    return out


def time_earlier(torch, ps, card, earlier, label, grid, cot, planes_shape):
    """Check and time each earlier transpose, then the port's kernel again."""
    if not earlier:
        return
    for path, (transpose, *_) in earlier.items():
        transpose_check(torch, ps, f"{label} ({path})", grid, cot, planes_shape, transpose)
        ms = device_ms(lambda: transpose(grid, cot, planes_shape), "transpose_kernel(")
        print(f"[8] B3 transpose {label} kernel of {path}: {ms:.4f} ms on {card}")
    ms = device_ms(lambda: ps.windowed_sample_transpose(grid, cot, planes_shape),
                   "transpose_kernel(")
    print(f"[8] B3 transpose {label} kernel, again after those: {ms:.4f} ms on {card}")


def b3_forward_diagnosis(torch, ps, card, tag, label, planes, grid, dt, earlier):
    """With `--earlier-src`: what binds B3's forward on one recorded grid, by
    timing (a) each earlier forward, (b) it on the same points permuted to
    8x8-ray-tile-major order (stratum-major within a tile; its output
    permuted back and compared), (c) a store-only kernel writing the same
    output bytes (`zero_`), (d) the earlier forward with streaming stores;
    then (e) the port's forward with every point on one 2x2 texel patch (its
    taps hit the L1), and the port's again."""
    if not earlier:
        return
    name = str(dt)[6:]
    own = ps.sample_planes_windowed(planes, grid, dt)

    def timed(fn):
        return device_ms(fn, "sample_kernel<")

    def same(o, what):
        e = (o.float() - own.float()).abs().max().item()
        print(f"{tag} B3 {label} {name}: {what} against the port's forward: max diff {e:.3e}, "
              f"bit-equal {torch.equal(o, own)}")
        return e

    rows = [("port's forward", timed(lambda: ps.sample_planes_windowed(planes, grid, dt)))]
    N, C = planes.shape[0], planes.shape[-1]
    res = round(grid.shape[1] ** 0.5) if grid.ndim == 4 else 0
    res = res if res * res == grid.shape[1] and res % 8 == 0 else 0
    for path, (_, forward, forward_cs) in earlier.items():
        same(forward(planes, grid, dt), f"(a) the forward of {path}")
        rows.append((f"(a) {path}", timed(lambda: forward(planes, grid, dt))))
        if res:
            S, t = grid.shape[2], res // 8
            g_t = grid.reshape(N, t, 8, t, 8, S, 2).permute(0, 1, 3, 5, 2, 4, 6).reshape(N, -1, 2)
            g_t = g_t.contiguous()
            back = forward(planes, g_t, dt).reshape(N, t, t, S, 8, 8, C).permute(
                0, 1, 4, 2, 5, 3, 6).reshape(own.shape)
            same(back, f"(b) the forward of {path} on tile-major points, permuted back")
            rows.append((f"(b) {path}, tile-major points", timed(lambda: forward(planes, g_t, dt))))
        if forward_cs is not None:
            same(forward_cs(planes, grid, dt), f"(d) the forward of {path} with __stcs")
            rows.append((f"(d) {path} with __stcs", timed(lambda: forward_cs(planes, grid, dt))))
    buf = torch.empty_like(own)
    rows.append(("(c) store-only (zero_ of the output)", device_ms(lambda: buf.zero_())))
    H = planes.shape[1]
    patch = (torch.tensor([100.5, 120.5], device=grid.device) + 0.5) / (H * 0.5) - 1.0
    g = patch + grid * 0
    rows.append(("(e) every point on one 2x2 texel patch",
                 timed(lambda: ps.sample_planes_windowed(planes, g, dt))))
    rows.append(("port's forward, again",
                 timed(lambda: ps.sample_planes_windowed(planes, grid, dt))))
    print(f"{tag} B3 {label} {name} diagnosis on {card}: " +
          "; ".join(f"{what} {ms:.4f} ms" for what, ms in rows))


def e4e_weights():
    """The e4e validation run's loss weights: train_e4e_real.yaml with LPIPS
    and ID off."""
    from invertavatar_torch.train.inversion import InversionLossWeights

    return InversionLossWeights(l1=1.0, lpips=0.0, id=0.0, w_delta=0.001, w_regular=0.0,
                                w_discriminator=0.01, raw_l1=1.0, tri=0.001)


def l1_distance(a, b):
    return (a - b).abs().mean()


def e4e_batch(torch, d, z_dim, res, seed=0):
    """A seeded B=1 e4e batch on `d`: a U(-1, 1) image, the frontal camera,
    its uvcoords and z."""
    import numpy as np

    from invertavatar_torch.flagship import example_inputs

    z_np, c_np, uvc_np = example_inputs(1, seed=seed)
    img = np.random.RandomState(seed).uniform(-1, 1, (1, 3, res, res)).astype(np.float32)
    return {"image": torch.from_numpy(img).to(d), "c": torch.from_numpy(c_np).to(d),
            "v": {"uvcoords_image": torch.from_numpy(uvc_np).to(d)},
            "z": torch.from_numpy(z_np[:, :z_dim]).to(d)}


def e4e_states(torch, net):
    """Fresh train states of the e4e encoder (masked Adam) and of a new
    latent discriminator."""
    from invertavatar_torch.models.encoders import LatentCodesDiscriminator
    from invertavatar_torch.train.loop_inversion import e4e_trainable, masked_adam
    from invertavatar_torch.train.state import TrainState

    wd = LatentCodesDiscriminator().to(next(net.parameters()).device)
    return (TrainState(net, masked_adam(net, 1e-4, e4e_trainable)),
            TrainState(wd, torch.optim.Adam(wd.parameters(), lr=2e-5)))


def e4e_phases(torch, dev, card, ps, rmod, earlier=None):
    """Phases 7-10 (`earlier`: `earlier_kernels`' kernels, or None); returns
    the kernel records of B3 and its transpose."""
    import numpy as np
    import torch.nn.functional as F

    from invertavatar_torch.flagship import flagship_inversion_net
    from invertavatar_torch.models.encoders import LatentCodesDiscriminator
    from invertavatar_torch.train.fast_render import grad_overrides
    from invertavatar_torch.train.loop_inversion import make_e4e_grad_programs
    from invertavatar_torch.utils import cuda_build

    weights = e4e_weights()
    l1 = l1_distance

    def batch_on(d, z_dim, res, seed=0):
        return e4e_batch(torch, d, z_dim, res, seed)

    def states(net):
        return e4e_states(torch, net)

    # ---------------------------------------------------------------- phase 7
    cuda_build.load("plane_sample")
    print_build("[7]", "plane_sample")

    # ---------------------------------------------------------------- phase 8
    mark("8")
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
            errs = b3_forward_check(torch, ps, "[8]", f"{label} S={S}", planes, grid, out)
            f_ms = device_ms(lambda: ps.sample_planes_windowed(planes, grid), "sample_kernel<")
            f_plain = device_ms(lambda: ps.sample_planes_windowed_reference(planes, grid))
            f_lib = device_ms(lambda: F.grid_sample(planes_nchw, grid, mode="bilinear",
                                                  padding_mode="zeros", align_corners=False))
            f_bytes = grid.numel() * 4 + planes.numel() * 4 + n_pts * C * 4
            f_bound, f_by = bound(f_bytes, n_pts * 4 * C * 2)
            print(f"[8] B3 {label} fp32 kernel {f_ms:.4f} ms, plain {f_plain:.4f} ms, "
                  f"F.grid_sample {f_lib:.4f} ms, bound {f_bound:.4f} ms ({f_by}; "
                  f"{f_bytes / 1e6:.1f} MB) on {card}")
            # the bf16 payload (the eval route): bf16 planes in, bf16 samples out
            bf_ms = device_ms(lambda: ps.sample_planes_windowed(planes, grid, torch.bfloat16),
                              "sample_kernel<")
            planes_bf, grid_bf = planes_nchw.bfloat16(), grid.bfloat16()
            bf_lib = device_ms(lambda: F.grid_sample(planes_bf, grid_bf, mode="bilinear",
                                                   padding_mode="zeros", align_corners=False))
            bf_bytes = grid.numel() * 4 + planes.numel() * 2 + n_pts * C * 2
            bf_bound, bf_by = bound(bf_bytes, n_pts * 4 * C * 2)
            print(f"[8] B3 {label} bf16 payload kernel {bf_ms:.4f} ms, F.grid_sample on bf16 "
                  f"planes {bf_lib:.4f} ms, bound {bf_bound:.4f} ms ({bf_by}; "
                  f"{bf_bytes / 1e6:.1f} MB) on {card}")
            del planes_bf, grid_bf
            for dt in (torch.float32, torch.bfloat16):
                b3_forward_diagnosis(torch, ps, card, "[8]", f"{label} S={S}", planes, grid, dt,
                                     earlier)
            # backward: the transpose, against its plain version and grid_sample's backward
            cot = torch.randn((N, R, S, C), device=dev)
            e = transpose_check(torch, ps, f"{label} S={S}", grid, cot, planes.shape)
            cot_nchw = cot.permute(0, 3, 1, 2).contiguous()
            b_ms = device_ms(lambda: ps.windowed_sample_transpose(grid, cot, planes.shape),
                             "transpose_kernel(")
            fill_ms = device_ms(lambda: torch.zeros(planes.shape, device=dev))
            b_plain = device_ms(lambda: ps.windowed_sample_transpose_reference(grid, cot,
                                                                            planes.shape))
            b_lib = device_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
                cot_nchw, planes_nchw, grid, 0, 0, False, [True, False]))
            b_bytes = grid.numel() * 4 + cot.numel() * 4 + planes.numel() * 4
            b_bound, b_by = bound(b_bytes, n_pts * 4 * C * 2)
            print(f"[8] B3 transpose {label} kernel {b_ms:.4f} ms (one kernel; the wrapper's "
                  f"zero fill {fill_ms:.4f} ms besides), plain {b_plain:.4f} ms, grid_sample "
                  f"backward {b_lib:.4f} ms (its zero fill included), bound {b_bound:.4f} ms "
                  f"({b_by}; {b_bytes / 1e6:.1f} MB) on {card}")
            time_earlier(torch, ps, card, earlier, f"{label} S={S}", grid, cot, planes.shape)
            if label == "coarse":  # the JSON record holds the S=40 pass
                # worst contention: every point of the pass on one 2x2 texel patch
                patch = (torch.tensor([100.5, 120.5], device=dev) + 0.5) / (H * 0.5) - 1.0
                grid_1 = patch + torch.rand(grid.shape, device=dev) / H
                transpose_check(torch, ps, f"one 2x2 patch S={S}", grid_1, cot, planes.shape)
                one_ms = device_ms(lambda: ps.windowed_sample_transpose(grid_1, cot,
                                                                        planes.shape),
                                   "transpose_kernel(")
                print(f"[8] B3 transpose one 2x2 patch S={S} kernel {one_ms:.4f} ms on {card}")
                time_earlier(torch, ps, card, earlier, f"one 2x2 patch S={S}", grid_1, cot,
                             planes.shape)
                del grid_1
                records = [
                    dict(name="plane_sample", route="cuda",
                         source="invertavatar_torch/csrc/plane_sample.cu",
                         replaces="invertavatar_tpu/ops/pallas_plane_sample.py:39",
                         max_abs_err=errs[torch.float32], ms=f_ms, plain_ms=f_plain,
                         bound_ms=f_bound, bound_by=f_by, library_ms=f_lib,
                         bf16_ms=bf_ms, bf16_bound_ms=bf_bound, bf16_library_ms=bf_lib),
                    dict(name="plane_sample_transpose", route="cuda",
                         source="invertavatar_torch/csrc/plane_sample.cu",
                         replaces="invertavatar_tpu/ops/plane_sample.py:170",
                         max_abs_err=e, ms=b_ms, plain_ms=b_plain,
                         bound_ms=b_bound, bound_by=b_by, library_ms=b_lib,
                         zero_fill_ms=fill_ms, one_patch_ms=one_ms)]
    del calls, tex, static, ws, planes_nc

    # ---------------------------------------------------------------- phase 9
    mark("9")
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
    mark("10")
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


def compare_driving(torch, label, got, ref, tag="[11]"):
    """Driving signals [1, 256, 256, 3] (u, v, mask) of two devices: the mask
    channel agrees on >= 99.9% of pixels, and where both hit u and v agree to
    1e-4 on >= 99.9% of pixels and to 1e-3 on all: under another evaluation
    order a pixel on a shared edge or at a depth tie may take the neighbouring
    face (the largest reading so far, 1.456e-4, was one such pixel)."""
    got, ref = got.float().cpu(), ref.float().cpu()
    agree = (got[..., 2] == ref[..., 2]).float().mean().item()
    both = (got[..., 2] == 1) & (ref[..., 2] == 1)
    d = (got[..., :2] - ref[..., :2]).abs().amax(dim=-1)[both]
    close = (d <= 1e-4).float().mean().item() if both.any() else 0.0
    err = d.max().item() if both.any() else float("inf")
    print(f"{tag} driving signal {label}: mask agrees on {agree * 100:.4f}% of pixels (>= 99.9%), "
          f"{int(both.sum())} face pixels, u and v within 1e-4 on {close * 100:.4f}% of them "
          f"(>= 99.9%), max|du|,|dv| {err:.3e} (<= 1e-3)")
    if not (agree >= 0.999 and both.sum() > 1000 and close >= 0.999 and err <= 1e-3
            and set(got[..., 2].unique().tolist()) <= {0.0, 1.0}):
        fail(f"the driving signal on the card disagrees with the CPU ({label})")


def online_frames(torch, fr, frame, coeffs, label):
    """Warm-up frames, then `N_ONLINE` timed frames of `frame(coeff)` with
    B1/B2 counted; returns (ms/frame on the host clock, launches, last image)."""
    for i in range(N_WARMUP):
        img = frame(coeffs[i])
    torch.cuda.synchronize()
    fr.fused_render.launches = fr.fused_merged_march.launches = 0
    t0 = time.perf_counter()
    for i in range(N_ONLINE):
        img = frame(coeffs[N_WARMUP + i])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / N_ONLINE * 1e3
    launches = {"fused_render": fr.fused_render.launches,
                "fused_merged_march": fr.fused_merged_march.launches}
    if tuple(img.shape) != (1, 3, 512, 512) or not torch.isfinite(img).all():
        fail(f"{label}: frame {tuple(img.shape)} is not a finite [1, 3, 512, 512]")
    if launches != {"fused_render": N_ONLINE, "fused_merged_march": N_ONLINE}:
        fail(f"{label}: B1/B2 launched {launches} times in {N_ONLINE} frames, expected one each "
             "per frame")
    return ms, launches, img


def online_phase(torch, dev, card, fr):
    """Phase 11; returns (the card's manager, the trajectory on the card,
    B1/B2 launches of the online loop)."""
    from invertavatar_torch.faceverse.synthetic import coeff_trajectory, synthetic_manager
    from invertavatar_torch.flagship import example_inputs, flagship_generator, init_flagship

    t0 = time.perf_counter()
    mgr, bank = synthetic_manager(n_grid=173, device=dev)
    mgr_cpu, _ = synthetic_manager(n_grid=173, device="cpu")
    V, F = mgr.model.assets.uv_per_ver.shape[0], mgr.tri.shape[0]
    print(f"[11] synthetic FaceVerse manager: {V} vertices, {F} faces, built on the card and "
          f"the CPU in {time.perf_counter() - t0:.2f} s")
    if (V, F) != (29929, 59168):
        fail(f"the synthetic mesh has {V} vertices and {F} faces, expected 29929 and 59168")
    for i in (1, 2):
        compare_driving(torch, f"drive coefficients {i}", mgr.make_driven_rendering(bank[i]),
                        mgr_cpu.make_driven_rendering(bank[i]))
    del mgr_cpu
    traj = torch.from_numpy(coeff_trajectory(N_WARMUP + N_ONLINE)).to(dev)
    raster_ms = device_ms(lambda: mgr.make_driven_rendering(traj[0]))
    print(f"[11] driving signal (coefficients -> mesh -> raster 256² -> uvcoords_image), device "
          f"time of all its ops {raster_ms:.4f} ms per frame on {card}")

    G = init_flagship(flagship_generator(device=dev), seed=0)
    z, c, _ = (torch.from_numpy(a).to(dev) for a in example_inputs(1))
    with torch.inference_mode():
        ws = G.mapping(z, c)
        tex = G.texture_backbone.synthesis(ws, return_list=True, noise_mode="const")
        static = G.backbone.synthesis(ws, return_list=True, noise_mode="const")
        cache, tex_cat = G.precompute_raster_static(static), G.precompute_texture_concat(tex)

        def frame(coeff):
            return G.synthesis_withTexture(ws, tex, c, {"uvcoords_image":
                                                        mgr.make_driven_rendering(coeff)},
                                           static_feats=static, noise_mode="const",
                                           evaluation=True, raster_static_cache=cache,
                                           texture_concat_cache=tex_cat)["image"]

        ms, launches, img = online_frames(torch, fr, frame, traj, "online loop")
    print(f"[11] online loop: {N_ONLINE} frames of coeff_trajectory -> make_driven_rendering -> "
          f"synthesis_withTexture [1,3,512,512], {ms:.3f} ms/frame, {1e3 / ms:.3f} frames/s "
          f"(host clock, B=1) on {card}; the driving signal's device time is "
          f"{raster_ms / ms * 100:.2f}% of it; launches {launches}; image mean "
          f"{img.float().mean().item():.4f}")
    return mgr, traj, launches


def fewshot_phases(torch, dev, card, fr, mgr, traj):
    """Phases 12-13; returns the B1/B2 launches of the absorb and of the
    driven frames."""
    from invertavatar_torch.cli import eval_seq as es
    from invertavatar_torch.faceverse.synthetic import synthetic_source_clip
    from invertavatar_torch.flagship import FLAGSHIP_RENDERING_KWARGS, fewshot_inversion_net

    # ---------------------------------------------------------------- phase 12
    mark("12")
    small = dict(z_dim=32, c_dim=25, w_dim=512, img_resolution=512, img_channels=3,
                 sr_num_fp16_res=0, neural_rendering_resolution=32, channel_base=2048,
                 channel_max=128, num_fp16_res=0, map_num_layers=2,
                 rendering_kwargs=dict(FLAGSHIP_RENDERING_KWARGS, depth_resolution=12,
                                       depth_resolution_importance=12, tile_shape=(16, 4)))
    inputs = synthetic_source_clip(mgr, traj, 4, seed=12)
    # bands of |card - CPU| as fractions of each tensor's largest entry (max,
    # mean): float32 sums in other orders through ~60 layers (the bar of
    # tests/test_torch_fewshot.py); bf16 layers rounded after other sums (the
    # 5% bar of tests/test_torch_unet_encoders.py)
    for dt, rel, mean_rel in ((None, 1e-3, 1e-4), (torch.bfloat16, 5e-2, 5e-3)):
        net_cpu = fewshot_inversion_net(small, trunk_layers_n=8, seed=2, unet_eval_dtype=dt,
                                        device="cpu")
        net_gpu = fewshot_inversion_net(small, trunk_layers_n=8, seed=2, unet_eval_dtype=dt,
                                        device=dev)
        net_gpu.load_state_dict(net_cpu.state_dict())
        outs = []
        for n, d in ((net_gpu, dev), (net_cpu, torch.device("cpu"))):
            with torch.inference_mode():
                avatar, r_list = es.absorb_clip(n, *(t.to(d) for t in inputs), T=2)
            outs.append([t.float().cpu() for t in avatar["texture"] + avatar["static"]
                         + r_list[0] + r_list[1]])
        worst = 0.0
        for a, b in zip(*outs):
            scale = b.abs().max().item() + 1e-6
            e = (a - b).abs()
            worst = max(worst, e.max().item() / scale)
            if not (torch.isfinite(a).all() and e.max() <= rel * scale
                    and e.mean() <= mean_rel * scale):
                fail(f"few-shot small config ({dt or 'float32'} U-Nets): card and CPU differ "
                     f"by {e.max().item():.3e} max, {e.mean().item():.3e} mean at scale "
                     f"{scale:.3e}")
        print(f"[12] few-shot small config, {dt or 'float32'} U-Nets, 2 chunks of T=2: "
              f"{len(outs[0])} features and GRU states, card vs CPU max|d| {worst:.3e} of each "
              f"tensor's scale (<= {rel}; mean <= {mean_rel})")
        del net_cpu, net_gpu, outs
    del inputs

    # ---------------------------------------------------------------- phase 13
    mark("13")
    t0 = time.perf_counter()
    net = fewshot_inversion_net(device=dev)
    n_frames = 2 * FEWSHOT_T
    images, uv, cams, uvc = synthetic_source_clip(mgr, traj, n_frames, seed=13)
    torch.cuda.synchronize()
    print(f"[13] few-shot network built (flagship eval generator, IR-SE-50 e4e encoder and GRU "
          f"U-Nets, bf16 U-Nets in the absorb), weights and {n_frames} source frames ready in "
          f"{time.perf_counter() - t0:.2f} s")
    with torch.inference_mode():
        es.absorb_clip(net, images, uv, cams, uvc, FEWSHOT_T)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fr.fused_render.launches = fr.fused_merged_march.launches = 0
        t0 = time.perf_counter()
        for _ in range(N_ABSORB_REPS):
            avatar, r_list = es.absorb_clip(net, images, uv, cams, uvc, FEWSHOT_T)
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t0) / N_ABSORB_REPS
        absorb_launches = {"fused_render": fr.fused_render.launches,
                           "fused_merged_march": fr.fused_merged_march.launches}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expect = FEWSHOT_T * 2 * N_ABSORB_REPS
    print(f"[13] few-shot absorb (encode + 2 chunks of T={FEWSHOT_T}, 512² frames): "
          f"{secs:.4f} s per {n_frames} absorbed frames over {N_ABSORB_REPS} repetitions "
          f"(host clock), {n_frames / secs:.3f} frames/s; peak memory {peak:.3f} GiB on {card}; "
          f"launches {absorb_launches}")
    if absorb_launches != {"fused_render": expect, "fused_merged_march": expect}:
        fail(f"the absorb launched B1/B2 {absorb_launches} times, expected {FEWSHOT_T} each per "
             f"chunk ({expect} in {N_ABSORB_REPS} absorbs of 2 chunks)")
    feats = avatar["texture"] + avatar["static"] + r_list[0] + r_list[1]
    if not all(torch.isfinite(t.float()).all() for t in feats):
        fail("the absorbed features or GRU states are not finite")
    if not all(r.dtype == torch.bfloat16 for r in r_list[0] + r_list[1]):
        fail("the carried GRU states are not bf16")

    with torch.inference_mode():
        caches = es.drive_caches(net, avatar)
        c = cams[:1]

        def frame(coeff):
            return es.render_drive_frame(net, avatar, caches, c, manager=mgr, coeff=coeff)

        ms, drive_launches, img = online_frames(torch, fr, frame, traj, "few-shot drive")
    print(f"[13] few-shot drive: {N_ONLINE} online frames of the absorbed avatar, {ms:.3f} "
          f"ms/frame, {1e3 / ms:.3f} frames/s (host clock, B=1) on {card}; launches "
          f"{drive_launches}; image mean {img.float().mean().item():.4f}")
    return absorb_launches, drive_launches


def oneshot_phases(torch, dev, card, fr, mgr, traj):
    """Phases 14-15; returns the B1/B2 launches of the inversions and of the
    driven frames."""
    from invertavatar_torch.cli import eval_os, eval_seq as es
    from invertavatar_torch.faceverse.synthetic import synthetic_source_clip
    from invertavatar_torch.flagship import FLAGSHIP_RENDERING_KWARGS, oneshot_inversion_net

    # ---------------------------------------------------------------- phase 14
    small = dict(z_dim=32, c_dim=25, w_dim=512, img_resolution=512, img_channels=3,
                 sr_num_fp16_res=0, neural_rendering_resolution=32, channel_base=2048,
                 channel_max=128, num_fp16_res=0, map_num_layers=2,
                 rendering_kwargs=dict(FLAGSHIP_RENDERING_KWARGS, depth_resolution=12,
                                       depth_resolution_importance=12, tile_shape=(16, 4)))
    image, uv, cam, uvc = synthetic_source_clip(mgr, traj, 1, seed=14)
    drive_uvc = [mgr.make_driven_rendering(traj[N_WARMUP + i]) for i in range(N_ONESHOT_SMALL)]
    net_cpu = oneshot_inversion_net(small, trunk_layers_n=8, seed=3, device="cpu")
    net_gpu = oneshot_inversion_net(small, trunk_layers_n=8, seed=3, device=dev)
    net_gpu.load_state_dict(net_cpu.state_dict())
    outs = []
    for n, d in ((net_gpu, dev), (net_cpu, torch.device("cpu"))):
        with torch.inference_mode():
            avatar = eval_os.invert_source(n, image.to(d), cam.to(d), uv.to(d), uvc.to(d))
            caches = es.drive_caches(n, avatar)
            frames = [es.render_drive_frame(n, avatar, caches, cam.to(d), u.to(d))
                      for u in drive_uvc]
        outs.append(([t.float().cpu() for t in avatar["texture"] + avatar["static"]],
                     torch.cat([f.float().cpu() for f in frames])))
    del net_cpu, net_gpu
    (feats_g, frames_g), (feats_c, frames_c) = outs
    # float32 on both sides with TF32 off: the features to 1e-3 of each
    # tensor's scale (phase 12's bar); the frames within phase 5's bands (the
    # card's renders take B1/B2 and their bf16 planes, the CPU's the plain
    # versions)
    worst = 0.0
    for a, b in zip(feats_g, feats_c):
        scale = b.abs().max().item() + 1e-6
        e = (a - b).abs()
        worst = max(worst, e.max().item() / scale)
        if not (torch.isfinite(a).all() and e.max() <= 1e-3 * scale
                and e.mean() <= 1e-4 * scale):
            fail(f"one-shot small config: card and CPU features differ by {e.max().item():.3e} "
                 f"max, {e.mean().item():.3e} mean at scale {scale:.3e}")
    e = (frames_g - frames_c).abs()
    print(f"[14] one-shot small config (tiny e4e trunk, full-width SegFormer U-Nets, float32): "
          f"inversion + {N_ONESHOT_SMALL} driven frames; {len(feats_g)} features, card vs CPU "
          f"max|d| {worst:.3e} of each tensor's scale (<= 1e-3; mean <= 1e-4); frames "
          f"{tuple(frames_g.shape)} max {e.max().item():.3e} (< 1e-1) mean "
          f"{e.mean().item():.3e} (< 1e-2)")
    if not (torch.isfinite(frames_g).all() and e.max() < 1e-1 and e.mean() < 1e-2):
        fail("one-shot small config: the driven frames on the card disagree with the CPU")
    del outs, feats_g, feats_c, frames_g, frames_c

    # ---------------------------------------------------------------- phase 15
    mark("15")
    t0 = time.perf_counter()
    net = oneshot_inversion_net(device=dev)
    image, uv, cam, uvc = synthetic_source_clip(mgr, traj, 1, seed=15)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in net.unet_encoder.parameters())
    print(f"[15] one-shot network built (flagship eval generator, IR-SE-50 e4e encoder, "
          f"SegFormer U-Nets {n_params / 1e6:.1f} M parameters in float32), weights and a 512² "
          f"source frame ready in {time.perf_counter() - t0:.2f} s")
    with torch.inference_mode():
        eval_os.invert_source(net, image, cam, uv, uvc)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fr.fused_render.launches = fr.fused_merged_march.launches = 0
        t0 = time.perf_counter()
        for _ in range(N_ONESHOT_REPS):
            avatar = eval_os.invert_source(net, image, cam, uv, uvc)
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t0) / N_ONESHOT_REPS
        invert_launches = {"fused_render": fr.fused_render.launches,
                           "fused_merged_march": fr.fused_merged_march.launches}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[15] one-shot inversion (encode, prefix render, both SegFormer U-Nets, SFT "
          f"backbone, final render; 512²): {secs:.4f} s per inversion over {N_ONESHOT_REPS} "
          f"(host clock); peak memory {peak:.3f} GiB on {card}; launches {invert_launches}; "
          f"render mean {avatar['image'].float().mean().item():.4f}")
    expect = 2 * N_ONESHOT_REPS  # the prefix render and the final render
    if invert_launches != {"fused_render": expect, "fused_merged_march": expect}:
        fail(f"the one-shot inversion launched B1/B2 {invert_launches} times, expected 2 each "
             f"per inversion ({expect} in {N_ONESHOT_REPS})")
    feats = avatar["texture"] + avatar["static"] + [avatar["image"]]
    if tuple(avatar["image"].shape) != (1, 3, 512, 512) or not all(
            torch.isfinite(t.float()).all() for t in feats):
        fail("the one-shot avatar's features or render are not finite [1, 3, 512, 512]")
    with torch.inference_mode():
        caches = es.drive_caches(net, avatar)

        def frame(coeff):
            return es.render_drive_frame(net, avatar, caches, cam, manager=mgr, coeff=coeff)

        ms, drive_launches, img = online_frames(torch, fr, frame, traj, "one-shot drive")
    print(f"[15] one-shot drive: {N_ONLINE} online frames of the inverted avatar, {ms:.3f} "
          f"ms/frame, {1e3 / ms:.3f} frames/s (host clock, B=1) on {card}; launches "
          f"{drive_launches}; image mean {img.float().mean().item():.4f}")
    del net, avatar, caches
    return invert_launches, drive_launches


def gan_batch(torch, d, B, res, z_dim, seed):
    """A seeded GAN batch on `d`: N(0, 1) images, the frontal camera, its
    uvcoords and z."""
    import numpy as np

    from invertavatar_torch.flagship import example_inputs

    z, c, uvc = example_inputs(B, seed=seed)
    img = np.random.RandomState(seed).randn(B, 3, res, res).astype(np.float32)
    return {"image": torch.from_numpy(img).to(d), "c": torch.from_numpy(c).to(d),
            "v": {"uvcoords_image": torch.from_numpy(uvc).to(d)},
            "z": torch.from_numpy(z[:, :z_dim]).to(d)}


def gan_models(torch, dev, seed, d_fp16_res=4):
    """The GAN CLI's models at flagship width after `torch.manual_seed(seed)`:
    the float32 generator (channel_base 32768, channel_max 512, neural
    rendering 64², `cli/train_gan.py`'s rendering kwargs: 48+48 stochastic
    samples, `pallas_coarse` kept from the flagship dict) and the dual
    discriminator at 512² (6 channels, bf16 top `d_fp16_res` resolutions)."""
    from invertavatar_torch.flagship import FLAGSHIP_RENDERING_KWARGS
    from invertavatar_torch.models.discriminator import DualDiscriminator
    from invertavatar_torch.models.triplane import TriPlaneGenerator

    rk = dict(FLAGSHIP_RENDERING_KWARGS, c_gen_conditioning_zero=True, gpc_reg_prob=None,
              density_reg=0.25, superresolution_noise_mode="random", det_stratified=False,
              depth_resolution=48, depth_resolution_importance=48)
    torch.manual_seed(seed)
    with torch.device(dev):
        G = TriPlaneGenerator(z_dim=512, c_dim=25, w_dim=512, img_resolution=512,
                              img_channels=3, rendering_kwargs=rk,
                              neural_rendering_resolution=64, channel_base=32768,
                              channel_max=512, map_num_layers=2)
        D = DualDiscriminator(c_dim=25, img_resolution=512, img_channels=6, channel_base=32768,
                              channel_max=512, num_fp16_res=d_fp16_res)
    return G, D


def gan_phases(torch, dev, card):
    """Phases 16-17: a tiny GAN step on the card against the CPU, then
    `train_gan` at flagship width for `N_GAN_STEPS` steps of batch 4, then
    warm steps with both regularisations."""
    import tempfile

    import numpy as np

    from invertavatar_torch.models.discriminator import DualDiscriminator
    from invertavatar_torch.models.triplane import TriPlaneGenerator
    from invertavatar_torch.train import gan as pg
    from invertavatar_torch.train.loop_gan import GANTrainConfig, train_gan
    from invertavatar_torch.train.state import LazyRegAdam, TrainState

    def batch_on(d, B, res, z_dim, seed):
        return gan_batch(torch, d, B, res, z_dim, seed)

    # ---------------------------------------------------------------- phase 16
    # the JAX dry run's tiny models, every draw the card and the CPU would
    # make differently removed: no synthesis noise (noise_strength 0), middle
    # strata, no importance pass, no conditioning swap; the density TV at
    # the same points on both sides
    rk = {"superresolution_module": "x.SuperresolutionHybrid2X", "c_gen_conditioning_zero": False,
          "c_scale": 1.0, "superresolution_noise_mode": "random", "density_reg": 0.25,
          "density_reg_p_dist": 0.004, "reg_type": "l1", "decoder_lr_mul": 1.0,
          "sr_antialias": True, "depth_resolution": 8, "depth_resolution_importance": 0,
          "box_warp": 1.0, "det_stratified": True}
    tiny = dict(z_dim=32, c_dim=25, w_dim=512, img_resolution=128, img_channels=3,
                rendering_kwargs=rk, neural_rendering_resolution=32, channel_base=1024,
                channel_max=64, map_num_layers=2)
    d_cfg = dict(c_dim=25, img_resolution=128, img_channels=6, channel_base=1024,
                 channel_max=64, num_fp16_res=0)
    cfg = pg.GANLossConfig(neural_rendering_resolution_initial=32,
                           neural_rendering_resolution_final=None, blur_init_sigma=10.0,
                           blur_fade_kimg=8.0)
    torch.manual_seed(16)
    G0, D0 = TriPlaneGenerator(**tiny), DualDiscriminator(**d_cfg)
    with torch.no_grad():
        for name, p in G0.named_parameters():
            if name.endswith("noise_strength"):
                p.zero_()
    points = torch.rand((2, 1000, 3), generator=torch.Generator().manual_seed(16)) * 2 - 1
    points = torch.cat([points, points + torch.randn(points.shape) * 0.004], dim=1)
    results = []
    for d in (dev, torch.device("cpu")):
        G, D = TriPlaneGenerator(**tiny).to(d), DualDiscriminator(**d_cfg).to(d)
        G.load_state_dict(G0.state_dict())
        D.load_state_dict(D0.state_dict())
        gs = TrainState(G, LazyRegAdam(G.parameters(), 0.0025, 0.0, 0.99, 1e-8, 4))
        ds = TrainState(D, LazyRegAdam(D.parameters(), 0.002, 0.0, 0.99, 1e-8, 16))
        batch = batch_on(d, 2, 128, 32, 16)
        sched = pg.make_schedules(cfg, 1000)
        step = pg.make_gan_train_step(G, D, cfg, 32, do_greg=False, do_dreg=True)
        m = {k: float(v) for k, v in step(gs, ds, batch, sched,
                                          torch.Generator(device=d).manual_seed(0),
                                          apply=False).items()}
        grads = {f"G.{k}": p.grad.detach().cpu() for k, p in G.named_parameters()}
        grads.update({f"D.{k}": p.grad.detach().cpu() for k, p in D.named_parameters()})
        with torch.no_grad():
            m["density_tv"] = float(pg.density_tv(G, batch["z"], batch["c"], batch["v"], sched,
                                                  cfg, coords=points.to(d)))
        results.append((m, grads))
        del G, D, gs, ds
    (m_g, grads_g), (m_c, grads_c) = results
    for k in sorted(m_c):
        print(f"[16] tiny GAN step {k}: card {m_g[k]:.7g} CPU {m_c[k]:.7g}")
    bad = [k for k in m_c if not abs(m_g[k] - m_c[k]) <= 1e-3 * abs(m_c[k]) + 1e-6]
    if sorted(m_g) != sorted(m_c) or bad:
        fail(f"the tiny GAN step on the card disagrees with the CPU on {bad}")
    # gradients to 1e-3 of each network's largest gradient entry: float32
    # sums in other orders through ~60 layers and R1's double backward
    for net in ("G", "D"):
        keys = [k for k in grads_c if k.startswith(net + ".")]
        scale = max(grads_c[k].abs().max().item() for k in keys)
        worst = max((grads_g[k] - grads_c[k]).abs().max().item() for k in keys) / scale
        print(f"[16] tiny GAN step {net} gradients: max|card-cpu| {worst:.3e} of the largest "
              f"entry {scale:.3e} (< 1e-3)")
        if not worst < 1e-3:
            fail(f"the tiny GAN step's {net} gradients differ between card and CPU")
    del results, G0, D0

    # ---------------------------------------------------------------- phase 17
    mark("17")
    t0 = time.perf_counter()
    G, D = gan_models(torch, dev, 17)
    batches = [batch_on(dev, GAN_BATCH, 512, 512, 170 + i) for i in range(N_GAN_STEPS)]
    torch.cuda.synchronize()
    print(f"[17] GAN models built: G {sum(p.numel() for p in G.parameters()) / 1e6:.1f} M, D "
          f"{sum(p.numel() for p in D.parameters()) / 1e6:.1f} M parameters (channel_base "
          f"32768, channel_max 512; D at 512², 6 channels, bf16 top 4 resolutions) in "
          f"{time.perf_counter() - t0:.2f} s")
    times, metrics = [], []

    def on_step(step_idx, cur_nimg, m):
        torch.cuda.synchronize()
        times.append(time.perf_counter())
        metrics.append(m)

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as run_dir:
        cfg = GANTrainConfig(run_dir=run_dir, batch_size=GAN_BATCH, snapshot_images=False,
                             loss=pg.GANLossConfig(blur_init_sigma=10.0, blur_fade_kimg=200.0,
                                                   neural_rendering_resolution_initial=64,
                                                   neural_rendering_resolution_fade_kimg=1000))
        torch.cuda.synchronize()
        times.append(time.perf_counter())
        g_state, d_state, G_ema, nimg = train_gan(G, D, iter(batches), cfg,
                                                  max_steps=N_GAN_STEPS, on_step=on_step,
                                                  device=dev)
        snaps = [f for f in os.listdir(run_dir) if f.startswith("snapshot-")]
    step_ms = [(b - a) * 1e3 for a, b in zip(times, times[1:])]
    regs = [("Greg" if "Loss/G/reg" in m else "") + ("+R1" if "Loss/r1_penalty" in m else "")
            for m in metrics]
    for i, (ms, m) in enumerate(zip(step_ms, metrics)):
        print(f"[17] GAN step {i} ({regs[i] or 'no regularisation'}): {ms:.3f} ms (host "
              f"clock{'; the first call of each op' if i < 2 else ''}) " +
              " ".join(f"{k}={v:.6g}" for k, v in m.items()))
    # steps 0 and 1 are the first of their graphs (with and without R1)
    warm = [ms for i, ms in enumerate(step_ms) if i >= 2 and not regs[i]]
    # both regularisations once more on the trained state, now warm
    reg_step = pg.make_gan_train_step(G, D, cfg.loss, 64, do_greg=True, do_dreg=True)
    sched = pg.make_schedules(cfg.loss, nimg)
    reg_ms = []
    for i in range(N_GAN_REG_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = reg_step(g_state, d_state, batches[i], sched, torch.Generator(device=dev).manual_seed(i))
        metrics.append({k: float(v) for k, v in m.items()})
        reg_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[17] GAN training at flagship width, batch {GAN_BATCH}, nrr 64, 48+48 samples: "
          f"{N_GAN_STEPS} steps of `train_gan`; {np.median(warm):.3f} ms/step (median of the "
          f"{len(warm)} warm steps without regularisation, {', '.join(f'{x:.3f}' for x in warm)}"
          f"); a step with the density TV and R1 {np.median(reg_ms):.3f} ms (median of "
          f"{N_GAN_REG_TIMED} warm ones, {', '.join(f'{x:.3f}' for x in reg_ms)}); peak memory "
          f"{peak:.3f} GiB on {card}; snapshot {snaps}")
    if regs != ["Greg+R1", "", "", "", "Greg", ""][:N_GAN_STEPS]:
        fail(f"the steps ran the regularisations {regs}, expected both at step 0, the density TV "
             "at step 4 and neither elsewhere")
    if nimg != GAN_BATCH * N_GAN_STEPS or len(snaps) != 1:
        fail(f"train_gan counted {nimg} images and wrote {snaps}")
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        fail("a GAN step gave a non-finite loss")
    for name, mod in (("G", g_state.module), ("D", d_state.module), ("G_ema", G_ema)):
        if not all(torch.isfinite(t).all() for t in mod.state_dict().values()
                   if t.is_floating_point()):
            fail(f"a parameter or buffer of {name} is not finite after {N_GAN_STEPS} steps")
    del G, D, g_state, d_state, G_ema, batches


# the tests' tiny generator widths (channel_base 1024, channel_max 64, 32²
# neural render, 6+6 samples), rendering 256² through the 4X SR so that
# frames, renders and D share one resolution (Dreal scores the frames):
# phases 18 and 20
SMALL_TRAIN_CFG = dict(
    z_dim=32, c_dim=25, w_dim=512, img_resolution=256, img_channels=3,
    rendering_kwargs={"superresolution_module": "x.SuperresolutionHybrid4X",
                      "c_gen_conditioning_zero": False, "c_scale": 1.0,
                      "superresolution_noise_mode": "none", "decoder_lr_mul": 1.0,
                      "sr_antialias": True, "depth_resolution": 6,
                      "depth_resolution_importance": 6, "box_warp": 1.0, "det_stratified": True},
    neural_rendering_resolution=32, channel_base=1024, channel_max=64, map_num_layers=2)
SMALL_D_CFG = dict(c_dim=25, img_resolution=256, img_channels=6, channel_base=1024,
                   channel_max=64, num_fp16_res=0)


def small_train_models(make, seed, device):
    """`make(SMALL_TRAIN_CFG, SMALL_D_CFG, ...)` (a `flagship.*_train_models`
    constructor) with tiny e4e trunks (and tiny U-Net trunks where the stage's
    U-Nets have them), the generator's decoder weights scaled by 10. At
    plain N(0, 0.1) draws the tiny generator's raw render is flat (spatial
    std ~2e-5 against ~1e-3 after the scaling), so whole channels of D sit
    together at a leaky-ReLU kink, and float32 noise in the fake pair moves
    D's gradient by up to ~1e-3 of its norm: a fixture that tests no
    program."""
    import torch

    net, D = make(dict(SMALL_TRAIN_CFG), SMALL_D_CFG, trunk_layers_n=8, seed=seed,
                  device=device)
    with torch.no_grad():
        for k, p in net.generator.decoder.named_parameters():
            if k.endswith("weight"):
                p.mul_(10.0)
    return net, D


def b3_path_checks(torch, ps, card, tag, calls, gen, extra=None):
    """B3 (fp32) and its transpose against their plain versions, and timed, on
    the two recorded `sample_planes_windowed_cvjp` calls (coarse, fine) of one
    student render of a training path; returns {kernel: {pass: (max |k -
    p|, ms, bound ms)}}. With a dict `extra`, the plain versions and the
    library calls (`F.grid_sample` and its backward) are timed too, into
    extra[kernel][pass] = (plain ms, library ms)."""
    if len(calls) != 2:
        fail(f"a student render made {len(calls)} B3 calls, expected 2 (coarse, fine)")
    checks = {"plane_sample": {}, "plane_sample_transpose": {}}
    with torch.no_grad():
        for (args, _, out), label in zip(calls, ("coarse", "fine")):
            planes, grid = args
            N, H, W, C = planes.shape
            what = f"student {label} {N // 3} item(s) S={grid.shape[2]}"
            errs = b3_forward_check(torch, ps, tag, what, planes, grid, out)
            cot = torch.randn((*grid.shape[:3], C), generator=gen, device=grid.device)
            e_t = transpose_check(torch, ps, what, grid, cot, planes.shape, tag=tag)
            f_ms = device_ms(lambda: ps.sample_planes_windowed(planes, grid), "sample_kernel<")
            t_ms = device_ms(lambda: ps.windowed_sample_transpose(grid, cot, planes.shape),
                             "transpose_kernel(")
            n_pts = grid.numel() // 2
            # forward: grid and planes read, samples written; the transpose:
            # grid and cotangent read, planes written; the same bytes and taps
            b_ms, b_by = bound(grid.numel() * 4 + planes.numel() * 4 + n_pts * C * 4,
                               n_pts * 4 * C * 2)
            print(f"{tag} B3 {what}: planes {tuple(planes.shape)}, grid {tuple(grid.shape)}; "
                  f"fp32 kernel {f_ms:.4f} ms, transpose kernel {t_ms:.4f} ms, bound of each "
                  f"{b_ms:.4f} ms ({b_by}) on {card}")
            checks["plane_sample"][label] = (errs[torch.float32], f_ms, b_ms)
            checks["plane_sample_transpose"][label] = (e_t, t_ms, b_ms)
            if extra is not None:
                import torch.nn.functional as F

                planes_nchw = planes.permute(0, 3, 1, 2).contiguous()
                cot_nchw = cot.permute(0, 3, 1, 2).contiguous()
                f_times = (device_ms(lambda: ps.sample_planes_windowed_reference(planes, grid)),
                           device_ms(lambda: F.grid_sample(planes_nchw, grid, mode="bilinear",
                                                           padding_mode="zeros",
                                                           align_corners=False)))
                t_times = (device_ms(lambda: ps.windowed_sample_transpose_reference(
                               grid, cot, planes.shape)),
                           device_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
                               cot_nchw, planes_nchw, grid, 0, 0, False, [True, False])))
                extra.setdefault("plane_sample", {})[label] = f_times
                extra.setdefault("plane_sample_transpose", {})[label] = t_times
                print(f"{tag} B3 {what}: plain {f_times[0]:.4f} ms, F.grid_sample "
                      f"{f_times[1]:.4f} ms; transpose plain {t_times[0]:.4f} ms, "
                      f"grid_sample backward {t_times[1]:.4f} ms on {card}")
                del planes_nchw, cot_nchw
    return checks


@contextlib.contextmanager
def timed_oneshot_phases(torch, li, ps, phases):
    """Time each phase of `make_oneshot_train_step`'s steps (host clock,
    synchronized) and count its B3 / transpose launches: appends (phase,
    do_r1, ms, B3 launches, transpose launches) to `phases`."""
    orig = li.make_oneshot_train_step

    def make(*args, **kwargs):
        step = orig(*args, **kwargs)

        def timed(state, d_state, batch, phase="Ireal", do_r1=False, generator=None):
            torch.cuda.synchronize()
            n0 = (ps.sample_planes_windowed.launches, ps.windowed_sample_transpose.launches)
            t0 = time.perf_counter()
            aux = step(state, d_state, batch, phase=phase, do_r1=do_r1, generator=generator)
            torch.cuda.synchronize()
            phases.append((phase, do_r1, (time.perf_counter() - t0) * 1e3,
                           ps.sample_planes_windowed.launches - n0[0],
                           ps.windowed_sample_transpose.launches - n0[1]))
            return aux
        return timed

    li.make_oneshot_train_step = make
    try:
        yield
    finally:
        li.make_oneshot_train_step = orig


def oneshot_train_phases(torch, dev, card):
    """Phases 18-19: the one-shot training step, small, on the card against
    the `F.grid_sample` route and the CPU; then `train_oneshot` at flagship
    width. Returns the kernels' launches in phase 19's `train_oneshot` run,
    and {kernel: {render pass: (max |k - p|, ms, bound ms)}} of B3 and its
    transpose at phase 19's own shapes."""
    import tempfile

    import numpy as np

    from invertavatar_torch.flagship import oneshot_train_batch, oneshot_train_models
    from invertavatar_torch.ops import plane_sample as ps
    from invertavatar_torch.ops.resize import resize_bilinear
    from invertavatar_torch.render import renderer as rmod
    from invertavatar_torch.train import loop_inversion as li
    from invertavatar_torch.train.fast_render import grad_overrides, nograd_overrides
    from invertavatar_torch.train.inversion import InversionLossWeights, oneshot_d_loss
    from invertavatar_torch.train.state import TrainState

    # the JAX package's one-shot step weights (tests/test_loop_inversion.py:632)
    weights = InversionLossWeights(l1=1.0, lpips=0.0, id=0.0, raw_l1=1.0, tri=0.001,
                                   texture=0.001, adv=0.01)

    def l1(a, b):
        return (a - b).abs().mean()

    # ---------------------------------------------------------------- phase 18
    schedule = [("Ireal", "tri", False), ("Dreal", "tri", True), ("Igen", "tex", False),
                ("Dgen", "tex", False)]

    def small_models(seed, device):
        return small_train_models(oneshot_train_models, seed, device)

    def run_routes(seed):
        """{route: {phase: (aux, gradients)}}, each phase from the same weights."""
        net_cpu, d_cpu = small_models(seed, "cpu")
        sd0 = {k: v.clone() for k, v in net_cpu.state_dict().items()}
        dsd0 = {k: v.clone() for k, v in d_cpu.state_dict().items()}
        net_gpu, d_gpu = small_models(seed, dev)
        results = {}
        for label, n, D, d, fast_grad in (("card B3", net_gpu, d_gpu, dev, "pallas"),
                                          ("card grid_sample", net_gpu, d_gpu, dev, "structured"),
                                          ("CPU", net_cpu, d_cpu, torch.device("cpu"), "pallas")):
            batch = oneshot_train_batch(1, 256, z_dim=32, seed=seed, device=d)
            step = li.make_oneshot_train_step(n, l1, None, weights, fast_igen_target="exact",
                                              fast_grad=fast_grad)
            n0 = (ps.sample_planes_windowed.launches, ps.windowed_sample_transpose.launches)
            out = {}
            for phase, unet, r1 in schedule:
                n.load_state_dict(sd0)
                D.load_state_dict(dsd0)
                pred = li.oneshot_tex_trainable if unet == "tex" else li.oneshot_tri_trainable
                state = TrainState(n, li.masked_adam(n, 1e-4, pred))
                d_state = TrainState(D, torch.optim.Adam(D.parameters(), lr=2e-4))
                aux = step(state, d_state, batch, phase=phase, do_r1=r1)
                trained = n if phase.startswith("I") else D
                grads = {k: p.grad.detach().float().cpu() for k, p in trained.named_parameters()
                         if p.grad is not None and p.requires_grad}
                out[phase] = ({k: float(v) for k, v in aux.items()}, grads)
            results[label] = out
            print(f"[18] seed {seed}, {label}: B3 / transpose launches over the four phases "
                  f"{ps.sample_planes_windowed.launches - n0[0]} / "
                  f"{ps.windowed_sample_transpose.launches - n0[1]}")
        # The fixture's conditioning, on the CPU: Dreal's D gradient (R1 on)
        # against the same with the fake pair moved by N(0, 1e-6), float32
        # rounding's size
        net_cpu.load_state_dict(sd0)
        d_cpu.load_state_dict(dsd0)
        d_cpu.requires_grad_(True)
        batch = oneshot_train_batch(1, 256, z_dim=32, seed=seed, device="cpu")
        with torch.no_grad():
            i_out = net_cpu({"image": batch["image"], "uv": batch["uv"]}, batch["c"], batch["v"],
                            nograd_render=nograd_overrides("exact"),
                            grad_render=grad_overrides("pallas"))
        fake = {"image": i_out["image"], "image_raw": i_out["feature_image"][:, :3]}
        real = {"image": batch["image"],
                "image_raw": resize_bilinear(batch["image"], (128, 128), antialias=True)}
        gen = torch.Generator().manual_seed(seed)
        d_grads = []
        for eps in (0.0, 1e-6):
            d_cpu.zero_grad(set_to_none=True)
            moved = {k: v + eps * torch.randn(v.shape, generator=gen) for k, v in fake.items()}
            oneshot_d_loss(d_cpu, moved, real, batch["c"], weights, True)[0].backward()
            d_grads.append(torch.cat([p.grad.flatten() for p in d_cpu.parameters()]))
        d_sens = ((d_grads[1] - d_grads[0]).norm() / d_grads[0].norm()).item()
        raw_std = fake["image_raw"].std(dim=(2, 3)).mean().item()
        print(f"[18] seed {seed}, the fixture on the CPU: the raw render's spatial std "
              f"{raw_std:.3e}; N(0, 1e-6) on Dreal's fake pair moves D's gradient by "
              f"{d_sens:.3e} of its norm")
        return results

    def compare(label, got, ref):
        """Float32 on every side, TF32 off: the losses to 1e-3 relative
        (+1e-7), phase 9's bar; the trained module's gradient (the U-Net in
        the I phases, D in the D phases) to 1e-3 of its norm, and each entry
        to 1e-3 of the largest entry."""
        for phase, _, _ in schedule:
            (aux, grads), (aux_r, grads_r) = got[phase], ref[phase]
            bad = [k for k in aux_r if not (np.isfinite(aux[k]) and
                                           abs(aux[k] - aux_r[k]) <= 1e-3 * abs(aux_r[k]) + 1e-7)]
            norm = sum(g.square().sum() for g in grads_r.values()).sqrt().item()
            rel = sum((grads[k] - grads_r[k]).square().sum()
                      for k in grads_r).sqrt().item() / norm
            scale = max(g.abs().max().item() for g in grads_r.values())
            diffs = {k: (grads[k] - grads_r[k]).abs().max().item() / scale for k in grads_r}
            print(f"[18] {label}, {phase}: " + " ".join(
                f"{k}={aux[k]:.7g}/{aux_r[k]:.7g}" for k in sorted(aux_r)) +
                f"; {len(grads_r)} gradients, |d| {rel:.3e} of their norm {norm:.3e} (< 1e-3); "
                f"largest entry differences, of the largest entry {scale:.3e} (< 1e-3): " +
                ", ".join(f"{k} {diffs[k]:.3e}" for k in sorted(diffs, key=diffs.get)[-3:]))
            if sorted(aux) != sorted(aux_r) or bad or sorted(grads) != sorted(grads_r) \
                    or not (rel < 1e-3 and max(diffs.values()) < 1e-3):
                fail(f"the small one-shot step, {label}, disagrees in {phase}: {bad}")

    t0 = time.perf_counter()
    for seed in SMALL_ONESHOT_SEEDS:
        results = run_routes(seed)
        compare(f"seed {seed}, card B3 vs CPU", results["card B3"], results["CPU"])
        compare(f"seed {seed}, card grid_sample vs CPU", results["card grid_sample"],
                results["CPU"])
        compare(f"seed {seed}, card B3 vs card grid_sample", results["card B3"],
                results["card grid_sample"])
        del results
    print(f"[18] small one-shot step checked on seeds {SMALL_ONESHOT_SEEDS} in "
          f"{time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------------------------- phase 19
    mark("19")
    t0 = time.perf_counter()
    # the float32 generator with the reference's 48+48 training samples
    net, D = oneshot_train_models(seed=19, device=dev)
    batches = [oneshot_train_batch(ONESHOT_BATCH, 512, seed=190 + i, device=dev)
               for i in range(N_ONESHOT_TRAIN)]
    unets = {"tex": net.unet_encoder.texture_unet, "tri": net.unet_encoder.triplane_unet}
    frozen = {"generator": net.generator, "encoder": net.encoder}
    frozen0 = {k: [p.detach().clone() for p in m.parameters()] for k, m in frozen.items()}
    torch.cuda.synchronize()
    print(f"[19] one-shot training models built: U-Nets "
          f"{sum(p.numel() for p in net.unet_encoder.parameters()) / 1e6:.1f} M, generator "
          f"{sum(p.numel() for p in net.generator.parameters()) / 1e6:.1f} M, encoder "
          f"{sum(p.numel() for p in net.encoder.parameters()) / 1e6:.1f} M, D "
          f"{sum(p.numel() for p in D.parameters()) / 1e6:.1f} M parameters (float32 "
          f"generator, 48+48 samples; D at 512², bf16 top 4 resolutions) in "
          f"{time.perf_counter() - t0:.2f} s")
    # B3 and its transpose at this path's own shapes: one student render of
    # the first batch recorded and held against the plain versions
    calls = []
    b = batches[0]
    with torch.no_grad(), recording(rmod, "sample_planes_windowed_cvjp", calls):
        net({"image": b["image"], "uv": b["uv"]}, b["c"], b["v"],
            nograd_render=nograd_overrides("exact"), grad_render=grad_overrides("pallas"))
    torch.cuda.synchronize()
    checks = b3_path_checks(torch, ps, card, "[19]", calls,
                            torch.Generator(device=dev).manual_seed(19))
    del calls
    snap = {"unets": {k: [p.detach().clone() for p in m.parameters()] for k, m in unets.items()},
            "D": [p.detach().clone() for p in D.parameters()]}
    moved, phases, aux_all = [], [], []

    def changed(old, module):
        return any(not torch.equal(a, p) for a, p in zip(old, module.parameters()))

    def on_step(step_idx, cur_nimg, aux):
        torch.cuda.synchronize()
        moved.append({**{k: changed(snap["unets"][k], m) for k, m in unets.items()},
                      "D": changed(snap["D"], D)})
        snap["unets"] = {k: [p.detach().clone() for p in m.parameters()]
                         for k, m in unets.items()}
        snap["D"] = [p.detach().clone() for p in D.parameters()]
        aux_all.append({k: float(v) for k, v in aux.items()})

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as run_dir, \
            timed_oneshot_phases(torch, li, ps, phases):
        cfg = li.InversionTrainConfig(run_dir=run_dir, batch_size=ONESHOT_BATCH, lr=1e-4,
                                      weights=weights)
        li.train_oneshot(net, D, iter(batches), cfg, l1, max_steps=N_ONESHOT_TRAIN,
                         fast_igen_target="exact", fast_grad="pallas", on_step=on_step,
                         device=dev)
        torch.cuda.synchronize()
        launches = launch_counts()
        total_s = time.perf_counter() - t1
        snap_bytes = sum(os.path.getsize(os.path.join(run_dir, f)) for f in os.listdir(run_dir)
                         if f.startswith("snapshot-"))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # expected launches of each phase, counted from the code: B3 twice per
    # render (coarse, fine) for the Igen target, the e4e prefix render and the
    # student render; the transpose twice in the student's backward; the D
    # phases re-run the target (Dgen), the prefix and the student without grad
    per_phase = {"Ireal": (4, 2), "Igen": (6, 2), "Dreal": (4, 0), "Dgen": (6, 0)}
    sched = [li.oneshot_phase_schedule(i, cfg.wd_reg_interval) for i in range(N_ONESHOT_TRAIN)]
    expect_phases = [x for i_ph, _, d_ph, r1 in sched for x in ((i_ph, False), (d_ph, r1))]
    if [(p[0], p[1]) for p in phases] != expect_phases:
        fail(f"train_oneshot ran the phases {[(p[0], p[1]) for p in phases]}, expected "
             f"{expect_phases}")
    for i, (i_ph, unet, d_ph, r1) in enumerate(sched):
        (_, _, i_ms, i_b3, i_t), (_, _, d_ms, d_b3, d_t) = phases[2 * i], phases[2 * i + 1]
        print(f"[19] step {i}: {i_ph} ({unet} U-Net) {i_ms:.3f} ms + {d_ph}{'+R1' if r1 else ''} "
              f"{d_ms:.3f} ms (host clock, synchronized); B3 / transpose launches {i_b3}/{i_t} + "
              f"{d_b3}/{d_t}; moved {moved[i]}; " +
              " ".join(f"{k}={v:.6g}" for k, v in aux_all[i].items()))
        if (i_b3, i_t) != per_phase[i_ph] or (d_b3, d_t) != per_phase[d_ph]:
            fail(f"step {i}: B3 / transpose launches {i_b3}/{i_t} + {d_b3}/{d_t}, expected "
                 f"{per_phase[i_ph]} + {per_phase[d_ph]}")
        other = "tex" if unet == "tri" else "tri"
        if not (moved[i][unet] and not moved[i][other] and moved[i]["D"]):
            fail(f"step {i} trains the {unet} U-Net and D: moved {moved[i]}")
        if not all(np.isfinite(v) for v in aux_all[i].values()):
            fail(f"step {i} gave a non-finite loss: {aux_all[i]}")
    for k, m in frozen.items():
        if changed(frozen0[k], m):
            fail(f"the frozen {k} moved")
    timed = phases[2 * N_ONESHOT_TIMED_FROM:]
    by_kind = {}
    for ph, r1, ms, _, _ in timed:
        by_kind.setdefault(ph + ("+R1" if r1 else ""), []).append(ms)
    step_ms = [timed[2 * i][2] + timed[2 * i + 1][2] for i in range(len(timed) // 2)]
    expect = {"plane_sample": sum(per_phase[p][0] for p, _ in expect_phases),
              "plane_sample_transpose": sum(per_phase[p][1] for p, _ in expect_phases),
              "fused_render": 0, "fused_merged_march": 0}  # B1/B2: the `fused` target only
    print(f"[19] one-shot training at flagship width, batch {ONESHOT_BATCH}, 512²: "
          f"{N_ONESHOT_TRAIN} steps of `train_oneshot` (exact / pallas) in {total_s:.1f} s "
          f"with the final snapshot ({snap_bytes / 2 ** 30:.2f} GiB); steps "
          f"{N_ONESHOT_TIMED_FROM}-{N_ONESHOT_TRAIN - 1}: {np.mean(step_ms):.3f} ms/step "
          f"({', '.join(f'{x:.3f}' for x in step_ms)}); per phase " +
          ", ".join(f"{k} {np.mean(v):.3f} ms" for k, v in by_kind.items()) +
          f" (host clock, synchronized); peak memory {peak:.3f} GiB on {card}; launches "
          f"{launches}, expected {expect}")
    if launches != expect:
        fail(f"launches {launches} in {N_ONESHOT_TRAIN} one-shot steps, expected {expect}")
    del net, D, batches, snap, frozen0
    return launches, checks


KERNEL_COUNTERS = ("fused_render", "fused_merged_march", "plane_sample", "plane_sample_transpose")


def launch_counts():
    """The four kernels' launch counters, by their record names."""
    from invertavatar_torch.ops import fused_render as fr
    from invertavatar_torch.ops import plane_sample as ps

    return dict(zip(KERNEL_COUNTERS, (fr.fused_render.launches, fr.fused_merged_march.launches,
                                      ps.sample_planes_windowed.launches,
                                      ps.windowed_sample_transpose.launches)))


def reset_launch_counts():
    from invertavatar_torch.ops import fused_render as fr
    from invertavatar_torch.ops import plane_sample as ps

    fr.fused_render.launches = fr.fused_merged_march.launches = 0
    ps.sample_planes_windowed.launches = ps.windowed_sample_transpose.launches = 0


def fewshot_expected(phase, T, Tc, route):
    """Launches of B1, B2, B3 and the transpose in one few-shot phase, counted
    from the code. No-grad renders (the clip's e4e renders, Igen's and D's
    targets, D's fakes): with "fused", B1 and B2 once per frame; with
    "exact", B3 twice (coarse, fine) per chunk's render call. Each
    gradient-carrying frame (Ireal's Tc selected frames, Igen's T): with
    "pallas", B3 twice and the transpose twice in its backward."""
    nograd, grad = route
    renders = {"Ireal": 1, "Igen": 2, "D": 3}[phase]  # no-grad renders of every frame
    out = dict.fromkeys(KERNEL_COUNTERS, 0)
    if nograd == "fused":
        out["fused_render"] = out["fused_merged_march"] = renders * T
    else:
        out["plane_sample"] = 2 * renders * (T // Tc)
    if grad == "pallas" and phase != "D":
        n = Tc if phase == "Ireal" else T
        out["plane_sample"] += 2 * n
        out["plane_sample_transpose"] = 2 * n
    return out


@contextlib.contextmanager
def timed_fewshot_phases(torch, li, phases):
    """Time each phase of `train_fewshot`'s steps (host clock, synchronized)
    and count its launches: appends (phase, T, do_r1, ms, launches) to
    `phases`."""
    orig_step, orig_d = li.make_fewshot_train_step, li.make_fewshot_d_step

    def timed(name_of, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            n0 = launch_counts()
            t0 = time.perf_counter()
            aux = fn(*args, **kwargs)
            torch.cuda.synchronize()
            n1 = launch_counts()
            phases.append((name_of(kwargs), args[-1]["c"].shape[1], kwargs.get("do_r1", False),
                           (time.perf_counter() - t0) * 1e3, {k: n1[k] - n0[k] for k in n1}))
            return aux
        return run

    def make_step(*args, **kwargs):
        return timed(lambda kw: "Igen" if kw.get("do_igen") else "Ireal",
                     orig_step(*args, **kwargs))

    def make_d(*args, **kwargs):
        return timed(lambda kw: "D", orig_d(*args, **kwargs))

    li.make_fewshot_train_step, li.make_fewshot_d_step = make_step, make_d
    try:
        yield
    finally:
        li.make_fewshot_train_step, li.make_fewshot_d_step = orig_step, orig_d


def fewshot_train_phases(torch, dev, card):
    """Phases 20-21: the few-shot training step, small, on the card against
    the `F.grid_sample` route and the CPU; then `train_fewshot` at flagship
    width. Returns the kernels' launches in phase 21's `train_fewshot` run,
    and {kernel: (max |k - p|, ms, bound ms)} of the four kernels at phase
    21's own shapes (B3 and its transpose by render pass)."""
    import tempfile

    import numpy as np

    from invertavatar_torch.flagship import fewshot_train_batch, fewshot_train_models
    from invertavatar_torch.losses.lpips import LPIPS
    from invertavatar_torch.ops import fused_render as fr
    from invertavatar_torch.ops import plane_sample as ps
    from invertavatar_torch.render import renderer as rmod
    from invertavatar_torch.train import loop_inversion as li
    from invertavatar_torch.train.fast_render import grad_overrides, nograd_overrides
    from invertavatar_torch.train.inversion import InversionLossWeights
    from invertavatar_torch.train.state import TrainState

    # configs/train_fewshot.yaml: l1 1, lpips 1, raw_l1 1, tri 0.001, lr_lpips 1,
    # adv 0.1, id 0
    weights = InversionLossWeights(l1=1.0, lpips=1.0, id=0.0, raw_l1=1.0, tri=0.001,
                                   lr_lpips=1.0, adv=0.1)

    def l1(a, b):
        return (a - b).abs().mean()

    # ---------------------------------------------------------------- phase 20
    # a 4-frame clip in chunks of 2 (one carried GRU state) through the tiny
    # GRU network; LPIPS as the L1 distance (the CLI's fallback). Every phase
    # from the same weights; Ireal trains the tri-plane decoder, Igen the
    # texture decoder; D without and with R1. Both card routes share B1/B2
    # for the no-grad renders, the grad-carrying render
    # takes B3 + its transpose or `F.grid_sample`; the CPU runs the plain
    # versions of the first route's kernels.
    T_small, Tc_small = 4, 2
    routes = (("card B3", dev, ("fused", "pallas")),
              ("card grid_sample", dev, ("fused", "structured")),
              ("CPU", torch.device("cpu"), ("fused", "pallas")))

    def run_routes(seed):
        net_cpu, d_cpu = small_train_models(fewshot_train_models, seed, "cpu")
        sd0 = {k: v.clone() for k, v in net_cpu.state_dict().items()}
        dsd0 = {k: v.clone() for k, v in d_cpu.state_dict().items()}
        net_gpu, d_gpu = small_train_models(fewshot_train_models, seed, dev)
        idx = li.fewshot_fake_idx(seed, 0, T_small, Tc_small)
        phases = (("Ireal", li.fewshot_tri_trainable), ("Igen", li.fewshot_tex_trainable),
                  ("D", None), ("D+R1", None))
        results = {}
        for label, d, route in routes:
            n, D = (net_cpu, d_cpu) if d.type == "cpu" else (net_gpu, d_gpu)
            batch = fewshot_train_batch(1, T_small, 256, z_dim=32, seed=seed, device=d)
            step = li.make_fewshot_train_step(n, l1, weights, Tc_small, *route)
            d_step = li.make_fewshot_d_step(n, weights, Tc_small, route[0])
            out = {}
            for phase, pred in phases:
                n.load_state_dict(sd0)
                D.load_state_dict(dsd0)
                n0 = launch_counts()
                if phase.startswith("D"):
                    aux = d_step(TrainState(D, torch.optim.Adam(D.parameters(), lr=1e-4)), batch,
                                 do_r1=phase == "D+R1")
                    trained = D
                else:
                    aux = step(TrainState(n, li.masked_adam(n, 1e-4, pred)), batch,
                               do_igen=phase == "Igen", multiT=True, fake_idx=idx, d_module=D)
                    trained = n
                if d.type != "cpu":
                    torch.cuda.synchronize()
                got = {k: v - n0[k] for k, v in launch_counts().items()}
                want = (dict.fromkeys(KERNEL_COUNTERS, 0) if d.type == "cpu" else
                        fewshot_expected(phase.split("+")[0], T_small, Tc_small, route))
                if got != want:
                    fail(f"the small few-shot {phase} ({label}) launched {got}, expected {want}")
                grads = {k: p.grad.detach().float().cpu() for k, p in trained.named_parameters()
                         if p.grad is not None and p.requires_grad}
                out[phase] = ({k: float(v) for k, v in aux.items()}, grads)
            results[label] = out
            print(f"[20] seed {seed}, {label} ({'/'.join(route)}): launches as counted from the "
                  f"code")
        return results

    def compare(label, got, ref):
        """Float32 on every side, TF32 off: the losses to 1e-3 relative
        (+1e-7); the trained module's gradient (the scheduled decoder in the I
        phases, D in the D phase) to 1e-3 of its norm, each entry to 1e-3 of
        the largest entry (phase 18's bars)."""
        for phase in ("Ireal", "Igen", "D", "D+R1"):
            (aux, grads), (aux_r, grads_r) = got[phase], ref[phase]
            bad = [k for k in aux_r if not (np.isfinite(aux[k]) and
                                           abs(aux[k] - aux_r[k]) <= 1e-3 * abs(aux_r[k]) + 1e-7)]
            norm = sum(g.square().sum() for g in grads_r.values()).sqrt().item()
            rel = sum((grads[k] - grads_r[k]).square().sum()
                      for k in grads_r).sqrt().item() / norm
            scale = max(g.abs().max().item() for g in grads_r.values())
            diffs = {k: (grads[k] - grads_r[k]).abs().max().item() / scale for k in grads_r}
            print(f"[20] {label}, {phase}: " + " ".join(
                f"{k}={aux[k]:.7g}/{aux_r[k]:.7g}" for k in sorted(aux_r)) +
                f"; {len(grads_r)} gradients, |d| {rel:.3e} of their norm {norm:.3e} (< 1e-3); "
                f"largest entry differences, of the largest entry {scale:.3e} (< 1e-3): " +
                ", ".join(f"{k} {diffs[k]:.3e}" for k in sorted(diffs, key=diffs.get)[-3:]))
            if sorted(aux) != sorted(aux_r) or bad or sorted(grads) != sorted(grads_r) \
                    or not (norm > 0 and rel < 1e-3 and max(diffs.values()) < 1e-3):
                fail(f"the small few-shot step, {label}, disagrees in {phase}: {bad}")

    t0 = time.perf_counter()
    for seed in SMALL_FEWSHOT_SEEDS:
        results = run_routes(seed)
        compare(f"seed {seed}, card B3 vs CPU", results["card B3"], results["CPU"])
        compare(f"seed {seed}, card grid_sample vs CPU", results["card grid_sample"],
                results["CPU"])
        compare(f"seed {seed}, card B3 vs card grid_sample", results["card B3"],
                results["card grid_sample"])
        del results
    print(f"[20] small few-shot step checked on seeds {SMALL_FEWSHOT_SEEDS} in "
          f"{time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------------------------- phase 21
    mark("21")
    t0 = time.perf_counter()
    net, D = fewshot_train_models(seed=21, device=dev)
    torch.manual_seed(21)
    lpips = LPIPS("alex").to(dev).eval().requires_grad_(False)
    with torch.no_grad():  # LPIPS's heads weigh squared differences: non-negative
        for p in lpips.lin.parameters():
            p.abs_()
    clips = [fewshot_train_batch(FEWSHOT_TRAIN_BATCH, FEWSHOT_TRAIN_T, 512, seed=210 + i,
                                 device=dev) for i in range(N_FEWSHOT_TRAIN)]
    unets = {"tex": net.unet_encoder.texture_unet, "tri": net.unet_encoder.triplane_unet}

    def decoder(m):
        return [p for k, p in m.named_parameters() if not k.startswith(("input_layer", "body"))]

    def trunk(m):
        return [p for k, p in m.named_parameters() if k.startswith(("input_layer", "body"))]

    frozen = {"generator": list(net.generator.parameters()),
              "encoder": list(net.encoder.parameters()),
              "tex trunk": trunk(unets["tex"]), "tri trunk": trunk(unets["tri"])}
    frozen0 = {k: [p.detach().clone() for p in v] for k, v in frozen.items()}
    torch.cuda.synchronize()
    print(f"[21] few-shot training models built: U-Nets "
          f"{sum(p.numel() for p in net.unet_encoder.parameters()) / 1e6:.1f} M (decoders "
          f"{sum(p.numel() for m in unets.values() for p in decoder(m)) / 1e6:.1f} M), generator "
          f"{sum(p.numel() for p in net.generator.parameters()) / 1e6:.1f} M, encoder "
          f"{sum(p.numel() for p in net.encoder.parameters()) / 1e6:.1f} M, D "
          f"{sum(p.numel() for p in D.parameters()) / 1e6:.1f} M parameters (float32 generator "
          f"and U-Nets, 48+48 samples; D at 512², bf16 top 4 resolutions); "
          f"{N_FEWSHOT_TRAIN} clips of {FEWSHOT_TRAIN_T} 512² frames in "
          f"{time.perf_counter() - t0:.2f} s")

    # the four kernels at this path's own shapes: one no-grad e4e render
    # (fused) and one student render (pallas) of the first clip's first frame
    b = clips[0]
    b1_calls, b2_calls, b3_calls = [], [], []
    with torch.no_grad():
        ws = net.encode(b["image"][:, 0, :3])
        tex, static = net.backbone_feats(ws)
        with recording(rmod, "fused_render", b1_calls), \
                recording(rmod, "fused_merged_march", b2_calls):
            net.multiT_chunk_inputs(b["image"][:, :1], b["c"][:, :1],
                                    {"uvcoords_image": b["v"]["uvcoords_image"][:, :1]},
                                    b["uv"][:, :1], ws, tex, static,
                                    nograd_render=nograd_overrides("fused"))
        with recording(rmod, "sample_planes_windowed_cvjp", b3_calls):
            net.generator.synthesis_withTexture(ws, tex, b["c"][:, 0], {
                "uvcoords_image": b["v"]["uvcoords_image"][:, 0]}, static_feats=static,
                noise_mode="const", rendering_overrides=grad_overrides("pallas"))
    torch.cuda.synchronize()
    if len(b1_calls) != 1 or len(b2_calls) != 1:
        fail(f"a no-grad e4e render made {len(b1_calls)} B1 and {len(b2_calls)} B2 calls, "
             "expected one each")
    checks = {k["name"]: (k["max_abs_err"], k["ms"], k["bound_ms"]) for k in fused_kernel_checks(
        torch, fr, card, "few-shot e4e render, 48+48", b1_calls[0], b2_calls[0], timed=True,
        tags=("[21]", "[21]"))}
    checks.update(b3_path_checks(torch, ps, card, "[21]", b3_calls,
                                 torch.Generator(device=dev).manual_seed(21)))
    del b1_calls, b2_calls, b3_calls, ws, tex, static

    snap = {"dec": {k: [p.detach().clone() for p in decoder(m)] for k, m in unets.items()},
            "D": [p.detach().clone() for p in D.parameters()]}
    moved, phases, aux_all = [], [], []

    def changed(old, params):
        return any(not torch.equal(a, p) for a, p in zip(old, params))

    def on_step(step_idx, cur_nimg, aux):
        torch.cuda.synchronize()
        moved.append({**{k: changed(snap["dec"][k], decoder(m)) for k, m in unets.items()},
                      "D": changed(snap["D"], D.parameters())})
        snap["dec"] = {k: [p.detach().clone() for p in decoder(m)] for k, m in unets.items()}
        snap["D"] = [p.detach().clone() for p in D.parameters()]
        aux_all.append({k: float(v) for k, v in aux.items()})

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as run_dir, timed_fewshot_phases(torch, li, phases):
        cfg = li.InversionTrainConfig(run_dir=run_dir, batch_size=FEWSHOT_TRAIN_BATCH, lr=1e-4,
                                      weights=weights)
        li.train_fewshot(net, iter(clips), cfg, lpips, d_module=D, max_steps=N_FEWSHOT_TRAIN,
                         multiT=FEWSHOT_CURRICULUM, frm_per_chunk=FEWSHOT_TC,
                         fast_no_grad="fused", fast_grad="pallas", on_step=on_step, device=dev)
        torch.cuda.synchronize()
        launches = launch_counts()
        total_s = time.perf_counter() - t1
        snap_bytes = sum(os.path.getsize(os.path.join(run_dir, f)) for f in os.listdir(run_dir)
                         if f.startswith("snapshot-"))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    sched = [li.fewshot_phase_schedule(i, FEWSHOT_CURRICULUM, cfg.wd_reg_interval)
             for i in range(N_FEWSHOT_TRAIN)]
    expect_phases = [(ph, T, r1 and ph == "D") for _, T, r1 in sched
                     for ph in ("Ireal", "Igen", "D")]
    if [p[:3] for p in phases] != expect_phases:
        fail(f"train_fewshot ran the phases {[p[:3] for p in phases]}, expected {expect_phases}")
    expect = dict.fromkeys(KERNEL_COUNTERS, 0)
    step_ms, seen, timed = {}, set(), []  # by T, the steps whose T ran before
    for i, (unet, T, r1) in enumerate(sched):
        run = phases[3 * i:3 * i + 3]
        for ph, _, _, _, got in run:
            want = fewshot_expected(ph, T, FEWSHOT_TC, ("fused", "pallas"))
            if got != want:
                fail(f"step {i} ({ph}, T={T}) launched {got}, expected {want}")
            expect = {k: expect[k] + want[k] for k in expect}
        ms = [p[3] for p in run]
        if T in seen:
            step_ms.setdefault(T, []).append(sum(ms))
            timed.append(i)
        seen.add(T)
        print(f"[21] step {i}: T={T}, {unet} decoder; Ireal {ms[0]:.3f} ms + Igen {ms[1]:.3f} "
              f"ms + D{'+R1' if r1 else ''} {ms[2]:.3f} ms (host clock, synchronized); moved "
              f"{moved[i]}; " + " ".join(f"{k}={v:.6g}" for k, v in aux_all[i].items()))
        other = "tex" if unet == "tri" else "tri"
        if not (moved[i][unet] and not moved[i][other] and moved[i]["D"]):
            fail(f"step {i} trains the {unet} decoder and D: moved {moved[i]}")
        if not all(np.isfinite(v) for v in aux_all[i].values()):
            fail(f"step {i} gave a non-finite loss: {aux_all[i]}")
    for k, params in frozen.items():
        if changed(frozen0[k], params):
            fail(f"the frozen {k} moved")
    # a step is timed when its T has run before: first calls (cuDNN's
    # algorithm choices, allocations) fall in each T's first step
    warm = [p for i in timed for p in phases[3 * i:3 * i + 3]]
    by_phase = {}
    for ph, T, r1, ms, _ in warm:
        by_phase.setdefault(f"{ph} T={T}", []).append(ms)
    print(f"[21] few-shot training at flagship width, batch {FEWSHOT_TRAIN_BATCH}, 512²: "
          f"{N_FEWSHOT_TRAIN} steps of `train_fewshot` (fused / pallas, curriculum "
          f"{'/'.join(map(str, FEWSHOT_CURRICULUM))} in chunks of {FEWSHOT_TC}) in "
          f"{total_s:.1f} s with the final snapshot "
          f"({snap_bytes / 2 ** 30:.2f} GiB); steps {timed} (each T's repeats), ms/step by T: " +
          ", ".join(f"T={T} {np.mean(v):.3f} ({', '.join(f'{x:.3f}' for x in v)})"
                    for T, v in sorted(step_ms.items())) + "; per phase " +
          ", ".join(f"{k} {np.mean(v):.3f}" for k, v in by_phase.items()) +
          f" ms (host clock, synchronized); step 0's D with R1 {phases[2][3]:.3f} ms; peak "
          f"memory {peak:.3f} GiB on {card}; launches {launches}, expected {expect}")
    if launches != expect:
        fail(f"launches {launches} in {N_FEWSHOT_TRAIN} few-shot steps, expected {expect}")
    del net, D, clips, snap, frozen0, lpips
    return launches, checks


def uv_band(torch, tag, label, got, ref):
    """Two devices' UV maps [res, res, 3] within the driving-signal band:
    where either side covers a pixel, |card - CPU| <= 1e-4 on >= 99.9% of
    them and <= 1e-3 on all. Returns the largest difference."""
    got, ref = got.float().cpu(), ref.float().cpu()
    face = (got.abs().amax(dim=-1) > 0) | (ref.abs().amax(dim=-1) > 0)
    d = (got - ref).abs().amax(dim=-1)[face]
    close = (d <= 1e-4).float().mean().item() if face.any() else 0.0
    err = d.max().item() if face.any() else float("inf")
    if not (face.sum() > 1000 and close >= 0.999 and err <= 1e-3):
        fail(f"{label}: {int(face.sum())} face pixels, {close * 100:.4f}% within 1e-4, max "
             f"{err:.3e}: the card disagrees with the CPU")
    return err, close, int(face.sum())


def preprocess_phase(torch, dev, card):
    """Phase 22: dataset preparation (`data/preprocess.py`) on the card at the
    FaceVerse v3 mesh size, against the CPU."""
    import tempfile

    import numpy as np

    from invertavatar_torch.data import preprocess as pp
    from invertavatar_torch.faceverse.synthetic import COEFF_DIM, synthetic_manager, uv_model_dict

    t0 = time.perf_counter()
    mgr, _ = synthetic_manager(n_grid=173, seed=22, device=dev)
    mgr_cpu, _ = synthetic_manager(n_grid=173, seed=22, device="cpu")
    md = uv_model_dict(mgr.model.assets)
    V, F = md["uv_per_ver"].shape[0], len(md["tri"]) - 1
    if (V, F) != (29929, 59168):
        fail(f"the synthetic mesh has {V} vertices and {F} faces, expected 29929 and 59168")
    rng = np.random.RandomState(22)
    coeffs = (rng.randn(N_PREP_FRAMES, COEFF_DIM) * 0.1).astype(np.float32)
    # unit scale: the head ~100 pixels across the 512² frame
    coeffs[:, -1] = 1.0 + rng.randn(N_PREP_FRAMES) * 0.05
    frames = rng.rand(N_PREP_FRAMES, 3, 512, 512).astype(np.float32)
    vert_mask = np.ones(V, np.float32)
    K = pp.uv_camera_intrinsics()
    print(f"[22] synthetic FaceVerse model ({V} vertices, {F} faces, point_buf "
          f"{md['point_buf'].shape}), {N_PREP_FRAMES} seeded coefficient frames and 512² frames "
          f"in {time.perf_counter() - t0:.2f} s")
    with tempfile.TemporaryDirectory() as out_dir:
        paths = []
        for i, c in enumerate(coeffs):
            paths.append(os.path.join(out_dir, f"{i:05d}.npy"))
            np.save(paths[-1], c)
        orth = os.path.join(out_dir, "orthRender256x256_face_eye")
        uv_dir = os.path.join(out_dir, "uvRender256x256")
        os.makedirs(uv_dir)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pp.render_uvcoords_for_video(mgr, paths, orth)
        torch.cuda.synchronize()
        uvc_ms = (time.perf_counter() - t0) * 1e3 / N_PREP_FRAMES
        t0 = time.perf_counter()
        raster, mask = pp.build_uv_raster(md["uv_per_ver"], md["tri"], vert_mask, device=dev)
        torch.cuda.synchronize()
        raster_ms = (time.perf_counter() - t0) * 1e3
        frames_d = torch.from_numpy(frames).to(dev)
        pverts, texs = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            for i in range(N_PREP_FRAMES):
                pv = pp.uv_pverts_map(mgr.model, coeffs[i], raster, md["tri"], mask,
                                      md["point_buf"], K)
                texs.append(pp.uv_gttex_image(frames_d[i], pv))
                np.save(os.path.join(uv_dir, f"{i:05d}.npy"), pv.cpu().numpy().astype(np.float16))
                pverts.append(pv)
        torch.cuda.synchronize()
        uv_ms = (time.perf_counter() - t0) * 1e3 / N_PREP_FRAMES
        written = [np.load(os.path.join(d, f)) for d in (orth, uv_dir)
                   for f in sorted(os.listdir(d))]
    if len(written) != 2 * N_PREP_FRAMES or any(
            a.dtype != np.float16 or a.shape != (256, 256, 3) for a in written):
        fail(f"the prepared files are {[(a.dtype, a.shape) for a in written[:3]]}..., "
             f"expected {2 * N_PREP_FRAMES} fp16 [256, 256, 3]")
    print(f"[22] on the card: uvcoords (orthRender, .npy) {uvc_ms:.3f} ms/frame, the UV raster "
          f"once {raster_ms:.3f} ms, uv_pverts + uvgttex (+ .npy) {uv_ms:.3f} ms/frame (host "
          f"clock, synchronized, {N_PREP_FRAMES} frames; the first calls included) on {card}; "
          f"{len(written)} fp16 [256, 256, 3] files written")

    # the same frames on the CPU
    t0 = time.perf_counter()
    raster_c, mask_c = pp.build_uv_raster(md["uv_per_ver"], md["tri"], vert_mask, device="cpu")
    hit, hit_c = raster.face_id.cpu() >= 0, raster_c.face_id >= 0
    same = (raster.face_id.cpu() == raster_c.face_id).float().mean().item()
    print(f"[22] UV raster card vs CPU: coverage equal {bool(torch.equal(hit, hit_c))}, face ids "
          f"equal on {same * 100:.4f}% of pixels (>= 99.9%)")
    if not (np.array_equal(mask, mask_c) and torch.equal(hit, hit_c) and same >= 0.999):
        fail("the UV raster on the card disagrees with the CPU")
    worst, tex_worst, tex_same = 0.0, 0, 1.0
    with torch.no_grad():
        for i in range(N_PREP_FRAMES):
            pv_c = pp.uv_pverts_map(mgr_cpu.model, coeffs[i], raster_c, md["tri"], mask_c,
                                    md["point_buf"], K)
            err, close, n_face = uv_band(torch, "[22]", f"uv_pverts frame {i}", pverts[i], pv_c)
            worst = max(worst, err)
            tex_c = pp.uv_gttex_image(torch.from_numpy(frames[i]), pv_c)
            d = (texs[i].cpu().short() - tex_c.short()).abs()
            tex_worst = max(tex_worst, int(d.max()))
            tex_same = min(tex_same, (d == 0).float().mean().item())
    print(f"[22] uv_pverts card vs CPU over {N_PREP_FRAMES} frames: max|d| {worst:.3e} (<= 1e-3; "
          f">= 99.9% of face pixels within 1e-4, frame {N_PREP_FRAMES - 1}: {close * 100:.4f}% "
          f"of {n_face}); uvgttex equal on >= {tex_same * 100:.4f}% of pixels (>= 99.9%), max "
          f"{tex_worst} level (<= 1)")
    if tex_same < 0.999 or tex_worst > 1:
        fail("the uvgttex textures on the card disagree with the CPU")
    for i in (0, N_PREP_FRAMES - 1):
        compare_driving(torch, f"uvcoords frame {i}", mgr.make_driven_rendering(coeffs[i]),
                        mgr_cpu.make_driven_rendering(coeffs[i]), tag="[22]")
    print(f"[22] CPU side in {time.perf_counter() - t0:.1f} s")
    del mgr, mgr_cpu, raster, raster_c, pverts, texs, frames_d


def b1_sampler_check(torch, fr, card, tag, label, call):
    """B1's direct layout (rgb, sigma float32: the unmerged fused route)
    against its plain version on one recorded call, timed; returns (max |k -
    p|, ms, plain ms, bound ms, bound by)."""
    args, kw, out = call
    planes, grid, params = args[:3]
    with torch.inference_mode():
        ref = fr.fused_render_reference(*args, **kw)
        worst, bad = 0.0, 0
        for a, b in zip(out, ref):
            e = (a - b).abs()
            worst = max(worst, e.max().item())
            bad += int((e > 1e-4 * b.abs() + 1e-4).sum())
        N, H, W, C = planes.shape
        R, S = grid.shape[1], grid.shape[2]
        HID = params[0].shape[1]
        points = R * S
        print(f"{tag} B1 fused_render {label}: rgb {tuple(out[0].shape)}, sigma "
              f"{tuple(out[1].shape)} float32, {points} points; max|k-p| {worst:.3e}; tolerance "
              f"|k-p| <= 1e-4|p| + 1e-4 (float32 outputs), violations {bad}")
        if bad or not all(torch.isfinite(a).all() for a in out):
            fail(f"B1 ({label}) disagrees with its plain version")
        ms = device_ms(lambda: fr.fused_render(*args, **kw), "fused_render_kernel<")
        plain_ms = device_ms(lambda: fr.fused_render_reference(*args, **kw))
    # grid read, the bf16 payload read, rgb and sigma written in float32
    nbytes = grid.numel() * 4 + planes.numel() * 2 + points * (C + 1) * 4
    b, by = bound(nbytes, points * tap_flops_per_point(C), points * mlp_flops_per_point(C, HID))
    print(f"{tag} fused_render {label} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
          f"{b:.4f} ms ({by}; {nbytes / 1e6:.1f} MB) on {card}")
    return worst, ms, plain_ms, b, by


def gan_metrics_phase(torch, dev, card, fr, rmod):
    """Phase 23: FID at the GAN trainer's snapshot, with KID, precision and
    recall, IS and PPL on its features and generator. Returns (the kernels'
    launches in `train_gan`, {kernel: {label: (max |k - p|, ms, plain ms,
    bound ms, bound by)}} at the sampler's shapes)."""
    import json
    import tempfile

    import numpy as np

    from invertavatar_torch.flagship import SeededMetricDataset, standin_detector
    from invertavatar_torch.losses.lpips import LPIPS
    from invertavatar_torch.metrics.extra import compute_is, compute_ppl, compute_pr
    from invertavatar_torch.metrics.fid import (FeatureStats, compute_fid, compute_kid,
                                                make_vert_conditioned_sample_fn)
    from invertavatar_torch.train import gan as pg
    from invertavatar_torch.train.loop_gan import GANTrainConfig, train_gan

    t0 = time.perf_counter()
    G, D = gan_models(torch, dev, 23)
    ds = SeededMetricDataset(N_METRIC_ITEMS, 512, seed=23)
    detect = standin_detector(device=dev, seed=23)
    feats = []

    def detector(images_u8):  # keeps the features the metric saw
        f = detect(images_u8)
        feats.append(f)
        return f

    batches = [gan_batch(torch, dev, GAN_BATCH, 512, 512, 230 + i)
               for i in range(N_METRIC_GAN_STEPS)]
    torch.cuda.synchronize()
    print(f"[23] GAN models (phase 17's), a seeded metric dataset of {len(ds)} 512² items and "
          f"the seeded stand-in detector (not Inception) in {time.perf_counter() - t0:.2f} s")
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as run_dir:
        cfg = GANTrainConfig(run_dir=run_dir, batch_size=GAN_BATCH, kimg_per_tick=1000,
                             snapshot_images=False,
                             loss=pg.GANLossConfig(blur_init_sigma=10.0, blur_fade_kimg=200.0,
                                                   neural_rendering_resolution_initial=64,
                                                   neural_rendering_resolution_fade_kimg=1000))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, G_ema, nimg = train_gan(G, D, iter(batches), cfg, max_steps=N_METRIC_GAN_STEPS,
                                      metric_names=("fid64",), metric_dataset=ds,
                                      metric_detector_fn=detector, device=dev)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = launch_counts()
        with open(os.path.join(run_dir, "metric-fid64.jsonl")) as f:
            lines = f.read().strip().splitlines()
        with open(os.path.join(run_dir, "stats.jsonl")) as f:
            stats = json.loads(f.read().strip().splitlines()[-1])
        files = sorted(os.listdir(run_dir))
    entry = json.loads(lines[-1])
    fid = entry["results"]["fid64"]
    reported = stats.get("Metrics/fid64", {}).get("mean")
    print(f"[23] train_gan: {N_METRIC_GAN_STEPS} steps of batch {GAN_BATCH} and a snapshot with "
          f"fid64 in {total_s:.1f} s; metric-fid64.jsonl: fid64 {fid:.6g} in "
          f"{entry['total_time']:.3f} s (64 real and 64 generated 512² images, 64² neural "
          f"render); stats.jsonl Metrics/fid64 {reported}; run dir {files}")
    if len(lines) != 1 or reported != fid or not (np.isfinite(fid) and fid > 0):
        fail(f"the snapshot's fid64 is {fid} in {len(lines)} line(s), reported {reported}")
    if "metric-cache" not in files or not any(f.startswith("snapshot-") for f in files):
        fail(f"train_gan wrote {files}")
    # the sampler renders 2 B1 passes per image (coarse, fine): the GAN CLI's
    # det_stratified=False keeps the merged march (B2) off; the steps render
    # on the exact route
    expect = dict.fromkeys(KERNEL_COUNTERS, 0)
    expect["fused_render"] = 2 * N_METRIC_ITEMS
    print(f"[23] launches in train_gan {launches}, expected {expect}")
    if launches != expect or nimg != GAN_BATCH * N_METRIC_GAN_STEPS:
        fail(f"train_gan launched {launches} (expected {expect}) and counted {nimg} images")

    # the features the metric saw: 4 real batches of 16, then 8 generated of 8
    n_real = -(-N_METRIC_ITEMS // 16)
    real, gen = np.concatenate(feats[:n_real]), np.concatenate(feats[n_real:])
    if real.shape != gen.shape or len(real) != N_METRIC_ITEMS:
        fail(f"the metric saw features {real.shape} and {gen.shape}")
    real_stats, gen_stats = FeatureStats(), FeatureStats()
    real_stats.append(real)
    gen_stats.append(gen)
    self_fid = compute_fid(real_stats, real_stats)
    again = compute_fid(real_stats, gen_stats)
    kid = compute_kid(real, gen)
    pr = compute_pr(real, gen)
    probs = np.exp(gen * 4.0) / np.exp(gen * 4.0).sum(axis=1, keepdims=True)
    is_mean, is_std = compute_is(probs, num_splits=4)
    print(f"[23] on the same features: FID of the real statistics against themselves "
          f"{self_fid:.3e} (|.| <= 1e-6), FID again {again:.6g}, KID {kid:.6g}, precision "
          f"{pr['precision']:.4f} recall {pr['recall']:.4f}, IS of softmax(4·features) "
          f"{is_mean:.4f} ± {is_std:.4f}")
    if abs(self_fid) > 1e-6 or abs(again - fid) > 1e-9 * max(1.0, abs(fid)):
        fail(f"FID real vs real {self_fid}, recomputed {again} against {fid}")
    if not all(np.isfinite(v) for v in (kid, pr["precision"], pr["recall"], is_mean, is_std)):
        fail("a feature metric is not finite")

    # PPL on the EMA generator, LPIPS VGG on seeded weights
    torch.manual_seed(23)
    lpips = LPIPS("vgg").to(dev).eval()
    with torch.no_grad():  # LPIPS's heads weigh squared differences: non-negative
        for p in lpips.lin.parameters():
            p.abs_()
    uvc = torch.from_numpy(ds[0]["v"]["uvcoords_image"]).to(dev)[None]

    def mapping_fn(z, c):
        return G_ema.mapping(torch.from_numpy(z).to(dev), torch.from_numpy(c).to(dev))

    def synth_fn(w, c):  # both ends of a pair render with the same draws
        return G_ema.synthesis(torch.from_numpy(np.asarray(w, np.float32)).to(dev),
                               torch.from_numpy(c).to(dev),
                               {"uvcoords_image": uvc.expand(len(c), -1, -1, -1)},
                               evaluation=True, noise_mode="const",
                               generator=torch.Generator(device=dev).manual_seed(0))["image"]

    def lpips_fn(a, b):
        return torch.stack([lpips(a[i:i + 1], b[i:i + 1]) for i in range(len(a))])

    def c_sampler(n, rng):
        return np.stack([ds[int(i)]["c"] for i in rng.randint(len(ds), size=n)])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        ppl = compute_ppl(mapping_fn, synth_fn, lpips_fn, 512, c_sampler,
                          num_samples=N_PPL_SAMPLES, batch_size=N_PPL_SAMPLES)
    torch.cuda.synchronize()
    print(f"[23] PPL (w, endpoints, eps 1e-4) over {N_PPL_SAMPLES} samples with LPIPS VGG on "
          f"seeded weights: {ppl:.6g} in {time.perf_counter() - t0:.2f} s")
    if not (np.isfinite(ppl) and ppl >= 0):
        fail(f"PPL {ppl}")

    # the kernels at the sampler's shapes: one generated image's two B1 calls
    calls = []
    sample_fn = make_vert_conditioned_sample_fn(G_ema, 512, ds)
    with recording(rmod, "fused_render", calls):
        sample_fn(1, np.random.RandomState(23))
    torch.cuda.synchronize()
    if len(calls) != 2:
        fail(f"one sampled image made {len(calls)} B1 calls, expected 2 (coarse, fine)")
    checks = {"fused_render": {}, "fused_merged_march": {}}
    for call, label in zip(calls, ("coarse", "fine")):
        S = call[0][1].shape[2]
        checks["fused_render"][f"sampler {label}"] = b1_sampler_check(
            torch, fr, card, "[23]", f"GAN metric sampler, 64² rays, {label} S={S}", call)
    # B1 (raw layout) and B2 at the sampler's planes and ray grid, 48+48 merged
    # (the route with det_stratified on: 96 slots over 4,096 rays)
    planes = calls[0][0][0].permute(0, 3, 1, 2)[None].contiguous()
    records = render_kernel_checks(
        torch, fr, rmod, card, "GAN sampler's planes, 64² rays, 48+48 merged", ds[0]["c"][None],
        planes, G_ema.decoder, dict(G_ema.rendering_kwargs, det_stratified=True), 64,
        timed=True, tags=("[23]", "[23]"))
    for r in records:
        checks[r["name"]]["merged 48+48"] = (r["max_abs_err"], r["ms"], r["plain_ms"],
                                              r["bound_ms"], r["bound_by"])
    del G, D, G_ema, batches, calls, planes, lpips
    return launches, checks


def projector_phase(torch, dev, card, ps, rmod):
    """Phase 24: the W+ projector on the frozen flagship generator, B3 and its
    transpose carrying the render's gradient. Returns (the kernels' launches
    in `project_w_plus`, B3 / transpose checks at its shapes, plain and
    library times there)."""
    import numpy as np

    from invertavatar_torch.flagship import example_inputs, init_flagship
    from invertavatar_torch.flagship import training_generator_config
    from invertavatar_torch.inversion import project_w_plus
    from invertavatar_torch.losses.lpips import LPIPS
    from invertavatar_torch.models.triplane import TriPlaneGenerator
    from invertavatar_torch.train.fast_render import grad_overrides

    t0 = time.perf_counter()
    with torch.device(dev):
        G = TriPlaneGenerator(**training_generator_config())
    init_flagship(G, seed=24).eval().requires_grad_(False)
    torch.manual_seed(24)
    lpips = LPIPS("vgg").to(dev).eval()
    z, c, uvc = (torch.from_numpy(a).to(dev) for a in example_inputs(1, seed=24))
    mesh = {"uvcoords_image": uvc}
    overrides = grad_overrides("pallas")

    def synth_fn(ws, noise_bufs):  # the generator's own constant noise stays
        return G.synthesis(ws, c, mesh, noise_mode="const",
                           rendering_overrides=overrides)["image"]

    def mapping_fn(zz):
        return G.mapping(zz, c.expand(len(zz), -1))

    def feature_fn(img255):  # LPIPS VGG's unit-normalised taps, concatenated
        x = img255 / 127.5 - 1.0
        return torch.cat([f.flatten() for f in lpips.features((x - lpips.mean) / lpips.std)])

    # the target: the render of a seeded W+ code, a mapped z plus N(0, 0.1²) per
    # layer: with seeded random weights the mapping's output hardly depends on
    # z (spread ~1e-6 about a mean of ~1e-3), so a mapped z alone would be
    # the projector's starting point, w_avg
    npr = np.random.RandomState(24)
    with torch.no_grad():
        w_true = G.mapping(torch.from_numpy(npr.randn(1, 512).astype(np.float32)).to(dev), c)
        w_true = w_true + torch.from_numpy(
            (npr.randn(*w_true.shape) * PROJ_W_OFFSET).astype(np.float32)).to(dev)
        target = (synth_fn(w_true, {})[0] + 1.0) * 127.5
    torch.cuda.synchronize()
    print(f"[24] frozen float32 flagship generator (48+48 samples, 128² render, 512²), LPIPS "
          f"VGG on seeded weights and the target (the generator's render of a seeded w) in "
          f"{time.perf_counter() - t0:.2f} s")
    dists, stamps = [], []

    def on_step(i, dist, loss):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        dists.append(float(dist))

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    w_opt, _ = project_w_plus(synth_fn, mapping_fn, feature_fn, target, {},
                              num_ws=w_true.shape[1], z_dim=512, num_steps=N_PROJ_STEPS,
                              w_avg_samples=N_PROJ_W_AVG, initial_learning_rate=PROJ_LR,
                              on_step=on_step, device=dev)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_s = np.diff(stamps)
    expect = dict.fromkeys(KERNEL_COUNTERS, 0)
    # one grad-carrying render per step: B3 coarse and fine, their transposes
    expect["plane_sample"] = expect["plane_sample_transpose"] = 2 * N_PROJ_STEPS
    print(f"[24] project_w_plus: {N_PROJ_STEPS} steps, w_avg over {N_PROJ_W_AVG} samples, lr "
          f"{PROJ_LR}; feature distance {dists[0]:.6g} at step 0 -> {dists[-1]:.6g} at step "
          f"{N_PROJ_STEPS - 1} (<= half); {np.median(step_s[2:]):.4f} s/step (median of steps "
          f"2-{N_PROJ_STEPS - 1}; step 0 with the w statistics {step_s[0]:.3f} s; host clock, "
          f"synchronized), peak memory {peak:.3f} GiB on {card}; launches {launches}, "
          f"expected {expect}")
    if not (np.isfinite(dists).all() and dists[-1] <= 0.5 * dists[0]):
        fail(f"the projection's feature distance went {dists[0]} -> {dists[-1]}")
    if launches != expect or not torch.isfinite(w_opt).all():
        fail(f"project_w_plus launched {launches}, expected {expect}")
    calls, extra = [], {}
    with torch.no_grad(), recording(rmod, "sample_planes_windowed_cvjp", calls):
        synth_fn(w_opt, {})
    torch.cuda.synchronize()
    checks = b3_path_checks(torch, ps, card, "[24]", calls,
                            torch.Generator(device=dev).manual_seed(24), extra=extra)
    del G, lpips, calls, target, w_opt
    return launches, checks, extra


# ---------------------------------------------------------------- phase 25
#
# The card does not repeat a training run bit for bit: on an H100, two
# flagship GAN runs from the same weights and draws differ in step 0's
# forward by ~1e-5 and, after 3 steps, on most parameters by up to ~2·lr a
# step. So the first GAN step's comparisons are also made between two runs
# without a mesh, and a result passes when it meets a fixed bar (phase 16's
# and the CPU tests') or stays within twice the card's own repeat; where the
# repeat is bitwise, over a mesh of one rank, bitwise is required. The
# inversion paths are held at the fixed bars alone. The comparisons run the
# discriminators in float32: with bf16 blocks a batch split moves D's
# outputs by about a bf16 ulp (R1 by ~1e-3 relative on 2 ranks), which no
# float32 bar can tell from a fault; `train_gan` over the mesh keeps the
# bf16 blocks.

# each path's learning rate: Adam moves a parameter by up to ~lr a step
DP_LR = {"gan": 0.0025, "oneshot": 1e-4, "fewshot": 1e-4}


def _l1(a, b):
    return (a - b).abs().mean()


def dp_gan_setup(torch, dev, d_fp16_res=0):
    """Phase 17's GAN models (seed 25; D's top `d_fp16_res` resolutions in
    bf16) with their initial state, the loss configuration and a seeded
    global batch of `GAN_BATCH`."""
    from invertavatar_torch.train import gan as pg

    G, D = gan_models(torch, dev, 25, d_fp16_res)
    init = _states(torch, {"G": G, "D": D})
    cfg = pg.GANLossConfig(blur_init_sigma=10.0, blur_fade_kimg=200.0,
                           neural_rendering_resolution_initial=64,
                           neural_rendering_resolution_fade_kimg=1000)
    return G, D, init, cfg, gan_batch(torch, dev, GAN_BATCH, 512, 512, 250)


def dp_gan_step(torch, G, D, init, cfg, batch, mesh=None, regs=True, apply=False):
    """One GAN step from the state `init` (both regularisations with `regs`)
    on `batch` (the global batch; each rank keeps its rows): (metrics, the
    gradients {net: {name: grad}}, w_avg)."""
    from invertavatar_torch.parallel.mesh import local_batch
    from invertavatar_torch.train import gan as pg
    from invertavatar_torch.train.state import LazyRegAdam, TrainState

    for k, m in (("G", G), ("D", D)):
        m.load_state_dict(init[k])
    gs = TrainState(G, LazyRegAdam(G.parameters(), 0.0025, 0.0, 0.99, 1e-8, 4))
    ds = TrainState(D, LazyRegAdam(D.parameters(), 0.002, 0.0, 0.99, 1e-8, 16))
    step = pg.make_gan_train_step(G, D, cfg, 64, regs, regs, mesh=mesh)
    m = step(gs, ds, local_batch(mesh, batch, GAN_BATCH), pg.make_schedules(cfg, 0),
             torch.Generator(device=batch["z"].device).manual_seed(250), apply=apply)
    grads = {k: {n: p.grad.detach().clone() for n, p in net.named_parameters()}
             for k, net in (("G", G), ("D", D))}
    return ({k: float(v) for k, v in m.items()}, grads,
            G.backbone.mapping.w_avg.detach().clone())


def _grad_diff(got, ref):
    """{net: max |got - ref| over its gradients / its largest |ref| entry}."""
    return {net: max((got[net][k] - g).abs().max().item() for k, g in grads.items())
            / max(g.abs().max().item() for g in grads.values()) for net, grads in ref.items()}


def _loss_diff(got, ref):
    """{name: |got - ref| / (|ref| + 1e-6)} of two metric dicts."""
    return {k: abs(got[k] - v) / (abs(v) + 1e-6) for k, v in ref.items()}


def _within(label, got, repeat, bar, same_arithmetic=False):
    """Each entry of `got` within `bar` or twice the card's repeat; with
    `same_arithmetic` (a mesh of one rank), bitwise where the repeat is.
    Fails naming the first entry that is not."""
    bitwise = same_arithmetic and all(v == 0 for v in repeat.values())
    for k, v in got.items():
        if (bitwise and v != 0) or not (v <= bar or v <= 2 * repeat[k]):
            fail(f"{label}: {k} differs by {v:.3e} (bar {bar:.0e}; the card's repeat "
                 f"{repeat[k]:.3e})")


def dp_oneshot_run(torch, dev, run_dir, mesh=None):
    """`train_oneshot` at flagship width (phase 19's models and weights, seed
    25, D in float32) on seeded global batches of `ONESHOT_BATCH`, B3 +
    transpose on the student render: per-step aux and ms, the network and D,
    the launches, the first batch."""
    from invertavatar_torch.flagship import oneshot_train_batch, oneshot_train_models
    from invertavatar_torch.train import loop_inversion as li
    from invertavatar_torch.train.inversion import InversionLossWeights

    # phase 19's weights
    weights = InversionLossWeights(l1=1.0, lpips=0.0, id=0.0, raw_l1=1.0, tri=0.001,
                                   texture=0.001, adv=0.01)
    net, D = oneshot_train_models(d_cfg=dict(c_dim=25, img_resolution=512, img_channels=6,
                                             num_fp16_res=0), seed=25, device=dev)
    batches = [oneshot_train_batch(ONESHOT_BATCH, 512, seed=251 + i, device=dev)
               for i in range(DP_ONESHOT_STEPS)]
    cfg = li.InversionTrainConfig(run_dir=run_dir, batch_size=ONESHOT_BATCH, lr=1e-4,
                                  weights=weights)
    return _timed_run(torch, lambda on_step: li.train_oneshot(
        net, D, iter(batches), cfg, _l1, max_steps=DP_ONESHOT_STEPS, fast_igen_target="exact",
        fast_grad="pallas", on_step=on_step, device=dev, mesh=mesh)) + (
        {"net": net, "D": D}, batches[0])


def dp_fewshot_run(torch, dev, run_dir, mesh=None):
    """`train_fewshot` of phase 20's small networks (seed 25) on seeded global
    batches of `DP_RANKS` clips of 4 frames, curriculum `DP_FEWSHOT_CURRICULUM`
    in chunks of 2, no-grad renders on B1/B2 and the student on B3 + its
    transpose: per-step aux and ms, the network and D, the launches, the
    first clip batch."""
    from invertavatar_torch.flagship import fewshot_train_batch, fewshot_train_models
    from invertavatar_torch.train import loop_inversion as li
    from invertavatar_torch.train.inversion import InversionLossWeights

    # phase 20's weights, LPIPS as the L1 distance
    weights = InversionLossWeights(l1=1.0, lpips=1.0, id=0.0, raw_l1=1.0, tri=0.001,
                                   lr_lpips=1.0, adv=0.1)
    net, D = small_train_models(fewshot_train_models, 25, dev)
    clips = [fewshot_train_batch(DP_RANKS, 4, 256, z_dim=32, seed=252 + i, device=dev)
             for i in range(DP_FEWSHOT_STEPS)]
    cfg = li.InversionTrainConfig(run_dir=run_dir, batch_size=DP_RANKS, lr=1e-4, weights=weights)
    return _timed_run(torch, lambda on_step: li.train_fewshot(
        net, iter(clips), cfg, _l1, d_module=D, max_steps=DP_FEWSHOT_STEPS,
        multiT=DP_FEWSHOT_CURRICULUM, frm_per_chunk=2, fast_no_grad="fused", fast_grad="pallas",
        on_step=on_step, device=dev, mesh=mesh)) + ({"net": net, "D": D}, clips[0])


def _timed_run(torch, train):
    """`train(on_step)` with the launch counters from 0: (per-step metrics,
    per-step ms on the host clock, synchronized, the launches)."""
    times, metrics = [], []

    def on_step(step_idx, cur_nimg, m):
        torch.cuda.synchronize()
        times.append(time.perf_counter())
        metrics.append({k: float(v) for k, v in m.items()})

    reset_launch_counts()
    torch.cuda.synchronize()
    times.append(time.perf_counter())
    train(on_step)
    return metrics, [(b - a) * 1e3 for a, b in zip(times, times[1:])], launch_counts()


def dp_gan_train(torch, dev, run_dir, mesh):
    """`train_gan` over the mesh at flagship width for `DP_GAN_STEPS` steps on
    seeded global batches (coverage: the loop's replicate, shards, sync,
    replica check and snapshot): per-step metrics and ms, the launches."""
    from invertavatar_torch.train.loop_gan import GANTrainConfig, train_gan

    G, D, _, cfg, _ = dp_gan_setup(torch, dev, d_fp16_res=4)
    batches = [gan_batch(torch, dev, GAN_BATCH, 512, 512, 250 + i) for i in range(DP_GAN_STEPS)]
    tcfg = GANTrainConfig(run_dir=run_dir, batch_size=GAN_BATCH, snapshot_images=False, loss=cfg)
    return _timed_run(torch, lambda on_step: train_gan(
        G, D, iter(batches), tcfg, max_steps=DP_GAN_STEPS, on_step=on_step, device=dev,
        mesh=mesh))


def dp_expected():
    """Each rank's launches on phase 25b's three paths, counted from the
    code: none in the GAN step (training renders are not evaluation
    renders); B3 / transpose per one-shot phase as in phase 19 (per render
    call, whatever the batch); per few-shot phase as `fewshot_expected` (B1
    and B2 once per frame of the rank's one clip)."""
    from invertavatar_torch.train import loop_inversion as li

    per_phase = {"Ireal": (4, 2), "Igen": (6, 2), "Dreal": (4, 0), "Dgen": (6, 0)}
    oneshot = dict.fromkeys(KERNEL_COUNTERS, 0)
    for i in range(DP_ONESHOT_STEPS):
        i_ph, _, d_ph, _ = li.oneshot_phase_schedule(i)
        oneshot["plane_sample"] += per_phase[i_ph][0] + per_phase[d_ph][0]
        oneshot["plane_sample_transpose"] += per_phase[i_ph][1] + per_phase[d_ph][1]
    fewshot = dict.fromkeys(KERNEL_COUNTERS, 0)
    for i in range(DP_FEWSHOT_STEPS):
        _, T, _ = li.fewshot_phase_schedule(i, DP_FEWSHOT_CURRICULUM)
        for ph in ("Ireal", "Igen", "D"):
            for k, v in fewshot_expected(ph, T, 2, ("fused", "pallas")).items():
                fewshot[k] += v
    return {"gan": dict.fromkeys(KERNEL_COUNTERS, 0), "oneshot": oneshot, "fewshot": fewshot}


def _states(torch, modules):
    """{net: {name: tensor}} clones of the modules' parameters and buffers."""
    return {k: {n: t.detach().clone() for n, t in m.state_dict().items()}
            for k, m in modules.items()}


def _param_diff(torch, got, ref, lr):
    """{"max": max |got - ref|, "share": share of entries beyond lr/50} over
    every float tensor of {net: state}: Adam's bound as
    tests/test_torch_parallel.py holds it (every entry within 2·lr a step,
    all but 0.1% within lr/50)."""
    worst, n_bad, n = 0.0, 0, 0
    for net, st in ref.items():
        for name, r in st.items():
            if not r.is_floating_point():
                continue
            d = (got[net][name].to(r.device, r.dtype) - r).abs().float()
            worst = max(worst, d.max().item())
            n_bad += int((d > lr / 50).sum())
            n += d.numel()
    return {"max": worst, "share": n_bad / max(n, 1)}


def dp_rank_checks(torch, dev, tag, oneshot_net, oneshot_batch, fewshot_net, fewshot_clip):
    """One launch of each kernel of the rank's paths against its plain
    version at the rank's shapes (phases 3-4 and 8's tolerances): B3 and its
    transpose on a one-shot student render, B1 and B2 on a few-shot no-grad
    e4e render and B3 on its student render. Returns {kernel: max |k - p|}."""
    from invertavatar_torch.ops import fused_render as fr
    from invertavatar_torch.ops import plane_sample as ps
    from invertavatar_torch.render import renderer as rmod
    from invertavatar_torch.train.fast_render import grad_overrides, nograd_overrides

    gen = torch.Generator(device=dev).manual_seed(25)
    errs = {}
    card = torch.cuda.get_device_name(0)

    def b3_checks(calls, what):
        if len(calls) != 2:
            fail(f"{tag} a {what} render made {len(calls)} B3 calls, expected 2")
        for (args, _, out), label in zip(calls, ("coarse", "fine")):
            planes, grid = args
            e = b3_forward_check(torch, ps, tag, f"{what} {label}", planes, grid, out)
            cot = torch.randn((*grid.shape[:3], planes.shape[-1]), generator=gen, device=dev)
            e_t = transpose_check(torch, ps, f"{what} {label}", grid, cot, planes.shape, tag=tag)
            errs["plane_sample"] = max(errs.get("plane_sample", 0.0), e[torch.float32])
            errs["plane_sample_transpose"] = max(errs.get("plane_sample_transpose", 0.0), e_t)

    calls = []
    b = oneshot_batch
    with torch.no_grad(), recording(rmod, "sample_planes_windowed_cvjp", calls):
        oneshot_net({"image": b["image"], "uv": b["uv"]}, b["c"], b["v"],
                    nograd_render=nograd_overrides("exact"), grad_render=grad_overrides("pallas"))
    b3_checks(calls, "one-shot student")
    b = fewshot_clip
    b1_calls, b2_calls, b3_calls = [], [], []
    with torch.no_grad():
        ws = fewshot_net.encode(b["image"][:, 0, :3])
        tex, static = fewshot_net.backbone_feats(ws)
        with recording(rmod, "fused_render", b1_calls), \
                recording(rmod, "fused_merged_march", b2_calls):
            fewshot_net.multiT_chunk_inputs(b["image"][:, :1], b["c"][:, :1],
                                            {"uvcoords_image": b["v"]["uvcoords_image"][:, :1]},
                                            b["uv"][:, :1], ws, tex, static,
                                            nograd_render=nograd_overrides("fused"))
        with recording(rmod, "sample_planes_windowed_cvjp", b3_calls):
            fewshot_net.generator.synthesis_withTexture(
                ws, tex, b["c"][:, 0], {"uvcoords_image": b["v"]["uvcoords_image"][:, 0]},
                static_feats=static, noise_mode="const",
                rendering_overrides=grad_overrides("pallas"))
    if len(b1_calls) != 1 or len(b2_calls) != 1:
        fail(f"{tag} a no-grad e4e render made {len(b1_calls)} B1 and {len(b2_calls)} B2 calls")
    for k in fused_kernel_checks(torch, fr, card, "few-shot e4e render", b1_calls[0],
                                 b2_calls[0], timed=False, tags=(tag, tag)):
        errs[k["name"]] = k["max_abs_err"]
    b3_checks(b3_calls, "few-shot student")
    return errs


def dp_rank(mesh, ref_dir):
    """One rank of phase 25b (gloo, every rank on card 0): the first GAN step
    over the mesh (not applied; its gradients held on rank 0 against the
    one-process step's in `ref_dir`), `train_gan`, `train_oneshot` and
    `train_fewshot` over the mesh (replicas checked bitwise at each
    snapshot; rank 0 holds the trained parameters against the one-process
    runs'), then one launch of each kernel against its plain version.
    Returns the rank's metrics, times, peak memory, launches and checks."""
    import tempfile

    import torch

    from invertavatar_torch.parallel.mesh import replicate, shard_batch
    from invertavatar_torch.parallel.multihost import check_replica_consistency

    dev = mesh.device
    tag = f"[25b rank {mesh.rank}]"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}

    def ref(name):
        return torch.load(os.path.join(ref_dir, f"{name}.pt"), map_location=dev,
                          weights_only=True)

    out["negatives"] = dp_negative_cases(torch, mesh)
    G, D, init, cfg, batch = dp_gan_setup(torch, dev)
    replicate(mesh, G, D)
    m, grads, w_avg = dp_gan_step(torch, G, D, init, cfg, batch, mesh)
    check_replica_consistency(mesh, {"G": G, "D": D})
    if mesh.rank == 0:
        r = ref("gan_step")
        out["gan_step"] = {"grads": _grad_diff(grads, r["grads"]),
                           "w_avg": (w_avg - r["w_avg"]).abs().max().item()}
        del r
    out.setdefault("gan_step", {})["metrics"] = m
    del G, D, init, grads
    runs = (("gan", lambda d: dp_gan_train(torch, dev, d, mesh)),
            ("oneshot", lambda d: dp_oneshot_run(torch, dev, d, mesh)),
            ("fewshot", lambda d: dp_fewshot_run(torch, dev, d, mesh)))
    kept = {}
    for name, run in runs:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory() as run_dir:
            res = run(run_dir)
        metrics, ms, launches = res[:3]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        diff = None
        if name != "gan":
            modules = res[3]
            check_replica_consistency(mesh, modules)
            if mesh.rank == 0:
                diff = _param_diff(torch, _states(torch, modules), ref(name), DP_LR[name])
            kept[name] = (modules["net"], shard_batch(mesh, res[4]))
        out[name] = {"metrics": metrics, "ms": ms, "peak_gib": peak, "launches": launches,
                     "diff": diff}
        print(f"{tag} {name}: {len(ms)} steps, ms/step {', '.join(f'{x:.1f}' for x in ms)}; peak "
              f"{peak:.3f} GiB; launches {launches}; replicas bitwise equal", flush=True)
        del res
    out["checks"] = dp_rank_checks(torch, dev, tag, *kept["oneshot"], *kept["fewshot"])
    return out


def parallel_phases(torch, dev, card):
    """Phase 25: data parallelism on the one card. 25a: over an NCCL mesh of
    world size 1 in this process, the first flagship GAN step against the
    same step with no mesh (twice: the card's own repeat), the step time
    with and without the mesh in turns, and `train_gan` over the mesh. 25b:
    the first GAN step, `train_gan`, `train_oneshot` and `train_fewshot` on
    `DP_RANKS` spawned gloo ranks sharing the card, against one process at
    the global batch (the first GAN step twice). Returns {path: launches (25a) or each rank's
    launches (25b)}."""
    import datetime
    import tempfile

    import numpy as np

    from invertavatar_torch.parallel.multihost import initialize_distributed, spawn_ranks

    # ---------------------------------------------------------------- 25a
    t0 = time.perf_counter()
    G, D, init, cfg, batch = dp_gan_setup(torch, dev)
    with tempfile.TemporaryDirectory() as tmp:
        store = torch.distributed.FileStore(os.path.join(tmp, "store"), 1)
        mesh = initialize_distributed(rank=0, world_size=1, local_rank=dev.index or 0,
                                      device=dev, store=store,
                                      timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
        print(f"[25a] process group: backend {torch.distributed.get_backend()}, world size "
              f"{mesh.world_size}, device {mesh.device}")
        try:
            a, m, b = (dp_gan_step(torch, G, D, init, cfg, batch, mm)
                       for mm in (None, mesh, None))
            # the step time of phase 17's path (D's bf16 blocks) in turns (no
            # regularisation, applied): warm-up, then rounds of no mesh, mesh,
            # mesh, no mesh
            del G, D, init
            torch.cuda.empty_cache()
            G, D, init, cfg, batch = dp_gan_setup(torch, dev, d_fp16_res=4)
            ms = {"no mesh": [], "mesh": []}
            order = ["no mesh", "mesh"] * 2 + ["no mesh", "mesh", "mesh", "no mesh"] * 2
            for i, label in enumerate(order):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                dp_gan_step(torch, G, D, init, cfg, batch, mesh if label == "mesh" else None,
                            regs=False, apply=True)
                torch.cuda.synchronize()
                if i >= 4:
                    ms[label].append((time.perf_counter() - t1) * 1e3)
            del G, D, init
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            with tempfile.TemporaryDirectory() as run_dir:
                m_t, ms_t, l_t = dp_gan_train(torch, dev, run_dir, mesh)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        finally:
            torch.distributed.destroy_process_group()
    loss_m, loss_b = _loss_diff(m[0], a[0]), _loss_diff(b[0], a[0])
    grad_m, grad_b = _grad_diff(m[1], a[1]), _grad_diff(b[1], a[1])
    w_m, w_b = ((x[2] - a[2]).abs().max().item() for x in (m, b))
    print(f"[25a] the first GAN step (both regularisations, batch {GAN_BATCH}, D in float32) "
          f"over the NCCL mesh of 1 against no mesh: losses rel " +
          ", ".join(f"{k} {v:.2e}" for k, v in loss_m.items()) + "; gradients, of each "
          f"network's largest entry, " + ", ".join(f"{k} {v:.3e}" for k, v in grad_m.items()) +
          f"; w_avg {w_m:.3e}. The card's repeat without a mesh: losses rel " +
          ", ".join(f"{k} {v:.2e}" for k, v in loss_b.items()) + "; gradients " +
          ", ".join(f"{k} {v:.3e}" for k, v in grad_b.items()) + f"; w_avg {w_b:.3e}")
    _within("[25a] losses over the NCCL mesh of 1", loss_m, loss_b, 1e-4, True)
    _within("[25a] gradients over the NCCL mesh of 1", grad_m, grad_b, 1e-3, True)
    _within("[25a] w_avg over the NCCL mesh of 1", {"w_avg": w_m}, {"w_avg": w_b}, 1e-6, True)
    med = {k: float(np.median(v)) for k, v in ms.items()}
    print(f"[25a] GAN step without regularisation (phase 17's models), in turns: "
          f"{med['mesh']:.3f} ms over the mesh "
          f"({', '.join(f'{x:.1f}' for x in ms['mesh'])}), {med['no mesh']:.3f} without "
          f"({', '.join(f'{x:.1f}' for x in ms['no mesh'])}): "
          f"{(med['mesh'] / med['no mesh'] - 1) * 100:+.2f}% (host clock, synchronized, "
          f"median of {len(ms['mesh'])}) on {card}")
    print(f"[25a] train_gan over the NCCL mesh: {DP_GAN_STEPS} steps, ms/step "
          f"{', '.join(f'{x:.1f}' for x in ms_t)}; peak {peak:.3f} GiB; launches {l_t}; "
          f"25a took {time.perf_counter() - t0:.1f} s")
    if not all(np.isfinite(v) for x in m_t for v in x.values()):
        fail("train_gan over the NCCL mesh gave a non-finite loss")
    if l_t != dict.fromkeys(KERNEL_COUNTERS, 0):
        fail(f"the GAN path over the NCCL mesh launched {l_t}, expected none")
    del a, m, b

    # ---------------------------------------------------------------- 25b
    mark("25b")
    t0 = time.perf_counter()
    refs = {}
    with tempfile.TemporaryDirectory() as ref_dir:
        torch.cuda.empty_cache()
        G, D, init, cfg, batch = dp_gan_setup(torch, dev)
        a, b = (dp_gan_step(torch, G, D, init, cfg, batch) for _ in range(2))
        torch.save({"grads": a[1], "w_avg": a[2]}, os.path.join(ref_dir, "gan_step.pt"))
        refs["gan_step"] = a[0]
        rep = {"loss": _loss_diff(b[0], a[0]), "grads": _grad_diff(b[1], a[1]),
                               "w_avg": (b[2] - a[2]).abs().max().item()}
        del G, D, init, a, b
        for name, run in (("oneshot", dp_oneshot_run), ("fewshot", dp_fewshot_run)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            with tempfile.TemporaryDirectory() as run_dir:
                metrics, ms, _, modules, _ = run(torch, dev, run_dir)
            torch.save(_states(torch, modules), os.path.join(ref_dir, f"{name}.pt"))
            refs[name] = (metrics, ms, torch.cuda.max_memory_allocated() / 2 ** 30)
            del modules
            print(f"[25b] one process, {name}: ms/step {', '.join(f'{x:.1f}' for x in ms)}; peak "
                  f"{refs[name][2]:.3f} GiB on {card}", flush=True)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        with tempfile.TemporaryDirectory() as rank_dir:
            ranks = spawn_ranks(dp_rank, DP_RANKS, rank_dir, args=(ref_dir,), device="cuda:0",
                                backend="gloo", timeout_s=DP_TIMEOUT_S, threads=2)
        spawn_s = time.perf_counter() - t1
    for r, res in enumerate(ranks):
        neg = res["negatives"]
        print(f"[25b] rank {r}, negative cases: Collector.sync with the same count and other "
              f"names raised {neg['collector']!r}; a replica with two swapped entries raised "
              f"{neg['swap']!r}")
        if not (neg["collector"] and "ranks reported different names" in neg["collector"]
                and neg["swap"] and "replicas differ at lin.weight" in neg["swap"]):
            fail(f"[25b] rank {r}: a negative case did not raise")
    # the first GAN step: losses (the ranks' mean), gradients, w_avg
    loss = _loss_diff({k: float(np.mean([r["gan_step"]["metrics"][k] for r in ranks]))
                       for k in refs["gan_step"]}, refs["gan_step"])
    got = ranks[0]["gan_step"]
    print(f"[25b] the first GAN step (D in float32) on {DP_RANKS} gloo ranks of card 0 against "
          f"one process at batch {GAN_BATCH}: losses rel " + ", ".join(f"{k} {v:.2e}" for k, v in loss.items()) +
          "; gradients " + ", ".join(f"{k} {v:.3e}" for k, v in got["grads"].items()) +
          f"; w_avg {got['w_avg']:.3e}; the card's repeat: losses " +
          ", ".join(f"{k} {v:.2e}" for k, v in rep["loss"].items()) + "; gradients " +
          ", ".join(f"{k} {v:.3e}" for k, v in rep["grads"].items()) + f"; w_avg {rep['w_avg']:.3e}")
    _within("[25b] the first GAN step's losses", loss, rep["loss"], 1e-4)
    _within("[25b] the first GAN step's gradients", got["grads"], rep["grads"], 1e-3)
    _within("[25b] the first GAN step's w_avg", {"w_avg": got["w_avg"]}, {"w_avg": rep["w_avg"]},
            1e-6)
    expect = dp_expected()
    n_steps = {"gan": DP_GAN_STEPS, "oneshot": DP_ONESHOT_STEPS, "fewshot": DP_FEWSHOT_STEPS}
    for name in ("gan", "oneshot", "fewshot"):
        per_rank = [r[name] for r in ranks]
        line = (f"[25b] {name} on {DP_RANKS} gloo ranks of card 0: {n_steps[name]} steps, s/step by "
                f"rank " + "; ".join(', '.join(f'{x / 1e3:.3f}' for x in r['ms'])
                                     for r in per_rank) +
                f"; peak GiB by rank {', '.join(f'{r['peak_gib']:.3f}' for r in per_rank)}; "
                f"launches by rank {[r['launches'] for r in per_rank]}, expected {expect[name]} "
                f"each; replicas bitwise equal")
        if not all(np.isfinite(v) for r in per_rank for m in r["metrics"] for v in m.values()):
            fail(f"{name} on {DP_RANKS} ranks gave a non-finite loss")
        for r, res in enumerate(per_rank):
            if res["launches"] != expect[name]:
                fail(f"{name}, rank {r}: launches {res['launches']}, expected {expect[name]}")
        if name in refs:
            ref_m, ref_ms, ref_peak = refs[name]
            loss = {f"step {i} {k}": v for i, m in enumerate(ref_m) for k, v in _loss_diff(
                {k: float(np.mean([r["metrics"][i][k] for r in per_rank])) for k in m},
                m).items()}
            diff = per_rank[0]["diff"]
            line += (f"; against one process (s/step {', '.join(f'{x / 1e3:.3f}' for x in ref_ms)}, "
                     f"peak {ref_peak:.3f} GiB): losses rel max {max(loss.values()):.2e} (< 1e-4), "
                     f"parameters max {diff['max']:.3e} (Adam's bound "
                     f"{2 * DP_LR[name] * n_steps[name]:.3e}), share beyond lr/50 "
                     f"{diff['share']:.3e} (< 1e-3)")
            bad = [k for k, v in loss.items() if not v <= 1e-4]
            if bad:
                fail(f"[25b] {name}'s losses differ from one process beyond 1e-4: {bad}")
            if diff["max"] > 2 * DP_LR[name] * n_steps[name] or diff["share"] >= 1e-3:
                fail(f"[25b] {name}'s parameters differ from one process by {diff['max']:.3e} "
                     f"({diff['share']:.3e} beyond lr/50)")
        print(line + f" on {card}")
    print(f"[25b] kernel checks by rank (max |k-p|): {[r['checks'] for r in ranks]}; the ranks "
          f"took {spawn_s:.1f} s from spawn to exit; 25b took {time.perf_counter() - t0:.1f} s")
    return {"dp_world1_gan": l_t, **{f"dp_{name}": [r[name]["launches"] for r in ranks]
                                      for name in ("gan", "oneshot", "fewshot")}}


# ---------------------------------------------------------------- phase 26


def _rel(got, ref):
    """The largest |got - ref| over the largest |ref|."""
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def _host_ms(torch, fn, warmup=N_MODULE_WARMUP, n=N_MODULE_TIMED):
    """fn()'s median ms on the host clock, synchronized, after `warmup`
    calls; and fn()'s last result."""
    import numpy as np

    for _ in range(warmup):
        out = fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def sft_conditions(torch, backbone, device, seed, batch=1):
    """Seeded nonzero CS-SFT (scale, shift) pairs at every resolution of a
    backbone past 4², on half of each block's channels: scale 1 + N(0, 0.2²),
    shift N(0, 0.1²)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for res in backbone.block_resolutions[1:]:
        half = getattr(backbone, f"b{res}").conv1.weight.shape[1] // 2
        scale = 1 + 0.2 * torch.randn(batch, half, res, res, generator=gen)
        shift = 0.1 * torch.randn(batch, half, res, res, generator=gen)
        out[res] = (scale.to(device), shift.to(device))
    return out


def _bands(tag, label, got, ref):
    """Phase 5's bands on image_raw, image_depth and image."""
    for key, max_tol, mean_tol in FRAME_BANDS:
        e = (got[key].float() - ref[key].float()).abs()
        print(f"{tag} {label}: {key} max {e.max().item():.3e} (< {max_tol}) mean "
              f"{e.mean().item():.3e} (< {mean_tol})")
        if not (_finite(got[key]) and e.max() < max_tol and e.mean() < mean_tol):
            fail(f"{tag} {label} disagrees on {key}")


def _finite(t):
    return bool(t.float().isfinite().all())


def with_condition_phase(torch, dev, card, fr, rmod):
    """Phase 26a: `synthesis_withCondition` at flagship width with seeded
    CS-SFT conditions on both backbones. Returns B1 and B2's launches over
    the timed calls, and their checks at this path's shapes."""
    from invertavatar_torch.flagship import (FLAGSHIP_RENDERING_KWARGS, example_inputs,
                                             flagship_generator, init_flagship)
    from invertavatar_torch.models.triplane import TriPlaneGenerator

    t0 = time.perf_counter()
    z_np, c_np, uvc_np = example_inputs(1)
    G = init_flagship(flagship_generator(device="cuda"), seed=0)
    z, c, uvc = (torch.from_numpy(a).to(dev) for a in (z_np, c_np, uvc_np))
    mesh = {"uvcoords_image": uvc}
    conds = (sft_conditions(torch, G.texture_backbone.synthesis, dev, 261),
             sft_conditions(torch, G.backbone.synthesis, dev, 262))

    def call(g, ws_, c_, mesh_, cond=(None, None)):
        return g.synthesis_withCondition(ws_, c_, mesh_, texture_feats_conditions=cond[0],
                                         static_feats_conditions=cond[1], noise_mode="const",
                                         evaluation=True)

    with torch.inference_mode():
        ws = G.mapping(z, c)
        b1, b2 = [], []
        with recording(rmod, "fused_render", b1), recording(rmod, "fused_merged_march", b2):
            out_k = call(G, ws, c, mesh, conds)
        torch.cuda.synchronize()
        if len(b1) != 1 or len(b2) != 1:
            fail(f"[26a] a call made {len(b1)} B1 and {len(b2)} B2 calls, expected one each")
        checks = fused_kernel_checks(torch, fr, card, "synthesis_withCondition (flagship, "
                                     "CS-SFT)", b1[0], b2[0], timed=True, tags=("[26a]", "[26a]"))
        del b1, b2
        rk0 = G.rendering_kwargs
        G.rendering_kwargs = dict(rk0, pallas_exact=True)
        out_e = call(G, ws, c, mesh, conds)
        G.rendering_kwargs = rk0
        _bands("[26a]", "the kernel route against the exact route (pallas_exact) on the card",
               out_k, out_e)
        plain = call(G, ws, c, mesh)
        moved = {k: _rel(out_k[k], plain[k]) for k in ("triplane", "image_raw", "image")}
        print(f"[26a] the conditions move, of each output's largest magnitude: " +
              ", ".join(f"{k} {v:.3e}" for k, v in moved.items()))
        if not moved["triplane"] > 1e-3:
            fail("[26a] the CS-SFT conditions do not move the tri-planes")
        del plain
        _bands("[26a]", "no conditions against `synthesis`", call(G, ws, c, mesh),
               G.synthesis(ws, c, mesh, noise_mode="const", evaluation=True))
        del out_e
        reset_launch_counts()
        ms, out = _host_ms(torch, lambda: call(G, ws, c, mesh, conds), N_COND_WARMUP,
                           N_COND_TIMED)
        launches = launch_counts()
    n_calls = N_COND_WARMUP + N_COND_TIMED
    expect = {"fused_render": n_calls, "fused_merged_march": n_calls, "plane_sample": 0,
              "plane_sample_transpose": 0}
    img = out["image"]
    print(f"[26a] synthesis_withCondition at flagship width (B=1, 40+24 samples, seeded CS-SFT "
          f"at every resolution of both backbones): {ms:.3f} ms per call (host clock, "
          f"synchronized, median of {N_COND_TIMED} after {N_COND_WARMUP}) on {card}; image "
          f"{tuple(img.shape)} mean {img.float().mean().item():.4f}; launches {launches}, "
          f"expected {expect}")
    if tuple(img.shape) != (1, 3, 512, 512) or not _finite(img):
        fail("[26a] the image is not a finite [1, 3, 512, 512]")
    if launches != expect:
        fail(f"[26a] launches {launches} in {n_calls} calls, expected {expect}")
    del G, out, out_k, ws, conds
    torch.cuda.empty_cache()

    # the small configuration on the card against the CPU (plain versions)
    small = dict(SMALL_FRAME_CFG, rendering_kwargs=dict(FLAGSHIP_RENDERING_KWARGS,
                                                        **SMALL_FRAME_RK))
    torch.manual_seed(1)
    g_cpu = init_flagship(TriPlaneGenerator(**small).eval(), seed=1)
    g_gpu = TriPlaneGenerator(**small).eval().to(dev)
    g_gpu.load_state_dict(g_cpu.state_dict())
    outs = []
    for g, d in ((g_gpu, dev), (g_cpu, torch.device("cpu"))):
        with torch.inference_mode():
            ws = g.mapping(torch.from_numpy(z_np[:, :32]).to(d), torch.from_numpy(c_np).to(d))
            cond = (sft_conditions(torch, g.texture_backbone.synthesis, d, 263),
                    sft_conditions(torch, g.backbone.synthesis, d, 264))
            o = call(g, ws, torch.from_numpy(c_np).to(d),
                     {"uvcoords_image": torch.from_numpy(uvc_np).to(d)}, cond)
        outs.append({k: v.float().cpu() for k, v in o.items() if torch.is_tensor(v)})
    _bands("[26a]", "small configuration with CS-SFT, card against the CPU", *outs)
    print(f"[26a] took {time.perf_counter() - t0:.1f} s")
    return launches, checks


def _grads_rel(got, ref):
    """max |got - ref| over the largest |ref| entry, of all the gradients."""
    scale = max(g.abs().max().item() for g in ref.values())
    return max((got[k] - ref[k]).abs().max().item() for k in ref) / scale


def remat_phase(torch, dev, card):
    """Phase 26b: `remat_stages` off, on and off again from the same weights
    and draws on phase 10's e4e step and on phase 19's one-shot Ireal phase:
    losses and gradients, launches against the counts from the code, peak
    memory and ms/step. Returns {path: launches over its timed steps}."""
    import numpy as np

    from invertavatar_torch.flagship import (flagship_inversion_net, oneshot_train_batch,
                                             oneshot_train_models)
    from invertavatar_torch.train import loop_inversion as li
    from invertavatar_torch.train.inversion import InversionLossWeights
    from invertavatar_torch.train.state import TrainState

    def run(label, prepare, step, grads_of, per_step):
        """(losses, gradients, ms/step, peak GiB, launches) of one setting:
        one step for the comparison (its gradients kept on the host, out of
        the next setting's peak), then `N_REMAT_TIMED` timed steps."""
        results = {}
        for setting, remat in (("off", False), ("on", True), ("off again", False)):
            prepare(remat)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            aux = {k: float(v) for k, v in step().items()}
            grads = grads_of()
            reset_launch_counts()
            ms, _ = _host_ms(torch, step, 0, N_REMAT_TIMED)
            launches = launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            results[setting] = (aux, grads, ms, peak, launches)
            b3, b3t = per_step(remat)
            expect = {"fused_render": 0, "fused_merged_march": 0,
                      "plane_sample": b3 * N_REMAT_TIMED,
                      "plane_sample_transpose": b3t * N_REMAT_TIMED}
            print(f"[26b] {label}, remat_stages {setting}: {ms:.3f} ms/step (host clock, "
                  f"synchronized, median of {N_REMAT_TIMED}); peak {peak:.3f} GiB on {card}; "
                  f"launches {launches}, expected {expect}; " +
                  " ".join(f"{k}={v:.7g}" for k, v in aux.items()))
            if launches != expect:
                fail(f"[26b] {label}, remat_stages {setting}: launches {launches}, expected "
                     f"{expect}")
            if not all(np.isfinite(v) for v in aux.values()):
                fail(f"[26b] {label}, remat_stages {setting}: a non-finite loss")
        (a_on, g_on), (a_off, g_off), (a_rep, g_rep) = (
            results[k][:2] for k in ("on", "off", "off again"))
        # relative to each loss, or to 1e-3 for a smaller one: the e4e step's
        # Igen/raw_l1 (~2e-7) is the float32 noise of two near-equal renders
        loss = {k: abs(a_on[k] - a_off[k]) / max(abs(a_off[k]), 1e-3) for k in a_off}
        loss_rep = {k: abs(a_rep[k] - a_off[k]) / max(abs(a_off[k]), 1e-3) for k in a_off}
        grad, grad_rep = _grads_rel(g_on, g_off), _grads_rel(g_rep, g_off)
        print(f"[26b] {label}: remat_stages on against off: losses rel max "
              f"{max(loss.values()):.3e}, gradients {grad:.3e} of the largest entry; the card's "
              f"repeat (off again): losses {max(loss_rep.values()):.3e}, gradients "
              f"{grad_rep:.3e}; peak {results['off'][3]:.3f} -> {results['on'][3]:.3f} GiB, "
              f"{results['off'][2]:.3f} -> {results['on'][2]:.3f} ms/step on {card}")
        _within(f"[26b] {label}'s losses with remat_stages", loss, loss_rep, 1e-4)
        _within(f"[26b] {label}'s gradients with remat_stages", {"grads": grad},
                {"grads": grad_rep}, 1e-3)
        return {setting: r[4] for setting, r in results.items()}

    t0 = time.perf_counter()
    launches = {}
    # phase 10's e4e step: B=1, the Igen target on B3, the students on B3 +
    # transpose; with remat_stages each grad-carrying B3 forward (one per
    # transpose) runs again in the recompute
    net = flagship_inversion_net(device=dev)
    batch = e4e_batch(torch, dev, 512, 512)
    sd0 = {k: v.clone() for k, v in net.state_dict().items()}
    wd_sd0 = {}
    st = {}

    def prepare_e4e(remat):
        net.load_state_dict(sd0)
        net.generator.rendering_kwargs["remat_stages"] = remat
        st["state"], st["wd"] = e4e_states(torch, net)
        if wd_sd0:
            st["wd"].module.load_state_dict(wd_sd0)
        else:
            wd_sd0.update({k: v.clone() for k, v in st["wd"].module.state_dict().items()})
        st["step"] = li.make_e4e_grad_programs(net, l1_distance, None, e4e_weights(),
                                               fast_igen_target="exact", fast_grad="pallas")

    launches["e4e"] = run(
        "phase 10's e4e step (B=1)", prepare_e4e,
        lambda: st["step"](st["state"], st["wd"], batch, do_wd_reg=False),
        lambda: {k: p.grad.detach().cpu() for k, p in net.encoder.named_parameters()
                 if p.grad is not None},
        lambda remat: (B3_PER_STEP + (B3T_PER_STEP if remat else 0), B3T_PER_STEP))
    net.generator.rendering_kwargs.pop("remat_stages")
    del net, batch, sd0, st
    torch.cuda.empty_cache()

    # phase 19's one-shot Ireal phase (batch 2, the tri-plane U-Net), the
    # student render's draws from one seeded generator in every setting
    weights = InversionLossWeights(l1=1.0, lpips=0.0, id=0.0, raw_l1=1.0, tri=0.001,
                                   texture=0.001, adv=0.01)
    net, D = oneshot_train_models(seed=19, device=dev)
    batch = oneshot_train_batch(ONESHOT_BATCH, 512, seed=190, device=dev)
    sd0 = {k: v.clone() for k, v in net.state_dict().items()}
    dsd0 = {k: v.clone() for k, v in D.state_dict().items()}
    st = {}

    def prepare_oneshot(remat):
        net.load_state_dict(sd0)
        D.load_state_dict(dsd0)
        net.generator.rendering_kwargs["remat_stages"] = remat
        st["state"] = TrainState(net, li.masked_adam(net, 1e-4, li.oneshot_tri_trainable))
        st["d"] = TrainState(D, torch.optim.Adam(D.parameters(), lr=2e-4))
        st["step"] = li.make_oneshot_train_step(net, l1_distance, None, weights,
                                                fast_igen_target="exact", fast_grad="pallas")

    launches["oneshot_ireal"] = run(
        f"phase 19's one-shot Ireal phase (batch {ONESHOT_BATCH})", prepare_oneshot,
        lambda: st["step"](st["state"], st["d"], batch, phase="Ireal", do_r1=False,
                           generator=torch.Generator(device=dev).manual_seed(26)),
        lambda: {k: p.grad.detach().cpu() for k, p in net.named_parameters()
                 if p.grad is not None and p.requires_grad},
        lambda remat: (4 + (2 if remat else 0), 2))
    net.generator.rendering_kwargs.pop("remat_stages")
    del net, D, batch, sd0, dsd0, st
    torch.cuda.empty_cache()
    print(f"[26b] took {time.perf_counter() - t0:.1f} s")
    return launches


def _card_vs_cpu(torch, dev, tag, label, build, inputs, fn, tol):
    """`build()`'s module (seeded, on the CPU) and its copy on the card, each
    through `fn(module, *inputs on its device)`: the outputs (tensors, or a
    tuple of them) within `tol` of their largest magnitude."""
    m_cpu = build("cpu").eval()
    m_gpu = build(dev).eval()
    m_gpu.load_state_dict(m_cpu.state_dict())
    with torch.inference_mode():
        got = fn(m_gpu, *(x.to(dev) for x in inputs))
        ref = fn(m_cpu, *inputs)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    errs = [_rel(a, b) for a, b in zip(got, ref)]
    print(f"{tag} {label}, card against the CPU: rel {', '.join(f'{e:.3e}' for e in errs)} "
          f"(< {tol:.0e})")
    if not all(_finite(a) for a in got) or not max(errs) < tol:
        fail(f"{tag} {label} on the card disagrees with the CPU")


def later_modules_phase(torch, dev, card):
    """Phases 26c-26d: the StyleGAN3 generator at a published configuration,
    DeepLabV3+ at 512², the MoCo and CX losses, the video discriminators at
    512², each finite and timed, and each at a small size on the card against
    the CPU."""
    from invertavatar_torch.losses.contextual import CXLoss
    from invertavatar_torch.losses.moco import MocoLoss
    from invertavatar_torch.models import segmentation as seg
    from invertavatar_torch.models.discriminator import (FusionVideoDiscriminator,
                                                          VideoDiscriminator)
    from invertavatar_torch.models.stylegan3 import SG3Generator

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(26)

    def seeded(build, seed):
        def make(device):
            torch.manual_seed(seed)
            return build(device)
        return make

    def timed(tag, label, module, inputs, fn, shape):
        with torch.inference_mode():
            ms, out = _host_ms(torch, lambda: fn(module, *inputs))
        outs = out if isinstance(out, tuple) else (out,)
        print(f"{tag} {label}: {ms:.3f} ms per call (host clock, synchronized, median of "
              f"{N_MODULE_TIMED} after {N_MODULE_WARMUP}) on {card}; output "
              f"{[tuple(o.shape) for o in outs]}")
        if tuple(outs[0].shape) != shape or not all(_finite(o) for o in outs):
            fail(f"{tag} {label}: not a finite {shape}")
        return ms

    # ---------------------------------------------------------------- 26c
    G = seeded(lambda d: SG3Generator(**SG3_T_1024, device=d), 26)(dev).eval()
    z = torch.randn(1, SG3_T_1024["z_dim"], generator=gen).to(dev)
    res = SG3_T_1024["img_resolution"]
    timed("[26c]", f"SG3Generator, stylegan3-t FFHQ-1024 ({SG3_T_1024}, "
          f"{sum(p.numel() for p in G.parameters()) / 1e6:.1f} M parameters), B=1", G, (z,),
          lambda m, z_: m(z_, None), (1, 3, res, res))
    del G
    _card_vs_cpu(torch, dev, "[26c]", "SG3Generator, the tests' 32² configuration",
                 seeded(lambda d: SG3Generator(**SG3_SMALL, device=d), 27),
                 (torch.randn(2, 16, generator=gen),), lambda m, z_: m(z_, None), 1e-4)
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 26d
    m = seeded(lambda d: seg.deeplabv3plus_resnet50(num_classes=21, device=d), 28)(dev).eval()
    timed("[26d]", f"DeepLabV3+ on ResNet-50, 21 classes, output stride 8, {DEEPLAB_RES}², B=1",
          m, (torch.rand(1, 3, DEEPLAB_RES, DEEPLAB_RES, generator=gen).to(dev),),
          lambda m_, x: m_(x)["out"], (1, 21, DEEPLAB_RES, DEEPLAB_RES))
    del m
    for name in ("deeplabv3_resnet50", "deeplabv3plus_resnet50"):
        _card_vs_cpu(torch, dev, "[26d]", f"{name} at 64²",
                     seeded(lambda d, n=name: getattr(seg, n)(num_classes=7, device=d), 29),
                     (torch.rand(2, 3, 64, 64, generator=gen),),
                     lambda m_, x: (m_(x)["out"], m_(x)["low_level"]), 1e-4)
    moco = seeded(lambda d: MocoLoss(device=d), 30)(dev)
    imgs = tuple(torch.rand(2, 3, MOCO_RES, MOCO_RES, generator=gen).to(dev) for _ in range(3))
    timed("[26d]", f"MocoLoss (ResNet-50 at 224², 3 {MOCO_RES}² images of batch 2)", moco, imgs,
          lambda m_, *x: m_(*x), ())
    del moco
    _card_vs_cpu(torch, dev, "[26d]", "MocoLoss features of 64² images",
                 seeded(lambda d: MocoLoss(device=d), 31),
                 (torch.rand(2, 3, 64, 64, generator=gen),), lambda m_, x: m_.extract_feats(x),
                 1e-4)
    cx = seeded(lambda d: CXLoss(device=d), 32)(dev)
    pair = tuple(torch.rand(1, 3, CX_RES, CX_RES, generator=gen).to(dev) for _ in range(2))
    timed("[26d]", f"CXLoss on a {CX_RES}² pair (above 256² resized to 256²: VGG19 relu3_4 at "
          "64², a 4096 x 4096 affinity)", cx, pair, lambda m_, x, y: m_(x, y), ())
    del cx
    _card_vs_cpu(torch, dev, "[26d]", "CXLoss on a 64² pair",
                 seeded(lambda d: CXLoss(device=d), 33),
                 tuple(torch.rand(1, 3, 64, 64, generator=gen) for _ in range(2)),
                 lambda m_, x, y: m_(x, y), 1e-4)
    B, T = 2, 2
    frames = torch.rand(B * T, 3, VIDEO_RES, VIDEO_RES, generator=gen).to(dev) * 2 - 1
    Ts = torch.tensor([[0.0, 3.0], [5.0, 6.0]], device=dev)
    cams = torch.randn(B, T, 25, generator=gen).to(dev)
    for cls in (VideoDiscriminator, FusionVideoDiscriminator):
        d = seeded(lambda d_, c=cls: c(c_dim=25, img_resolution=VIDEO_RES, img_channels=3,
                                        device=d_), 34)(dev).eval()
        timed("[26d]", f"{cls.__name__} at {VIDEO_RES}², {B} videos of T={T}, bf16 top 4 "
              "resolutions",
              d, ({"image": frames}, Ts, cams), lambda m_, i, t, c: m_(i, t, c), (B, 1))
        del d
        small = (torch.rand(B * T, 3, 32, 32, generator=gen) * 2 - 1, Ts.cpu(),
                 torch.randn(B, T, 25, generator=gen))
        _card_vs_cpu(torch, dev, "[26d]", f"{cls.__name__} at 32²",
                     seeded(lambda d_, c=cls: c(**VIDEO_SMALL, device=d_), 35), small,
                     lambda m_, x, t, c: m_({"image": x}, t, c), 1e-4)
    del frames, cams
    torch.cuda.empty_cache()
    print(f"[26c-d] took {time.perf_counter() - t0:.1f} s")


def tensorboard_phase(torch, dev, card):
    """Phase 26e: whether `torch.utils.tensorboard` imports here, and one
    `train_gan` tick of phase 16's tiny models: its `stats.jsonl` and, with
    the sink, its event file holding the same means."""
    import glob
    import tempfile

    from invertavatar_torch.models.discriminator import DualDiscriminator
    from invertavatar_torch.models.triplane import TriPlaneGenerator
    from invertavatar_torch.train import gan as pg
    from invertavatar_torch.train.loop_gan import GANTrainConfig, train_gan

    try:
        from torch.utils.tensorboard import SummaryWriter  # noqa: F401
        why = None
    except Exception as e:  # the optional sink's import, reported
        why = f"{type(e).__name__}: {e}"
    print(f"[26e] torch.utils.tensorboard " + ("imports: the sink is on" if why is None else
                                                f"does not import ({why}): no sink"))
    rk = {"superresolution_module": "x.SuperresolutionHybrid2X", "c_gen_conditioning_zero": False,
          "c_scale": 1.0, "superresolution_noise_mode": "random", "density_reg": 0.25,
          "density_reg_p_dist": 0.004, "reg_type": "l1", "decoder_lr_mul": 1.0,
          "sr_antialias": True, "depth_resolution": 8, "depth_resolution_importance": 8,
          "box_warp": 1.0, "det_stratified": False}
    torch.manual_seed(26)
    with torch.device(dev):
        G = TriPlaneGenerator(z_dim=32, c_dim=25, w_dim=512, img_resolution=128, img_channels=3,
                              rendering_kwargs=rk, neural_rendering_resolution=32,
                              channel_base=1024, channel_max=64, map_num_layers=2)
        D = DualDiscriminator(c_dim=25, img_resolution=128, img_channels=6, channel_base=1024,
                              channel_max=64, num_fp16_res=0)
    batch = gan_batch(torch, dev, 2, 128, 32, 26)
    with tempfile.TemporaryDirectory() as run_dir:
        cfg = GANTrainConfig(run_dir=run_dir, batch_size=2, snapshot_images=False,
                             loss=pg.GANLossConfig(neural_rendering_resolution_initial=32,
                                                   neural_rendering_resolution_final=None))
        train_gan(G, D, iter([batch]), cfg, max_steps=1, device=dev)
        with open(os.path.join(run_dir, "stats.jsonl")) as f:
            (entry,) = [json.loads(line) for line in f]
        names = sorted(k for k in entry if k not in ("step", "timestamp"))
        events = glob.glob(os.path.join(run_dir, "events.out.tfevents.*"))
        if why is not None:
            print(f"[26e] one train_gan tick: stats.jsonl holds {len(names)} names; event files "
                  f"{len(events)} (expected none)")
            if events:
                fail("[26e] an event file without the sink")
            return
        from tensorboard.backend.event_processing import event_accumulator

        acc = event_accumulator.EventAccumulator(run_dir)
        acc.Reload()
        worst = 0.0
        for name in names:
            (ev,) = acc.Scalars(name)
            mean = entry[name]["mean"]
            worst = max(worst, abs(ev.value - mean) / max(abs(mean), 1e-30))
            if ev.step != entry["step"]:
                fail(f"[26e] {name} at step {ev.step}, stats.jsonl at {entry['step']}")
        print(f"[26e] one train_gan tick: {len(events)} event file, {len(names)} names, each "
              f"mean as in stats.jsonl to {worst:.3e} relative (< 1e-6, float32 events)")
        if len(events) != 1 or sorted(acc.Tags()["scalars"]) != names or not worst < 1e-6:
            fail("[26e] the TensorBoard event file does not hold stats.jsonl's means")


def dp_negative_cases(torch, mesh):
    """Phase 25b's negative cases on every rank: `Collector.sync` with the
    same count and other names on each rank, and `check_replica_consistency`
    on a `Linear` whose last rank swapped two weight entries (equal sums).
    Returns the text each raised, or None."""
    from invertavatar_torch.parallel.multihost import check_replica_consistency
    from invertavatar_torch.utils.stats import Collector

    out = {}
    col = Collector()
    col.report(f"Loss/rank{mesh.rank}", 1.0)
    try:
        col.sync()
        out["collector"] = None
    except RuntimeError as e:
        out["collector"] = str(e)
    torch.manual_seed(0)
    lin = torch.nn.Linear(4, 3).to(mesh.device)
    if mesh.rank == mesh.world_size - 1:
        with torch.no_grad():
            w = lin.weight.view(-1)
            w[[0, 5]] = w[[5, 0]].clone()
    try:
        check_replica_consistency(mesh, {"lin": lin})
        out["swap"] = None
    except AssertionError as e:
        out["swap"] = str(e)
    return out


# ---------------------------------------------------------------- phase 27


def sphere_mesh(n_lat, n_lon, seed):
    """A UV sphere scaled to a head in the Next3D ortho window (the tests'
    stand-in for FLAME: no FLAME asset is in the repository), its topology
    with an all-ones face mask, and [1, V + 68, 3] vertices whose last 68
    rows (seeded vertex picks) stand in for the landmarks."""
    import numpy as np

    from invertavatar_torch.models.next3d import make_topology

    lat = np.linspace(0.12, np.pi - 0.12, n_lat)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    th, ph = np.meshgrid(lat, lon, indexing="ij")
    verts = np.stack([np.sin(th) * np.sin(ph), np.cos(th), np.sin(th) * np.cos(ph)],
                     axis=-1).reshape(-1, 3).astype(np.float32) * np.float32(0.12)
    jj, ii = np.meshgrid(np.arange(n_lon), np.arange(n_lat), indexing="xy")
    uvs = np.stack([jj / n_lon, ii / (n_lat - 1)], axis=-1).reshape(-1, 2).astype(np.float32)
    i, j = np.meshgrid(np.arange(n_lat - 1), np.arange(n_lon), indexing="ij")
    a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
    c, d = a + n_lon, b + n_lon
    faces = np.stack([np.stack([a, b, c], -1), np.stack([b, d, c], -1)], axis=2)
    faces = faces.reshape(-1, 3).astype(np.int32)
    topo = make_topology(uvs, faces, faces, np.ones((1, 256, 256, 1), np.float32),
                         n_verts=len(verts))
    lms = verts[np.random.RandomState(seed).choice(len(verts), 68)]
    return topo, np.concatenate([verts, lms], axis=0)[None]


def faces_per_tile_by_view(torch, topo, v, tile=32, res=256):
    """The largest count of candidate faces (bbox members, front-facing, on
    screen: the rasterizer's "sort" binning before its cap) in any 32² tile
    of each of the four Next3D ortho views."""
    from invertavatar_torch.models.next3d import _VIEWS_DEG, _angle2matrix_np, transform_to_view

    faces = torch.from_numpy(topo.faces.astype("int64"))
    verts = torch.from_numpy(v[:, :topo.n_verts])
    out = []
    for view in _VIEWS_DEG:
        tv = transform_to_view(verts, torch.from_numpy(_angle2matrix_np(view)))[0]
        px, py = (tv[:, 0] + 1) / 2 * res, (tv[:, 1] + 1) / 2 * res
        tx, ty = px[faces], py[faces]
        area2 = ((tx[:, 1] - tx[:, 0]) * (ty[:, 2] - ty[:, 0])
                 - (tx[:, 2] - tx[:, 0]) * (ty[:, 1] - ty[:, 0]))
        lo_x, hi_x, lo_y, hi_y = tx.amin(1), tx.amax(1), ty.amin(1), ty.amax(1)
        valid = (area2 > 1e-12) & ~((hi_x < 0) | (lo_x >= res) | (hi_y < 0) | (lo_y >= res))
        n = res // tile

        def span(lo, hi):
            return (torch.floor(lo / tile).clamp(0, n - 1).long(),
                    torch.floor(hi / tile).clamp(0, n - 1).long())

        (x0, x1), (y0, y1) = span(lo_x, hi_x), span(lo_y, hi_y)
        t = torch.arange(n)
        member = ((y0[None, None] <= t[:, None, None]) & (y1[None, None] >= t[:, None, None])
                  & (x0[None, None] <= t[None, :, None]) & (x1[None, None] >= t[None, :, None])
                  & valid)
        out.append(int(member.sum(-1).max()))
    return out


def _tensors(out):
    """A module's output as a flat tuple of tensors (dicts by key, tuples and
    lists in order, None dropped)."""
    if isinstance(out, dict):
        out = [out[k] for k in sorted(out)]
    if not isinstance(out, (tuple, list)):
        return (out,)
    return tuple(t for o in out if o is not None for t in _tensors(o))


def styleunet_specs(torch, gen, width):
    """Phase 27a's seven style-U-Net configurations at `width` ("small": the
    tests' tiny widths; "full": the widths the classes default to, a
    3-channel condition at in_size, 32 output channels at 256², B=1, T=4):
    [(label, build(device), inputs on the CPU, call(module, *inputs))]."""
    from invertavatar_torch.models.encoders import styleunet as su

    kw = dict(STYLEUNET_SMALL if width == "small" else STYLEUNET_FULL)
    B, T = (2, 3) if width == "small" else (1, STYLEUNET_T)
    res_in = kw["in_size"]

    def rand(*shape):
        return torch.randn(*shape, generator=gen)

    ch4 = min(kw["channel_base"] // 4, kw["channel_max"])
    new_kw = dict(kw, in_size=kw["img_resolution"], num_cond_res=kw["img_resolution"])
    plain_kw = {k: kw[k] for k in ("img_resolution", "img_channels", "channel_base",
                                   "channel_max")}
    return [
        ("CondSynthesisNetworkWithGRU", lambda d: su.CondSynthesisNetworkWithGRU(**kw, device=d),
         (rand(B, T, 3, res_in, res_in),), lambda m, x: m(x)),
        ("CondSynthesisNetwork", lambda d: su.CondSynthesisNetwork(**kw, device=d),
         (rand(B, 3, res_in, res_in),), lambda m, x: m(x, return_list=True)),
        ("CondSynthesisNetwork residual_arch",
         lambda d: su.CondSynthesisNetwork(**dict(kw, img_channels=3), residual_arch=True,
                                           device=d),
         (rand(B, 3, res_in, res_in),), lambda m, x: m(x)),
        # the encoder must reach the output's size (in_size = img_resolution)
        ("CondSynthesisNetworkNew", lambda d: su.CondSynthesisNetworkNew(**new_kw, device=d),
         (rand(B, 3, new_kw["in_size"], new_kw["in_size"]),),
         lambda m, x: m(x, return_list=True)),
        ("CondSynthesisNetworkWithConvFusion",
         lambda d: su.CondSynthesisNetworkWithConvFusion(**kw, T=T, device=d),
         (rand(B, T, 3, res_in, res_in),), lambda m, x: m(x)),
        ("CondSynthesisNetworkSFT", lambda d: su.CondSynthesisNetworkSFT(**kw, device=d),
         (rand(B, T, 3, res_in, res_in),), lambda m, x: m(x)),
        ("PlainSynthesisNetwork", lambda d: su.PlainSynthesisNetwork(**plain_kw, device=d),
         (rand(B, ch4, 4, 4), rand(B, kw["img_channels"], 4, 4)),
         lambda m, x, img: m(x, img, return_list=True)),
    ]


def styleunet_phase(torch, dev, card):
    """Phase 27a: the seven style-U-Net configurations, small on the card
    against the CPU (1e-4 of each output's largest magnitude), then at full
    width on the card: finite, ms per call and peak memory. No kernel."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(27)
    for i, (label, build, inputs, call) in enumerate(styleunet_specs(torch, gen, "small")):
        def seeded(d, build=build, i=i):
            torch.manual_seed(270 + i)
            return build(d)

        _card_vs_cpu(torch, dev, "[27a]", f"{label} at the tests' widths", seeded, inputs,
                     lambda m, *x, call=call: _tensors(call(m, *x)), 1e-4)
    for i, (label, build, inputs, call) in enumerate(styleunet_specs(torch, gen, "full")):
        torch.manual_seed(280 + i)
        m = build(dev).eval()
        x = tuple(t.to(dev) for t in inputs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            ms, out = _host_ms(torch, lambda: call(m, *x))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        outs = _tensors(out)
        print(f"[27a] {label} at full width ({sum(p.numel() for p in m.parameters()) / 1e6:.1f} "
              f"M parameters; input {[tuple(t.shape) for t in x]}): {ms:.3f} ms per call (host "
              f"clock, synchronized, median of {N_MODULE_TIMED} after {N_MODULE_WARMUP}), peak "
              f"{peak:.3f} GiB on {card}; {len(outs)} outputs, the first "
              f"{tuple(outs[0].shape)}")
        if not all(_finite(o) for o in outs):
            fail(f"[27a] {label} at full width gave non-finite values")
        del m, x, out, outs
    torch.cuda.empty_cache()
    print(f"[27a] took {time.perf_counter() - t0:.1f} s")


def _next3d(torch, cfg, rk, topo, device, seed):
    """A Next3D generator of `cfg` filled by `init_flagship(seed)` (built on
    `device`)."""
    from invertavatar_torch.flagship import init_flagship
    from invertavatar_torch.models.next3d import Next3DTriPlaneGenerator

    with torch.device(device):
        G = Next3DTriPlaneGenerator(**cfg, topology=topo, rendering_kwargs=dict(rk),
                                    device=device)
    return init_flagship(G, seed=seed).eval()


def _route_frame(torch, G, rk, ws, c, v, rmod, calls=None):
    """One evaluation frame of G under the rendering kwargs `rk`, the B3
    calls recorded into `calls`."""
    G.rendering_kwargs = dict(rk)
    with torch.inference_mode(), recording(rmod, "sample_planes_windowed",
                                           [] if calls is None else calls):
        return G.synthesis(ws, c, v, noise_mode="const", evaluation=True)


def _payload(torch, call):
    """The payload dtype of a recorded `sample_planes_windowed` call."""
    args, kw, _ = call
    return args[2] if len(args) > 2 else kw.get("payload_dtype", torch.float32)


def b3_record(torch, ps, card, tag, label, call, earlier=None):
    """B3 on one recorded Next3D render call (planes, grid, payload dtype):
    both payloads against the plain version, the call's own payload timed
    with its plain version and `F.grid_sample` on planes of that dtype;
    returns its kernel record."""
    import torch.nn.functional as F

    (planes, grid, *_), _, out = call
    dt = _payload(torch, call)
    errs = b3_forward_check(torch, ps, tag, label, planes, grid, out)
    N, H, W, C = planes.shape
    n_pts = N * grid.shape[1] * grid.shape[2]
    size = 2 if dt == torch.bfloat16 else 4
    nbytes = grid.numel() * 4 + planes.numel() * size + n_pts * C * size
    b, by = bound(nbytes, n_pts * 4 * C * 2)
    ms = device_ms(lambda: ps.sample_planes_windowed(planes, grid, dt), "sample_kernel<")
    plain = device_ms(lambda: ps.sample_planes_windowed_reference(planes, grid, dt))
    planes_nchw = planes.permute(0, 3, 1, 2).contiguous().to(dt)
    grid_l = grid.to(dt)
    lib = device_ms(lambda: F.grid_sample(planes_nchw, grid_l, mode="bilinear",
                                          padding_mode="zeros", align_corners=False))
    b3_forward_diagnosis(torch, ps, card, tag, label, planes, grid, dt, earlier)
    print(f"{tag} B3 {label} {str(dt)[6:]} payload: planes {tuple(planes.shape)}, grid "
          f"{tuple(grid.shape)}; kernel {ms:.4f} ms, plain {plain:.4f} ms, F.grid_sample on "
          f"{str(dt)[6:]} planes {lib:.4f} ms, bound {b:.4f} ms ({by}; {nbytes / 1e6:.1f} MB) on "
          f"{card}")
    return dict(route="cuda", source="invertavatar_torch/csrc/plane_sample.cu",
                replaces="invertavatar_tpu/ops/pallas_plane_sample.py:39",
                max_abs_err=errs[dt], ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                library_ms=lib)


def next3d_phases(torch, dev, card, ps, rmod, earlier=None):
    """Phases 27b-27c: the Next3D generator small on the card against the CPU
    on three routes, then at full width; the legacy generator at full
    width. Returns the kernel records of B3's Next3D routes and each
    counter's launches over 27c's timed frames."""
    import numpy as np

    from invertavatar_torch.flagship import example_inputs, init_flagship
    from invertavatar_torch.models.next3d import LegacyTriPlaneGenerator

    t0 = time.perf_counter()
    z_np, c_np, _ = example_inputs(1)
    routes = {"exact": {}, "pallas_exact": dict(pallas_coarse=True, pallas_exact=True),
              "pallas_coarse": dict(pallas_coarse=True)}
    b3_payload = {"exact": None, "pallas_exact": torch.float32, "pallas_coarse": torch.bfloat16}

    # ---------------------------------------------------------------- 27b
    mark("27b")
    topo, v_np = sphere_mesh(*N3D_SMALL_SPHERE, seed=27)
    sides = (("card", dev), ("CPU", torch.device("cpu")))
    gens = {side: _next3d(torch, N3D_SMALL, N3D_SMALL_RK, topo, d, 27) for side, d in sides}
    small_errs, outs = {}, {}
    for route, extra in routes.items():
        for side, d in sides:
            z, c, v = (torch.from_numpy(a).to(d) for a in (z_np[:, :32], c_np, v_np))
            with torch.inference_mode():
                ws = gens[side].mapping(z, c)
            calls = []
            reset_launch_counts()
            o = _route_frame(torch, gens[side], dict(N3D_SMALL_RK, **extra), ws, c, v, rmod,
                             calls)
            outs[(route, side)] = {k: t.float().cpu() for k, t in o.items()}
            if side != "card":
                continue
            torch.cuda.synchronize()
            got, payloads = launch_counts(), [_payload(torch, cl) for cl in calls]
            want = dict(dict.fromkeys(KERNEL_COUNTERS, 0), plane_sample=len(calls))
            expect = [] if b3_payload[route] is None else [b3_payload[route]]
            print(f"[27b] small Next3D frame, {route} route on the card: B3 payloads {payloads} "
                  f"(expected {expect}), launches {got}")
            if payloads != expect or got != want:
                fail(f"[27b] the small {route} frame launched {got} with B3 payloads "
                     f"{payloads}, expected {want} and {expect}")
            if calls:
                (planes, grid, *_), _, out = calls[0]
                small_errs[route] = b3_forward_check(
                    torch, ps, "[27b]", f"small Next3D {route}", planes, grid, out)[expect[0]]
        _bands("[27b]", f"small Next3D frame, {route} route, card against the CPU",
               outs[(route, "card")], outs[(route, "CPU")])
    for route in ("pallas_exact", "pallas_coarse"):
        _bands("[27b]", f"small Next3D frame on the card, the {route} route against the exact "
               "route", outs[(route, "card")], outs[("exact", "card")])
    del gens, outs
    print(f"[27b] took {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------------------------- 27c
    mark("27c")
    t0 = time.perf_counter()
    topo, v_np = sphere_mesh(*N3D_FULL_SPHERE, seed=28)
    per_tile = faces_per_tile_by_view(torch, topo, v_np)
    print(f"[27c] mesh: a UV sphere of {topo.n_verts} vertices and {len(topo.faces)} faces "
          f"(FLAME: 5,023 and 9,976) + 68 landmarks; most candidate faces in a 32² tile by "
          f"view {per_tile} (cap {N3D_FULL['faces_per_tile']})")
    if max(per_tile) > N3D_FULL["faces_per_tile"]:
        fail(f"[27c] a 32² tile holds {max(per_tile)} candidate faces, over the cap")
    G = _next3d(torch, N3D_FULL, N3D_FULL_RK, topo, dev, 27)
    z, c, v = (torch.from_numpy(a).to(dev) for a in (z_np, c_np, v_np))
    with torch.inference_mode():
        ws = G.mapping(z, c)
    torch.cuda.synchronize()
    print(f"[27c] full-width Next3D generator built, weights filled in "
          f"{time.perf_counter() - t0:.2f} s: {sum(p.numel() for p in G.parameters()) / 1e6:.1f} "
          f"M parameters")
    rk_k = dict(N3D_FULL_RK)  # pallas_coarse on: B3 with the bf16 payload
    rk_e = {k: val for k, val in rk_k.items() if k != "pallas_coarse"}
    calls = []
    out_k = _route_frame(torch, G, rk_k, ws, c, v, rmod, calls)
    if len(calls) != 1:
        fail(f"[27c] a frame made {len(calls)} B3 calls, expected 1 (the coarse pass)")
    records = {"next3d_plane_sample_bf16": b3_record(torch, ps, card, "[27c]",
                                                     "full-width Next3D coarse pass", calls[0],
                                                     earlier)}
    del calls
    out_e = _route_frame(torch, G, rk_e, ws, c, v, rmod)
    _bands("[27c]", "the kernel route (pallas_coarse, bf16 B3) against the exact route",
           out_k, out_e)
    calls = []
    out_x = _route_frame(torch, G, dict(rk_k, pallas_exact=True), ws, c, v, rmod, calls)
    _bands("[27c]", "the pallas_exact route (float32 B3) against the exact route", out_x, out_e)
    records["next3d_plane_sample_fp32"] = b3_record(
        torch, ps, card, "[27c]", "full-width Next3D coarse pass", calls[0], earlier)
    del calls, out_e, out_x

    launches = {}
    for route, extra, n in (("pallas_coarse", rk_k, N3D_FRAMES),
                            ("pallas_exact", dict(rk_k, pallas_exact=True), N3D_EXACT_FRAMES)):
        G.rendering_kwargs = dict(extra)
        with torch.inference_mode():
            for _ in range(N_WARMUP):
                G.synthesis(ws, c, v, noise_mode="const", evaluation=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t1 = time.perf_counter()
            for _ in range(n):
                out = G.synthesis(ws, c, v, noise_mode="const", evaluation=True)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) / n * 1e3
        launches[route] = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        img = out["image"]
        with torch.inference_mode():  # the device's busy time per frame (all its ops)
            busy = device_ms(lambda: G.synthesis(ws, c, v, noise_mode="const", evaluation=True),
                             n=3, warmup=1)
        want = dict.fromkeys(KERNEL_COUNTERS, 0)
        want["plane_sample"] = n
        print(f"[27c] Next3D frame, {route} route: {n} frames of {tuple(img.shape)} after "
              f"{N_WARMUP} warm-up, {ms:.3f} ms/frame (host clock, synchronized, B=1, "
              f"{N3D_FULL['neural_rendering_resolution']}² render, {rk_k['depth_resolution']}+"
              f"{rk_k['depth_resolution_importance']} samples, SR to "
              f"{N3D_FULL['img_resolution']}²), device busy {busy:.3f} ms/frame (idle share "
              f"{1 - busy / ms:.3f}), peak {peak:.3f} GiB on {card}; "
              f"launches {launches[route]}, expected {want}; image mean "
              f"{img.float().mean().item():.4f} std {img.float().std().item():.4f}")
        if tuple(img.shape) != (1, 3, 512, 512) or not all(_finite(t) for t in out.values()):
            fail(f"[27c] the {route} frame is not a finite [1, 3, 512, 512]")
        if launches[route] != want:
            fail(f"[27c] the {route} route launched {launches[route]} in {n} frames, "
                 f"expected {want}")
        records["next3d_plane_sample_bf16" if route == "pallas_coarse" else
                "next3d_plane_sample_fp32"].update(launches=launches[route]["plane_sample"],
                                                    frame_ms=ms, frame_busy_ms=busy,
                                                    peak_gib=peak)
    del G, out, out_k, ws
    torch.cuda.empty_cache()

    with torch.device(dev):
        L = LegacyTriPlaneGenerator(**N3D_FULL, topology=topo, rendering_kwargs=dict(rk_k),
                                    device=dev)
    init_flagship(L, seed=29).eval()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with torch.inference_mode():
        ms, out = _host_ms(torch, lambda: L(z, c, v[:, :topo.n_verts], noise_mode="const",
                                            evaluation=True), warmup=1, n=3)
    launches["legacy"] = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = dict(dict.fromkeys(KERNEL_COUNTERS, 0), plane_sample=4)
    print(f"[27c] LegacyTriPlaneGenerator forward at the same width (pallas_coarse): {ms:.3f} "
          f"ms (host clock, synchronized, median of 3 after 1), peak {peak:.3f} GiB on {card}; "
          f"image {tuple(out['image'].shape)} mean {out['image'].float().mean().item():.4f}; "
          f"launches {launches['legacy']}, expected {want}")
    if not all(_finite(t) for t in out.values()):
        fail("[27c] the legacy generator's output is not finite")
    if launches["legacy"] != want:
        fail(f"[27c] the legacy forwards launched {launches['legacy']}, expected {want}")
    del L, out
    torch.cuda.empty_cache()
    records["next3d_plane_sample_bf16"]["small_max_abs_err"] = small_errs["pallas_coarse"]
    records["next3d_plane_sample_fp32"]["small_max_abs_err"] = small_errs["pallas_exact"]
    print(f"[27c] took {time.perf_counter() - t0:.1f} s")
    return records, launches


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the port on one NVIDIA GPU.")
    ap.add_argument("--earlier-src", action="append", default=[], metavar="PATH",
                    help="a plane_sample.cu with the port's C interface whose kernels "
                         "phases 8 and 27c check and time beside the port's")
    args = ap.parse_args(argv)
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
    mark("3-4")
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
    mark("5")
    small = dict(SMALL_FRAME_CFG, rendering_kwargs=dict(FLAGSHIP_RENDERING_KWARGS,
                                                        **SMALL_FRAME_RK))
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
    for key, max_tol, mean_tol in FRAME_BANDS:
        e = (outs[0][key] - outs[1][key]).abs()
        print(f"[5] small frame, card vs CPU plain versions: {key} max {e.max().item():.3e} "
              f"(< {max_tol}) mean {e.mean().item():.3e} (< {mean_tol})")
        if not (torch.isfinite(outs[0][key]).all() and e.max() < max_tol and e.mean() < mean_tol):
            fail(f"small-config frame on the card disagrees with the CPU on {key}")
    del g_cpu, g_gpu

    # ---------------------------------------------------------------- phase 6
    mark("6")
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

    mark("7")
    earlier = earlier_kernels(torch, ps, args.earlier_src)
    kernels += e4e_phases(torch, dev, card, ps, rmod, earlier)
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ phases 11-13
    mark("11")
    mgr, traj, online_launches = online_phase(torch, dev, card, fr)
    torch.cuda.empty_cache()
    absorb_launches, drive_launches = fewshot_phases(torch, dev, card, fr, mgr, traj)
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ phases 14-17
    mark("14")
    invert_launches, os_drive_launches = oneshot_phases(torch, dev, card, fr, mgr, traj)
    del mgr, traj
    torch.cuda.empty_cache()
    mark("16")
    fr.fused_render.launches = fr.fused_merged_march.launches = 0
    gan_phases(torch, dev, card)
    gan_launches = {"fused_render": fr.fused_render.launches,
                    "fused_merged_march": fr.fused_merged_march.launches}
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ phases 18-21
    mark("18")
    os_train_launches, os_train_checks = oneshot_train_phases(torch, dev, card)
    torch.cuda.empty_cache()
    mark("20")
    fs_train_launches, fs_train_checks = fewshot_train_phases(torch, dev, card)
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ phases 22-24
    mark("22")
    preprocess_phase(torch, dev, card)
    torch.cuda.empty_cache()
    mark("23")
    metric_launches, metric_checks = gan_metrics_phase(torch, dev, card, fr, rmod)
    torch.cuda.empty_cache()
    mark("24")
    proj_launches, proj_checks, proj_extra = projector_phase(torch, dev, card, ps, rmod)
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- phase 25
    mark("25a")
    dp_launches = parallel_phases(torch, dev, card)
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- phase 26
    mark("26a")
    cond_launches, cond_checks = with_condition_phase(torch, dev, card, fr, rmod)
    mark("26b")
    remat_launches = remat_phase(torch, dev, card)
    mark("26c")
    later_modules_phase(torch, dev, card)
    mark("26e")
    tensorboard_phase(torch, dev, card)
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- phase 27
    mark("27a")
    styleunet_phase(torch, dev, card)
    n3d_records, n3d_launches = next3d_phases(torch, dev, card, ps, rmod, earlier)
    mark("end")
    cond_checks = {r["name"]: r for r in cond_checks}
    for k in kernels:
        name = k["name"]
        later = {"preprocess": 0, "gan_metrics": metric_launches[name],
                 "projector": proj_launches[name],
                 "dp_world1_gan": dp_launches["dp_world1_gan"][name],
                 **{f"{path}_by_rank": [r[name] for r in dp_launches[path]]
                    for path in ("dp_gan", "dp_oneshot", "dp_fewshot")},
                 "synthesis_withCondition": cond_launches[name],
                 **{f"{path}_remat_{setting.replace(' ', '_')}": n[name]
                    for path, by in remat_launches.items() for setting, n in by.items()},
                 **{f"next3d_{route}": n[name] for route, n in n3d_launches.items()}}
        if name in cond_checks:
            for key in ("max_abs_err", "ms", "plain_ms", "bound_ms"):
                k[f"synthesis_withCondition_{key}"] = cond_checks[name][key]
        if name in online_launches:
            k["launches_by_path"] = {"frame_loop": k["launches"],
                                     "online": online_launches[name],
                                     "fewshot_absorb": absorb_launches[name],
                                     "fewshot_drive": drive_launches[name],
                                     "oneshot_invert": invert_launches[name],
                                     "oneshot_drive": os_drive_launches[name],
                                     "gan_train": gan_launches[name],
                                     "oneshot_train": os_train_launches[name],
                                     "fewshot_train": fs_train_launches[name], **later}
            # the check and time at the few-shot training path's shapes (48+48)
            err, ms, b = fs_train_checks[name]
            k.update(fewshot_train_max_abs_err=err, fewshot_train_ms=ms,
                     fewshot_train_bound_ms=b)
            # and at the GAN metric sampler's (64² rays, 48+48)
            for i, key in enumerate(("max_abs_err", "ms", "plain_ms", "bound_ms")):
                k[f"gan_metrics_{key}"] = {label: v[i] for label, v in
                                           metric_checks[name].items()}
        else:
            k["launches_by_path"] = {"e4e_train": k["launches"],
                                     "oneshot_train": os_train_launches[name],
                                     "fewshot_train": fs_train_launches[name], **later}
            # the checks and times at the one-shot and few-shot training
            # paths' shapes (batch 2 and batch 1, S=48) and the projector's
            for path, checks in (("oneshot_train", os_train_checks),
                                 ("fewshot_train", fs_train_checks), ("projector", proj_checks)):
                at = checks[name]
                k[f"{path}_max_abs_err"] = max(e for e, _, _ in at.values())
                k[f"{path}_ms"] = {label: ms for label, (_, ms, _) in at.items()}
                k[f"{path}_bound_ms"] = {label: b for label, (_, _, b) in at.items()}
            k["projector_plain_ms"] = {label: t[0] for label, t in proj_extra[name].items()}
            k["projector_library_ms"] = {label: t[1] for label, t in proj_extra[name].items()}
    for name, r in n3d_records.items():
        payload = "pallas_coarse" if name.endswith("bf16") else "pallas_exact"
        kernels.append(dict(name=name, **r, launches_by_path={
            f"next3d_small_{payload}": 1, f"next3d_{payload}": r["launches"],
            **({"next3d_legacy": n3d_launches["legacy"]["plane_sample"]}
               if payload == "pallas_coarse" else {})}))
    print("[end] seconds by phase: " + ", ".join(
        f"{a} {t1 - t0:.1f}" for (a, t0), (_, t1) in zip(PHASE_MARKS, PHASE_MARKS[1:])))
    print(f"[end] chip_smoke.py ran {time.perf_counter() - T_START:.1f} s")

    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{**{key: k[key] for key in order},
                                   **{key: v for key, v in k.items() if key not in order}}
                                  for k in kernels]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
