"""Optimisation-based W+ projection (PTI stage 1), plain PyTorch (NCHW).

Counterpart of `invertavatar_tpu/inversion/projector.py` (reference
`inversion/projectors/w_plus_projector_ide3d.py:27`): Adam on the W+ code
and the noise buffers against a perceptual feature distance, with the
reference's learning-rate ramp-up and cosine ramp-down, decaying w-noise,
multi-scale noise autocorrelation regulariser and per-step noise
renormalisation. The schedules stay on the host, step by step.

The perceptual metric is a callable (`feature_fn`): the reference's is the
StyleGAN VGG16-LPIPS network, so pass `LPIPS("vgg").features` with imported
weights for parity, or any differentiable feature extractor.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.misc import resolve_device


def _noise_reg(noise_bufs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Multi-scale autocorrelation penalty (projector :118-128)."""
    reg = 0.0
    for buf in noise_bufs.values():
        noise = buf[None, None]  # [1, 1, H, W]
        while True:
            reg = reg + torch.mean(noise * torch.roll(noise, 1, dims=3)) ** 2
            reg = reg + torch.mean(noise * torch.roll(noise, 1, dims=2)) ** 2
            if noise.shape[2] <= 8:
                break
            noise = F.avg_pool2d(noise, 2)
    return reg


def _down256(img: torch.Tensor) -> torch.Tensor:
    """Area down-sampling to 256² (average pooling by the integer factor)."""
    if img.shape[2] > 256:
        img = F.avg_pool2d(img, img.shape[2] // 256)
    return img


def project_w_plus(synth_fn: Callable, mapping_fn: Callable, feature_fn: Callable,
                   target, noise_bufs: Dict[str, torch.Tensor], num_ws: int, z_dim: int,
                   num_steps: int = 1000, w_avg_samples: int = 10000,
                   initial_learning_rate: float = 5e-3, initial_noise_factor: float = 0.05,
                   lr_rampdown_length: float = 0.25, lr_rampup_length: float = 0.05,
                   noise_ramp_length: float = 0.75, regularize_noise_weight: float = 1e5,
                   initial_w: Optional[np.ndarray] = None, seed: int = 123,
                   verbose: bool = False, on_step: Optional[Callable] = None, device="cuda"):
    """Project `target` ([3, H, W] in [0, 255]) into W+.

    `synth_fn(ws [1, num_ws, C], noise_bufs) -> image [1, 3, H, W]` in [-1,
    1]; `mapping_fn(z [N, z_dim]) -> ws [N, L, C]`; `feature_fn(image [1, 3,
    256, 256] in [0, 255]) -> features`; `noise_bufs` {name: [res, res]}
    (their values are replaced by `RandomState(seed)` draws, as in the JAX
    package). The w-noise comes from a `torch.Generator` seeded by `seed`.
    `on_step(i, dist, loss)` (tensors) runs after each step. Runs on CUDA
    unless `device="cpu"` is asked for. Returns (w_opt [1, num_ws, C],
    {name: optimised noise buffer})."""
    device = resolve_device(device)
    # W statistics (projector :55-61)
    z_samples = np.random.RandomState(seed).randn(w_avg_samples, z_dim).astype(np.float32)
    with torch.no_grad():
        w_samples = mapping_fn(torch.from_numpy(z_samples).to(device))[:, :1, :]
    w_samples = w_samples.float().cpu().numpy()
    w_avg = w_samples.mean(axis=0, keepdims=True)
    w_std = float(np.sqrt(np.square(w_samples - w_avg).sum() / w_avg_samples))

    start_w = initial_w if initial_w is not None else w_avg
    if start_w.shape[1] != num_ws:
        start_w = np.repeat(start_w, num_ws, axis=1)
    w_opt = torch.tensor(np.asarray(start_w, np.float32), device=device, requires_grad=True)
    noise = {k: torch.tensor(np.random.RandomState(seed).randn(*b.shape).astype(np.float32),
                             device=device, requires_grad=True) for k, b in noise_bufs.items()}

    target = torch.as_tensor(target, dtype=torch.float32, device=device)
    with torch.no_grad():
        target_features = feature_fn(_down256(target[None]))

    opt = torch.optim.Adam([w_opt, *noise.values()], lr=initial_learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    gen = torch.Generator(device=device).manual_seed(seed)
    for i in range(num_steps):
        t = i / num_steps
        w_noise_scale = w_std * initial_noise_factor * max(0.0, 1.0 - t / noise_ramp_length) ** 2
        lr_ramp = min(1.0, (1.0 - t) / lr_rampdown_length)
        lr_ramp = 0.5 - 0.5 * np.cos(lr_ramp * np.pi)
        lr_ramp = lr_ramp * min(1.0, t / lr_rampup_length)
        for group in opt.param_groups:
            group["lr"] = initial_learning_rate * lr_ramp

        w_noise = torch.randn(w_opt.shape, generator=gen, device=device) * w_noise_scale
        img = synth_fn(w_opt + w_noise, noise)
        feats = feature_fn(_down256((img + 1.0) * (255.0 / 2.0)))
        dist = torch.sum(torch.square(target_features - feats))
        loss = dist + _noise_reg(noise) * regularize_noise_weight
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        with torch.no_grad():  # renormalise the noise buffers
            for b in noise.values():
                b.sub_(b.mean()).mul_(torch.rsqrt(torch.mean(torch.square(b)) + 1e-12))
        if on_step is not None:
            on_step(i, dist.detach(), loss.detach())
        if verbose and (i + 1) % 50 == 0:
            print(f"step {i + 1}/{num_steps}: dist {float(dist):.3f} loss {float(loss):.3f}")
    return w_opt.detach(), {k: b.detach() for k, b in noise.items()}


# ------------------------------------------------------------- PTI locality reg
def morphed_w_code(new_w: torch.Tensor, fixed_w: torch.Tensor, alpha: float = 30.0):
    """reference inversion/criteria/localitly_regulizer.py:14-21."""
    direction = new_w - fixed_w
    return fixed_w + alpha * direction / torch.linalg.norm(direction).clamp(min=1e-12)


def space_regularizer_loss(new_g_synthesis: Callable, old_g_synthesis: Callable,
                           mapping_fn: Callable, w_batch: torch.Tensor, lpips_fn: Callable,
                           generator: Optional[torch.Generator] = None, num_samples: int = 1,
                           alpha: float = 30.0, l2_lambda: float = 0.0,
                           lpips_lambda: float = 1.0) -> torch.Tensor:
    """PTI "ball-holder" locality regulariser (localitly_regulizer.py:27-58):
    the tuned generator must match the frozen one on w codes pushed a fixed
    distance from the inversion target. z ~ N(0, 1) [num_samples, w_dim]
    from `generator`; the frozen side carries no gradient."""
    z = torch.randn((num_samples, w_batch.shape[-1]), generator=generator,
                    device=w_batch.device)
    w_samples = mapping_fn(z)
    total = torch.zeros((), device=w_batch.device)
    for i in range(num_samples):
        w_code = morphed_w_code(w_samples[i:i + 1], w_batch, alpha)
        new_img = new_g_synthesis(w_code)
        with torch.no_grad():
            old_img = old_g_synthesis(w_code)
        if l2_lambda > 0:
            total = total + l2_lambda * torch.mean(torch.square(old_img - new_img))
        if lpips_lambda > 0:
            total = total + lpips_lambda * torch.mean(lpips_fn(old_img, new_img))
    return total / num_samples
