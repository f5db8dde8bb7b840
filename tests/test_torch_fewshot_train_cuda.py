"""The few-shot training step on the card: the grad-carrying renders through
B3 and its transpose (`fast_grad="pallas"`) against the `F.grid_sample`
route (`"structured"`), from the same weights, with the no-grad renders on
the fused kernels B1/B2 (`fast_no_grad="fused"`) and on B3 with a float32
payload (`"exact"`). Needs a CUDA device and imports no JAX, so it runs where
the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_fewshot_train_cuda.py

The two routes of a comparison share their no-grad mode: "fused" samples the
planes' bf16 rounding, which moves Igen's target, and with it its small
losses, by far more than the kernels' float32 differences.
"""

import numpy as np
import pytest
import torch

from invertavatar_torch.flagship import fewshot_train_batch, fewshot_train_models
from invertavatar_torch.ops import fused_render as fr
from invertavatar_torch.ops import plane_sample as ps
from invertavatar_torch.train.inversion import InversionLossWeights
from invertavatar_torch.train.loop_inversion import (
    fewshot_fake_idx,
    fewshot_tex_trainable,
    fewshot_tri_trainable,
    make_fewshot_train_step,
    masked_adam,
)
from invertavatar_torch.train.state import TrainState

# the tests' tiny widths, rendering 256² through the 4X SR (as
# tests/test_torch_oneshot_train_cuda.py; the card's machine may hold another
# package named `tests`, so nothing is imported from this folder)
SMALL = dict(z_dim=32, c_dim=25, w_dim=512, img_resolution=256, img_channels=3,
             rendering_kwargs={"superresolution_module": "x.SuperresolutionHybrid4X",
                               "c_gen_conditioning_zero": False, "c_scale": 1.0,
                               "superresolution_noise_mode": "none", "decoder_lr_mul": 1.0,
                               "sr_antialias": True, "depth_resolution": 6,
                               "depth_resolution_importance": 6, "box_warp": 1.0,
                               "det_stratified": True},
             neural_rendering_resolution=32, channel_base=1024, channel_max=64,
             map_num_layers=2)
D_CFG = dict(c_dim=25, img_resolution=256, img_channels=6, channel_base=1024, channel_max=64,
             num_fp16_res=0)
WEIGHTS = InversionLossWeights(l1=1.0, lpips=1.0, id=0.0, raw_l1=1.0, tri=0.001, lr_lpips=1.0,
                               adv=0.1)
T, TC = 4, 2


def _counts():
    return (fr.fused_render.launches, fr.fused_merged_march.launches,
            ps.sample_planes_windowed.launches, ps.windowed_sample_transpose.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("no_grad", ["fused", "exact"])
def test_fewshot_step_pallas_matches_structured_on_card(no_grad):
    """Ireal (tri-plane decoder, two selected frames) and Igen (texture
    decoder, every frame, the adversarial term) on a 4-frame clip in chunks
    of 2, each from the same weights, the tiny GRU network over the tests'
    tiny generator (decoder weights ×10) rendering 256²: losses to 1e-3
    relative, the trained decoder's gradient to 1e-3 of its norm (float32
    sums in other orders, TF32 off). The launches are those counted from the
    code: per frame of each no-grad render B1 and B2 ("fused"), or B3 twice
    per chunk's render ("exact"); per grad-carrying frame B3 and its
    transpose twice each on the kernel route, never on the grid_sample
    route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    net, D = fewshot_train_models(SMALL, D_CFG, trunk_layers_n=8, seed=9, device=dev)
    with torch.no_grad():
        for k, p in net.generator.decoder.named_parameters():
            if k.endswith("weight"):
                p.mul_(10.0)
    sd0 = {k: v.clone() for k, v in net.state_dict().items()}
    batch = fewshot_train_batch(1, T, 256, z_dim=32, seed=10, device=dev)
    idx = fewshot_fake_idx(0, 0, T, TC)
    results = {}
    for fast_grad in ("pallas", "structured"):
        step = make_fewshot_train_step(net, lambda a, b: (a - b).abs().mean(), WEIGHTS, TC,
                                       no_grad, fast_grad)
        out = {}
        for phase, pred in (("Ireal", fewshot_tri_trainable), ("Igen", fewshot_tex_trainable)):
            net.load_state_dict(sd0)
            n0 = _counts()
            aux = step(TrainState(net, masked_adam(net, 1e-4, pred)), batch,
                       do_igen=phase == "Igen", multiT=True, fake_idx=idx, d_module=D)
            torch.cuda.synchronize()
            out[phase] = ({k: float(v) for k, v in aux.items()},
                          {k: p.grad.detach().clone() for k, p in net.named_parameters()
                           if p.requires_grad and p.grad is not None},
                          tuple(b - a for a, b in zip(n0, _counts())))
        results[fast_grad] = out
    for phase, renders, grad_frames in (("Ireal", 1, TC), ("Igen", 2, T)):
        nograd = ((renders * T, renders * T, 0) if no_grad == "fused"
                  else (0, 0, 2 * renders * T // TC))
        assert results["pallas"][phase][2] == nograd[:2] + (nograd[2] + 2 * grad_frames,
                                                            2 * grad_frames), phase
        assert results["structured"][phase][2] == nograd + (0,), phase
        (aux, grads, _), (aux_r, grads_r, _) = (results["pallas"][phase],
                                                results["structured"][phase])
        assert sorted(aux) == sorted(aux_r) and sorted(grads) == sorted(grads_r) and grads_r
        for k in aux_r:
            assert np.isfinite(aux[k]) and abs(aux[k] - aux_r[k]) <= 1e-3 * abs(aux_r[k]) + 1e-7, k
        norm = sum(g.square().sum() for g in grads_r.values()).sqrt().item()
        diff = sum((grads[k] - grads_r[k]).square().sum() for k in grads_r).sqrt().item()
        assert norm > 0 and diff <= 1e-3 * norm, (phase, diff, norm)
