"""The one-shot training step on the card: the student render through B3 and
its transpose (`fast_grad="pallas"`) against the `F.grid_sample` route
(`"structured"`), from the same weights. Needs a CUDA device and imports no
JAX, so it runs where the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_oneshot_train_cuda.py
"""

import numpy as np
import pytest
import torch

from invertavatar_torch.flagship import oneshot_train_batch, oneshot_train_models
from invertavatar_torch.models.encoders import UnetEncoderPair, texture_out_channels_for
from invertavatar_torch.ops import plane_sample as ps
from invertavatar_torch.train.inversion import InversionLossWeights
from invertavatar_torch.train.loop_inversion import (
    make_oneshot_train_step,
    masked_adam,
    oneshot_tex_trainable,
    oneshot_tri_trainable,
)
from invertavatar_torch.train.state import TrainState

# the tests' tiny widths, rendering 256² through the 4X SR so that frames,
# renders and the discriminator share one resolution (Dreal scores frames)
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
WEIGHTS = InversionLossWeights(l1=1.0, lpips=0.0, id=0.0, raw_l1=1.0, tri=0.001, texture=0.001,
                               adv=0.01)


@pytest.mark.cuda
@pytest.mark.parametrize("unet_type", ["gru", "segformer"])
def test_oneshot_step_pallas_matches_structured_on_card(unet_type):
    """Ireal (tri U-Net), Dreal with R1, Igen (tex U-Net) and Dgen, each from
    the same weights, through B3 + transpose and through `F.grid_sample`:
    losses to 1e-3 relative, the trained network's gradient to 1e-3 of its
    norm (float32 sums in other orders, TF32 off; D's gradient runs through
    leaky-ReLU kinks, where float noise can flip a slope, so no per-entry
    bar). Over the four
    phases the kernel route launches B3 20 times and its transpose 4; the
    grid_sample route launches B3 12 times (the no-grad Igen targets and e4e
    prefix renders) and the transpose never."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    net, D = oneshot_train_models(SMALL, D_CFG, trunk_layers_n=8, seed=7, device=dev)
    if unet_type == "gru":  # the same step over the few-shot ConvGRU U-Nets (tiny trunks)
        net.unet_type = "gru"
        net.unet_encoder = UnetEncoderPair(
            unet_type="gru", texture_out_channels=texture_out_channels_for(1024, 64),
            channel_base=1024, channel_max=64, trunk_layers_n=8).to(dev)
    sd0 = {k: v.clone() for k, v in net.state_dict().items()}
    dsd0 = {k: v.clone() for k, v in D.state_dict().items()}
    batch = oneshot_train_batch(1, 256, z_dim=32, seed=8, device=dev)
    phases = (("Ireal", oneshot_tri_trainable, False), ("Dreal", oneshot_tri_trainable, True),
              ("Igen", oneshot_tex_trainable, False), ("Dgen", oneshot_tex_trainable, False))
    results = {}
    for fast_grad in ("pallas", "structured"):
        step = make_oneshot_train_step(net, lambda a, b: (a - b).abs().mean(), None, WEIGHTS,
                                       fast_igen_target="exact", fast_grad=fast_grad)
        ps.sample_planes_windowed.launches = ps.windowed_sample_transpose.launches = 0
        out = {}
        for phase, pred, r1 in phases:
            net.load_state_dict(sd0)
            D.load_state_dict(dsd0)
            aux = step(TrainState(net, masked_adam(net, 1e-4, pred)),
                       TrainState(D, torch.optim.Adam(D.parameters(), lr=2e-4)), batch,
                       phase=phase, do_r1=r1)
            trained = net if phase.startswith("I") else D
            out[phase] = ({k: float(v) for k, v in aux.items()},
                          {k: p.grad.detach().clone() for k, p in trained.named_parameters()
                           if p.requires_grad and p.grad is not None})
        results[fast_grad] = (out, ps.sample_planes_windowed.launches,
                              ps.windowed_sample_transpose.launches)
    (kern, b3, b3t), (ref, b3_s, b3t_s) = results["pallas"], results["structured"]
    assert (b3, b3t) == (20, 4) and (b3_s, b3t_s) == (12, 0), (b3, b3t, b3_s, b3t_s)
    for phase, _, _ in phases:
        (aux, grads), (aux_r, grads_r) = kern[phase], ref[phase]
        assert sorted(aux) == sorted(aux_r) and sorted(grads) == sorted(grads_r)
        for k in aux_r:
            assert np.isfinite(aux[k]) and abs(aux[k] - aux_r[k]) <= 1e-3 * abs(aux_r[k]) + 1e-7, k
        norm = sum(g.square().sum() for g in grads_r.values()).sqrt().item()
        diff = sum((grads[k] - grads_r[k]).square().sum() for k in grads_r).sqrt().item()
        assert norm > 0 and diff <= 1e-3 * norm, (phase, diff, norm)
