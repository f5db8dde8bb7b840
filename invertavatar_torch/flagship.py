"""Flagship model configuration: the shipped `ani3dgan512` geometry
(counterpart of `invertavatar_tpu/flagship.py`; the rendering kwargs are the
same dict, key for key)."""

from __future__ import annotations

import numpy as np
import torch

from .camera import fov_to_intrinsics, lookat_camera_pose
from .models.triplane import TriPlaneGenerator
from .utils.misc import resolve_device

FLAGSHIP_RENDERING_KWARGS = {
    "image_resolution": 512,
    "disparity_space_sampling": False,
    "clamp_mode": "softplus",
    "superresolution_module": "training_avatar_texture.superresolution.SuperresolutionHybrid8XDC",
    "c_gen_conditioning_zero": True,
    "c_scale": 1.0,
    "superresolution_noise_mode": "none",
    "density_reg": 0.25,
    "density_reg_p_dist": 0.004,
    "reg_type": "l1",
    "decoder_lr_mul": 1.0,
    "sr_antialias": True,
    # eval sampling budget (the reference trains at 48+48)
    "depth_resolution": 40,
    "depth_resolution_importance": 24,
    "ray_start": 2.25,
    "ray_end": 3.3,
    "box_warp": 1.0,
    "avg_camera_radius": 2.7,
    "avg_camera_pivot": [0, 0, 0.2],
    "det_stratified": True,
    # both render passes through the fused kernels (B1, B2), the fine pass
    # through the tile-pooled importance CDF
    "pallas_coarse": True,
    "pooled_importance": True,
    # ignored by the port, as by the JAX package off the TPU (exact UV warp)
    "fast_uv_warp": True,
    # 128×4 ray tiles for the fused kernels and the pooled CDF regions
    "tile_shape": (128, 4),
}


def flagship_config(neural_rendering_resolution: int = 128, num_fp16_res: int = 4,
                    sr_num_fp16_res: int = 4) -> dict:
    """`TriPlaneGenerator` keyword arguments of the flagship. The backbones'
    top `num_fp16_res` resolutions and the SR blocks' top `sr_num_fp16_res`
    compute in bfloat16; 0 for both is the float32 generator that training
    runs (the JAX `GEN_CFG` defaults)."""
    return dict(z_dim=512, c_dim=25, w_dim=512, img_resolution=512, img_channels=3,
                sr_num_fp16_res=sr_num_fp16_res, rendering_kwargs=dict(FLAGSHIP_RENDERING_KWARGS),
                neural_rendering_resolution=neural_rendering_resolution, channel_base=32768,
                channel_max=512, num_fp16_res=num_fp16_res, conv_clamp=256.0, map_num_layers=2)


def flagship_generator(neural_rendering_resolution: int = 128, num_fp16_res: int = 4,
                       sr_num_fp16_res: int = 4, device="cuda") -> TriPlaneGenerator:
    """The flagship generator (`flagship_config`) in eval mode on `device`
    (CUDA by default; raises if CUDA is asked for and absent)."""
    device = resolve_device(device)
    with torch.device(device):
        G = TriPlaneGenerator(**flagship_config(neural_rendering_resolution, num_fp16_res,
                                                sr_num_fp16_res))
    return G.eval()


def flagship_inversion_net(trunk_layers_n: int = 50, seed: int = 0, device="cuda"):
    """The e4e stage's network on `device` (CUDA by default): the float32
    flagship generator filled by `init_flagship(seed)` and an IR-SE
    `Encoder4Editing` (`trunk_layers_n=8`: the tiny test trunk) with torch's
    default initialisation drawn after `torch.manual_seed(seed)`."""
    from .models.encoders import InversionNet

    device = resolve_device(device)
    torch.manual_seed(seed)
    with torch.device(device):
        net = InversionNet(flagship_config(num_fp16_res=0, sr_num_fp16_res=0),
                           trunk_layers_n=trunk_layers_n)
    init_flagship(net.generator, seed=seed)
    return net


def fewshot_inversion_net(generator_cfg=None, trunk_layers_n: int = 50, seed: int = 0,
                          unet_eval_dtype=torch.bfloat16, device="cuda"):
    """The few-shot stage's network on `device` (CUDA by default): the
    flagship eval generator (`flagship_config()`: bf16 backbones and SR,
    conv_clamp 256) unless `generator_cfg` is given, filled by
    `init_flagship(seed)`; the e4e encoder and both ConvGRU U-Nets (IR-SE-50
    trunks; `trunk_layers_n=8`: the tiny test trunks) with torch's default
    initialisation drawn after `torch.manual_seed(seed)`, the U-Nets
    computing in `unet_eval_dtype` in the absorb."""
    from .models.encoders import InversionNet, texture_out_channels_for

    cfg = flagship_config() if generator_cfg is None else dict(generator_cfg)
    device = resolve_device(device)
    torch.manual_seed(seed)
    with torch.device(device):
        net = InversionNet(cfg, encoding_texture=True, encoding_triplane=True,
                           texture_out_channels=texture_out_channels_for(cfg["channel_base"],
                                                                         cfg["channel_max"]),
                           unet_eval_dtype=unet_eval_dtype, trunk_layers_n=trunk_layers_n)
    init_flagship(net.generator, seed=seed)
    return net.eval()


def oneshot_inversion_net(generator_cfg=None, trunk_layers_n: int = 50, seed: int = 0,
                          device="cuda"):
    """The one-shot stage's network on `device` (CUDA by default): the
    flagship eval generator (`flagship_config()`) unless `generator_cfg` is
    given, filled by `init_flagship(seed)`; the e4e encoder (`trunk_layers_n`
    deep; 8: the tiny test trunk) and both SegFormer U-Nets (IR-SE-50 trunks
    and ViT decoders, float32) with torch's default initialisation drawn
    after `torch.manual_seed(seed)`."""
    from .models.encoders import InversionNet, texture_out_channels_for

    cfg = flagship_config() if generator_cfg is None else dict(generator_cfg)
    device = resolve_device(device)
    torch.manual_seed(seed)
    with torch.device(device):
        net = InversionNet(cfg, encoding_texture=True, encoding_triplane=True,
                           unet_type="segformer",
                           texture_out_channels=texture_out_channels_for(cfg["channel_base"],
                                                                         cfg["channel_max"]),
                           trunk_layers_n=trunk_layers_n)
    init_flagship(net.generator, seed=seed)
    return net.eval()


def example_inputs(batch: int = 1, seed: int = 0):
    """(z, c, uvcoords_image) as numpy arrays: a frontal camera and a synthetic
    face mask with a mouth hole."""
    rng = np.random.RandomState(seed)
    z = rng.randn(batch, 512).astype(np.float32)
    c2w = lookat_camera_pose(None, np.pi / 2, np.pi / 2, [0.0, 0.0, 0.2], radius=2.7,
                             batch_size=batch).numpy()
    K = np.tile(fov_to_intrinsics(18.837).numpy()[None], (batch, 1, 1))
    c = np.concatenate([c2w.reshape(batch, 16), K.reshape(batch, 9)], axis=1).astype(np.float32)
    yy, xx = np.mgrid[0:256, 0:256].astype(np.float32) / 256
    face = (((xx - 0.5) / 0.3) ** 2 + ((yy - 0.47) / 0.38) ** 2) < 1.0
    mouth = (((xx - 0.5) / 0.1) ** 2 + ((yy - 0.62) / 0.04) ** 2) < 1.0
    alpha = (face & ~mouth).astype(np.float32)
    uvc = np.stack([(xx * 2 - 1) * 0.9, (yy * 2 - 1) * 0.9, alpha], axis=-1)
    uvc[alpha == 0, :2] = 0.0
    uvcoords = np.tile(uvc[None], (batch, 1, 1, 1)).astype(np.float32)
    return z, c, uvcoords


@torch.no_grad()
def init_flagship(G: TriPlaneGenerator, seed: int = 0) -> TriPlaneGenerator:
    """Fill every float parameter and buffer of `G` in place with seeded
    N(0, 1)·0.1 draws (numpy), in state-dict order: random weights for
    benchmarks and smoke runs."""
    npr = np.random.RandomState(seed)
    for t in G.state_dict().values():
        if t.is_floating_point():
            t.copy_(torch.from_numpy(
                np.asarray(npr.standard_normal(tuple(t.shape)) * 0.1, dtype=np.float32)))
        else:
            t.zero_()
    return G


def training_generator_config() -> dict:
    """The float32 flagship generator with the reference's 48+48 training
    samples: the inversion stages' frozen generator."""
    cfg = flagship_config(num_fp16_res=0, sr_num_fp16_res=0)
    cfg["rendering_kwargs"].update(depth_resolution=48, depth_resolution_importance=48)
    return cfg


def training_discriminator(generator_cfg, d_cfg=None, seed: int = 0, device="cuda"):
    """A `DualDiscriminator` (`d_cfg`; default: at the generator's
    resolution, 6 channels, the flagship widths with bf16 top four
    resolutions) with torch's initialisation after `torch.manual_seed(seed)`
    and seeded N(0, 0.1) draws added to its 1-D parameters: with zero biases
    and the inversion stages' zero cameras, its camera map and every logit
    are 0."""
    from .models.discriminator import DualDiscriminator

    d_cfg = d_cfg or dict(c_dim=generator_cfg["c_dim"],
                          img_resolution=generator_cfg["img_resolution"], img_channels=6)
    torch.manual_seed(seed)
    D = DualDiscriminator(**d_cfg)
    npr = np.random.RandomState(seed)
    with torch.no_grad():
        for p in D.parameters():
            if p.ndim == 1:
                p.add_(torch.from_numpy((npr.standard_normal(p.shape) * 0.1).astype(np.float32)))
    return D.to(resolve_device(device))


def oneshot_train_models(generator_cfg=None, d_cfg=None, trunk_layers_n: int = 50,
                         seed: int = 0, device="cuda"):
    """The one-shot training stage's networks on `device` (CUDA by default):
    `oneshot_inversion_net` over `training_generator_config()` (unless
    `generator_cfg` is given) and `training_discriminator(d_cfg)`. Returns
    (net, D)."""
    generator_cfg = generator_cfg or training_generator_config()
    net = oneshot_inversion_net(generator_cfg, trunk_layers_n=trunk_layers_n, seed=seed,
                                device=device)
    return net, training_discriminator(generator_cfg, d_cfg, seed=seed, device=device)


def fewshot_train_models(generator_cfg=None, d_cfg=None, trunk_layers_n: int = 50,
                         seed: int = 0, device="cuda"):
    """The few-shot training stage's networks on `device` (CUDA by default):
    `fewshot_inversion_net` over `training_generator_config()` (unless
    `generator_cfg` is given) with both ConvGRU U-Nets in float32 (they
    train), and `training_discriminator(d_cfg)`. Returns (net, D)."""
    generator_cfg = generator_cfg or training_generator_config()
    net = fewshot_inversion_net(generator_cfg, trunk_layers_n=trunk_layers_n, seed=seed,
                                unet_eval_dtype=None, device=device)
    return net, training_discriminator(generator_cfg, d_cfg, seed=seed, device=device)


def oneshot_train_batch(batch: int, res: int, z_dim: int = 512, seed: int = 0, device="cuda"):
    """A seeded one-shot training batch on `device`: frames [B, 3, res, res]
    uniform in [-1, 1], the UV input [B, 6, 256, 256] (a seeded UV texture
    beside `example_inputs`' UV vertex image, as `gen_uv` too), the frontal
    camera, its uvcoords and z [B, z_dim]."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    z, c, uvc = example_inputs(batch, seed=seed)
    uv = np.concatenate([rng.uniform(-1, 1, (batch, 256, 256, 3)), uvc], axis=-1)
    uv = torch.from_numpy(np.ascontiguousarray(uv.transpose(0, 3, 1, 2), np.float32)).to(device)
    img = rng.uniform(-1, 1, (batch, 3, res, res)).astype(np.float32)
    return {"image": torch.from_numpy(img).to(device), "c": torch.from_numpy(c).to(device),
            "v": {"uvcoords_image": torch.from_numpy(uvc).to(device)}, "uv": uv, "gen_uv": uv,
            "z": torch.from_numpy(z[:, :z_dim]).to(device)}


def fewshot_train_batch(batch: int, T: int, res: int, z_dim: int = 512, seed: int = 0,
                        device="cuda"):
    """A seeded few-shot training clip batch on `device`: frames [B, T, 4,
    res, res], RGB uniform in [-1, 1] and `example_inputs`' face region as
    the head mask; cameras [B, T, 25] turning ±0.1 rad about the frontal
    one; their uvcoords [B, T, 256, 256, 3]; the UV inputs [B, T, 6, 256,
    256] (a seeded UV texture per frame beside the UV vertex image) and z
    [B, z_dim]."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    z, _, uvc = example_inputs(batch, seed=seed)
    yaw = np.pi / 2 + 0.1 * np.sin(np.arange(T) * 0.7)
    K = fov_to_intrinsics(18.837).numpy().reshape(9)
    c = np.stack([np.concatenate([lookat_camera_pose(None, y, np.pi / 2, [0.0, 0.0, 0.2],
                                                     radius=2.7).numpy().reshape(16), K])
                  for y in yaw]).astype(np.float32)
    near = np.arange(res) * 256 // res
    mask = uvc[0, :, :, 2][near][:, near]
    img = rng.uniform(-1, 1, (batch, T, 4, res, res)).astype(np.float32)
    img[:, :, 3] = mask
    uv = np.concatenate([rng.uniform(-1, 1, (batch, T, 256, 256, 3)),
                         np.broadcast_to(uvc[:, None], (batch, T, 256, 256, 3))], axis=-1)
    uv = np.ascontiguousarray(uv.transpose(0, 1, 4, 2, 3), np.float32)
    t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(device)  # noqa: E731
    return {"image": t(img), "c": t(np.broadcast_to(c[None], (batch, T, 25))),
            "v": {"uvcoords_image": t(np.broadcast_to(uvc[:, None], (batch, T, 256, 256, 3)))},
            "uv": t(uv), "z": t(z[:, :z_dim])}


class SeededMetricDataset:
    """`n` seeded items in the layout the metrics read (`metrics/fid.py`):
    "image" uint8 [res, res, 3] (an 8×8 grid of seeded colours, blocky at
    res/8 pixels, plus seeded noise), "c" [25] (the flagship camera turned
    by a seeded yaw in ±0.3 rad and pitch in ±0.15 rad) and "v":
    {"uvcoords_image"} (`example_inputs`' face). A stand-in for a
    preprocessed dataset, made on the host item by item."""

    def __init__(self, n: int = 64, res: int = 512, seed: int = 0):
        self.n, self.res, self.seed = n, res, seed
        self.path = f"seeded-metric-dataset-{n}-{res}-{seed}"
        self._uvc = example_inputs(1)[2][0]
        self._K = fov_to_intrinsics(18.837).numpy().reshape(9)

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int):
        rng = np.random.RandomState(self.seed * 100_003 + i)
        grid = rng.randint(0, 256, (8, 8, 3)).astype(np.int16)
        img = np.kron(grid, np.ones((self.res // 8, self.res // 8, 1), np.int16))
        img = np.clip(img + rng.randint(-16, 17, img.shape), 0, 255).astype(np.uint8)
        yaw = np.pi / 2 + rng.uniform(-0.3, 0.3)
        pitch = np.pi / 2 + rng.uniform(-0.15, 0.15)
        pose = lookat_camera_pose(None, yaw, pitch, [0.0, 0.0, 0.2], radius=2.7).numpy()
        c = np.concatenate([pose.reshape(16), self._K]).astype(np.float32)
        return {"image": img, "c": c, "v": {"uvcoords_image": self._uvc}}


def standin_detector(seed: int = 0, device="cuda"):
    """A seeded STAND-IN for the Inception feature detector, on `device`
    (CUDA unless `device="cpu"` is asked for): uint8 NHWC images -> [-1, 1],
    area-pooled to 16², a seeded random projection to 32 features and tanh
    -> float64 numpy [N, 32]. It is not Inception: metric values through it
    are not comparable with published ones. 32 features stay below fid64's
    sample count, so the covariances have full rank."""
    import torch.nn.functional as F

    pool, dim = 16, 32
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    proj = (torch.randn((3 * pool * pool, dim), generator=gen) * (3 * pool * pool) ** -0.5
            ).to(device)

    def detect(images_u8: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(images_u8)).to(device)
        x = x.permute(0, 3, 1, 2).float() / 127.5 - 1.0
        x = F.adaptive_avg_pool2d(x, pool).flatten(1)
        return torch.tanh(x @ proj).double().cpu().numpy()

    return detect
