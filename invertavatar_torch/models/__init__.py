"""Generator modules: StyleGAN2 backbones, super-resolution, the tri-plane
generator and the legacy Next3D generators."""

from .next3d import CondGenerator, LegacyTriPlaneGenerator, Next3DTriPlaneGenerator
from .synthesis import Generator, SynthesisNetwork
from .triplane import OSGDecoder, TriPlaneGenerator

__all__ = ["Generator", "SynthesisNetwork", "OSGDecoder", "TriPlaneGenerator", "CondGenerator",
           "LegacyTriPlaneGenerator", "Next3DTriPlaneGenerator"]
