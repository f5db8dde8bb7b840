"""Inversion encoders: the IR-SE trunk, the e4e W+ encoder and the inversion
network that pairs it with the frozen generator."""

from .e4e import E4E, Encoder4Editing, LatentCodesDiscriminator
from .irse import BottleneckIRSE, IRSETrunk
from .uvnet import InversionNet

__all__ = ["E4E", "Encoder4Editing", "LatentCodesDiscriminator", "BottleneckIRSE", "IRSETrunk",
           "InversionNet"]
