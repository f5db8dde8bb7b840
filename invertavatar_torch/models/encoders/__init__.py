"""Inversion encoders: the IR-SE trunk, the e4e W+ encoder, the ConvGRU U-Nets
of the few-shot stage and the inversion network that pairs them with the
frozen generator."""

from .e4e import E4E, Encoder4Editing, LatentCodesDiscriminator
from .irse import BottleneckIRSE, IRSETrunk
from .unet_encoders import ConvGRU, TriPlanefeatEncoder, TriPlaneSFTfeatEncoder
from .uvnet import InversionNet, UnetEncoderPair, texture_out_channels_for

__all__ = ["E4E", "Encoder4Editing", "LatentCodesDiscriminator", "BottleneckIRSE", "IRSETrunk",
           "ConvGRU", "TriPlanefeatEncoder", "TriPlaneSFTfeatEncoder", "InversionNet",
           "UnetEncoderPair", "texture_out_channels_for"]
