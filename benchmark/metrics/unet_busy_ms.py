"""Device busy time under the program's `texture_unet` and `triplane_unet`
spans (both ConvGRU U-Nets of a chunk: IR-SE-50 trunks, recurrent decoders,
offset and SFT heads), per source frame. A program whose U-Nets are not
mirrored on the device reads nothing."""

NAME, UNIT, BETTER, SOURCE = "unet_busy_ms", "ms", "lower", "device_trace"
LAYER, MOVES = "ConvGRU U-Nets (models/encoders/unet_encoders.py)", "frames_per_s"
SPANS = ("texture_unet", "triplane_unet")


def read(summary):
    busy = [summary["span_busy_s"][s] for s in SPANS if s in summary["span_busy_s"]]
    return sum(busy) * 1e3 / summary["frames"] if busy else None
