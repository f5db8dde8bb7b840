"""Device busy time under the program's `encode` span (the e4e encoder of a
source clip's first frame: IR-SE-50 trunk, FPN laterals, style heads), per
source frame. A program whose `encode` is not mirrored on the device reads
nothing."""

NAME, UNIT, BETTER, SOURCE = "encode_busy_ms", "ms", "lower", "device_trace"
LAYER, MOVES = "e4e encoder (models/encoders/e4e.py, irse.py)", "frames_per_s"


def read(summary):
    busy = summary["span_busy_s"].get("encode")
    return None if busy is None else busy * 1e3 / summary["frames"]
