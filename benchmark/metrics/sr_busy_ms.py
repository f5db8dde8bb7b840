"""Device busy time under the `sr` spans, per frame."""

NAME, UNIT, BETTER, SOURCE = "sr_busy_ms", "ms", "lower", "device_trace"
LAYER, MOVES = "super-resolution (models/superresolution.py)", "frames_per_s"


def read(summary):
    busy = summary["span_busy_s"].get("sr")
    return None if busy is None else busy * 1e3 / summary["frames"]
