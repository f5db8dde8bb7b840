"""Device busy time under the `backbone` spans, per frame."""

NAME, UNIT, BETTER, SOURCE = "backbone_busy_ms", "ms", "lower", "device_trace"
LAYER, MOVES = "StyleGAN2 backbones (models/synthesis.py)", "frames_per_s"


def read(summary):
    busy = summary["span_busy_s"].get("backbone")
    return None if busy is None else busy * 1e3 / summary["frames"]
