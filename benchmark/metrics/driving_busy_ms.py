"""Device busy time under the `driving` spans, per frame."""

NAME, UNIT, BETTER, SOURCE = "driving_busy_ms", "ms", "lower", "device_trace"
LAYER, MOVES = "driving signal (faceverse/manager.py, render/rasterizer.py)", "frames_per_s"


def read(summary):
    busy = summary["span_busy_s"].get("driving")
    return None if busy is None else busy * 1e3 / summary["frames"]
