"""Device busy time under the `render` spans, per frame."""

NAME, UNIT, BETTER, SOURCE = "render_busy_ms", "ms", "lower", "device_trace"
LAYER, MOVES = "renderer (render/renderer.py, kernels included)", "frames_per_s"


def read(summary):
    busy = summary["span_busy_s"].get("render")
    return None if busy is None else busy * 1e3 / summary["frames"]
