"""Device busy time under the program's `uvwarp` spans (the UV warp with
`fill_mouth`, and the blend into the frontal plane), per frame."""

NAME, UNIT, BETTER, SOURCE = "uvwarp_busy_ms", "ms", "lower", "device_trace"
LAYER, MOVES = "UV warp (models/triplane.py: rasterize, _blend_planes)", "frames_per_s"


def read(summary):
    busy = summary["span_busy_s"].get("uvwarp")
    return None if busy is None else busy * 1e3 / summary["frames"]
