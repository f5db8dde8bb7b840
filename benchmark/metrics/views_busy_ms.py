"""Device busy time under the program's `views` span (Next3D's four view
rasters with their mouth fills and texture samples), per frame."""

NAME, UNIT, BETTER, SOURCE = "views_busy_ms", "ms", "lower", "device_trace"
LAYER, MOVES = "Next3D view rasters (models/next3d.py: rasterize_views)", "frames_per_s"


def read(summary):
    busy = summary["span_busy_s"].get("views")
    return None if busy is None else busy * 1e3 / summary["frames"]
