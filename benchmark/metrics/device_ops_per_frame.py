"""Device ops (kernels, copies, fills) in the traced window, per frame."""

NAME, UNIT, BETTER, SOURCE = "device_ops_per_frame", "ops", "lower", "device_trace"
LAYER, MOVES = "entry and host dispatch (the eager frame)", "frames_per_s"


def read(summary):
    return summary["device_ops"] / summary["frames"]
