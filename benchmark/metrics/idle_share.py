"""The share of a window in which no device op runs, from a trace that
records device ops alone (`trace.device_window`): with host ops recorded
too, the profiler's own host time would read as idle."""

NAME, UNIT, BETTER, SOURCE = "idle_share", "%", "lower", "device_trace"
LAYER, MOVES = "device (the card)", "frames_per_s"


def read(summary):
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
