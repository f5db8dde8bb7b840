"""The 95th percentile of every step's latency in the untraced window of a
closed loop (host clock, from the step's start to its outputs
synchronised), where the cell does not hold `frame_ms_p95` end to end:
there the host's speed, which moves between runs, paces the tail too
widely for a bound (PERF.md §2)."""

NAME, UNIT, BETTER, SOURCE = "step_ms_p95", "ms", "lower", "host_clock"
LAYER, MOVES = "entry and host dispatch (the eager frame)", "frames_per_s"


def read(summary):
    if "frame_ms_p95" in summary["end_to_end"]:
        return None
    return summary["frame_ms_p95"]
