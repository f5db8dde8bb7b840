"""Blocking host-device synchronisations inside the program's spans, per
frame: the calls of `invertavatar_torch.utils.trace.host_sync` in the
traced window (each names the innermost span it was made in). A program
without that tracer has nothing to count, and the metric reads nothing."""

import importlib.util

NAME, UNIT, BETTER, SOURCE = "host_syncs_per_frame", "syncs", "lower", "program_counter"
LAYER, MOVES = "entry and host dispatch (the eager frame)", "frames_per_s"
TRACER = "invertavatar_torch.utils.trace"


def _has_tracer() -> bool:
    try:
        return importlib.util.find_spec(TRACER) is not None
    except ImportError:
        return False


if _has_tracer():
    SITE = (TRACER, "host_sync")


def work(args, kwargs):
    return args[0] if args else kwargs["where"]


def read(summary):
    calls = summary["kernels"].get(NAME)
    return None if calls is None else len(calls) / summary["frames"]
