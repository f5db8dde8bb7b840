"""A kernel's share of its roofline: the least time of the work of every
recorded call (`bounds.bound_ms`) over the device time of all ops under
the span around those calls. Dividing by everything under the span, not by
one kernel's name, keeps the reading on the work when a later change
splits, renames or replaces the kernel."""

from benchmark.lib.bounds import bound_ms


def share(summary, name):
    calls = summary["kernels"].get(name)
    busy = summary["span_busy_s"].get(name)
    if not calls or not busy:
        return None
    return 100.0 * sum(bound_ms(*w) for w in calls) / (busy * 1e3)
