"""Spans placed from the benchmark's own files, and the reduction of a
`torch.profiler` trace of the window to what the per-layer metrics read.

`stage_scopes` is a copy of `invertavatar_torch/utils/profiling.py:
_stage_scopes`: it wraps each named callable where the program looks it up
in a `record_function` scope, so the program itself is not edited. The
profiler mirrors each scope onto the device timeline (from the first to the
last device op launched inside it); a device op belongs to every scope
whose mirror holds its start. The card runs one stream, so the ops under a
scope are the ops it launched."""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

import torch

SPAN = "span:"  # prefix of every scope the benchmark places
STEP = SPAN + "step"  # the host span of one step, synchronised at its end


@contextlib.contextmanager
def stage_scopes(targets):
    """Wrap each `(stage, object, attribute)` callable in a `record_function`
    scope named `span:<stage>` (restored after)."""

    def scoped(stage, fn):
        def wrapped(*a, **k):
            with torch.profiler.record_function(SPAN + stage):
                return fn(*a, **k)
        return wrapped

    saved = []
    for stage, obj, attr in targets:
        saved.append((obj, attr, attr in vars(obj), getattr(obj, attr)))
        setattr(obj, attr, scoped(stage, getattr(obj, attr)))
    try:
        yield
    finally:
        for obj, attr, own, fn in reversed(saved):
            if own:
                setattr(obj, attr, fn)
            else:
                delattr(obj, attr)


@contextlib.contextmanager
def kernel_sites(sites, records):
    """Wrap each `(name, module, attribute, work)` kernel entry in a scope
    `span:<name>` and append `work(args, kwargs)` of every call (computed
    from shapes alone: no device op, no sync) to `records[name]`."""

    def scoped(name, fn, work):
        def wrapped(*a, **k):
            records[name].append(work(a, k))
            with torch.profiler.record_function(SPAN + name):
                return fn(*a, **k)
        return wrapped

    saved = []
    for name, module, attr, work in sites:
        saved.append((module, attr, getattr(module, attr)))
        setattr(module, attr, scoped(name, getattr(module, attr), work))
    try:
        yield
    finally:
        for module, attr, fn in reversed(saved):
            setattr(module, attr, fn)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def device_window(prof) -> dict:
    """The card's busy time (the union of device-op intervals) and the
    window's length, in seconds, from a trace that records device ops
    alone, so that the profiler adds no time on the host to the window. The
    window runs from the first step's start to the last one's end where
    the trace holds the steps, else from the first device op's start to
    the last one's end."""
    events = list(prof.events())
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    ops = [(e.time_range.start, e.time_range.end) for e in events
           if e.device_type == cuda and not e.name.startswith(SPAN)]
    steps = [e for e in events if e.device_type == cpu and e.name == STEP]
    if steps:
        lo = min(e.time_range.start for e in steps)
        hi = max(e.time_range.end for e in steps)
    elif ops:
        lo, hi = min(s for s, _ in ops), max(e for _, e in ops)
    else:
        raise RuntimeError("the trace holds neither a step nor a device op")
    busy = _clip(_merge(ops), lo, hi)
    return {"window_s": (hi - lo) / 1e6, "busy_s": sum(e - s for s, e in busy) / 1e6}


def reduce(prof, top: int = 10) -> dict:
    """What the metrics read from a trace of the window with its host ops
    (times in seconds): the device ops in the window (the first step's
    start to the last step's end, on the host clock), device busy time
    under each `span:` scope, and the breakdown (device ops with the most
    time; idle gaps by the span and the host op that ran when each
    began)."""
    events = list(prof.events())
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    steps = [e for e in events if e.device_type == cpu and e.name == STEP]
    if not steps:
        raise RuntimeError("the trace holds no step")
    lo = min(e.time_range.start for e in steps)
    hi = max(e.time_range.end for e in steps)
    on_device = [e for e in events if e.device_type == cuda]
    mirrors = defaultdict(list)
    work = []
    for e in on_device:
        if e.name.startswith(SPAN):
            mirrors[e.name[len(SPAN):]].append((e.time_range.start, e.time_range.end))
        elif lo <= e.time_range.start < hi:
            work.append((e.time_range.start, e.time_range.end, e.name))

    busy = _clip(_merge([(s, e) for s, e, _ in work]), lo, hi)
    span_busy = {}
    for name, ivs in mirrors.items():
        ivs = sorted(ivs)
        starts = [s for s, _ in ivs]
        total = 0.0
        for s, e, _ in work:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s < ivs[i][1]:
                total += e - s
        span_busy[name] = total / 1e6

    by_op = defaultdict(float)
    for s, e, name in work:
        by_op[name] += (e - s) / 1e6
    device_ops = sorted(([n[:160], t] for n, t in by_op.items()), key=lambda x: -x[1])[:top]

    # idle gaps, each labelled by the innermost span and host op active on
    # the host clock when the gap began
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type == cpu and e.name != STEP)
    host_starts = [h[0] for h in host]

    def label(t):
        i = bisect.bisect_right(host_starts, t) - 1
        span, op = None, None
        for j in range(i, max(i - 400, -1), -1):
            s, e, n = host[j]
            if e < t:
                continue
            if n.startswith(SPAN):
                span = span or n[len(SPAN):]
            else:
                op = op or n
            if span and op:
                break
        return f"{span or 'between spans'}/{op or 'python'}"

    gaps = defaultdict(float)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 > g0:
            gaps[label(g0)] += (g1 - g0) / 1e6
    idle_gaps = sorted(([n[:160], t] for n, t in gaps.items()), key=lambda x: -x[1])[:top]
    return {"device_ops": len(work), "span_busy_s": span_busy,
            "breakdown": {"device_ops": device_ops, "idle_gaps": idle_gaps}}
