"""Spans at the layer boundaries of the port, and a count of the blocking
host–device synchronisations made inside them.

    from ..utils import trace

    with trace.span("volume"):
        ...

    @trace.spanned("uvwarp", device=True)
    def rasterize(...): ...

A span costs one attribute read when no profiler records: `span` then
returns one shared no-op context. While `torch.profiler` records, a span is
an event `span:<name>` of the host trace, on the clock of the host ops and
CUDA runtime calls. The tracer keeps no spans of its own: the profiler's
trace is the record. Every name carries the `span:` prefix, by which a
reader of the trace tells a span from an op.

Two kinds, because the profiler mirrors onto the device timeline only the
`record_function` scopes (user annotations), and each kernel only into the
innermost one open when it was launched:
  * a host span (the default) is a plain host event: it takes no kernel
    from a mirrored scope around it, so scopes placed around the program's
    callables from outside keep every kernel launched inside them;
  * a device span (`device=True`) is a `record_function` scope, mirrored
    from the first to the last kernel launched inside it. Only a layer
    that no other mirrored scope encloses or is enclosed by may take one:
    an inner mirrored scope would take its kernels away.

While a profiler records, the outermost span turns CUDA's sync debug mode
to "warn" and each "called a synchronizing CUDA operation" warning into one
call of `host_sync(where)`, `where` being the innermost open span; it puts
both back on exit. So every blocking synchronisation inside a span that
the debug mode sees is counted where it happens: `.item()`, `.cpu()`,
`nonzero`, the error check of `torch.linalg.inv`, and each host-to-device
copy from pageable memory (`torch.tensor(list, device=cuda)`,
`tensor.to(cuda)`), known or not. `host_sync` is called through the module
attribute, so a caller may wrap it to observe the calls; `syncs` counts
them by span. Like the profiler, the tracer is one per process: spans are
opened by one thread at a time."""

from __future__ import annotations

import collections
import contextlib
import functools
import warnings

import torch
import torch.autograd.profiler as _profiler

PREFIX = "span:"
SYNC_WARNING = "called a synchronizing CUDA operation"

_OFF = contextlib.nullcontext()
_open: list = []  # names of the open spans, innermost last, while a profiler records
syncs: collections.Counter = collections.Counter()  # host_sync calls by span


def span(name: str, device: bool = False):
    """A context that records `span:<name>` while `torch.profiler` records
    (mirrored on the device timeline with `device`), and does nothing
    otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def spanned(name: str, device: bool = False):
    """Decorate a function to run inside `span(name, device)`."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name, device):
                return fn(*args, **kwargs)
        return run
    return wrap


def host_sync(where: str) -> None:
    """One blocking host–device synchronisation made inside span `where`."""
    syncs[where] += 1


class _Span:
    __slots__ = ("name", "device", "scope", "watch")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device

    def __enter__(self):
        self.watch = None if _open else _SyncWatch()
        _open.append(self.name)
        self.scope = (torch.profiler.record_function(PREFIX + self.name) if self.device
                      else torch._C._profiler._RecordFunctionFast(PREFIX + self.name))
        self.scope.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self.scope.__exit__(*exc)
        finally:
            _open.pop()
            if self.watch is not None:
                self.watch.close()


class _SyncWatch:
    """CUDA's sync debug mode at "warn", each sync warning routed to
    `host_sync`, other warnings shown as before; `close` restores both."""

    def __init__(self):
        self.filters = warnings.catch_warnings()
        self.filters.__enter__()
        shown = warnings.showwarning
        warnings.filterwarnings("always", message=SYNC_WARNING, category=UserWarning)

        def show(message, category, filename, lineno, file=None, line=None):
            if SYNC_WARNING in str(message):
                host_sync(_open[-1] if _open else "")
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        self.mode = None
        if torch.cuda.is_initialized():
            self.mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")

    def close(self):
        if self.mode is not None:
            torch.cuda.set_sync_debug_mode(self.mode)
        self.filters.__exit__(None, None, None)
