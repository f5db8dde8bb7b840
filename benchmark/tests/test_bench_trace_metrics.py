"""The per-layer metrics that read the program's own spans and its count of
host-device synchronisations, on hand-built summaries: each reads its value
where the trace holds what it reads, and nothing where it does not (a
program without those spans or without the tracer)."""

import pytest

from benchmark.lib import registry

METRICS = {m.NAME: m for m in registry.metrics()}


def _summary(**kw):
    return dict({"frames": 40, "span_busy_s": {}, "kernels": {}}, **kw)


@pytest.mark.parametrize("name, span", [("uvwarp_busy_ms", "uvwarp"), ("views_busy_ms", "views")])
def test_span_busy_per_frame(name, span):
    m = METRICS[name]
    assert m.read(_summary(span_busy_s={span: 0.05, "frame": 2.0})) == pytest.approx(1.25)
    assert m.read(_summary(span_busy_s={"frame": 2.0})) is None


def test_host_syncs_per_frame():
    m = METRICS["host_syncs_per_frame"]
    assert m.SITE == ("invertavatar_torch.utils.trace", "host_sync")
    assert m.work(("view",), {}) == "view" and m.work((), {"where": "raster"}) == "raster"
    calls = ["view"] * 96 + ["raster"] * 32
    assert m.read(_summary(kernels={m.NAME: calls})) == pytest.approx(3.2)
    assert m.read(_summary(kernels={m.NAME: []})) == 0.0
    # a program without the tracer: no site placed, so nothing recorded
    assert m.read(_summary()) is None


def test_the_counter_sees_the_programs_calls():
    """The benchmark's kernel-site wrapper records each call made through
    the module attribute, with the span it names."""
    from collections import defaultdict

    from benchmark.lib.trace import kernel_sites
    from invertavatar_torch.utils import trace

    m = METRICS["host_syncs_per_frame"]
    records = defaultdict(list)
    with kernel_sites([(m.NAME, trace, "host_sync", m.work)], records):
        trace.host_sync("view")
        trace.host_sync("volume")
    assert records[m.NAME] == ["view", "volume"]
    assert trace.host_sync.__module__ == trace.__name__
