"""The port's spans and its count of host–device synchronisations
(`invertavatar_torch/utils/trace.py`), on a tiny TriPlaneGenerator frame
driven by FaceVerse and a tiny Next3D frame (the sizes of the benchmark's
CPU tests): with no profiler the tracer records nothing; under a CPU
profiler the spans nest as the layers do, all carry the `span:` prefix and
none takes a name the benchmark places itself; a synchronisation is
counted in the innermost open span; only the layers the benchmark reads on
the device timeline are mirrored there; the few-shot absorb opens its spans
in the order of its layers, with the encoder and the U-Nets mirrored on the
device. The card's own cases (`-m cuda`)
check that CUDA's sync debug mode sees the blocking copies, that each
cell's frame makes none, and that a host span leaves a mirrored scope
around it every kernel."""

import warnings

import numpy as np
import pytest
import torch

from benchmark.lib import registry
from benchmark.run import _merge
from benchmark.tests.tiny import CELLS, TINY_CONFIG, TINY_MIX
from benchmark.tests.tiny_fsinvert import CELL as ABSORB_CELL
from benchmark.tests.tiny_fsinvert import FS_CONFIG, FS_MIX
from benchmark.traffic.generate import make_inputs
from invertavatar_torch.utils import trace

# the names the benchmark places around callables of its own
BENCHMARK_NAMES = {"step", "driving", "backbone", "render", "sr", "b1_roofline", "b2_roofline",
                   "b3_roofline"}

# (parent, child) pairs of the span tree of each generator's frame
TREES = {
    "ani3dgan512-live4": {
        ("faceverse", "raster"), ("raster", "raster.bin"), ("raster", "raster.setup"),
        ("raster", "raster.z"), ("raster", "raster.untile"), ("faceverse", "uvimage"),
        ("uvimage", "raster.interp"), ("frame", "uvwarp"), ("uvwarp", "fill_mouth"),
        ("fill_mouth", "flood"), ("fill_mouth", "fill"), ("uvwarp", "warp"), ("frame", "stylegan"),
        ("stylegan", "stylegan.b32"), ("stylegan", "stylegan.b256"), ("frame", "volume"),
        ("volume", "rays"), ("volume", "coarse"), ("volume", "importance"), ("volume", "fine"),
        ("frame", "superres"), ("superres", "superres.b64"), ("superres", "superres.b128"),
        ("stylegan.b4", "conv1"), ("stylegan.b8", "conv0"), ("stylegan.b8", "torgb"),
        ("superres.b128", "conv1"),
    },
    "next3d-live1": {
        ("frame", "stylegan"), ("stylegan", "stylegan.b4"), ("stylegan", "stylegan.b256"),
        ("stylegan", "stylegan.e256"), ("frame", "views"), ("views", "view"), ("view", "raster"),
        ("raster", "raster.z"), ("view", "raster.interp"), ("view", "sample"),
        ("view", "fill_mouth"), ("fill_mouth", "flood"), ("frame", "mouth"),
        ("mouth", "stylegan"), ("mouth", "paste"), ("frame", "blend"), ("frame", "volume"),
        ("volume", "rays"), ("volume", "coarse"), ("volume", "importance"), ("volume", "fine"),
        ("frame", "superres"), ("superres", "superres.b128"),
    },
}
ROOTS = {"ani3dgan512-live4": {"faceverse", "frame"}, "next3d-live1": {"frame"}}
DEVICE_SPANS = {"ani3dgan512-live4": {"uvwarp"}, "next3d-live1": {"views"}}


def _tiny_step(cell, dev):
    """step(t) of the program at the benchmark's tiny sizes on `dev`: the
    cell's driving signal and frame, as the benchmark's loop runs them."""
    wl = registry.workload(cell)
    cfg = _merge(registry.config(wl["config"]), TINY_CONFIG[wl["config"]])
    mix = _merge(registry.traffic(wl["traffic"]), TINY_MIX)
    with torch.inference_mode():
        inputs = make_inputs(mix, cfg, 7, dev)
        build = registry.config_module(wl["config"]).Build("program", cfg, mix, inputs, 7, dev)
        rows = list(range(inputs["batch"]))
        avatar = build.avatar(rows)

    @torch.inference_mode()
    def step(t):
        return build.frame(avatar, rows, t, build.drive(t))

    return step


@pytest.fixture(scope="module", params=sorted(TREES))
def tiny_frame(request):
    """(cell, step(t)) of the program at the benchmark's tiny sizes, warmed up."""
    step = _tiny_step(request.param, torch.device("cpu"))
    step(0)
    return request.param, step


def _spans(prof):
    """[(start, end, name)] of the program's spans in a trace, by start."""
    return sorted((e.time_range.start, e.time_range.end, e.name[len(trace.PREFIX):])
                  for e in prof.events() if e.name.startswith(trace.PREFIX))


def _edges(spans):
    """{(parent, child)} by interval nesting, and the names of the roots."""
    edges, roots, stack = set(), set(), []
    for s, e, name in spans:
        while stack and stack[-1][1] <= s:
            stack.pop()
        if stack:
            edges.add((stack[-1][2], name))
        else:
            roots.add(name)
        stack.append((s, e, name))
    return edges, roots


def test_off_span_is_one_shared_no_op():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert trace.span("frame") is trace.span("volume")
    with trace.span("frame") as entered:
        assert entered is None


def test_without_a_profiler_nothing_is_recorded(tiny_frame, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("called while no profiler records")

    _, step = tiny_frame
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(trace, "host_sync", refuse)
    before = sum(trace.syncs.values())
    out = step(1)
    assert out["image"].isfinite().all()
    assert sum(trace.syncs.values()) == before and not trace._open


def test_spans_nest_as_the_layers(tiny_frame):
    cell, step = tiny_frame
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(1)
    # mirrored on the device: the layers the benchmark reads there, alone
    annotations = {e.name for e in prof.events() if e.is_user_annotation}
    assert annotations == {trace.PREFIX + n for n in DEVICE_SPANS[cell]}
    spans = _spans(prof)
    names = {n for _, _, n in spans}
    assert not names & BENCHMARK_NAMES
    edges, roots = _edges(spans)
    assert roots == ROOTS[cell]
    assert TREES[cell] <= edges, TREES[cell] - edges
    assert not trace._open


def test_the_absorb_opens_its_spans_in_the_order_of_its_layers():
    """`absorb_clip` is one root span, `absorb`: the encode of the first
    frame, then one `absorb.chunk` a chunk, each rendering the chunk
    (`frame`) before both U-Nets, each U-Net stepping its ConvGRUs (`gru`);
    the encoder and the U-Nets are mirrored on the device, beside the
    frame's UV warp."""
    from invertavatar_torch.cli import eval_seq

    wl = registry.workload(ABSORB_CELL)
    cfg = _merge(registry.config(wl["config"]), FS_CONFIG)
    mix = _merge(registry.traffic(wl["traffic"]), FS_MIX)
    dev = torch.device("cpu")
    with torch.inference_mode():
        inputs = make_inputs(mix, cfg, 7, dev)
        build = registry.config_module(wl["config"]).Build("program", cfg, mix, inputs, 7, dev)
        clip = build._clip(0)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            eval_seq.absorb_clip(build.net, clip["frames"], clip["uv"], clip["cameras"],
                                 clip["uvcoords"], build.T)
    annotations = {e.name for e in prof.events() if e.is_user_annotation}
    assert annotations == {trace.PREFIX + n for n in ("encode", "texture_unet", "triplane_unet",
                                                      "uvwarp")}
    spans = _spans(prof)
    edges, roots = _edges(spans)
    assert roots == {"absorb"}
    assert {("absorb", "encode"), ("absorb", "absorb.chunk"), ("absorb.chunk", "frame"),
            ("absorb.chunk", "texture_unet"), ("absorb.chunk", "triplane_unet"),
            ("texture_unet", "gru"), ("triplane_unet", "gru")} <= edges
    first = {}
    for _, _, name in spans:
        first.setdefault(name, len(first))
    order = ["absorb", "encode", "absorb.chunk", "frame", "texture_unet", "gru", "triplane_unet"]
    assert sorted(order, key=first.__getitem__) == order
    n_chunks = build.n // build.T
    assert sum(n == "absorb.chunk" for _, _, n in spans) == n_chunks
    assert sum(n == "gru" for _, _, n in spans) == 2 * 4 * n_chunks  # 4 decoder stages a U-Net
    assert not trace._open


def test_host_sync_counts_in_the_innermost_span(monkeypatch):
    calls = []
    monkeypatch.setattr(trace, "host_sync", calls.append)
    shown = []
    monkeypatch.setattr(warnings, "showwarning", lambda *a, **k: shown.append(str(a[0])))
    with warnings.catch_warnings(), \
            torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        warnings.simplefilter("always")
        with trace.span("frame"):
            warnings.warn(trace.SYNC_WARNING)
            with trace.span("views"), trace.span("view"):
                for _ in range(2):
                    warnings.warn(trace.SYNC_WARNING)
                warnings.warn("another warning")
            warnings.warn(trace.SYNC_WARNING)
        warnings.warn(trace.SYNC_WARNING + " outside every span")
    assert calls == ["frame", "view", "view", "frame"]
    assert shown == ["another warning", trace.SYNC_WARNING + " outside every span"]
    assert not trace._open


@pytest.mark.cuda
def test_sync_debug_mode_sees_the_blocking_copies():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    x = torch.ones(4, device=dev)
    before = dict(trace.syncs)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        with trace.span("frame"):
            with trace.span("view"):
                torch.tensor([1.0, -1.0, 1.0], device=dev)  # a list copied to the card
                torch.from_numpy(np.ones(3, np.float32)).to(dev)  # pageable host memory
            with trace.span("volume"):
                x.sum().item()
                x.cpu()
                (x + 1).mul_(2)  # no synchronisation
    grown = {k: v - before.get(k, 0) for k, v in trace.syncs.items() if v != before.get(k, 0)}
    assert grown == {"view": 2, "volume": 2}
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.cuda
def test_a_host_span_leaves_the_mirrored_scope_around_it_its_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.ones(1 << 20, device="cuda")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("span:outer"):
            with trace.span("inner"):
                y = (x * 2).add_(1)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    mirrors = {e.name: e for e in prof.events() if e.device_type == cuda
               and e.name.startswith(trace.PREFIX)}
    kernels = [e for e in prof.events() if e.device_type == cuda
               and not e.name.startswith(trace.PREFIX)]
    assert set(mirrors) == {"span:outer"} and len(kernels) == 2
    outer = mirrors["span:outer"].time_range
    assert all(outer.start <= k.time_range.start < outer.end for k in kernels)
    assert y.sum().item() == 3 * (1 << 20)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_frame_on_the_card_makes_no_host_sync(cell):
    """A warmed-up step of each cell's program (FaceVerse driving and
    `TriPlaneGenerator.synthesis_withTexture` with the raster caches, or a
    Next3D `synthesis`) runs under CUDA's sync debug mode at "error" without
    raising, and counts no synchronisation in its spans while traced."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    step = _tiny_step(cell, torch.device("cuda"))
    step(0)  # kernel builds, library handles and the allocator's first blocks
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step(1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    before = dict(trace.syncs)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        step(2)
        torch.cuda.synchronize()  # every kernel's record inside the trace that launched it
    assert dict(trace.syncs) == before
    assert out["image"].isfinite().all()
