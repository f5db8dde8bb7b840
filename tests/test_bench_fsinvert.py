"""The benchmark's `fsinvert512-absorb8` and `ani3dgan512-live1` cells on the
CPU at tiny sizes (`benchmark/tests/tiny_fsinvert.py`, `tiny.py`): the
program (`cli/eval_seq.absorb_clip`, `drive_caches` and one batched
`synthesis_withTexture`) equals the plain reference exactly; the TF32
control and three planted faults of the absorb (the GRU states dropped
between chunks, the SFT conditions left out of the static backbone, the
chunk renders that Δimage is taken from shifted) read not correct; a traced
run, in a fresh interpreter, reads the whole step's metrics, holds the
absorb's spans in its host trace and loads nothing of JAX; the new
per-layer metrics read the program's device spans; the reference's new
modules load nothing of the program; `BENCHMARK.json` names a file for
every cell, configuration and metric it lists.

The absorb's networks keep the published widths of their decoders and
heads at the tiny trunk, so each side is built and filled once for the
module (`shared_nets`) and each run takes a copy."""

import copy
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark.lib import registry
from benchmark.run import run_cell
from benchmark.tests.tiny import TINY_CONFIG, TINY_MIX
from benchmark.tests.tiny_fsinvert import CELL, run_tiny_fs

CHECKOUT = Path(__file__).resolve().parents[1]
LIVE1 = "ani3dgan512-live1"
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def shared_nets():
    """Builds each side's network once and fills it once per weight spec
    and seed; every `Build` of the module's runs gets a deep copy holding
    those weights, so a fault planted in one run stays there. The clip
    tables, read alike by both sides, are made once per seed and sizes."""
    fs = registry.config_module("fsinvert512")
    made, clips = {}, {}
    side, fill, config_module = fs._side, fs.fill, registry.config_module
    make_clips = fs.make_clips

    def cached_clips(traffic, cfg, inputs, seed, device):
        key = json.dumps([traffic, cfg, seed, str(device)], sort_keys=True)
        if key not in clips:
            clips[key] = make_clips(traffic, cfg, inputs, seed, device)
        return clips[key]

    def cached_side(name):
        build, absorb = side(name)

        def copy_of(generator_cfg, inv, device):
            if name not in made:
                made[name] = [build(generator_cfg, inv, device), None]
            net = copy.deepcopy(made[name][0])
            net.pristine = made[name]
            return net

        return copy_of, absorb

    def fill_once(module, spec, seed, stream=1):
        entry = getattr(module, "pristine", None)
        if entry is None:
            return fill(module, spec, seed, stream)
        key = (json.dumps(spec, sort_keys=True), seed, stream)
        if entry[1] != key:
            fill(entry[0], spec, seed, stream)
            entry[1] = key
        module.load_state_dict(entry[0].state_dict())
        return module

    mp = pytest.MonkeyPatch()
    mp.setattr(fs, "_side", cached_side)
    mp.setattr(fs, "fill", fill_once)
    mp.setattr(fs, "make_clips", cached_clips)
    mp.setattr(registry, "config_module",
               lambda name, *a, **k: fs if name == "fsinvert512" else config_module(name, *a, **k))
    yield
    mp.undo()


def _run(cell, **kw):
    if cell == CELL:
        return run_tiny_fs(**kw)
    return run_cell(cell, 7, 0.0, False, "cpu", config_override=TINY_CONFIG["ani3dgan512"],
                    traffic_override=TINY_MIX, **kw)


@pytest.mark.parametrize("cell", [CELL, LIVE1])
def test_program_equals_reference_on_the_cpu(cell, shared_nets):
    r = _run(cell)
    assert r["correct"] and r["failed"] == 0
    assert set(r["check"]) == set(registry.workload(cell)["limits"])
    assert all(v["value"] == 0 for v in r["check"].values())
    assert set(r["metrics"]) == set(registry.workload(cell)["end_to_end"])


@pytest.mark.parametrize("cell", [CELL, LIVE1])
def test_control_fails(cell, shared_nets):
    r = _run(cell, control="tf32")
    assert not r["correct"] and r["failed"] > 0


def _gru_carry_dropped(build):
    """Each chunk starts from fresh GRU states: `absorb_clip`'s carry lost."""
    ar_forward = build.net.ar_forward

    def fresh(x, vid_c, vid_v, ws, r_list, **kw):
        return ar_forward(x, vid_c, vid_v, ws, [None, None], **kw)

    build.net.ar_forward = fresh


def _sft_left_out(build):
    """The static backbone runs without the triplane U-Net's conditions."""
    synthesis = build.G.backbone.synthesis
    forward = synthesis.forward

    def unconditioned(*args, feat_conditions=None, **kw):
        return forward(*args, **kw)

    synthesis.forward = unconditioned


def _chunk_renders_shifted(build):
    """The chunk renders' super-resolved images, which Δimage is taken
    from, are off by 0.05 (the reconstructions are not): the check's
    reference takes Δimage from them as well, so only its own comparison of
    the renders can see the fault."""
    sr = build.G.superresolution
    forward = sr.forward

    def shifted(*args, **kw):
        out = forward(*args, **kw)
        return out + 0.05 if out.shape[0] == build.T else out

    sr.forward = shifted


@pytest.mark.parametrize("fault", [_gru_carry_dropped, _sft_left_out, _chunk_renders_shifted])
def test_broken_absorb_fails(fault, shared_nets):
    r = run_tiny_fs(fault=fault)
    assert not r["correct"] and r["failed"] > 0


def test_traced_absorb_reads_its_layers():
    """In a fresh interpreter (the tests' process holds JAX): the traced
    run reads the whole step's metrics, its host trace holds the absorb's
    spans, and no module of JAX or of the JAX package was loaded."""
    code = (
        "import json, sys; sys.path.insert(0, '.')\n"
        "import torch; torch.set_num_threads(1)\n"
        "from benchmark.lib import trace as tr\n"
        "from benchmark.run import forbidden_modules\n"
        "from benchmark.tests.tiny_fsinvert import run_tiny_fs\n"
        "names, reduce = set(), tr.reduce\n"
        "def keep(prof, *a, **k):\n"
        "    names.update(e.name for e in prof.events() if e.name.startswith(tr.SPAN))\n"
        "    return reduce(prof, *a, **k)\n"
        "tr.reduce = keep\n"
        "r = run_tiny_fs(trace=True)\n"
        "print(json.dumps({'correct': r['correct'], 'metrics': r['metrics'],\n"
        "                  'spans': sorted(names), 'forbidden': forbidden_modules()}))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=CHECKOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["forbidden"] == []
    assert {"idle_share", "mfu", "device_ops_per_frame"} <= set(out["metrics"])
    assert out["metrics"]["host_syncs_per_frame"]["value"] == 0.0
    spans = {n[len("span:"):] for n in out["spans"]}
    assert {"absorb", "absorb.chunk", "encode", "texture_unet", "triplane_unet", "gru",
            "backbone", "render", "sr"} <= spans


def test_the_absorb_metrics_read_the_programs_device_spans():
    metrics = {m.NAME: m for m in registry.metrics()}
    busy = {"encode": 0.004, "texture_unet": 0.003, "triplane_unet": 0.005, "frame": 1.0}
    summary = {"frames": 8, "span_busy_s": busy, "kernels": {}}
    assert metrics["encode_busy_ms"].read(summary) == pytest.approx(0.5)
    assert metrics["unet_busy_ms"].read(summary) == pytest.approx(1.0)
    # a program whose encoder and U-Nets are host spans alone reads nothing
    parent = dict(summary, span_busy_s={"frame": 1.0})
    assert metrics["encode_busy_ms"].read(parent) is None
    assert metrics["unet_busy_ms"].read(parent) is None


def test_the_new_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "import benchmark.reference.inversion, benchmark.traffic.clips\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'invertavatar_torch', 'invertavatar_tpu', 'jax', 'jaxlib', 'flax'}))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=CHECKOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_benchmark_json_names_a_file_for_everything_it_lists():
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    for w in bench["workloads"]:
        spec = registry.workload(w["name"])
        assert (spec["config"], spec["traffic"]) == (w["config"], w["traffic"])
        registry.traffic(w["traffic"])
    for c in bench["configs"]:
        assert registry.config(c["name"])["name"] == c["name"]
        assert (CHECKOUT / c["file"]).is_file()
    readers = {m.NAME for m in registry.metrics()}
    for m in bench["per_layer"]:
        assert m["name"] in readers
        assert set(m.get("workloads", ())) <= set(cells)
    for metric in ("encode_busy_ms", "unet_busy_ms", "mfu", "idle_share", "b1_roofline"):
        assert CELL in next(m for m in bench["per_layer"] if m["name"] == metric)["workloads"]
