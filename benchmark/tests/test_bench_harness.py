"""The harness on the CPU at tiny sizes: each cell runs and the program
agrees with the frozen reference exactly (on the CPU the port's kernel
wrappers run their plain versions, which the reference copies); the traced
run reads the per-layer metrics; a cell, configuration, traffic mix and
metric dropped in as new files alone are found and run; without a card the
command prints no result and fails."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.lib import registry
from benchmark.tests.tiny import TINY_CONFIG, run_tiny

CHECKOUT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("cell", ["ani3dgan512-grid10", "next3d-live1", "ani3dgan512-live4"])
def test_program_equals_reference_on_the_cpu(cell):
    r = run_tiny(cell)
    assert r["correct"] and r["failed"] == 0
    assert set(r["check"]) == set(registry.workload(cell)["limits"])
    assert all(v["value"] == 0 for v in r["check"].values())
    assert set(r["metrics"]) == set(registry.workload(cell)["end_to_end"])
    assert list(r)[-1] == "check"


def test_traced_run_reads_the_layers():
    r = run_tiny("ani3dgan512-grid10", trace=True)
    assert r["correct"]
    assert {"idle_share", "mfu", "device_ops_per_frame"} <= set(r["metrics"])
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def test_new_files_alone_are_found(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(registry.ROOT, root, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    cfg = json.loads((root / "configs" / "ani3dgan512.json").read_text())
    for key, over in TINY_CONFIG["ani3dgan512"].items():
        cfg[key] = dict(cfg[key], **over) if isinstance(over, dict) else over
    (root / "configs" / "dropin.json").write_text(json.dumps(dict(cfg, name="dropin")))
    shutil.copy(root / "configs" / "ani3dgan512.py", root / "configs" / "dropin.py")
    mix = json.loads((root / "traffic" / "live4.json").read_text())
    mix.update(streams=2, identities_per_stream=2, warmup_steps=1, check_steps=1, trace_steps=2)
    (root / "traffic" / "pairs.json").write_text(json.dumps(mix))
    (root / "workloads" / "dropin-pairs.json").write_text(json.dumps(
        {"config": "dropin", "traffic": "pairs", "chips": 1,
         "end_to_end": ["frames_per_s", "setup_s"],
         "limits": {"image": 0.0, "image_raw": 0.0, "image_depth": 0.0, "drive": 0.0}}))
    (root / "metrics" / "frames_traced.py").write_text(
        'NAME, UNIT, BETTER, SOURCE = "frames_traced", "frames", "higher", "program_counter"\n'
        'LAYER, MOVES = "entry", "frames_per_s"\n\n\n'
        'def read(summary):\n    return summary["frames"]\n')
    from benchmark.run import run_cell

    r = run_cell("dropin-pairs", 5, 0.0, True, "cpu", root=root)
    # frames of the traced window with host ops: its trace_steps steps of 4 frames
    assert r["correct"] and r["metrics"]["frames_traced"]["value"] == 2 * 4 < r["attempted"]
    r = run_cell("dropin-pairs", 5, 0.0, False, "cpu", root=root)
    assert r["correct"] and set(r["metrics"]) == {"frames_per_s", "setup_s"}


def test_without_a_card_no_result(tmp_path):
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, str(CHECKOUT / "benchmark" / "run.py"), "--workload",
                           "ani3dgan512-grid10", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_step_tail_is_per_layer_only_where_not_end_to_end():
    tail = {m.NAME: m for m in registry.metrics()}["step_ms_p95"]
    assert tail.read({"end_to_end": ["frames_per_s", "frame_ms_p95"], "frame_ms_p95": 9.0}) is None
    assert tail.read({"end_to_end": ["frames_per_s"], "frame_ms_p95": 9.0}) == 9.0


def test_a_pipelined_loop_has_no_step_tail():
    with pytest.raises(ValueError, match="pipelined"):
        run_tiny("ani3dgan512-live4", traffic={"loop": "pipelined", "ahead_steps": 2})
