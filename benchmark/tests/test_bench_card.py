"""On the card: one short run of each cell through the command, whose last
line is the result and whose check passes. Run there with
`python -m pytest -m cuda benchmark/tests/test_bench_card.py`."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ani3dgan512-grid10", "next3d-live1", "ani3dgan512-live4"])
def test_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                           "2147483999", "--seconds", "3", "--trace", "0"],
                          capture_output=True, text=True, timeout=600, cwd=CHECKOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
