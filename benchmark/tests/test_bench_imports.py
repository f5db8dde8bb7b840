"""No module a run loads has the top-level name `jax`, `jaxlib`, `flax` or
`invertavatar_tpu` (names compared whole: the port's name begins with the
JAX package's), and the reference alone loads nothing of the program.
Each check runs in a fresh interpreter."""

import subprocess
import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]


def _python(code: str):
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=CHECKOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("cell", ["ani3dgan512-grid10", "next3d-live1", "ani3dgan512-live4"])
def test_a_run_loads_no_jax(cell):
    last = _python(
        "import sys; sys.path.insert(0, '.')\n"
        "from benchmark.tests.tiny import run_tiny\n"
        "from benchmark.run import forbidden_modules\n"
        f"r = run_tiny({cell!r}, trace=True)\n"
        "assert r['correct'], r['check']\n"
        "print(forbidden_modules(), 'invertavatar_torch' in sys.modules)")
    assert last == "[] True"


def test_the_reference_loads_nothing_of_the_program():
    last = _python(
        "import sys; sys.path.insert(0, '.')\n"
        "import benchmark.reference.triplane, benchmark.reference.next3d\n"
        "import benchmark.reference.faceverse_manager, benchmark.reference.precision\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'invertavatar_torch', 'invertavatar_tpu', 'jax', 'jaxlib', 'flax'}))")
    assert last == "[]"
