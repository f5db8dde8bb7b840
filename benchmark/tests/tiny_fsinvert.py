"""Small sizes for the CPU tests of the `fsinvert512` cell: ani3dgan512's
tiny generator (`tiny.py`) over a 12² FaceVerse grid, the tiny IR-SE trunks
(8 layers; the decoders, style heads and SFT heads keep their widths) and
one clip of 2 source frames absorbed in 2 chunks of 1, so the GRU states
still cross a chunk boundary. One window step and one checked step: every
width of the cell is cut here, never in the configuration file."""

from benchmark.tests.tiny import TINY_CONFIG

CELL = "fsinvert512-absorb8"
FS_CONFIG = dict(TINY_CONFIG["ani3dgan512"], faceverse_grid=12,
                 inversion={"trunk_layers_n": 8, "chunk": 1, "source_frames": 2})
FS_MIX = {"identities_per_stream": 2, "cycle_frames": 2, "noise_resolution": 8,
          "warmup_steps": 0, "check_steps": 1, "trace_steps": 1}


def run_tiny_fs(seed=7, trace=False, **kw):
    """One run of the absorb cell on the CPU at the tiny sizes."""
    from benchmark.run import run_cell

    return run_cell(CELL, seed, 0.0, trace, "cpu", config_override=FS_CONFIG,
                    traffic_override=FS_MIX, **kw)
