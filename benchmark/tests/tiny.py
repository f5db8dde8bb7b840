"""Small sizes for the benchmark's CPU tests: every width of the cells is
cut here, never in the configuration files."""

TINY_CONFIG = {
    "ani3dgan512": {"generator": {"channel_base": 1024, "channel_max": 32,
                                  "neural_rendering_resolution": 32, "img_resolution": 128},
                    "rendering_kwargs": {"superresolution_module": "x.SuperresolutionHybrid2X",
                                         "depth_resolution": 6, "depth_resolution_importance": 6,
                                         "tile_shape": [16, 4]},
                    "faceverse_grid": 40},
    "next3d": {"generator": {"channel_base": 512, "channel_max": 64,
                             "neural_rendering_resolution": 32, "img_resolution": 128,
                             "faces_per_tile": 512},
               "rendering_kwargs": {"superresolution_module": "x.SuperresolutionHybrid2X",
                                    "image_resolution": 128, "depth_resolution": 6,
                                    "depth_resolution_importance": 6},
               "sphere": [24, 32]},
}
TINY_MIX = {"warmup_steps": 1, "check_steps": 2, "trace_steps": 2}
CELLS = {"ani3dgan512-grid10": "ani3dgan512", "ani3dgan512-live4": "ani3dgan512",
         "next3d-live1": "next3d"}


def run_tiny(cell, seed=7, trace=False, **kw):
    """One run of `cell` on the CPU at the tiny sizes (two steps at least)."""
    from benchmark.run import run_cell

    return run_cell(cell, seed, 0.0, trace, "cpu", config_override=TINY_CONFIG[CELLS[cell]],
                    traffic_override=dict(TINY_MIX, **kw.pop("traffic", {})), **kw)
