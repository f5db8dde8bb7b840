"""Per-layer metrics, one reader a file (`<name>.py`): NAME, UNIT, BETTER,
SOURCE, LAYER, MOVES and `read(summary)`, which returns None where the
trace holds nothing for it. A kernel's roofline also names the SITE (module,
attribute) the program calls it through and `work(args, kwargs)`, the
(bytes, fp32 flops, tensor-core flops) of one call from its shapes.

`summary` holds the traced window: "frames", "window_s", "busy_s",
"device_ops", "span_busy_s" {span: seconds}, "kernels" {name: [work of
each call]} and "flops_per_frame" (the reference's model FLOPs a frame)."""
