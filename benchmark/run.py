#!/usr/bin/env python3
"""The benchmark of `invertavatar_torch` on NVIDIA GPUs: one cell a run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (`workloads/<cell>.json`) names a configuration and a traffic mix.
The run makes every input and weight from the seed, builds the program,
makes each avatar's frame-independent part and warms every shape up
(set-up), then runs the frame loop for `--seconds`: closed (each step
waits for the last one's outputs) or pipelined (steps are sent ahead of
the card, and the window ends when the last one sent has finished), as
the traffic mix says. With `--trace
1` two traced windows of the mix's `trace_steps` steps follow: one that
records device ops alone (the idle share) and one with host ops, spans
and kernel shapes (the layers). Last it compares a seeded sample of the
steps' frames with the plain reference (`benchmark/reference`, at the
window's batch). It prints the check's numbers beside their limits as
its last lines on stderr, and one JSON line as the last line of stdout.
It needs the cards the cell asks for: without them it prints no result
and exits 2.

`--control tf32` puts the reference, one precision step down, in the
program's place: the check of that run has to fail (PERF.md)."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the program at a fixed path in the checkout
os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / "build" / "torch_extensions")
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

FORBIDDEN = ("jax", "jaxlib", "flax", "invertavatar_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (the port's name begins with the latter's)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _merge(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else out.stderr.strip()


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             chips: int = 1, control=None, config_override=None, traffic_override=None,
             fault=None, root=None) -> dict:
    """One run of `workload`; returns the result line's dict. The tests
    call it on the CPU with small overrides, `fault(build)` may break the
    program underneath, and `root` is a benchmark directory to find the
    cell's files in (this one by default)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.lib import registry
    from benchmark.lib import trace as tr
    from benchmark.lib.compare import Check
    from benchmark.reference.precision import lower
    from benchmark.traffic.generate import make_inputs

    root = root or registry.ROOT
    wl = registry.workload(workload, root)
    cfg = _merge(registry.config(wl["config"], root), config_override)
    # the configurations' float32 is float32 on both sides, and cuDNN picks
    # deterministic algorithms where the configuration says so (PERF.md);
    # the process is otherwise left as the program sets it up
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = bool(cfg["cudnn_deterministic"])
    mix = _merge(registry.traffic(wl["traffic"], root), traffic_override)
    if mix["loop"] not in ("closed", "pipelined"):
        raise ValueError(f"loop {mix['loop']!r}: 'closed' or 'pipelined'")
    if mix["loop"] == "pipelined" and "frame_ms_p95" in wl["end_to_end"]:
        raise ValueError(f"{workload}: a pipelined loop has no step latency for frame_ms_p95")
    side = registry.config_module(wl["config"], root).Build
    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    with torch.inference_mode():
        inputs = make_inputs(mix, cfg, seed, device)
        rows = list(range(inputs["batch"]))
        with lower(control):
            build = side("reference" if control else "program", cfg, mix, inputs, seed, device)
            if fault is not None:
                fault(build)
            avatar = build.avatar(rows)

            def step(t):
                drive = build.drive(t)
                out = build.frame(avatar, rows, t, drive)
                out["drive"] = drive
                return out

            for t in range(mix["warmup_steps"]):
                step(t)
            sync()

            metrics_mods = registry.metrics(root) if trace else []
            kernel_calls = {m.NAME: [] for m in metrics_mods if hasattr(m, "SITE")}
            sites = []
            for m in metrics_mods:
                if hasattr(m, "SITE") and not control:
                    module = sys.modules.get(m.SITE[0]) or __import__(m.SITE[0], fromlist=["_"])
                    sites.append((m.NAME, module, m.SITE[1], m.work))

            keep, rnd, steps_run, t_next = [], random.Random(seed), [0], [mix["warmup_steps"]]
            # a closed loop waits for each step's outputs; a pipelined one
            # waits only when more than `ahead_steps` steps are in flight
            ahead = mix["ahead_steps"] if mix["loop"] == "pipelined" else 0

            def loop(seconds=None, steps=None):
                """Steps for `seconds` (or `steps` of them): (the window's
                start, every step's latency in a closed loop, the window's
                length up to the end of the last step's work). The check
                keeps a seeded uniform sample of all steps run."""
                latencies, in_flight, n = [], collections.deque(), 0
                start = time.perf_counter()
                while True:
                    n += 1
                    s0 = time.perf_counter()
                    with torch.profiler.record_function(tr.STEP):
                        out = step(t_next[0])
                        if not ahead:
                            sync()
                    s1 = time.perf_counter()
                    if ahead:
                        in_flight.append(torch.cuda.Event() if cuda else None)
                        if cuda:
                            in_flight[-1].record()
                        while len(in_flight) > ahead:
                            e = in_flight.popleft()
                            if cuda:
                                e.synchronize()
                    else:
                        latencies.append(s1 - s0)
                    steps_run[0] += 1
                    if len(keep) < mix["check_steps"]:
                        keep.append((t_next[0], out))
                    else:
                        j = rnd.randrange(steps_run[0])
                        if j < mix["check_steps"]:
                            keep[j] = (t_next[0], out)
                    del out
                    t_next[0] += 1
                    if (n >= steps if steps else s1 - start >= seconds):
                        break
                end = s1
                if ahead:
                    # the window ends when the last step sent has finished
                    with torch.profiler.record_function(tr.STEP):
                        sync()
                    end = time.perf_counter()
                return start, latencies, end - start

            # the window, untraced in every run
            steps_before = steps_run[0]
            start, latencies, window_s = loop(seconds=seconds)
            window_steps = steps_run[0] - steps_before
            setup_s = start - T0
            frame_ms_p95 = (_percentile(sorted(x * 1e3 for x in latencies), 95)
                            if latencies else None)
            if trace:
                # the card's busy time with nothing recorded on the host, then
                # host ops, spans and kernel shapes in a window of their own
                acts = [torch.profiler.ProfilerActivity.CUDA if cuda
                        else torch.profiler.ProfilerActivity.CPU]
                with torch.profiler.profile(activities=acts) as device_prof:
                    loop(steps=mix["trace_steps"])
                acts = [torch.profiler.ProfilerActivity.CPU] + (
                    [torch.profiler.ProfilerActivity.CUDA] if cuda else [])
                with torch.profiler.profile(activities=acts) as prof, \
                        tr.stage_scopes(build.spans()), tr.kernel_sites(sites, kernel_calls):
                    loop(steps=mix["trace_steps"])
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        frames = window_steps * inputs["batch"]
        frames_per_s = frames / window_s
        del build, avatar
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # the check: the reference on the kept steps, at the window's batch
        ref = side("reference", cfg, mix, inputs, seed, device)
        check = Check(wl["limits"])
        keep.sort(key=lambda x: x[0])
        av = ref.avatar(rows)
        flops_per_frame = None
        for t, out in keep:
            if trace and flops_per_frame is None:
                with FlopCounterMode(display=False) as fc:
                    drive = ref.drive(t)
                    r = ref.frame(av, rows, t, drive)
                flops_per_frame = fc.get_total_flops() / len(rows)
            else:
                drive = ref.drive(t)
                r = ref.frame(av, rows, t, drive)
            for b in rows:
                s = b // mix["identities_per_stream"]
                check.add({name: gap(out, r, b, s, drive) for name, gap in check.gaps.items()})
            del r
        del av, ref

    result = {"correct": check.correct, "attempted": steps_run[0] * inputs["batch"],
              "failed": check.failed}
    if trace:
        summary = dict(tr.reduce(prof), **tr.device_window(device_prof),
                       frames=mix["trace_steps"] * inputs["batch"], kernels=kernel_calls,
                       flops_per_frame=flops_per_frame, frames_per_s=frames_per_s,
                       frame_ms_p95=frame_ms_p95, end_to_end=wl["end_to_end"])
        values = {}
        for m in metrics_mods:
            v = m.read(summary)
            if v is not None:
                values[m.NAME] = {"value": v, "unit": m.UNIT}
        result["metrics"] = values
        breakdown = summary["breakdown"]
    else:
        e2e = {"frames_per_s": (frames_per_s, "frames/s"),
               "frame_ms_p95": (frame_ms_p95, "ms"),
               "peak_mem_gib": (peak / 2 ** 30, "GiB"),
               "setup_s": (setup_s, "s")}
        result["metrics"] = {k: {"value": e2e[k][0], "unit": e2e[k][1]} for k in wl["end_to_end"]}
    result["device"] = {"platform": "gpu" if cuda else "cpu",
                        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                        "count": chips, "memory_peak_bytes": peak}
    if trace:
        result["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = breakdown
    result["check"] = check.lines()
    return result


def _percentile(sorted_values, q):
    """The q-th percentile of all values (linear between closest ranks)."""
    k = (len(sorted_values) - 1) * q / 100
    lo = math.floor(k)
    hi = min(lo + 1, len(sorted_values) - 1)
    return sorted_values[lo] + (sorted_values[hi] - sorted_values[lo]) * (k - lo)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("tf32",), default=None,
                   help="run the reference one precision step down in the program's place")
    args = p.parse_args(argv)

    from benchmark.lib import registry

    wl = registry.workload(args.workload)
    chips = int(wl.get("chips", 1))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"benchmark: card {card_line()}", file=sys.stderr)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", chips,
                      control=args.control)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}: JAX or the JAX package", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
