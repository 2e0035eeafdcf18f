#!/usr/bin/env python3
"""Profile the PyTorch port's combined step on one CUDA card.

    python3 tools/profile_torch_step.py [--steps 3] [--slice | --glass]
                                        [--trace trace.json]

Builds the full-size combined step (10,240 bodies, 1920x1080) with the
flagship's passes (`--slice`: the first slice's pass set, SLICE_OVERRIDES;
`--glass`: the glass step, box_materials=GLASS_BOXES with GLASS_OVERRIDES,
whose frame adds the OIT, refraction, sorted and trans-depth passes and
the translucent shadow map) and warms it up. First, without the profiler, it prints the median wall
time (host clock, synchronized) of the physics step, the render and the
whole step over 10 runs each. Then it profiles `--steps` steps with
torch.profiler and prints the wall time per step, the device's busy time
(kernel and copy time, and its share of the wall time), the host and
device time of each stage (physics, instance matrices, and the render's
main raster, csm_render, csm_resolve, hbao, sky_lighting, oit, refraction,
sorted, trans_depth and post; device time counts the hand kernels, see
`stage_times`) and the
operators with the most device time; the profiler adds host overhead to
every launch. `--trace` also writes a Chrome trace.
"""

import argparse
import bisect
import collections
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def stage_times(prof, names):
    """{name: (host ns, device ns)} summed over every occurrence of each
    named record_function range. A range's device time is that of the
    kernels and copies whose launch (a `cuda*` or `cu*` API call) starts
    inside it, matched to the launch by CUPTI's correlation id. The
    profiler's own `device_time_total` follows the operator tree instead,
    and so misses every kernel launched outside a PyTorch operator, as the
    port's hand kernels are (through ctypes)."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    dev_ns = collections.Counter()
    for e in events:
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            dev_ns[e.correlation_id()] += e.duration_ns()
    launches = sorted((e.start_ns(), dev_ns[e.correlation_id()]) for e in events
                      if e.device_type() == DeviceType.CPU and e.name().startswith("cu")
                      and e.correlation_id() in dev_ns)
    starts = [t for t, _ in launches]
    prefix = [0]
    for _, ns in launches:
        prefix.append(prefix[-1] + ns)
    out = {}
    for e in events:
        if (e.device_type() != DeviceType.CPU or not e.is_user_annotation()
                or e.name() not in names):
            continue
        lo = bisect.bisect_left(starts, e.start_ns())
        hi = bisect.bisect_right(starts, e.start_ns() + e.duration_ns())
        host, dev = out.get(e.name(), (0, 0))
        out[e.name()] = (host + e.duration_ns(), dev + prefix[hi] - prefix[lo])
    return {n: out[n] for n in names if n in out}


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--slice", action="store_true",
                       help="profile the first slice's pass set (SLICE_OVERRIDES)")
    which.add_argument("--glass", action="store_true",
                       help="profile the glass step (GLASS_BOXES, GLASS_OVERRIDES)")
    ap.add_argument("--trace", help="write a Chrome trace to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card.splitlines()[0]}")

    from garden_tpu_torch.entry import (GLASS_BOXES, GLASS_OVERRIDES,
                                        SLICE_OVERRIDES, build)
    if args.slice:
        name, kw = "SLICE_OVERRIDES", dict(cfg_overrides=SLICE_OVERRIDES)
    elif args.glass:
        name, kw = "glass", dict(cfg_overrides=GLASS_OVERRIDES, box_materials=GLASS_BOXES)
    else:
        name, kw = "flagship", {}
    step, state = build(n_bodies=10240, width=1920, height=1080, grid_dim=64,
                        device="cuda", **kw)
    print("pass set:", name)
    for _ in range(3):
        state, _ = step(state)
    torch.cuda.synchronize()

    def wall_ms(fn, reps=10):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    mats = step.instance_matrices(state["physics"])
    phys_ms = wall_ms(lambda: step.physics(state["physics"]))
    render_ms = wall_ms(lambda: step.render(mats, state["frame"]))
    step_ms = wall_ms(lambda: step(state))
    print(f"no profiler, median of 10: physics {phys_ms:.3f} ms, render "
          f"{render_ms:.3f} ms, combined step {step_ms:.3f} ms")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            with record_function("physics"):
                phys = step.physics(state["physics"])
            with record_function("instances"):
                mats = step.instance_matrices(phys)
            with record_function("render"):
                out = step.render(mats, state["frame"])
            state = {"physics": phys, "frame": out["frame_state"]}
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    # device time of each stage: the kernels and copies launched inside the
    # stage's range; the rest of the wall time the device sits idle
    stages = stage_times(prof, ("physics", "instances", "render", "raster",
                                "csm_render", "csm_resolve", "hbao", "sky_lighting",
                                "oit", "refraction", "sorted", "trans_depth", "post"))
    busy_ms = 0.0
    lines = []
    # the render's own ranges (deferred.DeferredRenderer.render) nest in it
    for name, (host_ns, dev_ns) in stages.items():
        ms, host = dev_ns / 1e6 / args.steps, host_ns / 1e6 / args.steps
        if name in ("physics", "instances", "render"):
            busy_ms += ms
        indent = "  " if name not in ("physics", "instances", "render") else ""
        lines.append(f"{indent}stage {name}: host {host:.3f} ms, device {ms:.3f} ms "
                     "per step")
    print(f"profiled: wall per step {prof_ms:.3f} ms; device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / prof_ms:.1f}% of wall, idle the rest)")
    print("\n".join(lines))
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25,
                                    max_name_column_width=60))
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
