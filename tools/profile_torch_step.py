#!/usr/bin/env python3
"""Profile the PyTorch port's combined step on one CUDA card.

    python3 tools/profile_torch_step.py [--steps 3]
        [--slice | --glass | --ultra | --temporal | --physics] [--trace trace.json]

Builds the full-size combined step (10,240 bodies, 1920x1080) with the
flagship's passes (`--slice`: the first slice's pass set, SLICE_OVERRIDES;
`--glass`: the glass step, box_materials=GLASS_BOXES with GLASS_OVERRIDES,
whose frame adds the OIT, refraction, sorted and trans-depth passes and
the translucent shadow map; `--ultra`: the ultra preset, ULTRA_OVERRIDES:
clouds, SSR, SSGI and the dense atlas; `--temporal`: TEMPORAL_OVERRIDES,
velocity, Hi-Z and SMAA, the renderer given the previous step's instance
matrices) and warms it up. First, without the profiler, it prints the median wall
time (host clock, synchronized) of the physics step, the render and the
whole step over 10 runs each. Then it profiles `--steps` steps with
torch.profiler and prints the wall time per step, the device's busy time
(kernel and copy time, and its share of the wall time), the host and
device time of each stage (physics, instance matrices, and the render's
main raster with its hiz, csm_render, csm_resolve, hbao, ssr, ssgi,
sky_lighting with its clouds, oit, refraction, sorted, trans_depth and
post with its aa; nested ranges count inside their parent too; device
time counts the hand kernels, see `stage_times`) and the
operators with the most device time; the profiler adds host overhead to
every launch. `--trace` also writes a Chrome trace. `--physics` profiles
the physics step alone on bench.py's world (10,240 bodies, half spheres;
`physics.scenes.bench_world`): wall time, device busy share and the
step's stages (`profile_physics`, which chip_smoke.py also runs).
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


RENDER_STAGES = ("raster", "hiz", "csm_render", "csm_resolve", "hbao", "ssr", "ssgi",
                 "sky_lighting", "clouds", "oit", "refraction", "sorted", "trans_depth",
                 "post", "aa")
PHYSICS_STAGES = ("physics", "collide", "broadphase", "narrowphase", "contact_compact",
                  "warm_match", "solve_velocity", "constraints", "integrate",
                  "solve_position", "sleep_misc")


def profile_physics(step, state, steps: int):
    """Profile `steps` calls of step(state) -> state, each inside a
    "physics" range; the port's physics step opens the other stage ranges
    itself. Returns (wall ms per step, device busy ms per step, {stage:
    (host ms, device ms) per step}); busy counts the kernels and copies
    launched inside the "physics" ranges."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            with record_function("physics"):
                state = step(state)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    stages = {n: (h / 1e6 / steps, d / 1e6 / steps)
              for n, (h, d) in stage_times(prof, PHYSICS_STAGES).items()}
    return wall, stages["physics"][1], stages


def profile_step(step, state, steps: int, temporal: bool = False):
    """Profile `steps` combined steps from `state`: the physics, the
    instance matrices and the render, each in a range of its own (with
    `temporal` the renderer also gets the previous step's instance
    matrices). Returns (wall ms per step, device busy ms per step, {stage:
    (host ms, device ms) per step}, the profiler); busy counts the kernels
    and copies launched inside the three top-level ranges."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    prev = step.instance_matrices(state["physics"])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            with record_function("physics"):
                phys = step.physics(state["physics"])
            with record_function("instances"):
                mats = step.instance_matrices(phys)
            with record_function("render"):
                out = step.render(mats, state["frame"], prev if temporal else None)
            state, prev = {"physics": phys, "frame": out["frame_state"]}, mats
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    # device time of each stage: the kernels and copies launched inside the
    # stage's range; the rest of the wall time the device sits idle
    stages = {n: (h / 1e6 / steps, d / 1e6 / steps) for n, (h, d) in stage_times(
        prof, ("physics", "instances", "render") + RENDER_STAGES).items()}
    busy = sum(stages[n][1] for n in ("physics", "instances", "render") if n in stages)
    return wall, busy, stages, prof


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--slice", action="store_true",
                       help="profile the first slice's pass set (SLICE_OVERRIDES)")
    which.add_argument("--physics", action="store_true",
                       help="profile the physics step alone on bench.py's world")
    which.add_argument("--glass", action="store_true",
                       help="profile the glass step (GLASS_BOXES, GLASS_OVERRIDES)")
    which.add_argument("--ultra", action="store_true",
                       help="profile the ultra preset (ULTRA_OVERRIDES)")
    which.add_argument("--temporal", action="store_true",
                       help="profile the temporal pass set (TEMPORAL_OVERRIDES)")
    ap.add_argument("--trace", help="write a Chrome trace to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card.splitlines()[0]}")

    from garden_tpu_torch.entry import (GLASS_BOXES, GLASS_OVERRIDES, SLICE_OVERRIDES,
                                        TEMPORAL_OVERRIDES, ULTRA_OVERRIDES, build)
    if args.physics:
        from garden_tpu_torch.physics import scenes
        from garden_tpu_torch.physics import world as pw
        state, cfg, types = scenes.bench_world("cuda")
        step = lambda s: pw.step(s, cfg, 1.0 / 60.0, types)
        for _ in range(3):
            state = step(state)
        torch.cuda.synchronize()
        wall, busy, stages = profile_physics(step, state, args.steps)
        print(f"bench world physics step: wall {wall:.3f} ms, device busy {busy:.3f} ms "
              f"({100 * busy / wall:.1f}% of wall)")
        for name, (host, dev) in stages.items():
            print(f"  stage {name}: host {host:.3f} ms, device {dev:.3f} ms per step")
        return 0
    if args.slice:
        name, kw = "SLICE_OVERRIDES", dict(cfg_overrides=SLICE_OVERRIDES)
    elif args.glass:
        name, kw = "glass", dict(cfg_overrides=GLASS_OVERRIDES, box_materials=GLASS_BOXES)
    elif args.ultra:
        name, kw = "ultra", dict(cfg_overrides=ULTRA_OVERRIDES)
    elif args.temporal:
        name, kw = "temporal", dict(cfg_overrides=TEMPORAL_OVERRIDES)
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

    prof_ms, busy_ms, stages, prof = profile_step(step, state, args.steps, args.temporal)
    print(f"profiled: wall per step {prof_ms:.3f} ms; device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / prof_ms:.1f}% of wall, idle the rest)")
    for name, (host, dev) in stages.items():
        indent = "" if name in ("physics", "instances", "render") else "  "
        print(f"{indent}stage {name}: host {host:.3f} ms, device {dev:.3f} ms per step")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25,
                                    max_name_column_width=60))
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
