#!/usr/bin/env python3
"""Profile the PyTorch port's combined step on one CUDA card.

    python3 tools/profile_torch_step.py [--steps 3]
        [--slice | --glass | --ultra | --temporal | --world-sim | --physics |
         --forward | --features | --bench-frame | --engine] [--trace trace.json]

Builds the full-size combined step (10,240 bodies, 1920x1080) with the
flagship's passes (`--slice`: the first slice's pass set, SLICE_OVERRIDES;
`--glass`: the glass step, box_materials=GLASS_BOXES with GLASS_OVERRIDES,
whose frame adds the OIT, refraction, sorted and trans-depth passes and
the translucent shadow map; `--ultra`: the ultra preset, ULTRA_OVERRIDES:
clouds, SSR, SSGI and the dense atlas; `--temporal`: TEMPORAL_OVERRIDES,
velocity, Hi-Z and SMAA, the renderer given the previous step's instance
matrices; `--world-sim`: the combined world sim, the glass step under the
clouds (WORLD_SIM_OVERRIDES, GLASS_BOXES) seen from WORLD_SIM_CAMERA, which
sees sky; `--features`: the feature frame, `entry.build_feature_frame`:
slot-binned cascades, textures, the environment map and the HUD;
`--bench-frame`: bench.py's world with LOD spheres,
`entry.build_bench_frame`) and warms it up. First, without the profiler, it prints the median wall
time (host clock, synchronized) of the physics step (as the combined step
replays it, and as the eager `world.step`), the render and the whole step
over 10 runs each. Then it profiles `--steps` steps with
torch.profiler and prints the wall time per step, the device's busy time
(kernel and copy time, and its share of the wall time), the host and
device time of each stage (physics, instance matrices, and the render's
main raster with its hiz, csm_render, csm_resolve, hbao, ssr, ssgi,
sky_lighting with its cloud_shadow, clouds and environment, oit, refraction, sorted,
trans_depth and post with its aa and ui; lod inside the cull; nested
ranges count inside their parent too; device
time counts the hand kernels, see `stage_ms`), the physics stages of the
eager step (`profile_physics`: on a card the combined step replays its
physics as a CUDA graph, which opens no stage range) and the
operators with the most device time; the profiler adds host overhead to
every launch. `--trace` also writes a Chrome trace. `--physics` profiles
the physics step alone on bench.py's world (10,240 bodies, half spheres;
`physics.scenes.bench_world`): wall time, device busy share and the
step's stages (`profile_physics`, which chip_smoke.py also runs).
`--forward` profiles the forward renderer's frame over the flagship
scene (`entry.build_forward`; stages raster, gbuffer, lighting).
`--engine` profiles the engine frame (`entry.build_engine_frame`: the
runtime's Engine over the flagship pile with characters, animation and the
HUD; `profile_engine`): the tick with each system's update and the physics
stages inside it, the bake of the world matrices and the render with its
stages.
"""

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import trace  # noqa: E402


def stage_ms(prof, names, steps: int):
    """{name: (host ms, device ms) per step}, in the order of `names`, of
    each named range summed over its occurrences
    (`benchmark.trace.stage_times`: a range's device time is that of the
    kernels and copies whose launch starts inside it, matched by CUPTI's
    correlation id, so the hand kernels, which launch through ctypes
    outside any PyTorch operator, count; the profiler's own
    `device_time_total` misses them)."""
    got = trace.stage_times(*trace.from_profiler(prof), names)
    return {n: (got[n][0] / 1e6 / steps, got[n][1] / 1e6 / steps)
            for n in names if n in got}


RENDER_STAGES = ("raster", "lod", "hiz", "csm_render", "csm_resolve", "hbao", "ssr",
                 "ssgi", "sky_lighting", "cloud_shadow", "clouds", "environment", "oit",
                 "refraction", "sorted", "trans_depth", "post", "aa", "ui")
FORWARD_STAGES = ("raster", "gbuffer", "lighting")
PHYSICS_STAGES = ("physics", "collide", "broadphase", "narrowphase", "contact_compact",
                  "warm_match", "solve_velocity", "constraints", "integrate",
                  "solve_position", "sleep_misc")


def profile_physics(step, state, steps: int):
    """Profile `steps` calls of step(state) -> state, each inside a
    "physics" range. `step` is the eager physics step (`physics.world.step`
    with its config bound, `eager_physics`), which opens the other stage
    ranges itself; `CombinedStep.physics` replays a CUDA graph on a card and
    opens none. Returns (wall ms per step, device busy ms per step, {stage:
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
    stages = stage_ms(prof, PHYSICS_STAGES, steps)
    return wall, stages["physics"][1], stages


def eager_physics(step):
    """The combined step's physics as an eager `physics.world.step`, which
    opens its stage ranges (the combined step replays it as a graph)."""
    from garden_tpu_torch.physics import world as pw
    return lambda s: pw.step(s, step.pcfg, 1.0 / 60.0, step.present_types)


def profile_step(step, state, steps: int, temporal: bool = False):
    """Profile `steps` combined steps from `state`: the physics, the
    instance matrices and the render, each in the span the step opens
    (`physics`, `instance_matrices`, `render`), the instance matrices in a
    range "instances" too (with `temporal` the renderer also gets the
    previous step's instance matrices). Returns (wall ms per step, device
    busy ms per step, {stage: (host ms, device ms) per step}, the
    profiler); busy counts the kernels and copies launched inside the
    three top-level ranges."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    prev = step.instance_matrices(state["physics"])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            phys = step.physics(state["physics"])
            with record_function("instances"):
                mats = step.instance_matrices(phys)
            out = step.render(mats, state["frame"], prev if temporal else None)
            state, prev = {"physics": phys, "frame": out["frame_state"]}, mats
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    # device time of each stage: the kernels and copies launched inside the
    # stage's range; the rest of the wall time the device sits idle
    stages = stage_ms(prof, ("physics", "instances", "render") + RENDER_STAGES, steps)
    busy = sum(stages[n][1] for n in ("physics", "instances", "render") if n in stages)
    return wall, busy, stages, prof


def profile_forward(fwd, scene, mats, constants, steps: int):
    """Profile `steps` forward frames, each inside a "frame" range. Returns
    (wall ms per frame, device busy ms per frame, {stage: (host ms, device
    ms) per frame})."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            with record_function("frame"):
                fwd.render(scene, mats, constants)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    stages = stage_ms(prof, ("frame",) + FORWARD_STAGES, steps)
    return wall, stages["frame"][1], stages


ENGINE_STAGES = ("tick", "AnimationSystem.update", "CharacterSystem.update",
                 "PhysicsSystem.update", "instance_matrices", "render")


def profile_engine(frame, state, steps: int):
    """Profile `steps` engine frames from `state`: the Engine's tick (each
    system's update in a range the Engine opens), the bake of the instance
    matrices and the render, each in the span the frame opens for it
    (`tick`, `instance_matrices`, `render`). Returns (wall ms
    per frame, device busy ms per frame, {stage: (host ms, device ms) per
    frame}, the profiler); busy counts the kernels and copies launched
    inside the three top-level ranges."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from garden_tpu_torch.entry import ENGINE_DT
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state = frame.tick(state, ENGINE_DT)
            mats = frame.instance_matrices(state)
            out = frame.render(mats, state["frame"])
            state = dict(state, frame=out["frame_state"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    stages = stage_ms(prof, ENGINE_STAGES + PHYSICS_STAGES[1:] + RENDER_STAGES, steps)
    busy = sum(stages[n][1] for n in ("tick", "instance_matrices", "render") if n in stages)
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
    which.add_argument("--world-sim", action="store_true",
                       help="profile the combined world sim (WORLD_SIM_OVERRIDES, "
                            "GLASS_BOXES, WORLD_SIM_CAMERA)")
    which.add_argument("--forward", action="store_true",
                       help="profile the forward renderer over the flagship scene")
    which.add_argument("--features", action="store_true",
                       help="profile the feature frame (entry.build_feature_frame)")
    which.add_argument("--bench-frame", action="store_true",
                       help="profile bench.py's world drawn (entry.build_bench_frame)")
    which.add_argument("--engine", action="store_true",
                       help="profile the engine frame (entry.build_engine_frame)")
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
                                        TEMPORAL_OVERRIDES, ULTRA_OVERRIDES,
                                        WORLD_SIM_CAMERA, WORLD_SIM_OVERRIDES, build,
                                        build_bench_frame, build_engine_frame,
                                        build_feature_frame, build_forward)
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
    if args.forward:
        fwd, scene, mats, constants = build_forward(10240, 1920, 1080, grid_dim=64,
                                                    device="cuda")
        for _ in range(3):
            fwd.render(scene, mats, constants)
        torch.cuda.synchronize()
        wall, busy, stages = profile_forward(fwd, scene, mats, constants, args.steps)
        print(f"forward frame: wall {wall:.3f} ms, device busy {busy:.3f} ms "
              f"({100 * busy / wall:.1f}% of wall)")
        for name, (host, dev) in stages.items():
            print(f"  stage {name}: host {host:.3f} ms, device {dev:.3f} ms per frame")
        return 0
    if args.engine:
        frame, state = build_engine_frame(10240, 1920, 1080, device="cuda")
        for _ in range(3):
            state, _ = frame(state)
        torch.cuda.synchronize()
        wall, busy, stages, prof = profile_engine(frame, state, args.steps)
        print(f"engine frame: wall {wall:.3f} ms, device busy {busy:.3f} ms "
              f"({100 * busy / wall:.1f}% of wall)")
        for name, (host, dev) in stages.items():
            indent = "" if name in ("tick", "instance_matrices", "render") else "  "
            print(f"{indent}stage {name}: host {host:.3f} ms, device {dev:.3f} ms per frame")
        if args.trace:
            prof.export_chrome_trace(args.trace)
        return 0
    builder = build
    if args.slice:
        name, kw = "SLICE_OVERRIDES", dict(cfg_overrides=SLICE_OVERRIDES)
    elif args.glass:
        name, kw = "glass", dict(cfg_overrides=GLASS_OVERRIDES, box_materials=GLASS_BOXES)
    elif args.ultra:
        name, kw = "ultra", dict(cfg_overrides=ULTRA_OVERRIDES)
    elif args.temporal:
        name, kw = "temporal", dict(cfg_overrides=TEMPORAL_OVERRIDES)
    elif args.world_sim:
        name, kw = "world sim", dict(cfg_overrides=WORLD_SIM_OVERRIDES, box_materials=GLASS_BOXES,
                                     camera=WORLD_SIM_CAMERA)
    elif args.features:
        name, kw, builder = "feature frame", dict(grid_dim=64), build_feature_frame
    elif args.bench_frame:
        name, kw, builder = "bench frame", {}, build_bench_frame
    else:
        name, kw = "flagship", {}
    if builder is build:
        kw["grid_dim"] = 64
    step, state = builder(10240, 1920, 1080, device="cuda", **kw)
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
    eager_ms = wall_ms(lambda: eager_physics(step)(state["physics"]))
    render_ms = wall_ms(lambda: step.render(mats, state["frame"]))
    step_ms = wall_ms(lambda: step(state))
    print(f"no profiler, median of 10: physics {phys_ms:.3f} ms (eager {eager_ms:.3f}), "
          f"render {render_ms:.3f} ms, combined step {step_ms:.3f} ms")

    prof_ms, busy_ms, stages, prof = profile_step(step, state, args.steps, args.temporal)
    print(f"profiled: wall per step {prof_ms:.3f} ms; device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / prof_ms:.1f}% of wall, idle the rest)")
    for name, (host, dev) in stages.items():
        indent = "" if name in ("physics", "instances", "render") else "  "
        print(f"{indent}stage {name}: host {host:.3f} ms, device {dev:.3f} ms per step")
    _, _, phys_stages = profile_physics(eager_physics(step), state["physics"], args.steps)
    for name, (host, dev) in phys_stages.items():
        print(f"  eager physics stage {name}: host {host:.3f} ms, device {dev:.3f} ms per step")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25,
                                    max_name_column_width=60))
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
