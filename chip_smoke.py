#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Run from the repository root with `python3 chip_smoke.py`. It needs one
NVIDIA card (Hopper: the kernels are built for sm_90a) and the CUDA
toolkit, and it imports nothing of JAX. Phases, each of which must pass:

1. print the card's name and power limit (nvidia-smi); fail without CUDA;
2. build the port's CUDA kernels from `garden_tpu_torch/csrc`;
3. build the combined step at full size: 10,240 bodies, 1920x1080, the
   port's pass set (`SLICE_OVERRIDES`);
4. compare the raster_shade kernel with its plain PyTorch version on the
   inputs of one real combined step;
5. run 5 combined steps and check that the kernel ran once per step, the
   image is a real frame and the bodies are finite; also check one small
   step on the card against the same step on the CPU;
6. time the kernel, its plain version, the physics step, the render and
   the combined step with CUDA events.

The line before the last is a JSON object describing each kernel; the last
line is `{"ok": true, "device": {...}}`. Any failure exits non-zero before
those lines are printed.
"""

import json
import statistics
import subprocess
import sys
import time

KERNEL_SOURCE = "garden_tpu_torch/csrc/raster_shade.cu"
KERNEL_REPLACES = "garden_tpu/render/raster.py:801"
TOL_TRI_AGREE = 0.999      # fraction of pixels whose tri_id must agree
TOL_VIS = 1e-5             # depth, b0, b1 where the ids agree
TOL_GBUF = 2e-5            # G-buffer planes (rsqrt may differ by an ulp)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of fn() over `reps` runs, each between two CUDA
    events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}")

    from garden_tpu_torch import cuda_build
    from garden_tpu_torch.entry import SLICE_OVERRIDES, build
    from garden_tpu_torch.render import raster

    # phase 2: build the kernels
    t0 = time.perf_counter()
    cuda_build.build("raster_shade", verbose=True)
    cuda_build.load("raster_shade")
    print(f"phase 2: kernels built in {time.perf_counter() - t0:.1f} s")

    # phase 3: the combined step at full size
    t0 = time.perf_counter()
    step, state = build(n_bodies=10240, width=1920, height=1080, grid_dim=64,
                        cfg_overrides=SLICE_OVERRIDES, device="cuda")
    torch.cuda.synchronize()
    print(f"phase 3: built 10240 bodies, 1920x1080 in "
          f"{time.perf_counter() - t0:.1f} s")

    # phase 4: the kernel against its plain version on one step's inputs
    phys = step.physics(state["physics"])
    kin = step.renderer.raster_inputs(step.scene, step.instance_matrices(phys),
                                      step.constants)
    args = raster.kernel_args(**kin)
    vis_k, gp_k = raster.raster_shade_cuda(*args)
    vis_p, gp_p = raster.raster_shade_plain(*args)
    torch.cuda.synchronize()
    same = vis_k["tri_id"] == vis_p["tri_id"]
    agree = same.float().mean().item()
    err_vis = max((vis_k[k] - vis_p[k]).abs()[same].max().item()
                  for k in ("depth", "b0", "b1"))
    err_gbuf = (gp_k - gp_p).abs()[:, same].max().item()
    covered = (vis_k["tri_id"] >= 0).float().mean().item()
    print(f"phase 4: raster_shade vs plain at 1920x1080: tri_id agreement "
          f"{agree:.7f} (>= {TOL_TRI_AGREE}), max|d| depth/b0/b1 {err_vis:.3g} "
          f"(<= {TOL_VIS}), max|d| gbuffer {err_gbuf:.3g} (<= {TOL_GBUF}), "
          f"covered {covered:.4f}")
    check(agree >= TOL_TRI_AGREE, "raster_shade tri_id disagrees with plain")
    check(err_vis <= TOL_VIS, "raster_shade depth/barycentrics disagree")
    check(err_gbuf <= TOL_GBUF, "raster_shade G-buffer planes disagree")

    # phase 5: the main path, 5 combined steps, counting kernel launches
    raster.rasterize_visibility_shaded.launches = 0
    st = state
    for _ in range(5):
        st, image = step(st)
    torch.cuda.synchronize()
    launches = raster.rasterize_visibility_shaded.launches
    print(f"phase 5: 5 combined steps, raster_shade launches {launches}")
    check(launches == 5, "raster_shade did not run once per step")
    check(tuple(image.shape) == (1080, 1920, 3) and image.dtype == torch.uint8,
          f"image is {tuple(image.shape)} {image.dtype}")
    out = step.render(step.instance_matrices(st["physics"]), st["frame"])
    hit = (out["tri_id"] >= 0).float().mean().item()
    print(f"phase 5: {hit:.4f} of pixels show geometry")
    check(hit > 0.05, "the frame is (nearly) all sky")
    pos = st["physics"]["bodies"]["pos"]
    check(bool(torch.isfinite(pos).all()), "body positions are not finite")
    fell = (state["physics"]["bodies"]["pos"][1:, 1] - pos[1:, 1]).mean().item()
    print(f"phase 5: bodies finite; mean drop over 5 steps {fell:.5f} m")

    # phase 5b: a small step on the card against the same step on the CPU
    small = {}
    for dev in ("cuda", "cpu"):
        s_step, s_state = build(32, 256, 128, grid_dim=8,
                                cfg_overrides=SLICE_OVERRIDES, device=dev)
        s_next, s_img = s_step(s_state)
        s_out = s_step.render(s_step.instance_matrices(s_next["physics"]),
                              s_state["frame"])
        small[dev] = (s_img.cpu(), s_out["tri_id"].cpu(),
                      s_next["physics"]["bodies"]["pos"].cpu())
    tri_small = (small["cuda"][1] == small["cpu"][1]).float().mean().item()
    img_d = (small["cuda"][0].int() - small["cpu"][0].int()).abs().amax(-1)
    img_ok = (img_d <= 2).float().mean().item()
    pos_d = (small["cuda"][2] - small["cpu"][2]).abs().max().item()
    print(f"phase 5b: 256x128 step cuda vs cpu: tri_id agreement {tri_small:.5f}, "
          f"image within 2 levels {img_ok:.5f}, max|d| pos {pos_d:.3g}")
    check(tri_small >= 0.999 and img_ok >= 0.995 and pos_d <= 1e-4,
          "the small step on the card disagrees with the CPU")

    # phase 6: timings (CUDA events; medians)
    k_ms = cuda_ms(lambda: raster.raster_shade_cuda(*args), reps=20, warmup=3)
    p_ms = cuda_ms(lambda: raster.raster_shade_plain(*args), reps=5)
    phys_ms = cuda_ms(lambda: step.physics(st["physics"]), reps=10)
    mats = step.instance_matrices(st["physics"])
    render_ms = cuda_ms(lambda: step.render(mats, st["frame"]), reps=10)
    step_ms = cuda_ms(lambda: step(st), reps=10)
    for name, ms in (("raster_shade kernel", k_ms), ("raster_shade plain", p_ms),
                     ("physics step", phys_ms), ("render", render_ms),
                     ("combined step", step_ms)):
        print(f"phase 6: {name} median {ms:.4f} ms  [{card}]")

    kernels = [{"name": "raster_shade", "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": KERNEL_REPLACES, "launches": launches,
                "max_abs_err": max(err_vis, err_gbuf), "ms": k_ms, "plain_ms": p_ms}]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
