#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Run from the repository root with `python3 chip_smoke.py`. It needs one
NVIDIA card (Hopper: the kernels are built for sm_90a) and the CUDA
toolkit, and it imports nothing of JAX. Phases, each of which must pass:

1. print the card's name and power limit (nvidia-smi); fail without CUDA;
2. build the port's CUDA kernels from `garden_tpu_torch/csrc`, one nvcc
   process per source, all at once;
3. build the combined step at full size: 10,240 bodies, 1920x1080, the
   first slice's pass set (`SLICE_OVERRIDES`);
4. compare the raster_shade kernel (K1) with its plain PyTorch version on
   the inputs of one real combined step;
5. run 5 such steps (K1 once per step, a real frame, finite bodies); 5b:
   one small step on the card against the same step on the CPU;
6. time K1, its plain version, physics, render and the step;
then the flagship, every pass on:
a. build the flagship step at full size with no overrides;
b. on one real flagship atlas: depth_super (K2) and depth_grid (K3, on
   K2's output) against their plain versions, exactly; the atlas's
   occupied tiles against max_active_tiles; depth_dense (K4) on the dense
   corner binning of the same casters, which must equal the split result;
c. run 5 flagship steps: K1, K2 and K3 launch once per step; a real frame
   with shadows and AO; finite bodies;
d. render one frame with the reference-parity shadows (ShadowConfig()):
   K4 launches once and equals its plain version;
e. a small flagship step on the card against the same step on the CPU;
f. time K2, K3, K4 against their plain versions and the flagship's stages,
   render and step.

The line before the last is a JSON object describing each kernel; the last
line is `{"ok": true, "device": {...}}`. Any failure exits non-zero before
those lines are printed.
"""

import json
import statistics
import subprocess
import sys
import time

KERNELS = {   # name -> (route, source, the TPU kernel it replaces)
    "raster_shade": ("cuda", "garden_tpu_torch/csrc/raster_shade.cu",
                     "garden_tpu/render/raster.py:801"),
    "depth_super": ("cuda", "garden_tpu_torch/csrc/depth_raster.cu",
                    "garden_tpu/render/raster.py:1336"),
    "depth_grid": ("cuda", "garden_tpu_torch/csrc/depth_raster.cu",
                   "garden_tpu/render/raster.py:1380"),
    "depth_dense": ("cuda", "garden_tpu_torch/csrc/depth_raster.cu",
                    "garden_tpu/render/raster.py:1268"),
}
TOL_TRI_AGREE = 0.999      # fraction of pixels whose tri_id must agree
TOL_VIS = 1e-5             # depth, b0, b1 where the ids agree
TOL_GBUF = 2e-5            # G-buffer planes (rsqrt may differ by an ulp)
N_BODIES, WIDTH, HEIGHT = 10240, 1920, 1080


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


def max_diff(a, b) -> float:
    return (a - b).abs().max().item()


def small_step_vs_cpu(build, overrides, phase: str) -> None:
    """One 32-body 256x128 step on the card and on the CPU: tri_id on >=
    99.9% of pixels, the image within 2 levels on >= 99.5%, bodies within
    1e-4."""
    small = {}
    for dev in ("cuda", "cpu"):
        s_step, s_state = build(32, 256, 128, grid_dim=8, cfg_overrides=overrides,
                                device=dev)
        s_next, s_img = s_step(s_state)
        s_out = s_step.render(s_step.instance_matrices(s_next["physics"]),
                              s_state["frame"])
        small[dev] = (s_img.cpu(), s_out["tri_id"].cpu(),
                      s_next["physics"]["bodies"]["pos"].cpu())
    tri_small = (small["cuda"][1] == small["cpu"][1]).float().mean().item()
    img_d = (small["cuda"][0].int() - small["cpu"][0].int()).abs().amax(-1)
    img_ok = (img_d <= 2).float().mean().item()
    pos_d = max_diff(small["cuda"][2], small["cpu"][2])
    print(f"phase {phase}: 256x128 step cuda vs cpu: tri_id agreement "
          f"{tri_small:.5f}, image within 2 levels {img_ok:.5f}, "
          f"max|d| pos {pos_d:.3g}")
    check(tri_small >= 0.999 and img_ok >= 0.995 and pos_d <= 1e-4,
          f"phase {phase}: the small step on the card disagrees with the CPU")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}")

    from garden_tpu_torch import cuda_build
    from garden_tpu_torch.core.config import ShadowConfig
    from garden_tpu_torch.entry import (DENSE_SHADOW_OVERRIDES, SLICE_OVERRIDES,
                                        build)
    from garden_tpu_torch.render import raster

    # phase 2: build the kernels, every source at once
    t0 = time.perf_counter()
    cuda_build.build_all(["raster_shade", "depth_raster"], verbose=True)
    cuda_build.load("raster_shade")
    cuda_build.load("depth_raster")
    print(f"phase 2: kernels built in {time.perf_counter() - t0:.1f} s")

    # phase 3: the combined step at full size, first slice's pass set
    t0 = time.perf_counter()
    step, state = build(n_bodies=N_BODIES, width=WIDTH, height=HEIGHT, grid_dim=64,
                        cfg_overrides=SLICE_OVERRIDES, device="cuda")
    torch.cuda.synchronize()
    print(f"phase 3: built 10240 bodies, 1920x1080 in "
          f"{time.perf_counter() - t0:.1f} s")

    # phase 4: K1 against its plain version on one step's inputs
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

    # phase 5: 5 combined steps of the slice, counting kernel launches
    raster.rasterize_visibility_shaded.launches = 0
    st = state
    for _ in range(5):
        st, image = step(st)
    torch.cuda.synchronize()
    launches = raster.rasterize_visibility_shaded.launches
    print(f"phase 5: 5 combined steps, raster_shade launches {launches}")
    check(launches == 5, "raster_shade did not run once per step")
    check(tuple(image.shape) == (HEIGHT, WIDTH, 3) and image.dtype == torch.uint8,
          f"image is {tuple(image.shape)} {image.dtype}")
    out = step.render(step.instance_matrices(st["physics"]), st["frame"])
    hit = (out["tri_id"] >= 0).float().mean().item()
    print(f"phase 5: {hit:.4f} of pixels show geometry")
    check(hit > 0.05, "the frame is (nearly) all sky")
    pos = st["physics"]["bodies"]["pos"]
    check(bool(torch.isfinite(pos).all()), "body positions are not finite")
    fell = (state["physics"]["bodies"]["pos"][1:, 1] - pos[1:, 1]).mean().item()
    print(f"phase 5: bodies finite; mean drop over 5 steps {fell:.5f} m")
    small_step_vs_cpu(build, SLICE_OVERRIDES, "5b")

    # phase 6: timings of the slice (CUDA events; medians)
    k_ms = cuda_ms(lambda: raster.raster_shade_cuda(*args), reps=20, warmup=3)
    p_ms = cuda_ms(lambda: raster.raster_shade_plain(*args), reps=3)
    phys_ms = cuda_ms(lambda: step.physics(st["physics"]), reps=10)
    mats = step.instance_matrices(st["physics"])
    render_ms = cuda_ms(lambda: step.render(mats, st["frame"]), reps=10)
    step_ms = cuda_ms(lambda: step(st), reps=10)
    for name, ms in (("raster_shade kernel", k_ms), ("raster_shade plain", p_ms),
                     ("physics step", phys_ms), ("slice render", render_ms),
                     ("slice combined step", step_ms)):
        print(f"phase 6: {name} median {ms:.4f} ms  [{card}]")
    del step, state, st, out, args, kin, vis_k, gp_k, vis_p, gp_p
    results = {"raster_shade": dict(launches=launches,
                                    max_abs_err=max(err_vis, err_gbuf),
                                    ms=k_ms, plain_ms=p_ms)}

    # phase a: the flagship step, no overrides
    t0 = time.perf_counter()
    fstep, fstate = build(n_bodies=N_BODIES, width=WIDTH, height=HEIGHT,
                          grid_dim=64, device="cuda")
    torch.cuda.synchronize()
    rend = fstep.renderer
    scfg = rend.config.shadow
    print(f"phase a: built the flagship step in {time.perf_counter() - t0:.1f} s "
          f"(shadow {scfg})")

    # phase b: the kernels of the split atlas raster on one real atlas
    fphys = fstep.physics(fstate["physics"])
    fmats = fstep.instance_matrices(fphys)
    din = rend.cascade_inputs(fstep.scene, fmats, fstep.constants)
    split = raster.depth_args(**din)
    k2 = raster.depth_super_cuda(*split["super"])
    p2 = raster.depth_super_plain(*split["super"])
    k3 = raster.depth_grid_cuda(k2.clone(), *split["grid"])
    p3 = raster.depth_grid_plain(k2.clone(), *split["grid"])
    torch.cuda.synchronize()
    err2, err3 = max_diff(k2, p2), max_diff(k3, p3)
    atlas_h, atlas_w = k3.shape
    print(f"phase b: atlas {atlas_w}x{atlas_h}: depth_super vs plain max|d| {err2}, "
          f"depth_grid vs plain max|d| {err3}; covered {(k3 > 0).float().mean():.4f}")
    check(err2 == 0.0 and err3 == 0.0, "depth_super/depth_grid disagree with plain")
    setup, th = din["setup"], din["tile_h"]
    _, cap = din["tile_tris"].shape
    d_tiles, d_counts, d_big = raster.bin_triangles_corner(
        setup, atlas_w, atlas_h, 128, cap, tile_h=th, max_big=256)
    occupied = d_counts > 0
    in_active = torch.zeros_like(occupied)
    in_active[din["act_ids"].long()] = True
    outside = int((occupied & ~in_active).sum())
    sup_counts = din["sup_bins"][1]
    print(f"phase b: {int(occupied.sum())} occupied atlas tiles of "
          f"{occupied.numel()} (max_active_tiles {scfg.max_active_tiles}); "
          f"{outside} with a list outside the active set (expected 0); "
          f"big casters {int((d_big >= 0).sum())}, largest super-tile list "
          f"{int(sup_counts.max())} of 64")
    dense = raster.depth_args(setup, d_tiles, d_counts, d_big, atlas_w, atlas_h, 128,
                              din["atlas_bounds"], din["tri_atlas"], th)["dense"]
    k4_flag = raster.depth_dense_cuda(*dense)
    torch.cuda.synchronize()
    split_vs_dense = max_diff(k4_flag, k3)
    print(f"phase b: depth_dense on the dense corner binning vs split: "
          f"max|d| {split_vs_dense}")
    check(outside == 0, "occupied atlas tiles lost their lists")
    check(split_vs_dense == 0.0, "the split atlas differs from the dense one")

    # phase c: 5 flagship steps; K1, K2 and K3 once per step
    for fn in (raster.rasterize_visibility_shaded, raster.depth_super,
               raster.depth_grid, raster.depth_dense):
        fn.launches = 0
    fst = fstate
    for _ in range(5):
        fst, fimage = fstep(fst)
    torch.cuda.synchronize()
    counts = {k: getattr(raster, f).launches for k, f in (
        ("raster_shade", "rasterize_visibility_shaded"), ("depth_super", "depth_super"),
        ("depth_grid", "depth_grid"), ("depth_dense", "depth_dense"))}
    print(f"phase c: 5 flagship steps, launches {counts}")
    check(counts["raster_shade"] == 5 and counts["depth_super"] == 5
          and counts["depth_grid"] == 5 and counts["depth_dense"] == 0,
          "the flagship step did not run K1, K2 and K3 once per step")
    check(tuple(fimage.shape) == (HEIGHT, WIDTH, 3) and fimage.dtype == torch.uint8,
          f"flagship image is {tuple(fimage.shape)} {fimage.dtype}")
    fout = fstep.render(fstep.instance_matrices(fst["physics"]), fst["frame"])
    vis = fout["gbuffer"]["visible"]
    sh = fout["shadow"][..., 0][vis]
    lit_mean, ao_min = sh.mean().item(), fout["ao"].min().item()
    fpos = fst["physics"]["bodies"]["pos"]
    print(f"phase c: visible {vis.float().mean():.4f}; shadow factor on visible "
          f"pixels mean {lit_mean:.4f}, in shadow (< 0.5) "
          f"{(sh < 0.5).float().mean():.4f}; AO min {ao_min:.4f}")
    check(0.0 < lit_mean < 1.0, "the shadow factor is all lit or all shadowed")
    check(ao_min < 1.0, "the AO is 1 everywhere")
    check(bool(torch.isfinite(fpos).all()), "flagship body positions not finite")

    # phase d: the reference-parity (dense) shadows, K4 on the main path
    dstep, dstate = build(n_bodies=N_BODIES, width=WIDTH, height=HEIGHT,
                          grid_dim=64, cfg_overrides=DENSE_SHADOW_OVERRIDES,
                          device="cuda")
    dmats = dstep.instance_matrices(dstep.physics(dstate["physics"]))
    raster.depth_dense.launches = 0
    dout = dstep.render(dmats, dstate["frame"])
    torch.cuda.synchronize()
    k4_launches = raster.depth_dense.launches
    dargs = raster.depth_args(**dstep.renderer.cascade_inputs(
        dstep.scene, dmats, dstep.constants))["dense"]
    k4 = raster.depth_dense_cuda(*dargs)
    p4 = raster.depth_dense_plain(*dargs)
    torch.cuda.synchronize()
    err4 = max_diff(k4, p4)
    print(f"phase d: dense-shadow frame: depth_dense launches {k4_launches}; atlas "
          f"{k4.shape[1]}x{k4.shape[0]} vs plain max|d| {err4}; image "
          f"{tuple(dout['image'].shape)}")
    check(k4_launches == 1, "the dense-shadow frame did not launch depth_dense once")
    check(err4 == 0.0, "depth_dense disagrees with its plain version")

    # phase e: a small flagship step on the card against the CPU
    small_step_vs_cpu(build, {"shadow": ShadowConfig(
        resolve_step=2, cascade_sizes=(256, 128, 128), atlas_tile_h=16,
        atlas_foot_y=2, max_active_tiles=24)}, "e")

    # phase f: timings of the kernels and the flagship (CUDA events; medians)
    prior = k2.clone()
    buf = torch.empty_like(prior)
    copy_ms = cuda_ms(lambda: buf.copy_(prior), reps=20, warmup=3)
    t = {
        "depth_super kernel": cuda_ms(lambda: raster.depth_super_cuda(*split["super"]),
                                      reps=20, warmup=3),
        "depth_super plain": cuda_ms(lambda: raster.depth_super_plain(*split["super"]),
                                     reps=3),
        "depth_grid kernel": cuda_ms(lambda: raster.depth_grid_cuda(
            buf.copy_(prior), *split["grid"]), reps=20, warmup=3) - copy_ms,
        "depth_grid plain": cuda_ms(lambda: raster.depth_grid_plain(
            buf.copy_(prior), *split["grid"]), reps=3) - copy_ms,
        "depth_dense kernel": cuda_ms(lambda: raster.depth_dense_cuda(*dargs),
                                      reps=20, warmup=3),
        "depth_dense plain": cuda_ms(lambda: raster.depth_dense_plain(*dargs),
                                     reps=3),
        "depth_dense kernel, flagship atlas": cuda_ms(
            lambda: raster.depth_dense_cuda(*dense), reps=20, warmup=3),
    }
    fmats = fstep.instance_matrices(fst["physics"])
    planes, fvis, g = rend.gbuffer_pass(fstep.scene, fmats, fstep.constants)
    light, splits = rend.shadow_light(fstep.constants)
    atlas = rend.shadow_atlas(fstep.scene, planes[0], light)
    shadow = rend.shadow_factor(g, fstep.constants, atlas, light, splits)
    ao = rend.ambient_occlusion(g, fstep.constants)
    hdr = rend.shade(g, fstep.constants, shadow, ao)
    t.update({
        "flagship raster + G-buffer": cuda_ms(lambda: rend.gbuffer_pass(
            fstep.scene, fmats, fstep.constants), reps=10),
        "flagship render_cascades": cuda_ms(lambda: rend.shadow_atlas(
            fstep.scene, planes[0], light), reps=10),
        "flagship resolve_shadow": cuda_ms(lambda: rend.shadow_factor(
            g, fstep.constants, atlas, light, splits), reps=10),
        "flagship HBAO": cuda_ms(lambda: rend.ambient_occlusion(g, fstep.constants),
                                 reps=10),
        "flagship sky + lighting": cuda_ms(lambda: rend.shade(
            g, fstep.constants, shadow, ao), reps=10),
        "flagship post chain": cuda_ms(lambda: rend.post(
            hdr, fstep.constants, fst["frame"]), reps=10),
        "flagship render": cuda_ms(lambda: fstep.render(fmats, fst["frame"]), reps=10),
        "flagship physics step": cuda_ms(lambda: fstep.physics(fst["physics"]), reps=10),
        "flagship combined step": cuda_ms(lambda: fstep(fst), reps=10),
    })
    for name, ms in t.items():
        print(f"phase f: {name} median {ms:.4f} ms  [{card}]")
    results["depth_super"] = dict(launches=counts["depth_super"], max_abs_err=err2,
                                  ms=t["depth_super kernel"],
                                  plain_ms=t["depth_super plain"])
    results["depth_grid"] = dict(launches=counts["depth_grid"], max_abs_err=err3,
                                 ms=t["depth_grid kernel"],
                                 plain_ms=t["depth_grid plain"])
    results["depth_dense"] = dict(launches=k4_launches,
                                  max_abs_err=max(err4, split_vs_dense),
                                  ms=t["depth_dense kernel"],
                                  plain_ms=t["depth_dense plain"])

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, **results[name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
