#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (phase mc uses every
visible card when there are more).

Run from the repository root with `python3 chip_smoke.py`. It needs one
NVIDIA card (Hopper: the kernels are built for sm_90a) and the CUDA
toolkit, and it imports nothing of JAX. Phases, each of which must pass:

1. print the card's name and power limit (nvidia-smi); fail without CUDA;
2. build the port's CUDA kernels from `garden_tpu_torch/csrc`, one nvcc
   process per source, all at once;
3. build the combined step at full size: 10,240 bodies, 1920x1080, the
   first slice's pass set (`SLICE_OVERRIDES`);
4. compare the raster_shade kernel (K1) with its plain PyTorch version on
   the inputs of one real combined step: tri_id, depth and barycentrics in
   every bit, the G-buffer planes within TOL_GBUF;
5. run 5 such steps (K1 once per step, a real frame, finite bodies); 5b:
   one small step on the card against the same step on the CPU;
6. time K1 (the card's time in it, and one call from an idle card), its
   plain version, physics, render and the step;
then the flagship, every pass on:
a. build the flagship step at full size with no overrides;
b. on one real flagship atlas: depth_super (K2) and depth_grid (K3, on
   K2's output) against their plain versions in every bit, each plain
   version masked by raster.tile_slot_keep equal to the unmasked one, both
   culls live (kept < named); what the lists hold (split_lists_report:
   full super-tile lists and the big casters their cap drops, kept list
   lengths, the share of the kept pairs that the warp cull keeps); the atlas's occupied tiles
   against max_active_tiles; depth_dense (K4) on the dense corner binning
   of the same casters, which must equal the split result;
c. run 5 flagship steps: K1, K2 and K3 launch once per step; a real frame
   with shadows and AO; finite bodies; K1 against its plain version on
   the last step's inputs, as in phase 4;
d. render one frame with the reference-parity shadows (ShadowConfig()):
   K4 launches once and equals its plain version, which equals itself
   masked by raster.tile_slot_keep; K4's bound at that shape;
e. a small flagship step on the card against the same step on the CPU;
f. time K2, K3, K4 against their plain versions, K1 at the flagship's
   shape, and the flagship's stages, render and step;
then the glass step (`box_materials=GLASS_BOXES`, `GLASS_OVERRIDES`): the
flagship frame with OIT, refractive and sorted boxes, trans-depth and the
translucent shadow map, at full size:
g. build the glass step;
h. on one real glass frame's inputs, each in every bit against its plain
   version: K1 (its G-buffer within TOL_GBUF), the visibility kernel (K5),
   the sorted_blend kernel (K6) on the sorted pass and on the translucent
   atlas tint, the OIT kernel (K7), and depth_dense (K4) on the translucent
   casters' atlas and at trans-depth's screen tiles; every plain version
   masked by raster.tile_slot_keep equals the unmasked one bit for bit; on
   the translucent atlas the cull keeps under 10% of the scanned slots;
i. run 5 glass steps: K1, K2, K3, K5 and K7 launch once per step, K4 and
   K6 twice; a real frame whose OIT, refraction, trans-depth and
   translucent shadow map each drew something; finite bodies;
j. a small glass step on the card against the same step on the CPU;
k. time K1 at the glass step's shape, and K4, K5, K6 and K7 there against
   their plain versions, the non-opaque stages, the glass render and the
   glass step;
then the rest of the physics world (plain PyTorch, no hand kernel):
l. bench.py's world at full size (`physics.scenes.bench_world`: 10,240
   bodies, a plane and alternating boxes and spheres): BENCH_SETTLE steps,
   finite, the lower layers landed (contacts carry impulses); from there 3
   steps on the card against the CPU, positions within TOL_BENCH_CPU and
   normal impulses within TOL_BENCH_WARM;
m. the seven golden scenes (`physics.golden`) on the card within their
   analytic budgets; the pendulum (a point joint) twice, the same bits;
n. a world of every shape type with a point joint and sleep on
   (`physics.scenes.mixed_world`, on the compacted collide branch):
   MIXED_STEPS steps on the card against the CPU within TOL_MIXED_CPU, a
   body asleep, the first MIXED_REPEAT steps twice on the card the same
   bits; cast_ray, cast_sphere and
   cast_shape on the card against the CPU within TOL_QUERY;
o. time the bench world's physics step and its stages (collide, broadphase,
   narrowphase, solve_velocity, solve_position), one `simulate` tick and
   the flagship's box-only physics step; profile the bench step for the
   device's busy share and each stage's host and device time
   (`tools/profile_torch_step.profile_physics`);
then the ultra and temporal pass sets (plain PyTorch passes around K1-K4):
p. the ultra preset (`ULTRA_OVERRIDES`: clouds, SSR, SSGI, the dense
   3x2048 atlas with a 5x5 PCF) at full size for 3 steps: K1 and K4 once a
   step, K2 and K3 never; from step 2 on SSR confidence above 0 on some
   visible pixels, GI above 0, cloud alpha above 0 over the sky (the
   frame's sky above the clouds' horizon, where it has any, and a dome of
   sky rays: the flagship camera's top row looks just below the horizon)
   and the cloud shadow below 1 somewhere (over a 20 km ground grid: the
   frame's +-22 m ground samples one patch of the cloud layer); every
   output finite; K4 on the ultra atlas equal to its plain version;
q. the flagship with `TEMPORAL_OVERRIDES` (velocity and disocclusion,
   Hi-Z, SMAA) at full size for 3 steps, the renderer given the previous
   step's instance matrices: K1, K2 and K3 once a step; K1 against its
   plain version as in phase 4, its velocity planes within TOL_GBUF;
   velocity above 0 on the moving boxes; the Hi-Z's culled instances,
   and the last frame rendered without Hi-Z drawing the same tri_id on
   >= 99.9% of pixels (the cull is conservative); SMAA changes pixels
   next to edges only, and the frame's image is SMAA's;
r. small steps on the card against the CPU (the bars of phases e and j):
   ultra and the temporal set (two steps each), potato, low, medium, high;
s. timings: the ultra and temporal steps and renders, their ssr, ssgi,
   clouds, hiz and aa stages, potato and low at full size, and the ultra
   step under the profiler (device busy share, stage host and device
   times); the run's time before phase p and after phase s;
then the rest of render (plain PyTorch around K1-K5):
t. the forward renderer (`entry.build_forward`: the flagship scene and
   camera, `raster.render_pass` on 128x128 tiles) for one frame: K5 once
   and nothing else, equal in every bit to its plain version on the same
   inputs, its kept counts to tile_slot_keep over band_args; the frame's
   tri_id is K5's and covers the pile; what the 512-slot cap drops;
u. the feature frame (`entry.build_feature_frame`: slot-binned cascades
   with a y-footprint of 8 tiles, textures on every other box, a 512x1024
   environment map of the sky, a HUD of 48 sprites) for 3 steps: K1, K2,
   K3 once a step; on the last step's inputs K1 (its texture ids live) as
   in phase 4, K2 and K3 on the slot lists in every bit against their
   plain versions, kept as in phase b; textured pixels change the base
   colour; the sky equals the environment's sharpest mip; the image equals
   the post chain's LDR with composite_sprites run alone; the atmosphere
   LUTs and equi_to_cube of the environment at face 512, card against CPU;
v. the bench frame (`entry.build_bench_frame`: bench.py's world, 0.98 M
   resident triangles, spheres as a two-level LOD chain) for 3 steps: K1,
   K2, K3 once a step; visible pixels of both LOD levels; every output
   finite; peak device memory; on the last step's inputs K1 as in phase 4
   and K2, K3 on the corner-binned cascade lists as in phase u;
w. a small feature frame and a small bench frame on the card against the
   CPU (the bars of phases e and j); timings: the forward frame and K5 at
   its shape, the feature step and render with its ui, environment and
   cascade stages, the bench-frame step and render with its binnings; the
   feature step under the profiler;
then the runtime (`entry.build_engine_frame`: the Engine and its systems
over the flagship pile, 8 characters, 64 animated entities, a HUD):
x. x.1: a small engine world (32 bodies, 2 characters, 4 animated, a
   spawner), 30 ticks and a 256x128 frame on the card and on the CPU:
   transforms within TOL_ENGINE_CPU, grounded flags, animation times,
   tick and time in every bit, the image bars of phases e and j; x.2: the
   engine frame at full size for ENGINE_FRAMES frames: K1, K2, K3 once a
   frame, every state leaf finite, each movable transform row its body's
   interpolated pose in every bit, K1 and K2/K3 on the last frame's
   inputs as in phases 4 and u, the tick, frame, bake and render times,
   peak memory, the frame under the profiler (`profile_engine`); x.3: a
   checkpoint saved at frame 2, loaded, stepped: frame 3 as the
   uninterrupted run's in every bit; x.4: `gather_snapshots` of the
   full-size state, card bytes == CPU bytes, applied to a fresh state the
   poses in every bit; x.5: `utils.profiler.trace` of one frame names the
   physics ranges and K1.
then batched worlds and split-frame bands (`parallel/`), the command line
and the full demo:
y. `WorldBatch` over WORLD_BATCH copies of bench.py's world (each lifted
   0.1 m more than the last; fewer if one world's reckoned memory times
   the copies exceeds half the card): one batched step against the same
   worlds stepped one by one (bitwise, or positions within TOL_WORLDS,
   the difference printed); ms per world-step both ways (CUDA events),
   the busy share of each under the profiler, peak device memory; vmap's
   per-world fallback warning is an error (one shard on cuda:0);
z. z.1: `FrameTiles` of 4 bands over ["cuda"] * 4 at 256x128 against the
   same bands on the CPU (the image bar of phases e and j); at the
   flagship config and 1920x1080, 4 bands against the single renderer's
   frame (the off-seam p99 and mean differences printed beside the
   reference test's bars), the banded frame's ms, K1, K2, K3 once a band,
   and on each band's inputs K1 as in phase 4 and K2, K3 as in phase b
   (`check_frame`); z.2: `python -m garden_tpu_torch scene <demo.scene>
   --preview` (`cli.main`) at 640x384 on the card against `--cpu` (the
   image bar), K1 once, and on the preview's inputs (`cli.preview_frame`)
   K1 as in phase 4 and K4 on its dense atlas in every bit; z.3:
   `examples/full_demo_torch.py`, 3 frames into a temporary directory:
   finite HDR, the G-buffer and physics dumps written, K1 once a frame,
   and on the last frame's inputs K1 and K4 as in z.2. With at least 2
   cards visible, z.1's flagship bands also run over distinct cards
   (band b on cuda:b mod count), equal in every bit to the bands on one.
then the multi-device path (`WorldBatch` over a device list and over the
ranks of a process group, `CombinedStep.to`, `entry.dryrun_multichip`),
over D: every visible card when there are at least 2, else cuda:0 twice:
mc. mc.1: phase y's bench worlds (its count and lift) as shards over D,
   every leaf equal in every bit to phase y's one-device batch, the
   reduce of the mean body height within TOL_MC_MEAN of the one-device
   reduce, ms per world-step both ways (host clock, every card idle
   before and after), peak memory per card; mc.2: the flagship combined
   step (10,240 bodies, 1920x1080) as one instance per entry of D
   (`CombinedStep.to`, instance i's pile lifted 0.1 i m; fewer if the
   instances on one card would pass half its memory, reckoned as phase
   y does), MC_STEPS steps through `WorldBatch`: K1, K2, K3 once per
   instance per step, each instance's state and image equal in every bit
   to the instance stepped alone on cuda:0, and on each instance's last
   inputs, on its own card, K1 and K2/K3 as in z.1 (`check_frame`); the
   step of all instances beside n x one; mc.3:
   `dryrun_multichip(len(D), devices=D)`: images (len(D), 32, 64, 3),
   finite states, K1 and K4 once per instance, each instance's state and
   image equal in every bit to the tiny step run once alone on cuda:0,
   and on each instance's inputs, on its own card, K1 and K4 (the dense
   atlas) against their plain versions (`check_frame`); mc.4:
   `tests/torch_multihost_worker.py` as two processes over gloo, each
   rank on its own card when there are 2, else both on cuda:0: each
   rank's mean sphere height within TOL_MC_PROCS of the CPU's.
Kernels launched on the paths of phases t-z and mc join each kernel's
`launches_by_path` in the kernels line (`launches` sums them).

Every kernel culls its slots exactly. Wherever one is checked (phases 4,
b, c, d and h), it also writes its per-tile (K1, K5, K7: per row band;
K3: per active row) `kept` counts (the slots that pass its cull), which
must equal the row sums of `raster.tile_slot_keep`, the cull's plain twin,
over the kernel's own layout (`cull_args`: `raster.band_args` or
`oit.band_lists` for the banded kernels, `raster.super_lists` for K2,
the active rows' tiles for K3): a redesign that culled nothing would fail
there.

The line before the last is a JSON object describing each kernel (its
launches on its main path, max |d| against its plain version, its device
time, one call of the plain version, and the bound: the least time the card could take
for the same work, from the work these inputs need: the (slot, pixel)
pairs that hold a triangle, after early exits, and the record rows the
lists name, each once; for the culled kernels only the pairs that
tile_slot_keep keeps, which alone can change a pixel, plus the cull's own
operations (for K2-K4, K6 and K7 also the lists' used slots; for K6 and
K7 the opaque depth, and for K3 the depth image, only of the tiles, bands
or rows that keep a slot; K7's operations split by where they are
needed, OPS_OIT_*; K2's and K3's their edges only on the warps that keep
a slot and their depth only where the pixel is inside, OPS_DEPTH_*), with
the count before the cull (every scanned pair)
beside it as `bound_ms_full`);
the last line is `{"ok": true, "device": {...}}`. Any failure exits
non-zero before those lines are printed.
"""

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

KERNELS = {   # name -> (route, source, the TPU kernel it replaces)
    "raster_shade": ("cuda", "garden_tpu_torch/csrc/raster_shade.cu",
                     "garden_tpu/render/raster.py:801"),
    "depth_super": ("cuda", "garden_tpu_torch/csrc/depth_raster.cu",
                    "garden_tpu/render/raster.py:1336"),
    "depth_grid": ("cuda", "garden_tpu_torch/csrc/depth_raster.cu",
                   "garden_tpu/render/raster.py:1380"),
    "depth_dense": ("cuda", "garden_tpu_torch/csrc/depth_raster.cu",
                    "garden_tpu/render/raster.py:1268"),
    "visibility": ("cuda", "garden_tpu_torch/csrc/raster_shade.cu",
                   "garden_tpu/render/raster.py:609"),
    "sorted_blend": ("cuda", "garden_tpu_torch/csrc/blend_raster.cu",
                     "garden_tpu/render/raster.py:1076"),
    "oit": ("cuda", "garden_tpu_torch/csrc/blend_raster.cu",
            "garden_tpu/render/oit.py:31"),
}
SOURCES = ["raster_shade", "depth_raster", "blend_raster"]
TOL_GBUF = 2e-5            # K1's G-buffer planes (rsqrt may differ by an ulp)
# physics on the card against the CPU: positions after 3 steps of the bench
# world from BENCH_SETTLE steps in (as phase 5b), and its normal impulses then
# over the largest of them; after MIXED_STEPS of the mixed world (compounds, hulls,
# meshes, a joint, sleep: a body at rest falls asleep after 31 steps), whose
# first MIXED_REPEAT steps run twice on the card; the three casts' distance,
# point and normal
TOL_BENCH_CPU, TOL_BENCH_WARM, TOL_MIXED_CPU, TOL_QUERY = 1e-4, 1e-5, 1e-3, 1e-4
BENCH_SETTLE = 20
MIXED_STEPS, MIXED_REPEAT = 35, 10
N_BODIES, WIDTH, HEIGHT = 10240, 1920, 1080

# The bound of a kernel: the larger of its float32 operations over the
# card's float32 rate outside the tensor cores, and the bytes it must move
# (each input tensor read once, each output written once) over the memory
# rate (NVIDIA H100 SXM data sheet, at the full 700 W).
FP32_RATE = 67e12
HBM_RATE = 3.35e12
# float32 operations per (slot, pixel) pair a kernel tests, counted from
# its inner loop (multiplies, adds, compares and selects):
# edge form (K1, K2-K4, K5): e0, e1 4 each, e2 2, the two barycentric
# weights 2, z 4, five coverage compares and the nearer-than compare or
# max 6 = 22; the atlas rect guard adds 4 compares. Vertex form: the
# three edges 7 each, b0 and b1 2, z 7, five compares (+4 with rects),
# then the blend (K6) 1 + 3 x 3 = 10 -> 45, or the OIT weight 6, its
# select 1, four accumulations 7 and the reveal 2 (K7) -> 50. K1 also
# finishes the G-buffer, ~60 operations a pixel.
OPS_EDGE, OPS_RECT, OPS_BLEND, OPS_OIT, OPS_SHADE = 22, 4, 45, 50, 60
# K7's least work splits that count by where it is needed: each kept slot
# forms three column shares (px - xa)(yc - ya) of 3 operations, three edge
# deltas and 1 - alpha once a column of its band (13); each kept (slot,
# pixel) pair the three edges from them, 3 each, and their three tests
# (12); only a pair whose pixel is inside the triangle the depth 8, the two
# depth tests, the weight 6, its select, the four accumulations 7 and the
# reveal's select and multiply 2 (26).
OPS_OIT_COLUMN, OPS_OIT_EDGE, OPS_OIT_INSIDE = 13, 12, 26
# K2's and K3's least work splits OPS_EDGE the same way: each (slot, pixel)
# pair on a warp that keeps the slot its edges e0, e1 4 each, e2 2 and
# their three tests (13; the rect's 4 only where the tile straddles the
# rect); only a pair whose pixel is inside the two weights 2, z 4, its two
# tests and the max (9).
OPS_DEPTH_EDGE, OPS_DEPTH_INSIDE = 13, 9
# The cull of every kernel (csrc/cull.cuh), per scanned slot that names a
# triangle: vertex form three edges of 12 (2 coefficient subtracts, 2 sign
# tests, 2 corner selects, 2 subtracts, 2 multiplies, 1 subtract, the < 0
# test) = 36; edge form four corner values of 8 and 5 more (two < 0 tests,
# e2's 2 subtracts and its test) = 37; the rect lookup over three rects 15,
# its miss and inside tests 9 -> +24.
OPS_CULL_VERTEX, OPS_CULL_EDGE, OPS_CULL_RECT = 36, 37, 24
SPIN_CYCLES = 4_000_000    # ~2 ms of the card's clock, ahead of a timed kernel


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


def kernel_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds the card spends in one call of fn(), a kernel
    wrapper that issues its work without waiting on the card: each call is
    timed between CUDA events queued behind a ~2 ms spin on the card, so
    the host has issued the call before the start event runs, and the
    events time the card's work alone. (Events around a call on an idle
    card also time the host issuing it: the wrapper's checks and the
    ctypes call, a large share of a kernel that runs ~0.1 ms.)"""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def nbytes(*xs) -> int:
    """Bytes of the tensors among xs (other arguments count nothing)."""
    import torch
    return sum(x.numel() * x.element_size() for x in xs if isinstance(x, torch.Tensor))


def used_slots(tile_tris, counts):
    """Mask of each tile's list slots [0, counts) that name a triangle."""
    import torch
    slot = torch.arange(tile_tris.shape[1], device=tile_tris.device)
    return (slot[None, :] < counts[:, None].long()) & (tile_tris >= 0)


def frame_pixels(n_tiles: int, width: int, height: int, tile: int, tile_h: int, dev):
    """(tiles,) pixels of each tile that lie inside the frame."""
    import torch
    tiles_x = -(-width // tile)
    t = torch.arange(n_tiles, device=dev)
    return ((width - t % tiles_x * tile).clamp(max=tile)
            * (height - t // tiles_x * tile_h).clamp(max=tile_h))


def raster_work(tile_tris, counts, big_list, width: int, height: int, tile: int,
                tile_h: int):
    """(pairs, ids) of a raster without early exit: the (slot, pixel) pairs
    it must test, that is each tile's used list slots and the big list's
    triangles (None: no big list) times the tile's pixels inside the
    frame, and the triangle ids those slots name."""
    import torch
    own = used_slots(tile_tris, counts)
    big = tile_tris[:0, 0] if big_list is None else big_list[big_list >= 0]
    px = frame_pixels(tile_tris.shape[0], width, height, tile, tile_h, tile_tris.device)
    return int(((own.sum(1) + big.numel()) * px).sum()), torch.cat([tile_tris[own], big])


def kept_pairs(keep, width: int, height: int, tile: int, tile_h: int) -> int:
    """The (slot, pixel) pairs that can change a pixel: the slots of
    `raster.tile_slot_keep`'s mask times the tile's pixels inside the
    frame."""
    px = frame_pixels(keep.shape[0], width, height, tile, tile_h, keep.device)
    return int((keep.sum(1) * px).sum())


def kept_columns(keep, width: int, tile: int) -> int:
    """The (slot, column) pairs of the kept slots of a band grid `tile`
    pixels wide: each band's kept slots times its columns inside the
    frame."""
    import torch
    tiles_x = -(-width // tile)
    tx = torch.arange(keep.shape[0], device=keep.device) % tiles_x
    return int((keep.sum(1) * (width - tx * tile).clamp(max=tile)).sum())


def named_slots(tile_tris, counts, big_list) -> int:
    """The (tile, slot) pairs that a culled kernel tests: each tile's used
    slots that name a triangle and the big list's triangles."""
    return (int(used_slots(tile_tris, counts).sum())
            + int((big_list >= 0).sum()) * tile_tris.shape[0])


def cull_args(args, kind: str) -> tuple:
    """The arguments of raster.tile_slot_keep (records, lists, counts, big
    list, width, height, tile, tile_h, rects, form[, tiles]) that give the
    cull of a kernel called with `args`: blend_cuda ("blend"),
    depth_dense_cuda ("depth"), depth_super_cuda ("super", each tile's
    super-tile list, raster.super_lists), depth_grid_cuda after its depth
    image ("grid", row i the list of tile act_ids[i]), raster_shade_cuda
    ("shade"), visibility_cuda ("visibility") or oit_cuda ("oit"); the
    last three cull per row band, so their rows are bands (raster.band_args,
    oit.band_lists)."""
    from garden_tpu_torch.render import oit, raster
    if kind == "oit":
        lists, counts = oit.band_lists(*args[1:3], *args[4:7])
        return (args[0], lists, counts, lists[0, :0], *args[4:7],
                oit.band_rows(args[6]), (), "vertex")
    return {"blend": lambda: (*args[:4], *args[6:11], "vertex"),
            "depth": lambda: (*args[:4], *args[5:10], "edge"),
            "super": lambda: (args[0], *raster.super_lists(*args[1:8]), args[1][0, :0],
                              *args[4:9], "edge"),
            "grid": lambda: (args[0], args[3], args[2], args[3][0, :0], *args[5:10],
                             "edge", args[1]),
            "shade": lambda: (args[0], *raster.band_args(args)[2:9], (), "edge"),
            "visibility": lambda: (*raster.band_args(args)[:8], (), "edge")}[kind]()


def run_kept(fn, args, kind: str, name: str):
    """fn(*args, kept=...) on the card; checks that the kernel's per-tile
    (or per-band, per-row) kept counts equal tile_slot_keep's row sums
    exactly and prints the share of the named slots kept and the longest
    kept list; -> (output, keep mask, kept slots, named slots)."""
    import torch
    from garden_tpu_torch.render import raster
    ca = cull_args(args, kind)
    keep = raster.tile_slot_keep(*ca)
    kept = torch.full((keep.shape[0],), -1, dtype=torch.int32, device=keep.device)
    out = fn(*args, kept=kept)
    same = torch.equal(kept, keep.sum(1).int())
    n_kept, n_named = int(keep.sum()), named_slots(*ca[1:4])
    per_row = keep.sum(1)
    unit = {"oit": "band", "shade": "band", "visibility": "band",
            "grid": "active row"}.get(kind, "tile")
    print(f"{name}: the cull keeps {n_kept} of {n_named} scanned slots "
          f"({n_kept / max(n_named, 1):.4f}; at most {int(per_row.max())} in one {unit}, "
          f"none in {int((per_row == 0).sum())} of {per_row.numel()} {unit}s); "
          f"kernel kept == tile_slot_keep: {same}")
    check(same, f"{name}: the kernel's kept counts differ from tile_slot_keep")
    return out, keep, n_kept, n_named


def split_warps(ca):
    """raster.warp_keep over the cull arguments `ca` of depth_super or
    depth_grid (cull_args kinds "super", "grid"): the survivors each warp
    of their tiles keeps, (rows, raster.DEPTH_WARPS, cap)."""
    from garden_tpu_torch.render import raster
    return raster.warp_keep(*ca[:3], *ca[4:9], *ca[10:])


def input_bytes(records, ids, *others) -> int:
    """Bytes a raster must read: each record row that `ids` names, once,
    and the tensors among `others` whole."""
    import torch
    rows = torch.unique(ids[ids >= 0]).numel()
    return rows * records.shape[1] * records.element_size() + nbytes(*others)


def list_bytes(tile_tris, counts, big_list) -> int:
    """Bytes of the lists a culled kernel (K4, K6) must read: each tile's
    slots that name a triangle and its count, and the big list's
    triangles."""
    return 4 * (int(used_slots(tile_tris, counts).sum()) + counts.numel()
                + int((big_list >= 0).sum()))


def atlas_inputs(step, mats):
    """The frame's opaque and translucent caster inputs
    (DeferredRenderer.cascade_inputs), built as the frame builds them."""
    from garden_tpu_torch.render import mesh
    planes, _ = mesh.transform_triangle_planes(step.scene, mats)
    light, _ = step.renderer.shadow_light(step.constants)
    return step.renderer.cascade_inputs(step.scene, planes, light)


def glass_kernel_args(step, state):
    """The kernels' inputs on one real glass frame, after one physics step
    of `state`, built as the frame builds them -> (args, light, hdr): args
    maps "raster_shade" (K1), "visibility" (K5), "sorted" and "atlas_tint"
    (K6), "oit" (K7), "depth_atlas" and "trans_depth" (K4) to the
    positional arguments of their wrappers; light and hdr are the frame's
    shadow light and opaque HDR."""
    from garden_tpu_torch.render import csm, oit, raster
    rend, scene, const = step.renderer, step.scene, step.constants
    mats = step.instance_matrices(step.physics(state["physics"]))
    geo, vis, g = rend.gbuffer_pass(scene, mats, const)
    light, splits = rend.shadow_light(const)
    atlas, trans = rend.shadow_atlas(scene, geo["planes"], light)
    shadow = rend.shadow_factor(g, const, atlas, light, splits, trans)
    hdr = rend.shade(g, const, shadow, rend.ambient_occlusion(g, const))
    _, tkw = rend.cascade_inputs(scene, geo["planes"], light)
    args = {
        "raster_shade": raster.kernel_args(**rend.raster_inputs(scene, mats, const)),
        "visibility": raster.visibility_args(**rend.refraction_inputs(scene, geo, const)),
        "sorted": raster.blend_args(**rend.sorted_inputs(scene, geo, const, vis["depth"],
                                                         hdr)),
        "atlas_tint": raster.blend_args(**csm.translucent_tint_inputs(
            tkw, rend.caster_tint(scene), atlas)),
        "oit": oit.oit_args(**rend.oit_inputs(scene, geo, const, vis["depth"])),
        "depth_atlas": raster.depth_args(**tkw)["dense"],
        "trans_depth": raster.depth_args(**rend.trans_depth_inputs(
            scene, geo, const))["dense"],
    }
    return args, light, hdr


def bound(ops: float, moved: int) -> dict:
    """bound_ms and bound_by of a kernel doing `ops` float32 operations and
    moving `moved` bytes."""
    t_ops, t_bytes = ops / FP32_RATE * 1e3, moved / HBM_RATE * 1e3
    if t_ops >= t_bytes:
        return {"bound_ms": t_ops, "bound_by": "operations"}
    return {"bound_ms": t_bytes, "bound_by": "bytes"}


def dense_bounds(a, out, work_full: int, work_kept: int, n_named: int):
    """(bound, bound_full) of depth_dense on the arguments `a` with output
    `out`. bound: the operations of the (slot, pixel) pairs after early
    exits that the plain version counted over the slots the cull keeps
    (`work_kept`) plus the cull's own per scanned slot; the bytes of the
    named records, the lists' used slots, the early-exit table and the
    output. bound_full, the count before the cull: every scanned slot's
    pairs (`work_full`) and the lists whole."""
    import torch
    ids = torch.cat([a[1][used_slots(a[1], a[2])], a[3]])
    moved = input_bytes(a[0], ids, a[4]) + list_bytes(*a[1:4]) + nbytes(out)
    moved_full = input_bytes(a[0], ids, *a[1:5]) + nbytes(out)
    rect = bool(a[9])
    per_pair = OPS_EDGE + (OPS_RECT if rect else 0)
    cull = n_named * (OPS_CULL_EDGE + (OPS_CULL_RECT if rect else 0))
    return (bound(work_kept * per_pair + cull, moved),
            bound(work_full * per_pair, moved_full))


def split_bounds(sup, grid, out2, keep3, work: dict, named: dict, kept: dict) -> dict:
    """{"depth_super": (bound, bound_tile, bound_full), "depth_grid": ...}
    of the split atlas raster on the arguments `sup` and `grid`, with
    depth_super's output out2 and depth_grid's cull mask keep3. work[k] is
    the plain version's count after early exits without and with the
    kernels' culls (`_depth_blocks`' four counts with `warps`). bound: the
    edges of the (slot, pixel) pairs whose warp keeps the slot, the rect
    test where the tile straddles the slot's rect, the depth and its max
    only where the pixel is inside, plus the cull's own operations per
    named slot (named[k]) and the warp cull's per kept slot (kept[k]) and
    warp; the bytes of the named records, the lists' used slots, the
    early-exit table, depth_super's output and the pixels that depth_grid
    reads and writes in the rows that keep a slot (a row that keeps none
    touches nothing). bound_tile, as dense_bounds counts K4: every pair of
    the kept slots at OPS_EDGE (+ OPS_RECT) plus the tile cull. bound_full,
    the count before the cull: every scanned pair, the lists whole and
    every active row's pixels."""
    from garden_tpu_torch.render import raster
    rect = bool(sup[8])
    per_pair = OPS_EDGE + (OPS_RECT if rect else 0)
    per_slot = OPS_CULL_EDGE + (OPS_CULL_RECT if rect else 0)
    ids2 = sup[1][used_slots(*sup[1:3])]
    ids3 = grid[3][used_slots(grid[3], grid[2])]
    none = grid[3][0, :0]
    row_bytes = 8 * grid[7] * grid[8]           # a tile's pixels, read and written
    moved = {"depth_super": input_bytes(sup[0], ids2) + list_bytes(sup[1], sup[2], none)
             + nbytes(out2),
             "depth_grid": input_bytes(grid[0], ids3, grid[1], grid[4])
             + list_bytes(grid[3], grid[2], none) + row_bytes * int(keep3.any(1).sum())}
    full = {"depth_super": input_bytes(sup[0], ids2, *sup[1:3]) + nbytes(out2),
            "depth_grid": input_bytes(grid[0], ids3, *grid[1:5])
            + row_bytes * grid[1].numel()}
    out = {}
    for k in moved:
        pairs, (tile_pairs, warp_pairs, rect_pairs, inside) = work[k]
        cull = named[k] * per_slot
        ops = (warp_pairs * OPS_DEPTH_EDGE + rect_pairs * OPS_RECT
               + inside * OPS_DEPTH_INSIDE + cull + kept[k] * raster.DEPTH_WARPS * per_slot)
        out[k] = (bound(ops, moved[k]), bound(tile_pairs * per_pair + cull, moved[k]),
                  bound(pairs * per_pair, full[k]))
    return out


def split_lists_report(din, sup, keep2, keep3, warps2, warps3) -> None:
    """Prints what the split atlas raster's lists hold: the super-tile lists
    that are full and the big casters their cap drops (raster.
    supertile_counts, the lists before the cap); the slots that
    depth_super's cull keeps in the tiles under full lists; the kept lists'
    lengths (per tile, per active row); and the share of the tile's kept
    (slot, warp) pairs that the warp cull keeps (split_warps)."""
    import torch
    from garden_tpu_torch.render import raster
    sup_x, sup_y, _ = sup[3]
    cap = sup[1].shape[1]
    uncapped = raster.supertile_counts(din["setup"], din["big_list"], *sup[4:8], sup_x,
                                       sup_y)
    lists, counts = raster.super_lists(*sup[1:8])
    under_full = counts >= cap
    kept_full = keep2.sum(1)[under_full].float()
    print(f"phase b: super-tile lists: {int((uncapped >= cap).sum())} of "
          f"{uncapped.numel()} full at {cap} slots; the cap drops "
          f"{int((uncapped - cap).clamp(min=0).sum())} of {int(uncapped.sum())} "
          f"(super-tile, big caster) pairs; the {int(under_full.sum())} tiles under "
          f"full lists keep {kept_full.mean().item() if kept_full.numel() else 0:.2f} "
          f"slots on average, at most "
          f"{int(kept_full.max()) if kept_full.numel() else 0} of {cap}")
    q = torch.tensor([0.5, 0.9, 0.99], device=keep2.device)
    n_w = raster.DEPTH_WARPS
    for name, keep, warps in (("depth_super", keep2, warps2), ("depth_grid", keep3, warps3)):
        rows = keep.sum(1).float()
        on = (warps & keep[:, None, :]).sum((1, 2))
        share = int(on.sum()) / max(n_w * int(keep.sum()), 1)
        print(f"phase b: {name} kept slots per row p50/p90/p99/max "
              f"{[round(v, 1) for v in torch.quantile(rows, q).tolist()]} / "
              f"{int(rows.max())}; the warp cull keeps {share:.4f} of the kept "
              f"(slot, warp) pairs; the busiest row's {n_w} warps keep "
              f"{int(on.max())} (slot, warp) pairs of {n_w * int(rows.max())}")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_diff(a, b) -> float:
    return (a - b).abs().max().item()


def same_bits(a, b) -> bool:
    """a and b hold the same float32 bit patterns (+0.0 and -0.0 differ)."""
    import torch
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def negative_zeros(x) -> int:
    import torch
    return int(((x == 0) & torch.signbit(x)).sum())


def check_raster_shade(args, name: str):
    """K1 on `args` against its plain version: tri_id, depth, b0 and b1 in
    every bit, the G-buffer planes within TOL_GBUF; its kept counts against
    tile_slot_keep (run_kept); the plain version masked by that mask equal
    to the unmasked one in every bit. -> (vis, planes, keep, named slots,
    max |d| of the G-buffer)."""
    import torch
    from garden_tpu_torch.render import raster
    (vis_k, gp_k), keep, _, n_named = run_kept(raster.raster_shade_cuda, args, "shade",
                                               f"{name}: raster_shade (K1)")
    vis_p, gp_p = raster.raster_shade_plain(*args)
    vis_m, gp_m = raster.raster_shade_plain(*raster.band_args(args), keep=keep)
    torch.cuda.synchronize()
    bits = {k: same_bits(vis_k[k], vis_p[k]) for k in ("tri_id", "depth", "b0", "b1")}
    err_gbuf = max_diff(gp_k, gp_p)
    masked = all(same_bits(vis_m[k], vis_p[k]) for k in vis_p) and same_bits(gp_m, gp_p)
    covered = (vis_k["tri_id"] >= 0).float().mean().item()
    print(f"{name}: raster_shade vs plain at {args[5]}x{args[6]}: same bits {bits}, "
          f"max|d| gbuffer {err_gbuf:.3g} (<= {TOL_GBUF}), covered {covered:.4f}; "
          f"masked plain == plain: {masked}; big list {int((args[4] >= 0).sum())} of "
          f"{args[4].numel()} slots used")
    check(all(bits.values()), f"{name}: raster_shade differs from its plain version")
    check(err_gbuf <= TOL_GBUF, f"{name}: raster_shade G-buffer planes disagree")
    check(masked, f"{name}: the plain raster_shade masked by tile_slot_keep differs "
                  "from the unmasked one")
    return vis_k, gp_k, keep, n_named, err_gbuf


def check_split(din, name: str, lists: str, results: dict):
    """K2 then K3 on the atlas inputs `din` (raster.depth_args) against
    their plain versions in every bit, their kept counts against
    tile_slot_keep (run_kept), the plain versions masked by that mask equal
    to the unmasked ones; each kernel's max |d| joins results. -> the
    atlas."""
    import torch
    from garden_tpu_torch.render import raster
    split = raster.depth_args(**din)
    sup, grid = split["super"], split["grid"]
    k2, keep2, kept2, named2 = run_kept(raster.depth_super_cuda, sup, "super",
                                        f"{name}: depth_super (K2) on {lists}")
    k3, keep3, kept3, named3 = run_kept(
        lambda *a, kept: raster.depth_grid_cuda(k2.clone(), *a, kept=kept), grid, "grid",
        f"{name}: depth_grid (K3) on {lists}")
    p2 = raster.depth_super_plain(*sup)
    p3 = raster.depth_grid_plain(k2.clone(), *grid)
    p2k = raster.depth_super_plain(*sup, keep=keep2)
    p3k = raster.depth_grid_plain(k2.clone(), *grid, keep=keep3)
    torch.cuda.synchronize()
    bits = {"depth_super": same_bits(k2, p2), "depth_grid": same_bits(k3, p3),
            "masked": same_bits(p2k, p2) and same_bits(p3k, p3)}
    print(f"{name}: atlas {k3.shape[1]}x{k3.shape[0]} on {lists}: same bits {bits}; "
          f"covered {(k3 > 0).float().mean():.4f}")
    check(all(bits.values()), f"{name}: K2/K3 on {lists} differ from their plain versions")
    check(kept2 < named2 and kept3 < named3, f"{name}: the split raster's cull keeps "
                                             "every named slot")
    for k, err in (("depth_super", max_diff(k2, p2)), ("depth_grid", max_diff(k3, p3))):
        results[k]["max_abs_err"] = max(results[k]["max_abs_err"], err)
    return k3


def check_dense(args, name: str, what: str, results: dict) -> None:
    """K4 on `args` (raster.depth_args' "dense") against its plain version
    in every bit, its kept counts against tile_slot_keep (run_kept), the
    plain version masked by that mask equal to the unmasked one; the max
    |d| joins results."""
    import torch
    from garden_tpu_torch.render import raster
    k4, keep, _, _ = run_kept(raster.depth_dense_cuda, args, "depth",
                              f"{name}: depth_dense (K4) on {what}")
    p4 = raster.depth_dense_plain(*args)
    p4k = raster.depth_dense_plain(*args, keep=keep)
    torch.cuda.synchronize()
    err = max_diff(k4, p4)
    print(f"{name}: {what} {k4.shape[1]}x{k4.shape[0]}: depth_dense vs plain max|d| {err}, "
          f"same bits {same_bits(k4, p4)}; masked plain == plain {same_bits(p4k, p4)}")
    check(same_bits(k4, p4), f"{name}: depth_dense differs from its plain version")
    check(same_bits(p4k, p4), f"{name}: the masked plain depth_dense differs")
    results["depth_dense"]["max_abs_err"] = max(results["depth_dense"]["max_abs_err"], err)


def check_frame(rend, scene, mats, const, name: str, results: dict, atlas: str) -> None:
    """K1 on the inputs of one frame of `rend` (as phase 4), and its shadow
    atlas kernels on that frame's casters: K2 and K3 (check_split) for a
    split atlas (`atlas` "split"), K4 (check_dense) for a dense one."""
    from garden_tpu_torch.render import raster
    *_, err = check_raster_shade(raster.kernel_args(**rend.raster_inputs(scene, mats, const)),
                                 name)
    results["raster_shade"]["max_abs_err"] = max(results["raster_shade"]["max_abs_err"], err)
    frame = SimpleNamespace(renderer=rend, scene=scene, constants=const)
    din, _ = atlas_inputs(frame, mats)
    if atlas == "split":
        check_split(din, name, "cascade lists", results)
    else:
        check_dense(raster.depth_args(**din)["dense"], name, "the dense atlas", results)


def raster_shade_bounds(args, vis, planes, keep, n_named):
    """(bound, bound_full) of raster_shade on `args` with outputs vis and
    planes: the operations of the (slot, pixel) pairs that tile_slot_keep
    keeps on the kernel's band grid, the cull's own per named slot of each
    band and the G-buffer finish per pixel; bound_full, the count before
    the cull, every scanned pair. Bytes: the named edge records, the
    lists, the winners' shading records and the outputs."""
    from garden_tpu_torch.render import raster
    pairs, ids = raster_work(*args[2:9])
    moved = (input_bytes(args[0], ids, *args[2:5]) + input_bytes(args[1], vis["tri_id"])
             + nbytes(*vis.values(), planes))
    finish = args[5] * args[6] * OPS_SHADE
    return (bound(kept_pairs(keep, *raster.band_args(args)[5:9]) * OPS_EDGE
                  + n_named * OPS_CULL_EDGE + finish, moved),
            bound(pairs * OPS_EDGE + finish, moved))


def oit_bounds(args, out, keep, n_named: int, inside: int):
    """(bound, bound_full) of the OIT kernel on `args` with outputs `out`
    and the band mask `keep` (oit.band_keep). bound: the column shares of
    each kept (band, slot), the edges of each kept pair, the rest only on
    the `inside` pairs whose pixel is inside the triangle (oit_plain's
    `work`), and the cull's own per named slot; bytes: the named records,
    the lists' used slots, the outputs and the opaque depth of the bands
    that keep a slot (a band that keeps none stores accum 0 and reveal 1).
    bound_full, the count before the cull: every scanned pair at OPS_OIT,
    the lists and the opaque depth whole. The merged list's holes add
    exactly zero: no work."""
    from garden_tpu_torch.render import oit
    records, tile_tris, counts, opaque, width, height, tile = args
    rows = oit.band_rows(tile)
    pairs, ids = raster_work(tile_tris, counts, None, width, height, tile, tile)
    px = frame_pixels(keep.shape[0], width, height, tile, rows, keep.device)
    moved = (input_bytes(records, ids) + list_bytes(tile_tris, counts, tile_tris[0, :0])
             + opaque.element_size() * int(px[keep.any(1)].sum()) + nbytes(*out))
    ops = (kept_columns(keep, width, tile) * OPS_OIT_COLUMN
           + kept_pairs(keep, width, height, tile, rows) * OPS_OIT_EDGE
           + inside * OPS_OIT_INSIDE + n_named * OPS_CULL_VERTEX)
    return (bound(ops, moved),
            bound(pairs * OPS_OIT, input_bytes(records, ids, tile_tris, counts, opaque)
                  + nbytes(*out)))


def small_step_vs_cpu(build, overrides, phase: str, box_materials=None,
                      steps: int = 1) -> None:
    """`steps` 32-body 256x128 steps on the card and on the CPU: tri_id on
    >= 99.9% of pixels, the last image within 2 levels on >= 99.5%, bodies
    within 1e-4."""
    small = {}
    for dev in ("cuda", "cpu"):
        s_step, s_state = build(32, 256, 128, grid_dim=8, cfg_overrides=overrides,
                                device=dev, box_materials=box_materials)
        for _ in range(steps):
            s_prev = s_state
            s_state, s_img = s_step(s_state)
        s_next = s_state
        s_out = s_step.render(s_step.instance_matrices(s_next["physics"]),
                              s_prev["frame"])
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


def physics_phases(card: str) -> None:
    """Phases l-o: the rest of the physics world on the card."""
    import numpy as np
    import torch
    from garden_tpu_torch.entry import flagship_world
    from garden_tpu_torch.physics import (golden, narrowphase, queries, scenes, solver,
                                          world as pw)
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from profile_torch_step import profile_physics

    h = 1.0 / 60.0

    def run(state, cfg, types, steps):
        for _ in range(steps):
            state = pw.step(state, cfg, h, types)
        return state

    # phase l: bench.py's world at full size (10,240 bodies, half spheres),
    # BENCH_SETTLE steps on the card so that the lower layers rest on the
    # plane and on each other; then 3 steps from there on the card and on the
    # CPU, contacts binding
    t0 = time.perf_counter()
    bst, bcfg, btypes = scenes.bench_world("cuda")
    check(btypes == frozenset((1, 2, 6)), f"bench world types {sorted(btypes)}")
    bs = run(bst, bcfg, btypes, BENCH_SETTLE)
    pos = bs["bodies"]["pos"]
    check(bool(torch.isfinite(pos).all()), "phase l: bench world bodies are not finite")
    n_contacts = int(pw.collide(bs, bcfg, btypes)["valid"].sum())
    binding = int((bs["warm"]["n"] > 0).sum())
    print(f"phase l: bench world 10240 bodies, {BENCH_SETTLE} steps in "
          f"{time.perf_counter() - t0:.1f} s; finite; {n_contacts} contact points "
          f"(speculative included), {binding} carry a normal impulse; mean drop "
          f"{(bst['bodies']['pos'][1:, 1] - pos[1:, 1]).mean().item():.5f} m")
    check(binding > 1000, "phase l: the bench world's contacts never bound")

    def to(tree, dev):
        return {k: to(v, dev) for k, v in tree.items()} if isinstance(tree, dict) \
            else tree.to(dev)

    after = {dev: run(to(bs, dev), bcfg, btypes, 3) for dev in ("cuda", "cpu")}
    d_bench = max_diff(after["cuda"]["bodies"]["pos"].cpu(), after["cpu"]["bodies"]["pos"])
    warm_cpu = after["cpu"]["warm"]["n"]
    d_warm = max_diff(after["cuda"]["warm"]["n"].cpu(), warm_cpu) / float(warm_cpu.abs().max())
    print(f"phase l: 3 steps from there cuda vs cpu: max|d| pos {d_bench:.3g} (bar "
          f"{TOL_BENCH_CPU}), normal impulses max|d| {d_warm:.3g} of their largest "
          f"{float(warm_cpu.abs().max()):.4g} (bar {TOL_BENCH_WARM})")
    check(d_bench <= TOL_BENCH_CPU and d_warm <= TOL_BENCH_WARM,
          "phase l: the bench world on the card disagrees with the CPU")

    # phase m: the seven golden scenes on the card, held to their budgets
    t0 = time.perf_counter()
    for name in golden.SCENES:
        curves = golden.simulate(name, "cuda")
        golden.check(name, curves)
        if name == "pendulum":
            again = golden.simulate(name, "cuda")
            check(all(np.array_equal(curves[k], again[k]) for k in curves),
                  "phase m: the pendulum on the card is not deterministic")
    print(f"phase m: the seven golden scenes pass their analytic budgets on the card; "
          f"the pendulum twice gives the same bits ({time.perf_counter() - t0:.1f} s)")

    # phase n: every shape type, a point joint and sleep, card against CPU
    t0 = time.perf_counter()
    out = {}
    for dev in ("cuda", "cpu"):
        st, mcfg, mtypes = scenes.mixed_world(dev)
        st = run(st, mcfg, mtypes, MIXED_REPEAT)
        if dev == "cuda":
            first = st["bodies"]["pos"].clone()
        out[dev] = run(st, mcfg, mtypes, MIXED_STEPS - MIXED_REPEAT)
    again = run(*scenes.mixed_world("cuda"), MIXED_REPEAT)
    check(torch.equal(first, again["bodies"]["pos"]),
          "phase n: the mixed world on the card is not deterministic")
    d_mixed = max_diff(out["cuda"]["bodies"]["pos"].cpu(), out["cpu"]["bodies"]["pos"])
    mb = out["cuda"]["bodies"]
    sleeping = int((mb["sleeping"] & (mb["motion"] == pw.DYNAMIC) & mb["has"]).sum())
    print(f"phase n: mixed world {sorted(mtypes)} with a joint and sleep, {MIXED_STEPS} "
          f"steps cuda vs cpu: max|d| pos {d_mixed:.3g} (bar {TOL_MIXED_CPU}); "
          f"{sleeping} dynamic bodies asleep; the card's first {MIXED_REPEAT} steps twice "
          f"give the same bits "
          f"({time.perf_counter() - t0:.1f} s)")
    check(d_mixed <= TOL_MIXED_CPU and sleeping >= 1,
          "phase n: the mixed world on the card disagrees with the CPU or never slept")
    hits = {}
    for dev in ("cuda", "cpu"):
        st = out[dev]
        v = lambda *c: torch.tensor(c, dtype=torch.float32, device=dev)
        down = v(0.0, -1.0, 0.0)
        hits[dev] = [queries.cast_ray(st, v(-3.5, 5.0, 0.3), down),
                     queries.cast_sphere(st, v(3.5, 5.0, -0.4), down, 0.2),
                     queries.cast_shape(st, 5, v(0.2, 6.0, 0.1), v(0.0, 0.0, 0.0, 1.0), down,
                                        max_distance=20.0, present_types=mtypes)]
    for name, hc, hp in zip(("cast_ray", "cast_sphere", "cast_shape"), hits["cuda"],
                            hits["cpu"]):
        d = max(max_diff(getattr(hc, k).cpu(), getattr(hp, k))
                for k in ("distance", "point", "normal"))
        print(f"phase n: {name} on the card: hit {bool(hc.hit)} body {int(hc.body)} "
              f"distance {float(hc.distance):.5f}; max|d| vs cpu {d:.3g}")
        check(bool(hc.hit) and int(hc.body) == int(hp.body) and d <= TOL_QUERY,
              f"phase n: {name} on the card disagrees with the CPU")

    # phase o: timings (medians of CUDA events after a warm-up)
    step = lambda s: pw.step(s, bcfg, h, btypes)
    stype, params, margin, cand, cvalid = pw.candidates(bs, bcfg)
    n, k = cand.shape
    pair_i = torch.arange(n, dtype=torch.int32, device="cuda")[:, None].expand(n, k).reshape(-1)
    contacts = pw.collide(bs, bcfg, btypes)
    bodies = bs["bodies"]
    warm = {key: torch.zeros_like(contacts["pen"]) for key in ("n", "t1", "t2")}
    gravity = torch.tensor(bcfg.gravity, device="cuda")
    fw, fcfg, _ = flagship_world(N_BODIES, 64, 2.0)
    fstate, ftypes = fw.device_state("cuda"), fw.shapes.present_types()
    times = {
        "bench world physics step": cuda_ms(lambda: step(bs), reps=10, warmup=3),
        "  collide (broadphase + narrowphase)": cuda_ms(
            lambda: pw.collide(bs, bcfg, btypes), reps=10),
        "    broadphase": cuda_ms(lambda: pw.candidates(bs, bcfg), reps=10),
        "    narrowphase": cuda_ms(lambda: narrowphase.generate_contacts(
            bodies["pos"], bodies["quat"], stype, params, pair_i, cand.reshape(-1),
            cvalid.reshape(-1), margin=margin, present_types=btypes,
            tables=bs["shapes"]), reps=10),
        "  solve_velocity": cuda_ms(lambda: solver.solve_velocity(
            bodies, contacts, h, iterations=bcfg.solver_iterations, baumgarte=0.0,
            slop=bcfg.penetration_slop, warm=warm, gravity=gravity), reps=10),
        "  solve_position": cuda_ms(lambda: solver.solve_position(
            bodies["pos"], bodies, contacts, contacts["pen"],
            iterations=bcfg.position_iterations, slop=bcfg.penetration_slop), reps=10),
        "simulate tick (dt 1/60: 1 step kept of the 4 it runs)": cuda_ms(
            lambda: pw.simulate(bs, bcfg, h, present_types=btypes), reps=5),
        "flagship box-only physics step": cuda_ms(
            lambda: pw.step(fstate, fcfg, h, ftypes), reps=10, warmup=3),
    }
    for name, ms in times.items():
        print(f"phase o: {name} median {ms:.4f} ms  [{card}]")
    wall, busy, stages = profile_physics(step, bs, 5)
    print(f"phase o: bench world step under the profiler: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms ({100 * busy / wall:.1f}% of wall)  [{card}]")
    for name, (host, dev) in stages.items():
        print(f"phase o:   stage {name}: host {host:.3f} ms, device {dev:.3f} ms per step")


def all_finite(tree, where: str = "") -> list:
    """Names of the floating-point tensors in a nested dict that hold a
    non-finite value."""
    import torch
    bad = []
    if isinstance(tree, dict):
        for k, v in tree.items():
            bad += all_finite(v, f"{where}/{k}")
    elif isinstance(tree, torch.Tensor) and tree.is_floating_point():
        if not bool(torch.isfinite(tree).all()):
            bad.append(where)
    return bad


def dome_rays(n: int, device):
    """(n, n, 3) unit directions over the sky: azimuth all around,
    elevation from 3 to 87 degrees."""
    import torch
    az = torch.linspace(0.0, 2.0 * math.pi, n, device=device)[None, :]
    el = torch.linspace(math.radians(3.0), math.radians(87.0), n, device=device)[:, None]
    return torch.stack([torch.cos(el) * torch.cos(az), torch.sin(el).expand(n, n),
                        torch.cos(el) * torch.sin(az)], dim=-1)


def ground_grid(n: int, half_km: float, device):
    """(n, n, 3) ground points (y = 0) on a square of +-half_km km."""
    import torch
    xs = torch.linspace(-half_km * 1000.0, half_km * 1000.0, n, device=device)
    gz, gx = torch.meshgrid(xs, xs, indexing="ij")
    return torch.stack([gx, torch.zeros_like(gx), gz], dim=-1)


def run_temporal(step, state, steps: int, prev_mats=None):
    """`steps` combined steps, the renderer given the previous step's
    instance matrices (the first step: those of `state`) -> (state, the
    last step's render output, its instance matrices, the frame state and
    previous instance matrices it was rendered from)."""
    prev = step.instance_matrices(state["physics"]) if prev_mats is None else prev_mats
    for _ in range(steps):
        frame_in, prev_in = state["frame"], prev
        phys = step.physics(state["physics"])
        mats = step.instance_matrices(phys)
        out = step.render(mats, frame_in, prev_in)
        state, prev = {"physics": phys, "frame": out["frame_state"]}, mats
    return state, out, mats, frame_in, prev_in


def pass_set_phases(card: str, results: dict, t_start: float) -> None:
    """Phases p-s: the ultra preset and the temporal pass set at full size,
    every quality preset small against the CPU, and their timings. Prints
    the run's time before them (phases 1-o, the earlier slices') and
    after them, from `t_start`."""
    import torch
    print(f"chip_smoke: phases 1-o took {time.perf_counter() - t_start:.1f} s")
    from garden_tpu_torch.core.config import QUALITY_PRESETS, ShadowConfig
    from garden_tpu_torch.entry import TEMPORAL_OVERRIDES, ULTRA_OVERRIDES, build
    from garden_tpu_torch.ops.blur import decimate2x
    from garden_tpu_torch.render import clouds, fxaa, lighting, raster, smaa, tonemap
    from garden_tpu_torch.render.deferred import DeferredRenderer
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from profile_torch_step import profile_step

    kernels = {"raster_shade": raster.rasterize_visibility_shaded,
               "depth_super": raster.depth_super, "depth_grid": raster.depth_grid,
               "depth_dense": raster.depth_dense}

    def zero_counts():
        for fn in kernels.values():
            fn.launches = 0

    # phase p: the ultra preset at full size, 3 steps
    t0 = time.perf_counter()
    ustep, ustate = build(n_bodies=N_BODIES, width=WIDTH, height=HEIGHT, grid_dim=64,
                          cfg_overrides=ULTRA_OVERRIDES, device="cuda")
    urend, uc = ustep.renderer, ustep.constants
    torch.cuda.synchronize()
    print(f"phase p: built the ultra step in {time.perf_counter() - t0:.1f} s "
          f"(shadow {urend.config.shadow})")
    zero_counts()
    ust = ustate
    frames = []
    for _ in range(3):
        frame_in = ust["frame"]
        phys = ustep.physics(ust["physics"])
        umats = ustep.instance_matrices(phys)
        uout = ustep.render(umats, frame_in)
        ust = {"physics": phys, "frame": uout["frame_state"]}
        frames.append((umats, frame_in, uout))
    torch.cuda.synchronize()
    ulaunch = {k: fn.launches for k, fn in kernels.items()}
    print(f"phase p: 3 ultra steps, launches {ulaunch}")
    check(ulaunch == {"raster_shade": 3, "depth_super": 0, "depth_grid": 0,
                      "depth_dense": 3},
          "phase p: the ultra step did not run K1 and K4 once per step (and K2, K3 never)")
    to_light = -uc["light_dir"]
    dome, ground = dome_rays(64, "cuda"), ground_grid(64, 10.0, "cuda")
    for i, (umats, frame_in, uout) in enumerate(frames[1:], start=2):
        geo, vis, g = urend.gbuffer_pass(ustep.scene, umats, uc, frame_in)
        _, conf = urend.reflections(g, vis["depth"], frame_in, uc)
        gi = urend.bounce(g, vis["depth"], frame_in, uc)
        rays_h = decimate2x(lighting.view_rays(g, uc))
        _, alpha = clouds.render_clouds(rays_h, to_light, time=uc["time"])
        _, alpha_dome = clouds.render_clouds(dome, to_light, time=uc["time"])
        sky = decimate2x((vis["tri_id"] < 0).float()) > 0.5
        above = sky & (rays_h[..., 1] > 0.02)
        cshadow = urend.cloud_shadow(g, uc, torch.ones_like(vis["depth"])[..., None])
        cs_ground = clouds.cloud_shadow(ground, to_light, time=uc["time"])
        visible = g["visible"]
        bad = all_finite(uout, "out")
        print(f"phase p: step {i}: SSR confidence > 0 on {(conf[visible] > 0).float().mean():.4f} "
              f"of visible pixels (max {conf.max():.4f}); GI max {gi.max():.4f}, > 0 on "
              f"{(gi.amax(-1)[visible] > 0).float().mean():.4f}; sky {sky.float().mean():.4f} "
              f"of half-res rays, above the clouds' horizon (up > 0.02) {above.float().mean():.4f}, "
              f"cloud alpha there max {alpha[above].max() if above.any() else 0.0:.4f}, over a "
              f"dome of sky rays max {alpha_dome.max():.4f} (> 0 on "
              f"{(alpha_dome > 0).float().mean():.4f}); cloud shadow min "
              f"{cshadow[visible].min():.4f}, < 1 on {(cshadow[visible] < 1).float().mean():.4f} "
              f"of visible pixels, over a 20 km ground grid min {cs_ground.min():.4f}, < 1 on "
              f"{(cs_ground < 1).float().mean():.4f}; non-finite outputs {bad}")
        check((conf[visible] > 0).any(), f"phase p: step {i}: SSR confidence is 0 everywhere")
        check(gi.max() > 0, f"phase p: step {i}: the GI is 0 everywhere")
        check(alpha_dome.max() > 0 and (not above.any() or alpha[above].max() > 0),
              f"phase p: step {i}: the clouds have no alpha over the sky")
        check(cs_ground.min() < 1, f"phase p: step {i}: the cloud shadow is 1 everywhere")
        check(not bad, f"phase p: step {i}: non-finite outputs {bad}")
    # K4 on the ultra atlas (3x2048, 5x5 PCF) against its plain version
    umats = frames[-1][0]
    uargs = raster.depth_args(**atlas_inputs(ustep, umats)[0])["dense"]
    check_dense(uargs, "phase p", "the ultra atlas", results)
    del uargs, frames

    # phase q: the flagship with TEMPORAL_OVERRIDES at full size, 3 steps, the
    # renderer given the previous step's instance matrices
    t0 = time.perf_counter()
    tstep, tstate = build(n_bodies=N_BODIES, width=WIDTH, height=HEIGHT, grid_dim=64,
                          cfg_overrides=TEMPORAL_OVERRIDES, device="cuda")
    trend, tc = tstep.renderer, tstep.constants
    torch.cuda.synchronize()
    print(f"phase q: built the temporal step in {time.perf_counter() - t0:.1f} s")
    zero_counts()
    tst, tout, tmats, tframe, tprev = run_temporal(tstep, tstate, 3)
    torch.cuda.synchronize()
    tlaunch = {k: fn.launches for k, fn in kernels.items()}
    print(f"phase q: 3 temporal steps, launches {tlaunch}")
    check(tlaunch == {"raster_shade": 3, "depth_super": 3, "depth_grid": 3,
                      "depth_dense": 0},
          "phase q: the temporal step did not run K1, K2 and K3 once per step")
    # K1 on the last step's inputs, the velocity planes (16, 17) live
    targs = raster.kernel_args(**trend.raster_inputs(
        tstep.scene, tmats, tc, frame_state=tframe, prev_inst_matrices=tprev))
    vis_q, gp_q, _, _, err_q = check_raster_shade(targs, "phase q")
    _, gp_qp = raster.raster_shade_plain(*targs)
    torch.cuda.synchronize()
    err_vel = max_diff(gp_q[16:18], gp_qp[16:18])
    vel = tout["velocity"]
    boxes = tout["gbuffer"]["visible"] & (tout["gbuffer"]["instance"] >= 1)
    speed = torch.linalg.vector_norm(vel, dim=-1)[boxes]
    culled = trend.occluded_instances(tstep.scene, tmats, tc, tframe["prev_depth"])
    print(f"phase q: K1 velocity planes vs plain max|d| {err_vel:.3g} (<= {TOL_GBUF}), "
          f"largest |velocity| {gp_q[16:18].abs().max():.4f} px; on visible box pixels "
          f"|velocity| > 1e-3 px on {(speed > 1e-3).float().mean():.4f}, max {speed.max():.4f} "
          f"px; Hi-Z culled {int(culled.sum())} of {culled.numel()} instances; "
          f"disoccluded {tout['disocclusion'].mean():.4f} of pixels")
    check(err_vel <= TOL_GBUF, "phase q: K1's velocity planes disagree with the plain version")
    # the Hi-Z cull is conservative: the last frame without it draws the
    # same triangles
    nohiz = DeferredRenderer(dataclasses.replace(trend.config, use_occlusion_culling=False),
                             trend.scene_host, "cuda")
    same_hiz = (nohiz.render(tstep.scene, tmats, tc, tframe, prev_inst_matrices=tprev)["tri_id"]
                == tout["tri_id"]).float().mean().item()
    print(f"phase q: the frame without Hi-Z has the same tri_id on {same_hiz:.5f} of pixels")
    check(same_hiz >= 0.999, "phase q: the Hi-Z cull removed visible triangles")
    del nohiz
    check(speed.max() > 1e-3, "phase q: the velocity is 0 on the moving boxes")
    results["raster_shade"]["max_abs_err"] = max(results["raster_shade"]["max_abs_err"], err_q)
    # SMAA against no AA on the same frame: the frame's image is the SMAA'd
    # LDR, which differs from the LDR on edge pixels only
    seen = {}
    post = trend.post

    def spy(hdr, *a):
        seen["hdr"] = hdr
        return post(hdr, *a)
    trend.post = spy
    qout = tstep.render(tmats, tframe, tprev)
    del trend.post
    ldr, _, _ = trend.tone(seen["hdr"], tc, tframe)
    aa = trend.antialias(ldr)
    changed = (tonemap.to_uint8(aa) != tonemap.to_uint8(ldr)).any(-1)
    edges = smaa.detect_edges(ldr).any(-1)
    near = torch.nn.functional.max_pool2d(edges[None, None].float(), 3, 1, 1)[0, 0] > 0
    print(f"phase q: SMAA changes {int(changed.sum())} pixels ({changed.float().mean():.4f}), "
          f"{int((changed & ~near).sum())} of them away from an edge; the frame's image is "
          f"SMAA's: {torch.equal(qout['image'], tonemap.to_uint8(aa))}")
    check(changed.any(), "phase q: SMAA changed no pixel")
    check(not (changed & ~near).any(), "phase q: SMAA changed a pixel away from the edges")
    check(torch.equal(qout["image"], tonemap.to_uint8(aa)),
          "phase q: the frame's image is not the SMAA'd LDR")
    check(not all_finite(tout, "out"), "phase q: non-finite outputs")
    del gp_q, gp_qp, vis_q, targs, qout, seen, aa

    # phase r: small steps on the card against the CPU, each preset
    cut = dict(cascade_sizes=(256, 128, 128))
    split = ShadowConfig(resolve_step=2, atlas_tile_h=16, atlas_foot_y=2,
                         max_active_tiles=24, **cut)
    small = {
        "ultra": (dict(ULTRA_OVERRIDES, shadow=ShadowConfig(map_size=2048, pcf_radius=2,
                                                            **cut)), 2),
        "temporal": (dict(TEMPORAL_OVERRIDES, shadow=split), 2),
        "potato": (dict(QUALITY_PRESETS["potato"]), 1),
        "low": (dict(QUALITY_PRESETS["low"]), 1),
        "medium": (dict(QUALITY_PRESETS["medium"],
                        shadow=ShadowConfig(map_size=1024, resolve_step=2, **cut)), 1),
        "high": (dict(QUALITY_PRESETS["high"], shadow=ShadowConfig(map_size=2048, **cut)), 1),
    }
    for name, (over, steps) in small.items():
        small_step_vs_cpu(build, over, f"r ({name})", steps=steps)

    # phase s: timings (medians of CUDA events)
    umats, uframe = ustep.instance_matrices(ust["physics"]), ust["frame"]
    geo, vis, g = urend.gbuffer_pass(ustep.scene, umats, uc, uframe)
    rays_h = decimate2x(lighting.view_rays(g, uc))
    ones = torch.ones_like(vis["depth"])[..., None]
    st = {
        "ultra combined step": cuda_ms(lambda: ustep(ust), reps=5),
        "ultra render": cuda_ms(lambda: ustep.render(umats, uframe), reps=5),
        "ultra ssr": cuda_ms(lambda: urend.reflections(g, vis["depth"], uframe, uc), reps=10),
        "ultra ssgi": cuda_ms(lambda: urend.bounce(g, vis["depth"], uframe, uc), reps=10),
        "ultra clouds (half-res march)": cuda_ms(
            lambda: clouds.render_clouds(rays_h, to_light, time=uc["time"]), reps=5),
        "ultra clouds (cloud shadow)": cuda_ms(lambda: urend.cloud_shadow(g, uc, ones),
                                               reps=5),
        "temporal combined step": cuda_ms(lambda: run_temporal(tstep, tst, 1, tmats), reps=5),
        "temporal render": cuda_ms(lambda: tstep.render(tmats, tframe, tprev), reps=5),
        "temporal hiz": cuda_ms(lambda: trend.occluded_instances(
            tstep.scene, tmats, tc, tframe["prev_depth"]), reps=10),
        "temporal aa (SMAA)": cuda_ms(lambda: trend.antialias(ldr), reps=10),
        "FXAA on the same image": cuda_ms(lambda: fxaa.apply_fxaa(ldr), reps=10),
    }
    del geo, vis, g, ldr
    for name in ("potato", "low"):
        pstep, pstate = build(n_bodies=N_BODIES, width=WIDTH, height=HEIGHT, grid_dim=64,
                              cfg_overrides=dict(QUALITY_PRESETS[name]), device="cuda")
        pst, _ = pstep(pstate)
        st[f"{name} combined step"] = cuda_ms(lambda: pstep(pst), reps=5)
        print(f"phase s: {name} renders {pstep.renderer.width}x{pstep.renderer.height}")
        del pstep, pstate, pst
    for name, ms in st.items():
        print(f"phase s: {name} median {ms:.4f} ms  [{card}]")
    wall, busy, stages, _ = profile_step(ustep, ust, 3)
    print(f"phase s: ultra step under the profiler: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms ({100 * busy / wall:.1f}% of wall)  [{card}]")
    for name, (host, dev) in stages.items():
        print(f"phase s:   stage {name}: host {host:.3f} ms, device {dev:.3f} ms per step")
    print(f"chip_smoke: phases 1-s took {time.perf_counter() - t_start:.1f} s")


def rel_diff(a, b) -> float:
    """Largest |a - b| / (|b| + 1e-6)."""
    return ((a - b).abs() / (b.abs() + 1e-6)).max().item()


def small_frame_vs_cpu(make, phase: str) -> None:
    """One step of make(device) -> (step, state), a small frame, on the card
    and on the CPU: tri_id on >= 99.9% of pixels, the image within 2 levels
    on >= 99.5%, bodies within 1e-4 (the bars of phases e and j)."""
    small = {}
    for dev in ("cuda", "cpu"):
        s_step, s_state = make(dev)
        s_next, s_img = s_step(s_state)
        s_out = s_step.render(s_step.instance_matrices(s_next["physics"]), s_state["frame"])
        small[dev] = (s_img.cpu(), s_out["tri_id"].cpu(),
                      s_next["physics"]["bodies"]["pos"].cpu())
    tri_small = (small["cuda"][1] == small["cpu"][1]).float().mean().item()
    img_d = (small["cuda"][0].int() - small["cpu"][0].int()).abs().amax(-1)
    img_ok = (img_d <= 2).float().mean().item()
    pos_d = max_diff(small["cuda"][2], small["cpu"][2])
    print(f"phase {phase}: 256x128 step cuda vs cpu: tri_id agreement {tri_small:.5f}, "
          f"image within 2 levels {img_ok:.5f}, max|d| pos {pos_d:.3g}")
    check(tri_small >= 0.999 and img_ok >= 0.995 and pos_d <= 1e-4,
          f"phase {phase}: the small step on the card disagrees with the CPU")


def feature_phases(card: str, results: dict, t_start: float) -> None:
    """Phases t-w: the forward renderer, the feature frame and the bench
    frame at full size, small frames card vs CPU, and their timings. Each
    kernel's launches on these paths join its `launches_by_path`."""
    import torch
    from garden_tpu_torch.entry import build_bench_frame, build_feature_frame, build_forward
    from garden_tpu_torch.ops import cubemap
    from garden_tpu_torch.core import math3d as m3
    from garden_tpu_torch.core.config import ShadowConfig
    from garden_tpu_torch.render import (atmosphere, csm, ibl, lighting, mesh, raster,
                                         sprites, tonemap)
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from profile_torch_step import profile_step

    kernels = {"raster_shade": raster.rasterize_visibility_shaded,
               "depth_super": raster.depth_super, "depth_grid": raster.depth_grid,
               "depth_dense": raster.depth_dense, "visibility": raster.rasterize_visibility}

    def zero_counts():
        for fn in kernels.values():
            fn.launches = 0

    def read_counts():
        return {k: fn.launches for k, fn in kernels.items()}

    def add_path(name: str, path: str, n: int):
        by = results[name].setdefault("launches_by_path", {})
        by[path] = n
        results[name]["launches"] = sum(by.values())

    t_phase = time.perf_counter()
    # phase t: the forward renderer over the flagship scene, one frame
    fwd, fscene, fmats, fconst = build_forward(N_BODIES, WIDTH, HEIGHT, grid_dim=64,
                                               device="cuda", use_hdr=True)
    zero_counts()
    fout = fwd.render(fscene, fmats, fconst)
    torch.cuda.synchronize()
    flaunch = read_counts()
    print(f"phase t: one forward frame, launches {flaunch}")
    check(flaunch == {"raster_shade": 0, "depth_super": 0, "depth_grid": 0,
                      "depth_dense": 0, "visibility": 1},
          "phase t: the forward frame did not launch K5 once (and nothing else)")
    cfg = fwd.config
    wpos, _ = mesh.transform_vertices(fscene, fmats)
    clip = m3.apply_mat4_h(fconst["view_proj"], wpos)
    setup = raster.setup_triangles(clip, fscene["indices"], fscene["tri_valid"], WIDTH,
                                   HEIGHT)
    bins = raster.bin_triangles(setup, WIDTH, HEIGHT, cfg.tile_size, cfg.max_tris_per_tile)
    vargs = raster.visibility_args(setup, *bins, WIDTH, HEIGHT, cfg.tile_size)
    kv, keep5, kept5, named5 = run_kept(raster.visibility_cuda, vargs, "visibility",
                                        "phase t: visibility (K5) on 128x128 tiles")
    pv = raster.visibility_plain(*vargs)
    pvk = raster.visibility_plain(*raster.band_args(vargs), keep=keep5)
    torch.cuda.synchronize()
    bits5 = {k: same_bits(kv[k], pv[k]) for k in ("tri_id", "depth", "b0", "b1")}
    masked5 = all(same_bits(pvk[k], pv[k]) for k in pv)
    # what the 512-slot cap drops: every tile's entries before the cap
    uncapped = raster.bin_triangles(setup, WIDTH, HEIGHT, cfg.tile_size, 8192)[1]
    dropped = int((uncapped - cfg.max_tris_per_tile).clamp(min=0).sum())
    full = int((uncapped > cfg.max_tris_per_tile).sum())
    cover = (fout["tri_id"] >= 0).float().mean().item()
    boxes = int(torch.unique(fscene["tri_instance"][fout["tri_id"][fout["tri_id"] >= 0]
                                                    .long()]).numel())
    print(f"phase t: K5 vs plain at {WIDTH}x{HEIGHT} on {cfg.tile_size}x{cfg.tile_size} "
          f"tiles, {vargs[1].shape[1]} list slots + {vargs[3].numel()} big: same bits "
          f"{bits5}; masked plain == plain {masked5}; the frame's tri_id is K5's: "
          f"{torch.equal(fout['tri_id'], kv['tri_id'])}")
    print(f"phase t: {full} of {uncapped.numel()} tiles over the {cfg.max_tris_per_tile}-slot "
          f"cap drop {dropped} of {int(uncapped.sum())} (tile, triangle) entries; big list "
          f"{int((bins[2] >= 0).sum())} of {bins[2].numel()}; covered {cover:.4f}, "
          f"{boxes} instances visible; hdr finite {bool(torch.isfinite(fout['hdr']).all())}")
    check(all(bits5.values()) and masked5, "phase t: K5 differs from its plain version")
    check(torch.equal(fout["tri_id"], kv["tri_id"]), "phase t: the frame's tri_id is not K5's")
    check(cover > 0.05 and boxes >= 50, "phase t: the forward frame misses the pile")
    check(bool(torch.isfinite(fout["hdr"]).all()), "phase t: non-finite HDR")
    add_path("visibility", "forward frame", flaunch["visibility"])
    fwd_args = vargs
    del pv, pvk, kv, uncapped

    # phase u: the feature frame at full size, 3 steps
    t0 = time.perf_counter()
    ustep, ustate = build_feature_frame(N_BODIES, WIDTH, HEIGHT, grid_dim=64, device="cuda")
    urend, uc = ustep.renderer, ustep.constants
    torch.cuda.synchronize()
    print(f"phase u: built the feature frame in {time.perf_counter() - t0:.1f} s (shadow "
          f"{urend.config.shadow}; {int(ustep.ui_sprites['count'])} HUD sprites; "
          f"environment {tuple(ustep.environment.shape)})")
    zero_counts()
    ust = ustate
    for _ in range(3):
        ust, uimage = ustep(ust)
    torch.cuda.synchronize()
    ulaunch = read_counts()
    print(f"phase u: 3 feature steps, launches {ulaunch}")
    check(ulaunch == {"raster_shade": 3, "depth_super": 3, "depth_grid": 3,
                      "depth_dense": 0, "visibility": 0},
          "phase u: the feature step did not run K1, K2 and K3 once per step")
    for k in ("raster_shade", "depth_super", "depth_grid"):
        add_path(k, "feature frame (3 steps)", ulaunch[k])
    umats = ustep.instance_matrices(ust["physics"])
    # K1 on the last step's inputs, the texture ids (plane 14) live
    uargs = raster.kernel_args(**urend.raster_inputs(ustep.scene, umats, uc))
    *_, err_u = check_raster_shade(uargs, "phase u")
    din, _ = atlas_inputs(ustep, umats)
    k3 = check_split(din, "phase u", "slot lists", results)
    slots = used_slots(din["tile_tris"], din["counts"])
    print(f"phase u: slot-binned atlas {k3.shape[1]}x{k3.shape[0]} (foot 2 x "
          f"{csm.atlas_tiling(urend.config.shadow)[2]}, {din['tile_tris'].shape[1]} slots): "
          f"active rows' slots used {int(slots.sum())} of {slots.numel()} "
          f"(p50/max per row {int(slots.sum(1).median())}/{int(slots.sum(1).max())}); "
          f"full rows {int((din['counts'] >= din['tile_tris'].shape[1]).sum())}")
    results["raster_shade"]["max_abs_err"] = max(results["raster_shade"]["max_abs_err"], err_u)
    del uargs, din, k3
    # the textures, the environment and the HUD on the last step's frame
    seen = {}
    post = urend.post

    def spy(hdr, *a):
        seen["hdr"] = hdr
        return post(hdr, *a)
    urend.post = spy
    uout = ustep.render(umats, ust["frame"])
    del urend.post
    g = uout["gbuffer"]
    inst = g["instance"].clamp(min=0).long()
    mat = ustep.scene["materials"][ustep.scene["inst_material"][inst].long()]
    textured = g["visible"] & (mat[..., 10] >= 0)
    tex_changed = (g["base_color"] != mat[..., 0:3]).any(-1) & textured
    rays = lighting.view_rays(g, uc)
    env = ustep.environment
    sky = ibl.sample_prefiltered(ibl.prefilter_latlong(env)[:1], rays,
                                 torch.zeros_like(rays[..., 0]))
    hdr_env = urend.shade(g, uc, uout["shadow"], uout["ao"], environment=env)
    bg = ~g["visible"]
    sky_equal = torch.equal(hdr_env[bg], sky[bg])
    ldr, _, _ = urend.tone(seen["hdr"], uc, ust["frame"])
    ldr = urend.antialias(ldr)
    hud_alone = tonemap.to_uint8(sprites.composite_sprites(ldr, ustep.ui_atlas,
                                                            ustep.ui_sprites))
    hud_equal = torch.equal(uout["image"], hud_alone)
    hud_px = (hud_alone != tonemap.to_uint8(ldr)).any(-1).float().mean().item()
    print(f"phase u: textured box pixels {int(textured.sum())}, base colour changed by "
          f"the texture on {tex_changed.float().sum() / max(int(textured.sum()), 1):.4f}; "
          f"sky pixels {bg.float().mean():.4f}, equal to the environment's sharpest mip "
          f"{sky_equal}; the HUD changes {hud_px:.4f} of pixels and the image equals "
          f"composite_sprites alone {hud_equal}")
    check(tex_changed.any(), "phase u: the textures change no pixel")
    check(bool(bg.any()) and sky_equal, "phase u: the sky is not the environment map")
    check(hud_equal and hud_px > 0, "phase u: the HUD differs from composite_sprites alone")
    bad = all_finite(uout, "out")
    check(not bad, f"phase u: non-finite outputs {bad}")
    # the LUTs in float32 are ill-conditioned below the horizon (the Chapman
    # lower branch cancels exp(x - x sin) at x ~ 800): there the CPU's float32
    # transmittance is itself ~7e-4 off float64, so the card is held to
    # float64 as closely as the CPU is (within twice the CPU's largest error,
    # and at least the CPU tests' rtol 2e-4, above an absolute floor of 1e-6
    # of the LUT's scale); equi_to_cube card vs CPU at rtol 1e-5
    for name, fn in (("transmittance_lut", atmosphere.transmittance_lut),
                     ("multi_scatter_lut", atmosphere.multi_scatter_lut)):
        on_card, on_cpu = fn(device="cuda").cpu(), fn(device="cpu")
        default = torch.get_default_dtype()
        torch.set_default_dtype(torch.float64)
        try:
            exact = fn(device="cpu")
        finally:
            torch.set_default_dtype(default)
        floor = 1e-6 * exact.abs().max().item()      # absolute floor: 1e-6 of the scale
        rel = lambda x: ((x.double() - exact).abs() - floor).clamp(min=0) / exact.abs().clamp(
            min=1e-30)
        bar = max(2e-4, 2 * rel(on_cpu).max().item())
        card_rel = rel(on_card).max().item()
        print(f"phase u: {name} {tuple(on_card.shape)}: max rel error against float64, "
              f"card {card_rel:.3g}, cpu {rel(on_cpu).max().item():.3g} (bar {bar:.3g}); card "
              f"vs cpu max rel {rel_diff(on_card, on_cpu):.3g}")
        check(card_rel <= bar, f"phase u: {name} on the card is less accurate than on the CPU")
    # equi_to_cube is bilinear in coordinates from atan2 and asin, which may
    # differ by an ulp between the card and the CPU: the value then moves by
    # that ulp times the map's gradient, which is steep only at the sun's
    # disk. So: rtol 1e-5 on >= 99.9% of texels, and nowhere more than the
    # largest difference between two adjacent texels of the map
    cube_card, cube_cpu = cubemap.equi_to_cube(env, 512).cpu(), cubemap.equi_to_cube(
        env.cpu(), 512)
    near = torch.isclose(cube_card, cube_cpu, rtol=1e-5, atol=1e-6).all(-1).float().mean()
    env_c = env.cpu()
    step_max = max((env_c[1:] - env_c[:-1]).abs().max().item(),
                   (env_c[:, 1:] - env_c[:, :-1]).abs().max().item())
    worst = max_diff(cube_card, cube_cpu)
    print(f"phase u: equi_to_cube(environment, 512) {tuple(cube_card.shape)} card vs cpu: "
          f"within rtol 1e-5 on {near:.6f} of texels, max|d| {worst:.4g} (the map's largest "
          f"adjacent-texel step {step_max:.4g}), max rel {rel_diff(cube_card, cube_cpu):.3g}")
    check(near >= 0.999 and worst <= step_max,
          "phase u: equi_to_cube on the card disagrees with the CPU")
    del seen, hdr_env, uout, cube_card, cube_cpu

    # phase v: the bench frame at full size, 3 steps
    t0 = time.perf_counter()
    bstep, bstate = build_bench_frame(N_BODIES, WIDTH, HEIGHT, device="cuda")
    torch.cuda.synchronize()
    n_tri = int(bstep.scene["tri_valid"].sum())
    print(f"phase v: built the bench frame in {time.perf_counter() - t0:.1f} s: {n_tri} "
          f"resident triangles, LOD switch at "
          f"{bstep.renderer.scene_host.inst_lod_dist[2, 0]:.3f} m")
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    bst = bstate
    for _ in range(3):
        bst, bimage = bstep(bst)
    torch.cuda.synchronize()
    blaunch = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase v: 3 bench-frame steps, launches {blaunch}; peak device memory "
          f"{peak:.2f} GiB")
    check(blaunch == {"raster_shade": 3, "depth_super": 3, "depth_grid": 3,
                      "depth_dense": 0, "visibility": 0},
          "phase v: the bench frame did not run K1, K2 and K3 once per step")
    for k in ("raster_shade", "depth_super", "depth_grid"):
        add_path(k, "bench frame (3 steps)", blaunch[k])
    bmats = bstep.instance_matrices(bst["physics"])
    bout = bstep.render(bmats, bst["frame"])
    tri = bout["tri_id"]
    lod = bstep.scene["tri_lod"][tri[tri >= 0].long()]
    levels = sorted(torch.unique(lod).tolist())
    bad = all_finite(bout, "out")
    kept_tris = int(bstep.renderer.cull_instances(bstep.scene, bmats, bstep.constants).sum())
    print(f"phase v: visible pixels by LOD level {[(l, int((lod == l).sum())) for l in levels]}; "
          f"the cull keeps {kept_tris} of {n_tri} triangles; covered "
          f"{(tri >= 0).float().mean():.4f}; non-finite outputs {bad}")
    check(levels == [0, 1], "phase v: the bench frame does not draw both LOD levels")
    check(not bad and bool(torch.isfinite(bst["physics"]["bodies"]["pos"]).all()),
          f"phase v: non-finite outputs {bad}")
    del bout
    # K1, K2 and K3 on the last step's inputs against their plain versions
    bargs = raster.kernel_args(**bstep.renderer.raster_inputs(bstep.scene, bmats,
                                                              bstep.constants))
    *_, err_v = check_raster_shade(bargs, "phase v")
    bdin, _ = atlas_inputs(bstep, bmats)
    check_split(bdin, "phase v", "corner lists", results)
    results["raster_shade"]["max_abs_err"] = max(results["raster_shade"]["max_abs_err"], err_v)
    del bargs, bdin

    # phase w: small frames card vs CPU, then timings
    cut = ShadowConfig(resolve_step=2, cascade_sizes=(256, 128, 128), atlas_tile_h=16,
                       atlas_foot_y=None, max_active_tiles=24)
    small_frame_vs_cpu(lambda dev: build_feature_frame(
        32, 256, 128, grid_dim=8, cfg_overrides=dict(shadow=cut), device=dev,
        env_height=16), "w (feature frame)")
    small_frame_vs_cpu(lambda dev: build_bench_frame(
        64, 256, 128, cfg_overrides=dict(shadow=dataclasses.replace(cut, atlas_foot_y=2)),
        device=dev), "w (bench frame)")
    geo, vis, g = urend.gbuffer_pass(ustep.scene, umats, uc, ust["frame"])
    ldr, _, _ = urend.tone(g["base_color"], uc, ust["frame"])
    bren = bstep.renderer
    bgeo, _, _ = bren.gbuffer_pass(bstep.scene, bmats, bstep.constants)
    blight, _ = bren.shadow_light(bstep.constants)
    tt = {
        "forward frame": cuda_ms(lambda: fwd.render(fscene, fmats, fconst), reps=10),
        "visibility (K5) on the forward frame: kernel, device": kernel_ms(
            lambda: raster.visibility_cuda(*fwd_args)),
        "visibility (K5) on the forward frame: plain": cuda_ms(
            lambda: raster.visibility_plain(*fwd_args), reps=3),
        "feature combined step": cuda_ms(lambda: ustep(ust), reps=5),
        "feature render": cuda_ms(lambda: ustep.render(umats, ust["frame"]), reps=5),
        "feature ui (composite_sprites)": cuda_ms(lambda: sprites.composite_sprites(
            ldr, ustep.ui_atlas, ustep.ui_sprites), reps=10),
        "feature environment (prefilter, sky, SH, specular, resolve)": cuda_ms(
            lambda: urend.shade(g, uc, None, None, environment=ustep.environment), reps=10),
        "feature render_cascades (slot-binned)": cuda_ms(lambda: urend.shadow_atlas(
            ustep.scene, geo["planes"], urend.shadow_light(uc)[0]), reps=10),
        "bench-frame combined step": cuda_ms(lambda: bstep(bst), reps=5),
        "bench-frame render": cuda_ms(lambda: bstep.render(bmats, bst["frame"]), reps=5),
        "bench-frame main raster inputs (setup, binning, records)": cuda_ms(
            lambda: bren.raster_inputs(bstep.scene, bmats, bstep.constants), reps=5),
        "bench-frame cascade inputs (setup, corner binning)": cuda_ms(
            lambda: bren.cascade_inputs(bstep.scene, bgeo["planes"], blight), reps=5),
    }
    for name, ms in tt.items():
        print(f"phase w: {name} median {ms:.4f} ms  [{card}]")
    wall, busy, stages, _ = profile_step(ustep, ust, 3)
    print(f"phase w: feature step under the profiler: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms ({100 * busy / wall:.1f}% of wall)  [{card}]")
    for name, (host, dev) in stages.items():
        print(f"phase w:   stage {name}: host {host:.3f} ms, device {dev:.3f} ms per step")
    print(f"chip_smoke: phases t-w took {time.perf_counter() - t_phase:.1f} s; phases 1-w "
          f"{time.perf_counter() - t_start:.1f} s")


SMALL_SHADOW = dict(resolve_step=2, cascade_sizes=(256, 128, 128), atlas_tile_h=16,
                    atlas_foot_y=2, max_active_tiles=24)
ENGINE_FRAMES, TOL_ENGINE_CPU = 5, 1e-4


def tree_leaves(tree, path: str = "") -> list:
    """(key path, tensor) of a nested dict of tensors, in sorted key order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in tree_leaves(tree[k], f"{path}/{k}")]
    return [(path, tree)]


def same_trees(a, b) -> list:
    """Key paths where two states differ in shape, dtype or any bit."""
    la, lb = tree_leaves(a), tree_leaves(b)
    if [k for k, _ in la] != [k for k, _ in lb]:
        return ["<structure>"]
    return [k for (k, x), (_, y) in zip(la, lb)
            if x.shape != y.shape or x.dtype != y.dtype
            or not torch_equal_bits(x, y)]


def torch_equal_bits(x, y) -> bool:
    import torch
    x, y = x.cpu(), y.cpu()
    if x.is_floating_point():
        return same_bits(x.float(), y.float())
    return torch.equal(x, y)


def engine_phases(card: str, results: dict, t_start: float) -> None:
    """Phase x: the runtime (the ECS world, the Engine's tick, the systems,
    checkpoints, replication, the profiler) in the engine frame."""
    import os
    import tempfile
    import torch
    from garden_tpu_torch.core.config import ShadowConfig
    from garden_tpu_torch.entry import ENGINE_DT, build_engine_frame
    from garden_tpu_torch.net import replication
    from garden_tpu_torch.physics import world as pw
    from garden_tpu_torch.render import raster
    from garden_tpu_torch.utils import checkpoint, profiler
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from profile_torch_step import profile_engine

    kernels = {"raster_shade": raster.rasterize_visibility_shaded,
               "depth_super": raster.depth_super, "depth_grid": raster.depth_grid,
               "depth_dense": raster.depth_dense, "visibility": raster.rasterize_visibility}
    t_phase = time.perf_counter()

    # x.1: a small world, 30 ticks and one frame on the card and on the CPU
    small = {}
    for dev in ("cuda", "cpu"):
        f, s = build_engine_frame(32, 256, 128, grid_dim=8, device=dev, n_characters=2,
                                  n_animated=4,
                                  cfg_overrides=dict(shadow=ShadowConfig(**SMALL_SHADOW)))
        s = f.engine.run_ticks(s, 30, ENGINE_DT)
        out = f.render(f.instance_matrices(s), s["frame"])
        small[dev] = (s, out["image"].cpu(), out["tri_id"].cpu())
    sc, sp = small["cuda"][0], small["cpu"][0]
    tcc, tcp = sc["components"]["transform"], sp["components"]["transform"]
    d_tr = max(max_diff(tcc[k].cpu(), tcp[k]) for k in ("position", "rotation", "scale"))
    same_ground = torch.equal(sc["components"]["character"]["grounded"].cpu(),
                              sp["components"]["character"]["grounded"])
    same_anim = not same_trees(
        {"anim": sc["components"]["animation"]["time"], "tick": sc["tick"], "time": sc["time"]},
        {"anim": sp["components"]["animation"]["time"], "tick": sp["tick"], "time": sp["time"]})
    tri_small = (small["cuda"][2] == small["cpu"][2]).float().mean().item()
    img_ok = ((small["cuda"][1].int() - small["cpu"][1].int()).abs().amax(-1) <= 2
              ).float().mean().item()
    print(f"phase x.1: 32 bodies, 2 characters, 4 animated, 30 ticks + a 256x128 frame, "
          f"cuda vs cpu: max|d| transforms {d_tr:.3g} (<= {TOL_ENGINE_CPU}), grounded equal "
          f"{same_ground}, animation times / tick / time equal in every bit {same_anim}, "
          f"tri_id agreement {tri_small:.5f}, image within 2 levels {img_ok:.5f}")
    check(d_tr <= TOL_ENGINE_CPU and same_ground and same_anim,
          "phase x.1: the small engine world on the card disagrees with the CPU")
    check(tri_small >= 0.999 and img_ok >= 0.995,
          "phase x.1: the small engine frame on the card disagrees with the CPU")
    del small, sc, sp, tcc, tcp

    # x.2: the engine frame at full width, ENGINE_FRAMES frames
    t0 = time.perf_counter()
    frame, state0 = build_engine_frame(N_BODIES, WIDTH, HEIGHT, device="cuda")
    torch.cuda.synchronize()
    w = frame.engine.world
    print(f"phase x.2: built the engine frame in {time.perf_counter() - t0:.1f} s: "
          f"{w.entity_count()} entities of {w.capacity}, "
          f"{int(w._stores['rigidbody']['has'].sum())} bodies, "
          f"{int(w._stores['character']['has'].sum())} characters, "
          f"{int(w._stores['animation']['has'].sum())} animated, "
          f"{frame.ui_sprites['count']} HUD sprites")
    check(frame.ui_sprites["count"] > 0, "phase x.2: the HUD emitted no sprite")
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    states = [state0]
    for _ in range(ENGINE_FRAMES):
        nxt, image = frame(states[-1])
        states.append(nxt)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launch = {k: fn.launches for k, fn in kernels.items()}
    print(f"phase x.2: {ENGINE_FRAMES} engine frames, launches {launch}; peak device "
          f"memory {peak:.2f} GiB")
    check(launch == {"raster_shade": ENGINE_FRAMES, "depth_super": ENGINE_FRAMES,
                     "depth_grid": ENGINE_FRAMES, "depth_dense": 0, "visibility": 0},
          "phase x.2: the engine frame did not run K1, K2 and K3 once per frame")
    for k in ("raster_shade", "depth_super", "depth_grid"):
        by = results[k].setdefault("launches_by_path", {})
        by[f"engine frame ({ENGINE_FRAMES} frames)"] = launch[k]
        results[k]["launches"] = sum(by.values())
    last = states[-1]
    bad = all_finite(last, "state")
    check(not bad, f"phase x.2: non-finite state leaves {bad}")
    check(tuple(image.shape) == (HEIGHT, WIDTH, 3), f"phase x.2: image {tuple(image.shape)}")
    pcfg = w.systems["PhysicsSystem"].config
    pos, quat = pw.interpolated_pose(last["physics"], pcfg)
    b = last["physics"]["bodies"]
    movable = b["has"] & (b["entity"] >= 0) & (b["motion"] != pw.STATIC)
    ent = b["entity"][movable].long()
    tc = last["components"]["transform"]
    synced = (torch.equal(tc["position"][ent], pos[movable])
              and torch.equal(tc["rotation"][ent], quat[movable]))
    grounded = last["components"]["character"]["grounded"]
    fell = (state0["physics"]["bodies"]["pos"][1:N_BODIES, 1]
            - b["pos"][1:N_BODIES, 1]).mean().item()
    print(f"phase x.2: {int(movable.sum())} movable transform rows equal their bodies' "
          f"interpolated pose in every bit: {synced}; characters grounded "
          f"{int(grounded.sum())} of {int(last['components']['character']['has'].sum())}; "
          f"mean drop of the pile {fell:.5f} m; tick {int(last['tick'])}")
    check(synced, "phase x.2: the transform sync differs from interpolated_pose")
    mats = frame.instance_matrices(last)
    args = raster.kernel_args(**frame.renderer.raster_inputs(frame.scene, mats,
                                                             frame.constants))
    *_, err_x = check_raster_shade(args, "phase x.2")
    results["raster_shade"]["max_abs_err"] = max(results["raster_shade"]["max_abs_err"], err_x)
    din, _ = atlas_inputs(frame, mats)
    check_split(din, "phase x.2", "cascade lists", results)
    del args, din
    tick_ms = cuda_ms(lambda: frame.tick(last, ENGINE_DT), reps=5)
    frame_ms = cuda_ms(lambda: frame(last), reps=5)
    bake_ms = cuda_ms(lambda: frame.instance_matrices(last), reps=5)
    render_ms = cuda_ms(lambda: frame.render(mats, last["frame"]), reps=5)
    for name, ms in (("engine tick", tick_ms), ("engine frame", frame_ms),
                     ("bake_world_matrices", bake_ms), ("engine frame render", render_ms)):
        print(f"phase x.2: {name} median {ms:.4f} ms  [{card}]")
    wall, busy, stages, _ = profile_engine(frame, last, 3)
    print(f"phase x.2: engine frame under the profiler: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms ({100 * busy / wall:.1f}% of wall)  [{card}]")
    for name, (host, dev) in stages.items():
        print(f"phase x.2:   stage {name}: host {host:.3f} ms, device {dev:.3f} ms per frame")

    # x.3: save at frame 2, load, run frame 3: every leaf as the run that
    # was never interrupted
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "frame2.npz")
        checkpoint.save(path, states[2])
        loaded = checkpoint.load(path, states[2])
    resumed, img_r = frame(loaded)
    again, img_a = frame(states[2])
    diff = same_trees(resumed, states[3]) + same_trees(again, states[3])
    on_card = all(x.is_cuda for _, x in tree_leaves(loaded))
    print(f"phase x.3: checkpoint at frame 2 ({len(tree_leaves(loaded))} leaves, on the "
          f"card {on_card}), frame 3 from it equals the uninterrupted run's in every bit: "
          f"{not diff} {diff[:5]}")
    check(not diff and on_card and torch.equal(img_r, img_a),
          "phase x.3: the resumed frame differs from the uninterrupted run")

    # x.4: replication of the full-width state
    uid = torch.arange(pcfg.max_bodies, dtype=torch.int64).numpy() + 1000
    payload = replication.gather_snapshots(last["physics"], uid)
    on_cpu = {k: v.cpu() for k, v in last["physics"]["bodies"].items()}
    payload_cpu = replication.gather_snapshots(dict(last["physics"], bodies=on_cpu), uid)
    client = replication.apply_snapshots(frame.engine.device_state()["physics"], payload,
                                         {int(u): i for i, u in enumerate(uid)})
    dyn = b["motion"] == pw.DYNAMIC
    poses = all(torch.equal(client["bodies"][k][dyn], b[k][dyn])
                for k in ("pos", "quat", "linvel", "angvel"))
    print(f"phase x.4: gather_snapshots {len(payload)} bytes ({int(dyn.sum())} bodies), "
          f"card == cpu bytes {payload == payload_cpu}; applied to a fresh engine state: "
          f"poses equal in every bit {poses}")
    check(payload == payload_cpu and poses, "phase x.4: replication is not bitwise")

    # x.5: one engine frame under utils.profiler.trace
    with tempfile.TemporaryDirectory() as tmp:
        with profiler.trace(tmp):
            frame(last)
        with open(os.path.join(tmp, profiler.TRACE_FILE), encoding="utf-8") as fh:
            names = {e.get("name", "") for e in json.load(fh).get("traceEvents", [])}
    want = ("PhysicsSystem.update", "CharacterSystem.update", "collide", "solve_velocity",
            "raster")
    missing = [n for n in want if n not in names]
    k1 = sorted(n for n in names if "raster_shade_kernel" in n)
    print(f"phase x.5: the trace names {len(names)} events; ranges missing {missing}; "
          f"K1 as {k1[:1]}")
    check(not missing and k1, "phase x.5: the trace lacks the physics ranges or K1")
    print(f"chip_smoke: phase x took {time.perf_counter() - t_phase:.1f} s; phases 1-x "
          f"{time.perf_counter() - t_start:.1f} s")


WORLD_BATCH, TOL_WORLDS = 8, 1e-5
SEAM_ROWS = 2      # rows each side of a band seam left out of the band bars


def lift_bodies(state, i):
    """A physics state with its dynamic bodies lifted 0.1 * i m (i a 0-d
    tensor; the same bits on any device and under vmap)."""
    import torch
    from garden_tpu_torch.physics import world as pw
    b = state["bodies"]
    dyn = (b["motion"] == pw.DYNAMIC).to(b["pos"].dtype)
    zero = torch.zeros_like(dyn)
    return dict(state, bodies=dict(b, pos=b["pos"] + torch.stack([zero, dyn, zero], -1)
                                   * (0.1 * i.float())))


def mean_body_height(state):
    """The mean height of a world's bodies after the ground (body 0)."""
    return state["bodies"]["pos"][1:, 1].mean()


def world_batch_phase(card: str) -> dict:
    """Phase y: WorldBatch over copies of bench.py's world on the card. ->
    what phase mc.1 shards: the step, the state, the count, the one-device
    batch after one step and the reduce of its mean body height."""
    import warnings
    import torch
    from garden_tpu_torch.parallel.worlds import WorldBatch
    from garden_tpu_torch.physics import scenes, world as pw
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from profile_torch_step import profile_physics

    t0 = time.perf_counter()
    bst, bcfg, btypes = scenes.bench_world("cuda")
    step = lambda s: pw.step(s, bcfg, 1.0 / 60.0, btypes)
    # one world's memory: its state plus what its step holds at its peak
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(bst)
    torch.cuda.synchronize()
    state_bytes = sum(x.numel() * x.element_size() for _, x in tree_leaves(bst))
    per_world = state_bytes + torch.cuda.max_memory_allocated() - base
    total = torch.cuda.get_device_properties(0).total_memory
    n = max(1, min(WORLD_BATCH, int(total // 2 // per_world)))
    print(f"phase y: one bench world: state {state_bytes / 2 ** 30:.3f} GiB, state + step "
          f"peak {per_world / 2 ** 30:.3f} GiB; {WORLD_BATCH} worlds reckoned "
          f"{WORLD_BATCH * per_world / 2 ** 30:.2f} GiB of the card's {total / 2 ** 30:.1f} "
          f"GiB (half {total / 2 ** 31:.1f}): batching {n} worlds")
    wb = WorldBatch(step, n, devices=["cuda:0"])
    singles = [lift_bodies(bst, torch.tensor(i, dtype=torch.int32, device="cuda"))
               for i in range(n)]
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        batched = wb.replicate(bst, vary_fn=lift_bodies)
        torch.cuda.reset_peak_memory_stats()
        (stepped,) = wb.step(batched)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ones = [step(s) for s in singles]
        bits = all(not same_trees({k: v[i] for k, v in tree_leaves(stepped)},
                                  dict(tree_leaves(one))) for i, one in enumerate(ones))
        d_pos = max(max_diff(stepped["bodies"]["pos"][i], one["bodies"]["pos"])
                    for i, one in enumerate(ones))
        spread = (stepped["bodies"]["pos"][:, 1:, 1].mean(1)).tolist()
        print(f"phase y: {n} worlds, one batched step against each world's own step: every "
              f"leaf in every bit {bits}; max|d| pos {d_pos:.3g} (bar {TOL_WORLDS}); mean "
              f"body height per world {[round(v, 4) for v in spread]}; peak device memory "
              f"{peak:.2f} GiB")
        check(bits or d_pos <= TOL_WORLDS, "phase y: a batched world differs from its own step")
        check(all(b > a for a, b in zip(spread, spread[1:])), "phase y: the worlds did not differ")
        batched_ms = cuda_ms(lambda: wb.step([stepped]), reps=5, warmup=1)
        single_ms = cuda_ms(lambda: [step(s) for s in singles], reps=3, warmup=1)
        wall_b, busy_b, _ = profile_physics(wb.step, [stepped], 3)
    wall_s, busy_s, _ = profile_physics(step, ones[0], 3)
    print(f"phase y: batched step of {n} worlds median {batched_ms:.4f} ms = "
          f"{batched_ms / n:.4f} ms per world-step; {n} single steps median "
          f"{single_ms:.4f} ms = {single_ms / n:.4f} ms per world-step  [{card}]")
    print(f"phase y: under the profiler: batched wall {wall_b:.3f} ms, device busy "
          f"{busy_b:.3f} ms ({100 * busy_b / wall_b:.1f}%); single wall {wall_s:.3f} ms, "
          f"device busy {busy_s:.3f} ms ({100 * busy_s / wall_s:.1f}%)  [{card}]")
    print(f"chip_smoke: phase y took {time.perf_counter() - t0:.1f} s")
    return dict(step=step, state=bst, n=n, stepped=stepped,
                mean=float(wb.reduce([stepped], mean_body_height)))


DEMO_SCENE = {"entities": [
    {"uid": 1, "transform": {"position": [0, 0, 0]},
     "rigidbody": {"shapeType": "plane", "normal": [0, 1, 0], "distance": 0.0,
                   "motionType": "static"}},
    {"uid": 2, "transform": {"position": [0, 0.5, 0]},
     "rigidbody": {"shapeType": "box", "halfExtent": [0.5, 0.5, 0.5]}},
    {"uid": 3, "transform": {"position": [0.1, 1.5, 0.0]},
     "rigidbody": {"shapeType": "sphere", "radius": 0.5}},
    {"uid": 4, "transform": {"position": [-1.5, 0.8, 0.5], "rotation": [0, 0, 0.38268, 0.92388]},
     "rigidbody": {"shapeType": "capsule", "radius": 0.3, "halfHeight": 0.5,
                   "motionType": "kinematic"}},
    {"uid": 5, "transform": {"position": [1.6, 0.6, -0.4]},
     "rigidbody": {"shapeType": "compound", "children": [
         {"shapeType": "sphere", "radius": 0.3, "position": [-0.3, 0, 0]},
         {"shapeType": "box", "halfExtent": [0.2, 0.2, 0.2], "position": [0.3, 0, 0]}]}},
]}


def band_bars(img, ref, n_bands: int):
    """(p99, mean) of |img - ref| over the rows SEAM_ROWS or more from a seam."""
    import numpy as np
    h = ref.shape[0]
    band_h = h // n_bands
    seam = {r for b in range(1, n_bands)
            for r in range(b * band_h - SEAM_ROWS, b * band_h + SEAM_ROWS)}
    rows = [r for r in range(h) if r not in seam]
    diff = np.abs(img[rows].astype(int) - ref[rows].astype(int))
    return float(np.percentile(diff, 99)), float(diff.mean())


def count_launches(fn, devices):
    """fn() with K1-K4's launch counts set to 0 just before it and read just
    after every device in `devices` is idle -> (fn's result, {kernel:
    launches})."""
    from garden_tpu_torch.render import raster
    kernels = {"raster_shade": raster.rasterize_visibility_shaded,
               "depth_super": raster.depth_super, "depth_grid": raster.depth_grid,
               "depth_dense": raster.depth_dense}
    for k in kernels.values():
        k.launches = 0
    out = fn()
    sync_all(devices)
    return out, {k: f.launches for k, f in kernels.items()}


def join_launches(results: dict, path: str, launch: dict) -> None:
    """Each launched kernel's count on `path` joins its launches_by_path."""
    for k, v in launch.items():
        if v:
            by = results[k].setdefault("launches_by_path", {})
            by[path] = v
            results[k]["launches"] = sum(by.values())


def parallel_cli_phases(card: str, results: dict, t_start: float) -> None:
    """Phases z.1-z.3: split-frame bands, the scene preview of the command
    line and the full demo, with the kernels they launch."""
    import importlib.util
    import os
    import tempfile
    import numpy as np
    import torch
    from garden_tpu_torch import cli
    from garden_tpu_torch.core.config import ShadowConfig
    from garden_tpu_torch.entry import build
    from garden_tpu_torch.parallel.frame_tiles import FrameTiles, band_constants

    t_phase = time.perf_counter()
    counted = lambda fn: count_launches(fn, ["cuda"])
    join = lambda path, launch: join_launches(results, path, launch)

    # z.1 small: 4 bands on the card against the same bands on the CPU
    small = {}
    for dev in ("cuda", "cpu"):
        st, s0 = build(300, 256, 128, device=dev,
                       cfg_overrides=dict(shadow=ShadowConfig(**SMALL_SHADOW)))
        ft = FrameTiles(st.renderer.config, st.renderer.scene_host, 4, overlap=16,
                        devices=[dev] * 4)
        img, _ = ft.render(st.scene, st.instance_matrices(s0["physics"]), st.constants,
                           ft.initial_state())
        small[dev] = img.cpu()
    img_ok = ((small["cuda"].int() - small["cpu"].int()).abs().amax(-1) <= 2
              ).float().mean().item()
    print(f"phase z.1: 4 bands of a 300-body 256x128 frame, cuda vs cpu: image within 2 "
          f"levels {img_ok:.5f} (bar 0.995)")
    check(img_ok >= 0.995, "phase z.1: the banded frame on the card disagrees with the CPU")

    # z.1 full size: the flagship frame as 4 bands against the single renderer
    step, state = build(N_BODIES, WIDTH, HEIGHT, grid_dim=64, device="cuda")
    mats = step.instance_matrices(state["physics"])
    ref = step.render(mats, state["frame"])["image"]
    ft = FrameTiles(step.renderer.config, step.renderer.scene_host, 4, overlap=16,
                    devices=["cuda"] * 4)
    fstate = ft.initial_state()
    (img, nstate), launch = counted(lambda: ft.render(step.scene, mats, step.constants,
                                                      fstate))
    p99, mean = band_bars(img.cpu().numpy(), ref.cpu().numpy(), 4)
    lum = [float(s["avg_luminance"]) for s in nstate]
    print(f"phase z.1: flagship 1920x1080 as 4 bands of {ft.band_h} rows + {ft.overlap} "
          f"guard rows each side, against the single renderer off the seams (+-{SEAM_ROWS} "
          f"rows): p99 |d| {p99:.1f} levels (the reference test's bar 2), mean "
          f"{mean:.4f} (bar 0.5); launches {launch}; next exposure per band {lum}")
    check(tuple(img.shape) == tuple(ref.shape) and len(set(lum)) == 1
          and all(math.isfinite(v) for v in lum), "phase z.1: the banded frame is malformed")
    check(launch["raster_shade"] == 4 and launch["depth_super"] == 4
          and launch["depth_grid"] == 4, "phase z.1: K1, K2, K3 did not run once a band")
    join("frame bands (4 bands, 1 frame)", launch)
    if torch.cuda.device_count() >= 2:
        # the same bands over distinct cards, stitched on cuda:0
        cards = [torch.device("cuda", b % torch.cuda.device_count()) for b in range(4)]
        ftd = FrameTiles(step.renderer.config, step.renderer.scene_host, 4, overlap=16,
                         devices=cards)
        img_d, _ = ftd.render(step.scene, mats, step.constants, ftd.initial_state())
        same = torch.equal(img_d.cpu(), img.cpu())
        print(f"phase z.1: the 4 bands on {[str(c) for c in cards]}: image equal in every "
              f"bit to the bands on one card: {same}")
        check(same, "phase z.1: the bands on distinct cards differ from one card's")
        del ftd, img_d
    # each band's K1 on its cropped camera (334 rows at 1080p, not a multiple
    # of K1's 32-row tile) and K2/K3 on the cascades fitted to that band
    for b in range(ft.n_bands):
        consts = band_constants(step.constants, b, ft.n_bands, 2.0 * ft.overlap / ft.full_h)
        check_frame(ft.renderers[b], step.scene, mats, consts, f"phase z.1: band {b}",
                    results, "split")
    band_ms = cuda_ms(lambda: ft.render(step.scene, mats, step.constants, fstate), reps=3)
    single_ms = cuda_ms(lambda: step.render(mats, state["frame"]), reps=3)
    print(f"phase z.1: banded frame (4 bands on one card) median {band_ms:.4f} ms; the "
          f"single renderer's frame {single_ms:.4f} ms  [{card}]")
    del step, state, mats, ref, ft, fstate, img, nstate

    with tempfile.TemporaryDirectory() as tmp:
        # z.2: the scene preview of the command line, card and CPU
        scene_path = os.path.join(tmp, "demo.scene")
        with open(scene_path, "w", encoding="utf-8") as fh:
            json.dump(DEMO_SCENE, fh)
        out_png = {d: os.path.join(tmp, f"preview_{d}.png") for d in ("cuda", "cpu")}
        t0 = time.perf_counter()
        rc, launch = counted(lambda: cli.main(["scene", scene_path, "--preview",
                                               out_png["cuda"]]))
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rc_cpu = cli.main(["scene", scene_path, "--preview", out_png["cpu"], "--cpu"])
        cpu_s = time.perf_counter() - t0
        pngs = {d: read_png(p) for d, p in out_png.items()}
        ok = (np.abs(pngs["cuda"].astype(int) - pngs["cpu"].astype(int)).max(-1) <= 2).mean()
        print(f"phase z.2: scene preview {pngs['cuda'].shape[1]}x{pngs['cuda'].shape[0]} on "
              f"the card ({card_s:.1f} s) against --cpu ({cpu_s:.1f} s): within 2 levels "
              f"{ok:.5f} (bar 0.995); launches {launch}")
        check(rc == 0 and rc_cpu == 0 and pngs["cuda"].shape == (384, 640, 3),
              "phase z.2: the preview failed")
        check(ok >= 0.995, "phase z.2: the preview on the card disagrees with the CPU")
        check(launch["raster_shade"] == 1, "phase z.2: the preview did not launch K1 once")
        join("scene preview (1 frame)", launch)
        with open(scene_path, encoding="utf-8") as fh:
            check_frame(*cli.preview_frame(json.load(fh), 640, 384, "cuda"), "phase z.2",
                        results, "dense")

        # z.3: the full demo, 3 frames
        spec = importlib.util.spec_from_file_location(
            "full_demo_torch", Path(__file__).resolve().parent / "examples" / "full_demo_torch.py")
        demo = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(demo)
        out_dir = os.path.join(tmp, "demo")
        summary, launch = counted(lambda: demo.main([out_dir, "--frames", "3"]))
        files = sorted(os.listdir(out_dir))
        dumps = [os.path.basename(p) for p in summary["written"]]
        print(f"phase z.3: full demo, 3 frames in {summary['seconds']:.2f} s; HDR finite "
              f"{summary['finite']}; wrote {len(files)} files, dumps {dumps}; launches "
              f"{launch}  [{card}]")
        check(all(summary["finite"]) and len(summary["finite"]) == 3,
              "phase z.3: a demo frame is not finite")
        check(all(os.path.getsize(os.path.join(out_dir, f)) > 0 for f in dumps)
              and "debug_normal.png" in dumps and "physics_top.png" in dumps
              and "frame_002.png" in files, "phase z.3: the demo's dumps are missing")
        check(launch["raster_shade"] == 3, "phase z.3: K1 did not run once a frame")
        join("full demo (3 frames)", launch)
        check_frame(*summary["last"], "phase z.3 (last frame)", results, "dense")
    print(f"chip_smoke: phase z took {time.perf_counter() - t_phase:.1f} s; phases 1-z "
          f"{time.perf_counter() - t_start:.1f} s")


MC_STEPS = 3            # steps of each flagship instance in phase mc.2
TOL_MC_MEAN = 1e-6      # mc.1's sharded reduce against the one-device reduce (relative)
TOL_MC_PROCS = 1e-5     # mc.4's two-process mean on the card against the CPU's


def multichip_devices() -> list:
    """Phase mc's devices: every visible card when there are at least 2,
    else cuda:0 twice (two shards on one card)."""
    import torch
    count = torch.cuda.device_count()
    if count >= 2:
        return [torch.device("cuda", i) for i in range(count)]
    return [torch.device("cuda", 0)] * 2


def sync_all(devices) -> None:
    import torch
    for d in sorted(set(devices), key=str):
        torch.cuda.synchronize(d)


def wall_ms(fn, devices, reps: int, warmup: int = 1) -> float:
    """Median host milliseconds of fn() from all `devices` idle to all idle
    again (CUDA events time one card only)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        sync_all(devices)
        t0 = time.perf_counter()
        fn()
        sync_all(devices)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def state_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for _, x in tree_leaves(tree))


def unbatch(tree):
    """A shard of one world without its world axis."""
    return {k: unbatch(v) for k, v in tree.items()} if isinstance(tree, dict) else tree[0]


def multichip_phases(card: str, results: dict, batch: dict, t_start: float) -> None:
    """Phases mc.1-mc.4: the world batch sharded over cards, flagship
    instances one per card, the multichip dryrun and two processes."""
    import importlib.util
    import socket
    import warnings
    import torch
    from garden_tpu_torch.entry import (DRYRUN_OVERRIDES, DRYRUN_SIZE, build,
                                        dryrun_multichip)
    from garden_tpu_torch.parallel.worlds import WorldBatch

    t_phase = time.perf_counter()
    count = torch.cuda.device_count()
    devices = multichip_devices()
    print(f"phase mc: {count} card(s) visible; devices {[str(d) for d in devices]}"
          + ("" if count >= 2 else " (one card: each shard or instance on cuda:0)")
          + f"  [{card}]")
    counted = lambda fn: count_launches(fn, devices)
    join = lambda path, launch: join_launches(results, path, launch)

    # mc.1: phase y's bench worlds sharded over the devices
    n, step = batch["n"], batch["step"]
    wb = WorldBatch(step, n, devices=devices)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        for d in set(wb.devices):
            torch.cuda.reset_peak_memory_stats(d)
        shards = wb.step(wb.replicate(batch["state"], vary_fn=lift_bodies))
        sync_all(wb.devices)
        peak = {str(d): torch.cuda.max_memory_allocated(d) / 2 ** 30
                for d in sorted(set(wb.devices), key=str)}
        ref = dict(tree_leaves(batch["stepped"]))
        differ = []
        for k, shard in enumerate(shards):
            part = {key: v[k * wb.per:(k + 1) * wb.per] for key, v in ref.items()}
            differ += [f"shard {k}{key}" for key in same_trees(dict(tree_leaves(shard)), part)]
        mean = float(wb.reduce(shards, mean_body_height))
        rel = abs(mean - batch["mean"]) / abs(batch["mean"])
        one = WorldBatch(step, n, devices=[devices[0]])
        one_state = [batch["stepped"]]
        sharded_ms = wall_ms(lambda: wb.step(shards), wb.devices, reps=5)
        one_ms = wall_ms(lambda: one.step(one_state), [devices[0]], reps=5)
    print(f"phase mc.1: {n} bench worlds as {len(wb.devices)} shards of {wb.per} on "
          f"{[str(d) for d in wb.devices]}: against phase y's one-device batch, leaves "
          f"differing {differ or 'none'}; mean body height {mean!r} against {batch['mean']!r} "
          f"(relative {rel:.3g}, bar {TOL_MC_MEAN}); peak memory per card (GiB) {peak}")
    check(not differ, "phase mc.1: a sharded world differs from the one-device batch")
    check(rel <= TOL_MC_MEAN, "phase mc.1: the sharded reduce differs")
    print(f"phase mc.1: sharded step median {sharded_ms:.4f} ms = {sharded_ms / n:.4f} ms "
          f"per world-step; one-device batch {one_ms:.4f} ms = {one_ms / n:.4f} ms per "
          f"world-step (host clock, every card idle before and after)  [{card}, {count} "
          f"card(s)]")
    del wb, shards, one, one_state

    # mc.2: flagship instances, one per entry of the device list
    fstep, fstate = build(N_BODIES, WIDTH, HEIGHT, grid_dim=64, device=devices[0])
    sync_all(devices)
    base = torch.cuda.memory_allocated(devices[0])
    torch.cuda.reset_peak_memory_stats(devices[0])
    fstep(fstate)
    sync_all(devices)
    per_inst = state_bytes(fstate) + torch.cuda.max_memory_allocated(devices[0]) - base
    half = torch.cuda.get_device_properties(devices[0]).total_memory // 2
    inst_devices = list(devices)
    while len(inst_devices) > 1 and max(inst_devices.count(d) for d in inst_devices) \
            * per_inst > half:
        inst_devices.pop()
    m = len(inst_devices)
    print(f"phase mc.2: one flagship instance reckoned {per_inst / 2 ** 30:.3f} GiB (state + "
          f"step peak); {m} instances on {[str(d) for d in inst_devices]} (at most half a "
          f"card's {2 * half / 2 ** 30:.1f} GiB on each)")

    def lift_pile(s, i):
        return dict(s, physics=lift_bodies(s["physics"], i))

    insts = [fstep.to(d) for d in inst_devices]
    wbf = WorldBatch(insts, m, devices=inst_devices)
    states = wbf.replicate(fstate, vary_fn=lift_pile)

    def run_steps():
        out = None
        cur = states
        for _ in range(MC_STEPS):
            out = wbf.step(cur)
            cur = [st for st, _ in out]
        return out

    out, launch = counted(run_steps)
    print(f"phase mc.2: {m} instances x {MC_STEPS} steps: launches {launch}")
    check(all(launch[k] == m * MC_STEPS for k in ("raster_shade", "depth_super",
                                                  "depth_grid")),
          "phase mc.2: K1, K2, K3 did not run once per instance per step")
    join(f"flagship instances ({m} x {MC_STEPS} steps)", launch)
    for i, (st, img) in enumerate(out):
        alone = lift_pile(fstate, torch.tensor(i, dtype=torch.int32, device=devices[0]))
        for _ in range(MC_STEPS):
            alone, alone_img = fstep(alone)
        differ = same_trees(unbatch(st), alone)
        same_img = torch.equal(img[0].cpu(), alone_img.cpu())
        finite = not all_finite(st["physics"])
        print(f"phase mc.2: instance {i} on {inst_devices[i]} against it alone on "
              f"{devices[0]}: state leaves differing {differ or 'none'}; image same bits "
              f"{same_img}; physics finite {finite}")
        check(not differ and same_img and finite,
              f"phase mc.2: instance {i} differs from the instance alone")
        phys = unbatch(st["physics"])
        check_frame(insts[i].renderer, insts[i].scene, insts[i].instance_matrices(phys),
                    insts[i].constants, f"phase mc.2: instance {i} on {inst_devices[i]}",
                    results, "split")
    cur = [st for st, _ in out]
    all_ms = wall_ms(lambda: wbf.step(cur), inst_devices, reps=3)
    one_ms = wall_ms(lambda: fstep(fstate), [devices[0]], reps=3)
    print(f"phase mc.2: one step of {m} instances median {all_ms:.4f} ms; one instance "
          f"alone {one_ms:.4f} ms, x {m} = {m * one_ms:.4f} ms (host clock)  [{card}, "
          f"{count} card(s)]")
    del fstep, fstate, insts, wbf, states, out, cur

    # mc.3: the multichip entry point; each instance against the tiny step
    # run once alone, and K1, K4 on each instance's inputs on its own card
    (mstates, images), launch = counted(lambda: dryrun_multichip(len(devices),
                                                                  devices=devices))
    bad = [p for s in mstates for p in all_finite(s)]
    print(f"phase mc.3: dryrun_multichip({len(devices)}): images {tuple(images.shape)} on "
          f"{images.device}; non-finite state leaves {bad or 'none'}; launches {launch}")
    check(tuple(images.shape) == (len(devices), 32, 64, 3) and images.dtype == torch.uint8
          and not bad, "phase mc.3: the dryrun's output is malformed")
    check(launch["raster_shade"] == len(devices) and launch["depth_dense"] == len(devices),
          "phase mc.3: K1 and K4 did not run once per instance")
    join(f"dryrun_multichip ({len(devices)} instances, 1 step)", launch)
    tstep, tstate = build(**DRYRUN_SIZE, cfg_overrides=DRYRUN_OVERRIDES, device=devices[0])
    alone, alone_img = tstep(tstate)
    for i, d in enumerate(devices):
        differ = same_trees(unbatch(mstates[i]), alone)
        same_img = torch.equal(images[i].cpu(), alone_img.cpu())
        print(f"phase mc.3: instance {i} on {d} against the tiny step alone on "
              f"{devices[0]}: state leaves differing {differ or 'none'}; image same bits "
              f"{same_img}")
        check(not differ and same_img, f"phase mc.3: instance {i} differs from the step alone")
        on_d = tstep.to(d)
        check_frame(on_d.renderer, on_d.scene,
                    on_d.instance_matrices(unbatch(mstates[i]["physics"])), on_d.constants,
                    f"phase mc.3: instance {i} on {d}", results, "dense")
    del mstates, images, tstep, tstate, alone, alone_img

    # mc.4: two processes over gloo, each rank on its own card where there are two
    root = Path(__file__).resolve().parent
    worker = root / "tests" / "torch_multihost_worker.py"
    spec = importlib.util.spec_from_file_location("torch_multihost_worker", worker)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _, _, on_cpu = mod.mean_height("cpu")
    ranks = ["cuda:0", "cuda:1"] if count >= 2 else ["cuda:0"] * 2
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(worker), str(r), f"tcp://localhost:{port}",
                               ranks[r]], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, cwd=root) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    vals = []
    for r, (p, text) in enumerate(zip(procs, outs)):
        found = [line for line in text.splitlines() if line.startswith(f"proc {r}: OK")]
        print(f"phase mc.4: rank {r} on {ranks[r]}: rc {p.returncode}; "
              f"{found[0] if found else text[-2000:]}")
        check(p.returncode == 0 and found, f"phase mc.4: rank {r} failed")
        vals.append(float(found[0].split("mean_y=")[1].split()[0]))
    print(f"phase mc.4: two processes over gloo in {time.perf_counter() - t0:.1f} s: mean_y "
          f"{vals} against the CPU's {on_cpu!r} (bar {TOL_MC_PROCS})")
    check(all(abs(v - on_cpu) <= TOL_MC_PROCS for v in vals),
          "phase mc.4: the two-process mean differs from the CPU's")
    print(f"chip_smoke: phase mc took {time.perf_counter() - t_phase:.1f} s; phases 1-mc "
          f"{time.perf_counter() - t_start:.1f} s")


def read_png(path: str):
    """Decode an 8-bit RGB or RGBA, non-interlaced PNG (any row filter) to
    (H, W, 3) uint8: the card's machine has no PIL."""
    import struct
    import zlib
    import numpy as np
    data = open(path, "rb").read()
    pos, idat = 8, b""
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    check(depth == 8 and color in (2, 6), f"read_png: unsupported PNG {path}")
    c = 3 if color == 2 else 4
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * c)
    out = np.zeros((h, w * c), np.int32)
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        f, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if f in (0, 2):                      # none, up: no dependence along the row
            out[y] = prev = (line + (prev if f == 2 else 0)) & 255
            continue
        cur = np.zeros(w * c, np.int32)
        for x in range(w * c):
            a = cur[x - c] if x >= c else 0
            b = prev[x]
            cc = prev[x - c] if x >= c else 0
            if f == 0:
                pred = 0
            elif f == 1:
                pred = a
            elif f == 2:
                pred = b
            elif f == 3:
                pred = (a + b) // 2
            else:
                pa, pb, pc = abs(b - cc), abs(a - cc), abs(a + b - 2 * cc)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
            cur[x] = (line[x] + pred) & 255
        out[y] = prev = cur
    return out.reshape(h, w, c)[..., :3].astype(np.uint8)


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}")

    from garden_tpu_torch import cuda_build
    from garden_tpu_torch.core.config import ShadowConfig
    from garden_tpu_torch.entry import (DENSE_SHADOW_OVERRIDES, GLASS_BOXES,
                                        GLASS_OVERRIDES, SLICE_OVERRIDES, build)
    from garden_tpu_torch.render import oit, raster

    # phase 2: build the kernels, every source at once
    t0 = time.perf_counter()
    cuda_build.build_all(SOURCES, verbose=True)
    for name in SOURCES:
        cuda_build.load(name)
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
    vis_k, gp_k, keep1, named1, err_gbuf = check_raster_shade(args, "phase 4")

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

    # phase 6: timings of the slice (medians; K1 also by its device time)
    k_ms = cuda_ms(lambda: raster.raster_shade_cuda(*args), reps=20, warmup=3)
    k_dev = kernel_ms(lambda: raster.raster_shade_cuda(*args))
    p_ms = cuda_ms(lambda: raster.raster_shade_plain(*args), reps=3)
    phys_ms = cuda_ms(lambda: step.physics(st["physics"]), reps=10)
    mats = step.instance_matrices(st["physics"])
    render_ms = cuda_ms(lambda: step.render(mats, st["frame"]), reps=10)
    step_ms = cuda_ms(lambda: step(st), reps=10)
    for name, ms in (("raster_shade kernel, device", k_dev),
                     ("raster_shade kernel, one call", k_ms), ("raster_shade plain", p_ms),
                     ("physics step", phys_ms), ("slice render", render_ms),
                     ("slice combined step", step_ms)):
        print(f"phase 6: {name} median {ms:.4f} ms  [{card}]")
    k1_bound, k1_full = raster_shade_bounds(args, vis_k, gp_k, keep1, named1)
    print(f"phase 6: raster_shade bound {k1_bound} (full: every scanned pair "
          f"{k1_full})")
    del step, state, st, out, args, kin, vis_k, gp_k, keep1
    results = {"raster_shade": dict(launches=launches, max_abs_err=err_gbuf,
                                    ms=k_dev, plain_ms=p_ms, **k1_bound,
                                    bound_ms_full=k1_full["bound_ms"])}

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
    din, _ = atlas_inputs(fstep, fmats)
    split = raster.depth_args(**din)
    sup, grid = split["super"], split["grid"]
    k2, keep2, kept2, named2 = run_kept(raster.depth_super_cuda, sup, "super",
                                        "phase b: depth_super (K2)")
    k3, keep3, kept3, named3 = run_kept(
        lambda *a, kept: raster.depth_grid_cuda(k2.clone(), *a, kept=kept), grid, "grid",
        "phase b: depth_grid (K3)")
    # the plain versions count their (slot, pixel) pairs after early exits,
    # over the scanned slots and over the slots the cull keeps
    # (with the warp culls' masks, also what the kernels' two culls leave)
    warps2 = split_warps(cull_args(sup, "super"))
    warps3 = split_warps(cull_args(grid, "grid"))
    work2, work2k, work3, work3k = [0], [0] * 4, [0], [0] * 4
    p2 = raster.depth_super_plain(*sup, work=work2)
    p2k = raster.depth_super_plain(*sup, work=work2k, keep=keep2, warps=warps2)
    p3 = raster.depth_grid_plain(k2.clone(), *grid, work=work3)
    p3k = raster.depth_grid_plain(k2.clone(), *grid, work=work3k, keep=keep3, warps=warps3)
    torch.cuda.synchronize()
    err2, err3 = max_diff(k2, p2), max_diff(k3, p3)
    bits23 = {"depth_super": same_bits(k2, p2), "depth_grid": same_bits(k3, p3)}
    masked23 = same_bits(p2k, p2) and same_bits(p3k, p3)
    atlas_h, atlas_w = k3.shape
    print(f"phase b: atlas {atlas_w}x{atlas_h}: depth_super vs plain max|d| {err2}, "
          f"depth_grid vs plain max|d| {err3}, same bits {bits23}; masked plain == "
          f"plain: {masked23}; covered {(k3 > 0).float().mean():.4f}")
    check(all(bits23.values()), "depth_super/depth_grid differ from their plain versions")
    check(masked23, "a split plain version masked by tile_slot_keep differs from the "
                    "unmasked one")
    check(kept2 < named2 and kept3 < named3,
          "the split atlas raster's cull keeps every named slot")
    split_lists_report(din, sup, keep2, keep3, warps2, warps3)
    b23 = split_bounds(sup, grid, k2, keep3,
                       {"depth_super": (work2[0], work2k), "depth_grid": (work3[0], work3k)},
                       {"depth_super": named2, "depth_grid": named3},
                       {"depth_super": kept2, "depth_grid": kept3})
    print(f"phase b: (slot, pixel) pairs all / tile-kept / warp-kept / rect-straddling / "
          f"inside: depth_super {[work2[0], *work2k]}, depth_grid {[work3[0], *work3k]}")
    print(f"phase b: bounds (after both culls; tile cull only; full: every scanned "
          f"pair) {b23}")
    del p2k, p3k
    setup, th = din["setup"], din["tile_h"]
    _, cap = din["tile_tris"].shape
    d_tiles, d_counts, d_big = raster.bin_triangles_corner(
        setup, atlas_w, atlas_h, 128, cap, tile_h=th, max_big=256)
    occupied = d_counts > 0
    in_active = torch.zeros_like(occupied)
    in_active[din["act_ids"].long()] = True
    outside = int((occupied & ~in_active).sum())
    print(f"phase b: {int(occupied.sum())} occupied atlas tiles of "
          f"{occupied.numel()} (max_active_tiles {scfg.max_active_tiles}); "
          f"{outside} with a list outside the active set (expected 0); "
          f"big casters {int((d_big >= 0).sum())}")
    dense = raster.depth_args(setup, d_tiles, d_counts, d_big, atlas_w, atlas_h, 128,
                              din["atlas_bounds"], din["tri_atlas"], th)["dense"]
    k4_flag, _, _, _ = run_kept(raster.depth_dense_cuda, dense, "depth",
                                "phase b: depth_dense (K4) on the flagship atlas")
    torch.cuda.synchronize()
    split_vs_dense = max_diff(k4_flag, k3)
    bits_b = same_bits(k4_flag, k3)
    print(f"phase b: depth_dense on the dense corner binning vs split: "
          f"max|d| {split_vs_dense}, same bits {bits_b}")
    check(outside == 0, "occupied atlas tiles lost their lists")
    check(bits_b, "the split atlas differs from the dense one")

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
    fargs = raster.kernel_args(**rend.raster_inputs(
        fstep.scene, fstep.instance_matrices(fst["physics"]), fstep.constants))
    *out_f, err_gbuf_f = check_raster_shade(fargs, "phase c")
    print(f"phase c: raster_shade bound (and full) {raster_shade_bounds(fargs, *out_f)}")
    del out_f
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
    dargs = raster.depth_args(**atlas_inputs(dstep, dmats)[0])["dense"]
    k4, keep_d, _, named_d = run_kept(raster.depth_dense_cuda, dargs, "depth",
                                      "phase d: depth_dense (K4) on the dense-shadow atlas")
    work_d, work_dk = [0], [0]
    p4 = raster.depth_dense_plain(*dargs, work=work_d)
    p4k = raster.depth_dense_plain(*dargs, work=work_dk, keep=keep_d)
    torch.cuda.synchronize()
    err4 = max_diff(k4, p4)
    b4d, b4d_full = dense_bounds(dargs, k4, work_d[0], work_dk[0], named_d)
    print(f"phase d: dense-shadow frame: depth_dense launches {k4_launches}; atlas "
          f"{k4.shape[1]}x{k4.shape[0]} vs plain max|d| {err4}, same bits "
          f"{same_bits(k4, p4)}; image {tuple(dout['image'].shape)}; bound {b4d} "
          f"(full {b4d_full})")
    check(k4_launches == 1, "the dense-shadow frame did not launch depth_dense once")
    check(same_bits(k4, p4), "depth_dense disagrees with its plain version")
    check(same_bits(p4k, p4),
          "the plain depth_dense masked by tile_slot_keep differs from the unmasked one")

    # phase e: a small flagship step on the card against the CPU
    small_step_vs_cpu(build, {"shadow": ShadowConfig(
        resolve_step=2, cascade_sizes=(256, 128, 128), atlas_tile_h=16,
        atlas_foot_y=2, max_active_tiles=24)}, "e")

    # phase f: timings of the kernels and the flagship (medians; kernels also by
    # their device time)
    prior = k2.clone()
    buf = torch.empty_like(prior)
    copy_ms = cuda_ms(lambda: buf.copy_(prior), reps=20, warmup=3)
    t = {
        "depth_super kernel, device": kernel_ms(
            lambda: raster.depth_super_cuda(*split["super"])),
        "depth_grid kernel, device": kernel_ms(lambda: raster.depth_grid_cuda(
            buf.copy_(prior), *split["grid"])) - kernel_ms(lambda: buf.copy_(prior)),
        "depth_dense kernel, device": kernel_ms(lambda: raster.depth_dense_cuda(*dargs)),
        "depth_super kernel, one call": cuda_ms(
            lambda: raster.depth_super_cuda(*split["super"]), reps=20, warmup=3),
        "depth_super plain": cuda_ms(lambda: raster.depth_super_plain(*split["super"]),
                                     reps=3),
        "depth_grid kernel, one call": cuda_ms(lambda: raster.depth_grid_cuda(
            buf.copy_(prior), *split["grid"]), reps=20, warmup=3) - copy_ms,
        "depth_grid plain": cuda_ms(lambda: raster.depth_grid_plain(
            buf.copy_(prior), *split["grid"]), reps=3) - copy_ms,
        "depth_dense kernel, one call": cuda_ms(lambda: raster.depth_dense_cuda(*dargs),
                                                reps=20, warmup=3),
        "depth_dense plain": cuda_ms(lambda: raster.depth_dense_plain(*dargs),
                                     reps=3),
        "depth_dense kernel, device, flagship atlas": kernel_ms(
            lambda: raster.depth_dense_cuda(*dense)),
        "raster_shade kernel, device, flagship": kernel_ms(
            lambda: raster.raster_shade_cuda(*fargs)),
    }
    fmats = fstep.instance_matrices(fst["physics"])
    fgeo, fvis, g = rend.gbuffer_pass(fstep.scene, fmats, fstep.constants)
    light, splits = rend.shadow_light(fstep.constants)
    atlas, _ = rend.shadow_atlas(fstep.scene, fgeo["planes"], light)
    shadow = rend.shadow_factor(g, fstep.constants, atlas, light, splits)
    ao = rend.ambient_occlusion(g, fstep.constants)
    hdr = rend.shade(g, fstep.constants, shadow, ao)
    t.update({
        "flagship raster + G-buffer": cuda_ms(lambda: rend.gbuffer_pass(
            fstep.scene, fmats, fstep.constants), reps=10),
        "flagship render_cascades": cuda_ms(lambda: rend.shadow_atlas(
            fstep.scene, fgeo["planes"], light), reps=10),
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
    results["depth_super"] = dict(
        launches=counts["depth_super"], max_abs_err=err2,
        ms=t["depth_super kernel, device"], plain_ms=t["depth_super plain"],
        **b23["depth_super"][0], bound_ms_tile=b23["depth_super"][1]["bound_ms"],
        bound_ms_full=b23["depth_super"][2]["bound_ms"])
    results["depth_grid"] = dict(
        launches=counts["depth_grid"], max_abs_err=err3, ms=t["depth_grid kernel, device"],
        plain_ms=t["depth_grid plain"], **b23["depth_grid"][0],
        bound_ms_tile=b23["depth_grid"][1]["bound_ms"],
        bound_ms_full=b23["depth_grid"][2]["bound_ms"])
    err4_all = max(err4, split_vs_dense)
    del fstep, fstate, fst, fout, dstep, dstate, dout, k2, p2, k3, p3, k4, p4, dense
    del fargs
    del fgeo, fvis, g, atlas, shadow, ao, hdr

    # phase g: the glass step at full size
    t0 = time.perf_counter()
    gstep, gstate = build(n_bodies=N_BODIES, width=WIDTH, height=HEIGHT, grid_dim=64,
                          box_materials=GLASS_BOXES, cfg_overrides=GLASS_OVERRIDES,
                          device="cuda")
    torch.cuda.synchronize()
    grend, gscene, gconst = gstep.renderer, gstep.scene, gstep.constants
    modes = {k: int(gscene[k].sum()) for k in ("tri_translucent", "tri_sorted",
                                               "tri_refract")}
    print(f"phase g: built the glass step in {time.perf_counter() - t0:.1f} s; "
          f"non-opaque triangles {modes} of {gscene['tri_valid'].numel()}")

    # phase h: K5, K6, K7 and K4 against their plain versions on one real
    # glass frame's inputs
    ga, light, ghdr = glass_kernel_args(gstep, gstate)
    gargs, vargs, sargs, aargs, oargs = (ga[k] for k in (
        "raster_shade", "visibility", "sorted", "atlas_tint", "oit"))
    d4 = {"atlas": ga["depth_atlas"], "trans_depth": ga["trans_depth"]}
    *out_g, err_gbuf_g = check_raster_shade(gargs, "phase h")
    print(f"phase h: raster_shade bound (and full) {raster_shade_bounds(gargs, *out_g)}")
    del out_g
    kv, keep5, _, named5 = run_kept(raster.visibility_cuda, vargs, "visibility",
                                    "phase h: visibility (K5)")
    pv = raster.visibility_plain(*vargs)
    pv_keep = raster.visibility_plain(*raster.band_args(vargs), keep=keep5)
    ks, keep_s, _, _ = run_kept(raster.blend_cuda, sargs, "blend",
                                "phase h: sorted_blend (K6), sorted pass")
    ka, keep_a, kept_a, named_a = run_kept(raster.blend_cuda, aargs, "blend",
                                           "phase h: sorted_blend (K6), atlas tint")
    ps, pa = raster.blend_plain(*sargs), raster.blend_plain(*aargs)
    ko, keep7, _, named7 = run_kept(oit.oit_cuda, oargs, "oit", "phase h: oit (K7)")
    inside7 = [0]
    po = oit.oit_plain(*oargs, work=inside7)
    po_keep = oit.oit_plain(*oargs, keep=keep7)
    # the plain K4 counts its (slot, pixel) pairs after early exits, over
    # the scanned slots (work4) and over the slots the cull keeps (work4k)
    run4 = {k: run_kept(raster.depth_dense_cuda, a, "depth",
                        f"phase h: depth_dense (K4), {k}") for k, a in d4.items()}
    k4g = {k: r[0] for k, r in run4.items()}
    work4, work4k = {k: [0] for k in d4}, {k: [0] for k in d4}
    p4g = {k: raster.depth_dense_plain(*a, work=work4[k]) for k, a in d4.items()}
    p4k = {k: raster.depth_dense_plain(*a, work=work4k[k], keep=run4[k][1])
           for k, a in d4.items()}
    ps_keep = raster.blend_plain(*sargs, keep=keep_s)
    pa_keep = raster.blend_plain(*aargs, keep=keep_a)
    torch.cuda.synchronize()
    check(same_bits(ps_keep, ps) and same_bits(pa_keep, pa)
          and all(same_bits(p4k[k], p4g[k]) for k in d4)
          and all(same_bits(pv_keep[k], pv[k]) for k in pv)
          and all(same_bits(a, b) for a, b in zip(po_keep, po)),
          "a plain version masked by tile_slot_keep differs from the unmasked one")
    for name, (n_kept, n_named) in (("sorted_blend atlas tint", (kept_a, named_a)),
                                    ("depth_dense translucent atlas", run4["atlas"][2:])):
        check(n_kept < 0.1 * n_named,
              f"{name}: the cull keeps {n_kept} of {n_named} slots, not under 10%")
    same5 = torch.equal(kv["tri_id"], pv["tri_id"])
    err5 = max(max_diff(kv[k], pv[k]) for k in ("depth", "b0", "b1"))
    bits5 = all(same_bits(kv[k], pv[k]) for k in pv)
    err6 = {"sorted": max_diff(ks, ps), "atlas": max_diff(ka, pa)}
    err7 = max(max_diff(ko[0], po[0]), max_diff(ko[1], po[1]))
    err4g = {k: max_diff(k4g[k], p4g[k]) for k in d4}
    # the culled kernels must match their plain versions in every bit: a
    # culled slot would turn a -0.0 destination into +0.0 in the plain
    # version (the cull's precondition), which a comparison of values
    # cannot see
    bits = {"visibility": bits5,
            "sorted_blend sorted pass": same_bits(ks, ps),
            "sorted_blend atlas tint": same_bits(ka, pa),
            "oit accum": same_bits(ko[0], po[0]), "oit reveal": same_bits(ko[1], po[1]),
            **{f"depth_dense {k}": same_bits(k4g[k], p4g[k]) for k in d4}}
    print(f"phase h: visibility (K5) vs plain at 1920x1080: tri_id equal {same5}, "
          f"max|d| depth/b0/b1 {err5}; refraction covers "
          f"{(kv['tri_id'] >= 0).float().mean():.4f}")
    print(f"phase h: sorted_blend (K6) vs plain: sorted pass max|d| {err6['sorted']}, "
          f"atlas tint max|d| {err6['atlas']}; oit (K7) vs plain max|d| {err7}; "
          f"depth_dense (K4) vs plain: translucent atlas {err4g['atlas']}, "
          f"trans-depth {err4g['trans_depth']}")
    print(f"phase h: same bits as the plain version: {bits}; -0.0 in the "
          f"destination: sorted pass {negative_zeros(sargs[5])}, atlas tint "
          f"{negative_zeros(aargs[5])}")
    check(all(bits.values()), f"a culled kernel differs from its plain version in "
          f"some bit: {bits}")

    # phase i: 5 glass steps, counting every kernel's launches
    wrappers = {"raster_shade": raster.rasterize_visibility_shaded,
                "depth_super": raster.depth_super, "depth_grid": raster.depth_grid,
                "depth_dense": raster.depth_dense,
                "visibility": raster.rasterize_visibility,
                "sorted_blend": raster.rasterize_sorted_blend, "oit": oit.rasterize_oit}
    per_step = {"raster_shade": 1, "depth_super": 1, "depth_grid": 1, "depth_dense": 2,
                "visibility": 1, "sorted_blend": 2, "oit": 1}
    for fn in wrappers.values():
        fn.launches = 0
    gst = gstate
    for _ in range(5):
        gst, gimage = gstep(gst)
    torch.cuda.synchronize()
    glaunch = {k: fn.launches for k, fn in wrappers.items()}
    print(f"phase i: 5 glass steps, launches {glaunch}")
    check(glaunch == {k: 5 * n for k, n in per_step.items()},
          f"the glass step's launches per step are not {per_step}")
    check(tuple(gimage.shape) == (HEIGHT, WIDTH, 3) and gimage.dtype == torch.uint8,
          f"glass image is {tuple(gimage.shape)} {gimage.dtype}")
    gout = gstep.render(gstep.instance_matrices(gst["physics"]), gst["frame"])
    tr_out = gout["translucent"]
    chain = {"OIT reveal < 1": (tr_out["reveal"] < 1).float().mean().item(),
             "refraction coverage": (tr_out["refract_tri_id"] >= 0).float().mean().item(),
             "trans-depth coverage": (gout["trans_depth"] > 0).float().mean().item(),
             "atlas tint < 1": (tr_out["trans_atlas"][..., :3] < 1).any(-1)
             .float().mean().item()}
    gpos = gst["physics"]["bodies"]["pos"]
    print("phase i: share of pixels or texels: " + ", ".join(
        f"{k} {v:.5f}" for k, v in chain.items()) + f"; shadow {tuple(gout['shadow'].shape)}")
    check(all(v > 0 for v in chain.values()), "a non-opaque pass drew nothing")
    check(bool(torch.isfinite(gpos).all()), "glass body positions not finite")

    # phase j: a small glass step on the card against the CPU
    small_step_vs_cpu(build, dict(GLASS_OVERRIDES, shadow=ShadowConfig(
        resolve_step=2, cascade_sizes=(256, 128, 128), atlas_tile_h=16,
        atlas_foot_y=2, max_active_tiles=24)), "j", box_materials=GLASS_BOXES)

    # phase k: timings at the glass step's shapes (medians; kernels also by
    # their device time)
    gt = {"raster_shade: kernel, device": kernel_ms(
        lambda: raster.raster_shade_cuda(*gargs))}
    for name, fn, plain in (
            ("visibility", lambda: raster.visibility_cuda(*vargs),
             lambda: raster.visibility_plain(*vargs)),
            ("sorted_blend, sorted pass", lambda: raster.blend_cuda(*sargs),
             lambda: raster.blend_plain(*sargs)),
            ("sorted_blend, atlas tint", lambda: raster.blend_cuda(*aargs),
             lambda: raster.blend_plain(*aargs)),
            ("oit", lambda: oit.oit_cuda(*oargs), lambda: oit.oit_plain(*oargs)),
            ("depth_dense, atlas", lambda: raster.depth_dense_cuda(*d4["atlas"]),
             lambda: raster.depth_dense_plain(*d4["atlas"])),
            ("depth_dense, trans_depth",
             lambda: raster.depth_dense_cuda(*d4["trans_depth"]),
             lambda: raster.depth_dense_plain(*d4["trans_depth"]))):
        gt[f"{name}: kernel, device"] = kernel_ms(fn)
        gt[f"{name}: kernel, one call"] = cuda_ms(fn, 20, 3)
        gt[f"{name}: plain"] = cuda_ms(plain, 3)
    gmats = gstep.instance_matrices(gst["physics"])
    geo, gvis, gg = grend.gbuffer_pass(gscene, gmats, gconst)
    opaque = gvis["depth"]
    gt.update({
        "glass render_cascades (with the translucent map)": cuda_ms(
            lambda: grend.shadow_atlas(gscene, geo["planes"], light), 10),
        "glass OIT pass": cuda_ms(lambda: grend.oit_pass(gscene, geo, gconst, opaque,
                                                         ghdr), 10),
        "glass refraction pass": cuda_ms(lambda: grend.refraction_pass(
            gscene, geo, gconst, ghdr), 10),
        "glass sorted pass": cuda_ms(lambda: grend.sorted_pass(gscene, geo, gconst,
                                                               opaque, ghdr), 10),
        "glass trans-depth pass": cuda_ms(lambda: grend.trans_depth_pass(
            gscene, geo, gconst), 10),
        "glass render": cuda_ms(lambda: gstep.render(gmats, gst["frame"]), 10),
        "glass combined step": cuda_ms(lambda: gstep(gst), 10),
    })
    for name, ms in gt.items():
        print(f"phase k: {name} median {ms:.4f} ms  [{card}]")

    results["raster_shade"]["max_abs_err"] = max(err_gbuf, err_gbuf_f, err_gbuf_g)
    # K1, K5 and K7: the operations of the (slot, pixel) pairs that the cull
    # keeps plus the cull's own per named slot; bytes as before the cull.
    # bound_ms_full counts every scanned pair
    pairs5, ids5 = raster_work(*vargs[1:8])
    moved5 = input_bytes(vargs[0], ids5, *vargs[1:4]) + nbytes(*kv.values())
    results["visibility"] = dict(
        launches=glaunch["visibility"], max_abs_err=err5,
        ms=gt["visibility: kernel, device"], plain_ms=gt["visibility: plain"],
        **bound(kept_pairs(keep5, *raster.band_args(vargs)[4:8]) * OPS_EDGE
                + named5 * OPS_CULL_EDGE,
                moved5),
        bound_ms_full=bound(pairs5 * OPS_EDGE, moved5)["bound_ms"])
    # K4 and K6: the operations of the (slot, pixel) pairs that the cull
    # keeps (a culled pair cannot change a pixel) plus the cull's own per
    # scanned slot; K6's bytes: the named records, the lists' used slots,
    # hdr, the output, and the opaque depth of the tiles that keep a slot
    # (a tile that keeps none is a copy of hdr). bound_ms_full counts as
    # before the cull: every scanned pair, the lists and the opaque depth whole
    b6, b6_full = [], []
    for a, k, keep in ((sargs, ks, keep_s), (aargs, ka, keep_a)):
        pairs6, ids6 = raster_work(*a[1:4], *a[6:10])
        px = frame_pixels(keep.shape[0], *a[6:10], keep.device)
        moved = (input_bytes(a[0], ids6, a[5]) + list_bytes(*a[1:4])
                 + a[4].element_size() * int(px[keep.any(1)].sum()) + nbytes(k))
        rect = bool(a[10])
        per_pair = OPS_BLEND + (OPS_RECT if rect else 0)
        b6_full.append(bound(pairs6 * per_pair, input_bytes(a[0], ids6, *a[1:6])
                             + nbytes(k)))
        b6.append(bound(kept_pairs(keep, *a[6:10]) * per_pair + named_slots(*a[1:4])
                        * (OPS_CULL_VERTEX + (OPS_CULL_RECT if rect else 0)), moved))
    results["sorted_blend"] = dict(
        launches=glaunch["sorted_blend"], max_abs_err=max(err6.values()),
        ms=(gt["sorted_blend, sorted pass: kernel, device"]
            + gt["sorted_blend, atlas tint: kernel, device"]),
        plain_ms=gt["sorted_blend, sorted pass: plain"] + gt["sorted_blend, atlas tint: plain"],
        bound_ms=b6[0]["bound_ms"] + b6[1]["bound_ms"],
        bound_by=max(b6, key=lambda b: b["bound_ms"])["bound_by"],
        bound_ms_full=b6_full[0]["bound_ms"] + b6_full[1]["bound_ms"])
    b7, b7_full = oit_bounds(oargs, ko, keep7, named7, inside7[0])
    results["oit"] = dict(
        launches=glaunch["oit"], max_abs_err=err7, ms=gt["oit: kernel, device"],
        plain_ms=gt["oit: plain"], **b7, bound_ms_full=b7_full["bound_ms"])
    print(f"phase k: oit bound {b7} (full {b7_full}): {inside7[0]} inside pairs of "
          f"{kept_pairs(keep7, *oargs[4:7], oit.band_rows(oargs[6]))} kept")
    b4, b4_full = zip(*(dense_bounds(a, k4g[k], work4[k][0], work4k[k][0], run4[k][3])
                        for k, a in d4.items()))
    results["depth_dense"] = dict(
        launches=glaunch["depth_dense"], max_abs_err=max(err4_all, *err4g.values()),
        ms=(gt["depth_dense, atlas: kernel, device"]
            + gt["depth_dense, trans_depth: kernel, device"]),
        plain_ms=gt["depth_dense, atlas: plain"] + gt["depth_dense, trans_depth: plain"],
        bound_ms=b4[0]["bound_ms"] + b4[1]["bound_ms"],
        bound_by=max(b4, key=lambda b: b["bound_ms"])["bound_by"],
        bound_ms_full=b4_full[0]["bound_ms"] + b4_full[1]["bound_ms"])
    print(f"phase k: bounds per shape (full: every scanned pair): sorted_blend sorted "
          f"pass {b6[0]} (full {b6_full[0]}), atlas tint {b6[1]} (full {b6_full[1]}); "
          f"depth_dense translucent atlas {b4[0]} (full {b4_full[0]}), trans-depth "
          f"{b4[1]} (full {b4_full[1]})")

    for k in ("visibility", "depth_dense"):
        results[k]["launches_by_path"] = {"glass (5 steps)": glaunch[k]}
    for k, path, n in (("raster_shade", "slice (5 steps)", launches),
                       ("depth_super", "flagship (5 steps)", counts["depth_super"]),
                       ("depth_grid", "flagship (5 steps)", counts["depth_grid"])):
        results[k]["launches_by_path"] = {path: n}
    physics_phases(card)
    pass_set_phases(card, results, t_start)
    feature_phases(card, results, t_start)
    engine_phases(card, results, t_start)
    batch = world_batch_phase(card)
    parallel_cli_phases(card, results, t_start)
    multichip_phases(card, results, batch, t_start)

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "library_ms": None, **results[name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
