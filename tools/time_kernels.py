#!/usr/bin/env python3
"""Device time of the port's hand kernels at the main path's full-size
shapes, to compare checkouts in one call on one card.

    python3 tools/time_kernels.py [--rounds N] [--label TEXT]

Builds the flagship step and the glass step (10,240 bodies, 1920x1080) on
the CUDA card, takes each kernel's inputs from one real frame with
`chip_smoke.py`'s own functions (`atlas_inputs`, `glass_kernel_args`), and
times one launch of each kernel with `chip_smoke.kernel_ms` (CUDA events
queued behind a ~2 ms spin, median of 20), over `rounds` rounds that each
visit every kernel. K1 runs at the flagship's shape (the slice's is the
same frame) and at the glass step's; K4 and K6 at their two glass shapes;
K3 in place on a copy of K2's output, the copy's own time taken off. It
calls only arguments that every version of the wrappers takes, so it runs
in an older checkout too, one whose `cuda_build` has `SOURCES`: copy it and
`chip_smoke.py` into that checkout (the tool to its tools/), and run
parent, change, change, parent in one call. Prints the card, then one JSON line {"label", "card", "ms": {kernel:
[ms per round]}}.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--label", default=str(ROOT))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_kernels: CUDA is not available", file=sys.stderr)
        return 1
    from garden_tpu_torch import cuda_build
    from garden_tpu_torch.entry import GLASS_BOXES, GLASS_OVERRIDES, build
    from garden_tpu_torch.render import oit, raster

    card = chip_smoke.card_line()
    print(f"card: {card}")
    cuda_build.build_all(cuda_build.SOURCES)
    size = dict(n_bodies=chip_smoke.N_BODIES, width=chip_smoke.WIDTH,
                height=chip_smoke.HEIGHT, grid_dim=64, device="cuda")
    fns = {}

    step, state = build(**size)
    rend = step.renderer
    mats = step.instance_matrices(step.physics(state["physics"]))
    k1 = raster.kernel_args(**rend.raster_inputs(step.scene, mats, step.constants))
    fns["K1 raster_shade, flagship"] = lambda: raster.raster_shade_cuda(*k1)
    split = raster.depth_args(**chip_smoke.atlas_inputs(step, mats)[0])
    prior = raster.depth_super_cuda(*split["super"])
    buf = torch.empty_like(prior)
    fns["K2 depth_super"] = lambda: raster.depth_super_cuda(*split["super"])
    fns["K3 depth_grid (+ copy)"] = lambda: raster.depth_grid_cuda(buf.copy_(prior),
                                                                   *split["grid"])
    fns["copy"] = lambda: buf.copy_(prior)

    gstep, gstate = build(box_materials=GLASS_BOXES, cfg_overrides=GLASS_OVERRIDES,
                          **size)
    g, _, _ = chip_smoke.glass_kernel_args(gstep, gstate)
    fns.update({
        "K1 raster_shade, glass": lambda: raster.raster_shade_cuda(*g["raster_shade"]),
        "K4 depth_dense, translucent atlas":
            lambda: raster.depth_dense_cuda(*g["depth_atlas"]),
        "K4 depth_dense, trans-depth": lambda: raster.depth_dense_cuda(*g["trans_depth"]),
        "K5 visibility": lambda: raster.visibility_cuda(*g["visibility"]),
        "K6 sorted_blend, sorted pass": lambda: raster.blend_cuda(*g["sorted"]),
        "K6 sorted_blend, atlas tint": lambda: raster.blend_cuda(*g["atlas_tint"]),
        "K7 oit": lambda: oit.oit_cuda(*g["oit"]),
    })
    torch.cuda.synchronize()

    ms = {name: [] for name in fns}
    for _ in range(args.rounds):
        for name, fn in fns.items():
            ms[name].append(chip_smoke.kernel_ms(fn))
    ms["K3 depth_grid"] = [a - b for a, b in zip(ms.pop("K3 depth_grid (+ copy)"),
                                                ms.pop("copy"))]
    for name, t in ms.items():
        print(f"{args.label}: {name}: " + " ".join(f"{x:.4f}" for x in t) + f" ms  [{card}]")
    print(json.dumps({"label": args.label, "card": card, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
