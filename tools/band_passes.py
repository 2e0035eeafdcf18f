#!/usr/bin/env python3
"""Which pass moves the pixels of a banded frame, on one CUDA card.

    python3 tools/band_passes.py [--bands 4] [--overlap 16]

Builds the flagship frame (10,240 bodies, 1920x1080, `entry.build`) and
renders it once by one `DeferredRenderer` and once as `--bands` horizontal
bands (`parallel.frame_tiles.FrameTiles`, every band on the card). It
prints the p99 and mean |difference| in 8-bit levels off the seams
(`chip_smoke.band_bars`: rows within SEAM_ROWS of a seam left out), first
with every pass on, then with one pass off at a time (shadows, bloom,
HBAO, FXAA, auto exposure), beside the card's name and power limit.
"""

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PASSES = ("use_shadows", "use_bloom", "use_hbao", "use_fxaa", "use_auto_exposure")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bands", type=int, default=4)
    ap.add_argument("--overlap", type=int, default=16)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("band_passes: CUDA is not available", file=sys.stderr)
        return 1
    from chip_smoke import HEIGHT, N_BODIES, SEAM_ROWS, WIDTH, band_bars, card_line
    from garden_tpu_torch import cuda_build
    from garden_tpu_torch.entry import build
    from garden_tpu_torch.parallel.frame_tiles import FrameTiles
    from garden_tpu_torch.render.deferred import DeferredRenderer
    cuda_build.build_all(cuda_build.SOURCES)
    print(f"card: {card_line()}")
    step, state = build(N_BODIES, WIDTH, HEIGHT, grid_dim=64, device="cuda")
    mats = step.instance_matrices(state["physics"])
    for off in (None,) + PASSES:
        cfg = step.renderer.config
        if off is not None:
            cfg = dataclasses.replace(cfg, **{off: False})
        one = DeferredRenderer(cfg, step.renderer.scene_host, "cuda")
        ref = one.render(step.scene, mats, step.constants, one.initial_frame_state())
        ft = FrameTiles(cfg, step.renderer.scene_host, args.bands, overlap=args.overlap,
                        devices=["cuda"] * args.bands)
        img, _ = ft.render(step.scene, mats, step.constants, ft.initial_state())
        p99, mean = band_bars(img.cpu().numpy(), ref["image"].cpu().numpy(), args.bands)
        print(f"{off or 'every pass on'}{'=False' if off else ''}: {args.bands} bands of "
              f"{ft.band_h} rows + {ft.overlap} guard rows against one renderer, off the "
              f"seams (+-{SEAM_ROWS} rows): p99 |d| {p99:.1f} levels, mean {mean:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
