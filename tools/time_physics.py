#!/usr/bin/env python3
"""Time the port's physics step on bench.py's world on one CUDA card.

    python3 tools/time_physics.py [--root DIR] [--reps 20]

Imports `garden_tpu_torch` from DIR (default: this checkout), so that two
trees can be timed on the same card, each in a process of its own, for
example a parent unpacked with `git archive` against this tree: run
parent, change, change, parent in one session and compare within it.

Builds `physics.scenes.bench_world` (10,240 bodies, half spheres), settles
it 20 steps, then prints the median milliseconds (CUDA events around each
call, after 3 warm-up calls) of the whole step, `collide`, the broadphase
(`world.candidates`) and the narrowphase (`narrowphase.generate_contacts`
on the candidate pairs), beside the card's name and power limit.
"""

import argparse
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SETTLE = 20


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="the tree whose garden_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(HERE))
    from chip_smoke import card_line, cuda_ms      # this checkout's, before `root`
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("time_physics: CUDA is not available", file=sys.stderr)
        return 1
    card = card_line()
    from garden_tpu_torch.physics import narrowphase, scenes
    from garden_tpu_torch.physics import world as pw
    state, cfg, types = scenes.bench_world("cuda")
    step = lambda s: pw.step(s, cfg, 1.0 / 60.0, types)
    for _ in range(SETTLE):
        state = step(state)
    stype, params, margin, cand, cvalid = pw.candidates(state, cfg)
    n, k = cand.shape
    pair_i = torch.arange(n, dtype=torch.int32, device="cuda")[:, None].expand(n, k).reshape(-1)
    bodies = state["bodies"]
    times = {
        "step": cuda_ms(lambda: step(state), args.reps, warmup=3),
        "collide": cuda_ms(lambda: pw.collide(state, cfg, types), args.reps, warmup=3),
        "broadphase": cuda_ms(lambda: pw.candidates(state, cfg), args.reps, warmup=3),
        "narrowphase": cuda_ms(lambda: narrowphase.generate_contacts(
            bodies["pos"], bodies["quat"], stype, params, pair_i, cand.reshape(-1),
            cvalid.reshape(-1), margin=margin, present_types=types,
            tables=state["shapes"]), args.reps, warmup=3),
    }
    print(f"tree {root}  [{card}]")
    for name, ms in times.items():
        print(f"  bench world {name}: median {ms:.4f} ms over {args.reps}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
