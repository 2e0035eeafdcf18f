#!/usr/bin/env python3
"""The benchmark of garden_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout. Builds the cell's scene from its
configuration file and the seed on the card, loads the kernels (built once
into garden_tpu_torch/_build/ inside the checkout), warms up with the
cell's own shapes, measures for S seconds on two fixed cores, checks the
kept steps against the plain reference, and prints one JSON line last on
standard output:
with --trace 0 the cell's end-to-end metrics, with --trace 1 its per-layer
metrics read from a short profiled stretch of the window. Each compared
number and its limit are the last lines on standard error and the last key
of that line. Without the CUDA cards the cell asks for, it prints no
result and exits with 2; with a JAX module loaded at the end, with 3.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def pin_to_two_cores() -> None:
    """Keep this process, and every thread it starts from now on, on the two
    highest-numbered cores it may use. The steps are bound by the host's
    launch loop, and a process that the scheduler moves between cores ran
    115-146 ms a frame against 125-135 pinned (PERF.md, section 2)."""
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cores[-2:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    pin_to_two_cores()
    import torch
    from benchmark import harness

    loaded = harness.load_cell(args.workload)
    need = loaded["traffic"]["devices"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        print(f"run.py: {args.workload} needs {need} CUDA card(s), {have} visible; "
              "no result", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              [f"cuda:{i}" for i in range(need)], START, loaded)
    bad = harness.forbidden_modules()
    if bad:
        print(f"run.py: modules of JAX or the JAX package loaded: {bad}; no result",
              file=sys.stderr)
        return 3
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, d in result["checks"].items():
        print(f"check {name}: {d['value']!r} limit {d['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
