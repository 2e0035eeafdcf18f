#!/usr/bin/env python3
"""The rate a worlds cell sustains at each number of worlds on one card.

    python3 benchmark/sweep.py --workload NAME --worlds 8,16,32,64 --seed N
        --seconds S [--controls bf16]

Runs the cell once per world count in this one process, each run as
run.py makes it (the cell's traffic with `worlds` replaced, a window of S
seconds, the check against the reference after it), and prints one JSON
line per count: the rate, the step time, the peak device memory, whether
it was correct and the compared numbers (and, with --controls, the
control's). The traffic file's world count is chosen from these lines:
where the rate stops growing.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="a worlds cell's rate by world count")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--worlds", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--controls", default="")
    args = ap.parse_args(argv)

    import torch
    from benchmark import harness

    base = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("sweep.py: needs a CUDA card", file=sys.stderr)
        return 2
    controls = [m for m in args.controls.split(",") if m]
    for n in (int(w) for w in args.worlds.split(",")):
        loaded = copy.deepcopy(base)
        loaded["traffic"]["worlds"] = n
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        res = harness.run_cell(args.workload, args.seed, args.seconds, False, ["cuda:0"], t,
                               loaded, controls=controls)
        rate = res["metrics"]["world_steps_per_s"]["value"]
        print(json.dumps({"worlds": n, "world_steps_per_s": rate, "step_ms": 1e3 * n / rate,
                          "setup_s": res["metrics"]["setup_s"]["value"],
                          "memory_peak_bytes": res["device"]["memory_peak_bytes"],
                          "correct": res["correct"],
                          "checks": {k: d["value"] for k, d in res["checks"].items()},
                          "controls": res.get("controls")}), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
