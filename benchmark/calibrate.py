#!/usr/bin/env python3
"""The readings that the limits of `correct` are set from.

    python3 benchmark/calibrate.py --workload NAME --seeds 1,2,3 --seconds S
        [--controls tf32,bf16]

Runs the cell once per seed in this one process (each run as run.py makes
it, a window of S seconds) and prints, per seed, the program's compared
numbers and, for each control, the numbers of the plain reference in that
precision put in the program's place over the same kept steps: "tf32" the
reference with TF32 on, "bf16" the reference from its input rounded
through bfloat16. Last, per number, the largest program reading and the
smallest control reading over the seeds, as one JSON line.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="readings for the limits of a cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--controls", default="tf32,bf16")
    args = ap.parse_args(argv)

    import torch
    from benchmark import harness

    loaded = harness.load_cell(args.workload)
    need = loaded["traffic"]["devices"]
    if (torch.cuda.device_count() if torch.cuda.is_available() else 0) < need:
        print(f"calibrate.py: {args.workload} needs {need} CUDA card(s)", file=sys.stderr)
        return 2
    controls = [m for m in args.controls.split(",") if m]
    program, control = {}, {m: {} for m in controls}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        res = harness.run_cell(args.workload, seed, args.seconds, False,
                               [f"cuda:{i}" for i in range(need)], t, loaded,
                               controls=controls)
        nums = {k: d["value"] for k, d in res["checks"].items()}
        for k, v in nums.items():
            program[k] = max(program.get(k, v), v)
        for m, got in res.get("controls", {}).items():
            for k, v in got.items():
                control[m][k] = min(control[m].get(k, v), v)
        print(json.dumps({"seed": seed, "attempted": res["attempted"], "program": nums,
                          "controls": res.get("controls"),
                          "metrics": {k: d["value"] for k, d in res["metrics"].items()},
                          "seconds": time.perf_counter() - t}), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "program_max": program,
                      "control_min": control}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
