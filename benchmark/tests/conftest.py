"""The benchmark's own tests: CPU tests at small sizes, and card tests
marked `gpu`, which decide inside the test whether a card is there.

    python -m pytest benchmark/tests -q              # here, on the CPU
    python -m pytest benchmark/tests -q -m gpu       # on a machine with cards
"""

import json
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
torch.set_num_threads(2)


def tiny(loaded, n_bodies=300, worlds=2, devices=1):
    """A cell loaded by `harness.load_cell`, cut to a CPU test's size: the
    port's lattice of n_bodies - 1 bodies, a 256x128 frame with shadow maps
    of 512 (the near one, where the file sizes each), short warm-up and
    check, the profiled stretch at the window's start. Widths of the file's
    kind (half extents, spacing) stay."""
    cfg, traffic = loaded["config"], loaded["traffic"]
    cfg["n_bodies"] = n_bodies
    # the side that entry.flagship_world, and so the program's camera, takes
    side = max(int(round((n_bodies - 1) ** (1.0 / 3.0))), 1)
    cfg["bodies"]["lattice"].update(
        side=side, dims={"x": side, "y": -(-(n_bodies - 1) // side ** 2), "z": side})
    if "width" in cfg:
        cfg.update(width=256, height=128)
        shadow = cfg["render"]["shadow"]
        if "cascade_sizes" in shadow:
            shadow["cascade_sizes"] = [512, 256, 256]
        else:
            shadow["map_size"] = 512
    traffic.update(warmup_steps=2, check_within=3, devices=devices, trace_start=1,
                   trace_steps=2, span_steps=min(2, traffic["span_steps"]))
    if traffic["entry"] == "world_batch":
        traffic["worlds"] = worlds
    return loaded


def cells(entry):
    """The cells of BENCHMARK.json whose traffic drives `entry`."""
    from benchmark import harness
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in spec["workloads"]
            if harness.load_cell(w["name"], spec)["traffic"]["entry"] == entry]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
