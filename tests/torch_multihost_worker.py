"""One process of the port's two-process world batch (the twin of
tests/multihost_worker.py, SURVEY.md section 5.8's multi-host path).

    python tests/torch_multihost_worker.py RANK tcp://localhost:PORT [DEVICE]

Two such processes join a `torch.distributed` gloo group over the given
address. Each holds 2 of 4 worlds (a plane and a sphere dropped from y=3,
16 body slots; world i's sphere moved 0.01 i in x, as the reference's
make_global does) on DEVICE ("cpu" by default; two ranks may share a card,
as gloo allows), steps them 3 times through `WorldBatch` and all-reduces
the mean sphere height. Each checks that the mean lies in (2.5, 3.0) and
equals, within 1e-6, the same reduce of the same 4 worlds in one process
(taken before the group starts), then prints `proc RANK: OK mean_y=...`.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from garden_tpu_torch.core.config import PhysicsConfig  # noqa: E402
from garden_tpu_torch.parallel.worlds import WorldBatch  # noqa: E402
from garden_tpu_torch.physics import world as pw  # noqa: E402

N_WORLDS, N_RANKS, STEPS = 4, 2, 3


def worlds(device):
    """(the step, the 4 world states on `device`)."""
    cfg = PhysicsConfig(max_bodies=16, grid_dim=8, cell_size=2.0)
    w = pw.PhysicsWorld(cfg)
    w.add_body(w.shapes.plane((0, 1, 0), 0.0), motion=pw.STATIC)
    w.add_body(w.shapes.sphere(0.5), position=(0.0, 3.0, 0.0))
    types = w.shapes.present_types()
    state = w.device_state(device)
    states = []
    for i in range(N_WORLDS):
        pos = state["bodies"]["pos"].clone()
        pos[1, 0] += 0.01 * i
        states.append(dict(state, bodies=dict(state["bodies"], pos=pos)))
    return (lambda s: pw.step(s, cfg, 1.0 / 60.0, types)), states


def mean_height(device):
    """The mean sphere height over the 4 worlds after STEPS steps, through a
    WorldBatch on `device` (split across the ranks under a process group)
    -> (the batch, its shards, the mean)."""
    step, states = worlds(device)
    wb = WorldBatch(step, N_WORLDS, devices=[device])
    batched = wb.stack(states)
    for _ in range(STEPS):
        batched = wb.step(batched)
    for shard in batched:
        assert bool(torch.isfinite(shard["bodies"]["pos"]).all())
    return wb, batched, float(wb.reduce(batched, lambda s: s["bodies"]["pos"][1, 1]))


def main(argv) -> int:
    rank, init = int(argv[1]), argv[2]
    device = argv[3] if len(argv) > 3 else "cpu"
    torch.set_num_threads(1)
    _, _, alone = mean_height(device)
    dist.init_process_group("gloo", init_method=init, world_size=N_RANKS, rank=rank)
    try:
        wb, batched, val = mean_height(device)
    finally:
        dist.destroy_process_group()
    assert 2.5 < val < 3.0, val          # fell ~3 steps of gravity from y=3
    assert abs(val - alone) <= 1e-6, (val, alone)
    # this rank holds worlds 2 rank and 2 rank + 1, and only those
    assert wb.world(batched, 2 * rank)["bodies"]["pos"].shape == (16, 3)
    try:
        wb.world(batched, 2 * (1 - rank))
    except IndexError:
        pass
    else:
        raise AssertionError("world() returned a world of the other rank")
    print(f"proc {rank}: OK mean_y={val!r} one process {alone!r} on {device}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
