"""The seed's body positions: deterministic, distinct, never in contact,
and on the lattice the port's own world constructors use."""

import pytest
import torch

from benchmark import harness, inputs
from benchmark.tests.conftest import cells

CONFIGS = ["flagship_1080p.play"] + cells("world_batch")
SEEDS = [0, 7, 2 ** 31 + 11, 3 * 2 ** 32 + 5]


@pytest.mark.parametrize("cell", CONFIGS)
def test_positions_are_deterministic_and_differ_by_seed_and_world(cell):
    cfg = harness.load_cell(cell)["config"]
    a = inputs.positions(cfg, SEEDS[2], 0, "cpu")
    assert torch.equal(a, inputs.positions(cfg, SEEDS[2], 0, "cpu"))
    assert not torch.equal(a, inputs.positions(cfg, SEEDS[3], 0, "cpu"))
    assert not torch.equal(a, inputs.positions(cfg, SEEDS[2], 1, "cpu"))
    assert a.shape == (cfg["n_bodies"], 3) and a.dtype == torch.float32


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CONFIGS)
def test_every_start_gap_is_above_zero(cell, seed):
    cfg = harness.load_cell(cell)["config"]
    pos = inputs.positions(cfg, seed, 3, "cpu").double()
    half = cfg["bodies"]["half_extent"]
    base = torch.as_tensor(inputs.lattice(cfg)).double()
    shift = pos[1:] - base
    assert shift.abs().max() <= cfg["bodies"]["shift"] + 1e-6
    assert torch.all(shift[:, 1] == 0)
    assert torch.all(pos[0] == 0)
    # bodies are boxes of half extent `half`: two are apart where their boxes
    # are apart along some axis
    p = pos[1:]
    d = (p[:, None, :] - p[None, :, :]).abs() - 2 * half
    gap = d.max(-1).values
    gap.fill_diagonal_(float("inf"))
    assert gap.min() > 0.0
    assert (p[:, 1] - half).min() > 0.0          # above the ground plane


@pytest.mark.parametrize("cell", CONFIGS)
def test_lattice_is_the_ports_own(cell):
    from garden_tpu_torch import entry
    cfg = harness.load_cell(cell)["config"]
    w, _, side = entry.flagship_world(cfg["n_bodies"], 16)
    assert side == cfg["bodies"]["lattice"]["side"]
    assert torch.equal(torch.as_tensor(w._b["pos"][1:]), torch.as_tensor(inputs.lattice(cfg)))
